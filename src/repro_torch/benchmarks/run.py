"""Benchmark aggregator of the port: one module per paper figure
(counterpart of ``benchmarks/run.py``).

    python -m repro_torch.benchmarks.run                  # all
    python -m repro_torch.benchmarks.run fig04 fig18      # a selection
    python -m repro_torch.benchmarks.run fig13 --device cpu

Prints ``name,us_per_call,derived`` CSV rows (``benchmarks/common.emit``).
A selection picks every module whose name contains one of its words.
``--device`` goes to every figure (the card by default); the analytic
ones (fig06, fig18, fig04's cost half) ignore it.
fig16 and the roofline report read the dry-run's rows
(``python -m repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback
from typing import Optional, Sequence

MODULES = [
    "fig01_breakdown",
    "fig04_scheduling",
    "fig06_heatmap",
    "fig09_operator_scaling",
    "fig11_fused_prep",
    "fig13_library",
    "fig14_dispatch_overhead",
    "fig16_multipod",
    "fig18_guideline_eval",
    "roofline_report",
]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sel", nargs="*", help="words selecting modules")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    fig_argv = [] if args.device is None else ["--device", args.device]
    print("name,us_per_call,derived", flush=True)
    failures = []
    for name in MODULES:
        if args.sel and not any(s in name for s in args.sel):
            continue
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        t0 = time.time()
        try:
            mod.main(fig_argv)
        except Exception as e:  # noqa: BLE001 - report, keep going
            failures.append((name, repr(e)))
            traceback.print_exc(limit=3)
        print(f"# {name} done in {time.time() - t0:.1f}s", file=sys.stderr,
              flush=True)
    if failures:
        print(f"# FAILURES: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
