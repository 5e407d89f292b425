"""Paper Fig. 15-17: beyond one socket, DP vs MP across the slow link
(counterpart of ``benchmarks/fig16_multipod.py``).

    python -m repro_torch.benchmarks.fig16_multipod [--results DIR]

Reads the port's dry-run rows (``results/dryrun_torch/``, written by
``python -m repro_torch.launch.dryrun``): for each arch x shape present
on both meshes, the multi-pod collective-byte increase (the UPI-traffic
analogue) and the multi-pod collective term; then the cost model's DP
vs MP comparison across the pod axis for every arch at train_4k (paper
§7.2: MP helps only when similar-size parallel ops sit on the critical
path), on the port's ``Hardware()``.  No device runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.benchmarks.common import emit
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import autotune, tuner
from repro_torch.launch.dryrun import RESULTS


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Emits the reference's rows; returns them as records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=None)
    ap.add_argument("--device", default=None, help="ignored: analytic")
    args = ap.parse_args(argv)
    results = Path(args.results) if args.results else RESULTS
    out = []
    # counted: single vs multi wire bytes per device
    for f in sorted(results.glob("*__single__guideline.json")):
        g = results / f.name.replace("__single__", "__multi__")
        if not g.exists():
            continue
        a = json.loads(f.read_text())
        b = json.loads(g.read_text())
        if a["wire_bytes_per_device"] > 0:
            ratio = b["wire_bytes_per_device"] / a["wire_bytes_per_device"]
        else:
            ratio = float("nan")
        name = f"fig16.measured.{a['arch']}.{a['shape']}"
        emit(name, b["collective_s"] * 1e6,
             f"wire_ratio_multi_vs_single={ratio:.2f},"
             f"pod_mode={b['plan']['pod_mode']}")
        out.append(dict(name=name, collective_s=b["collective_s"],
                        wire_ratio=ratio, pod_mode=b["plan"]["pod_mode"]))

    # model: DP vs MP pod axis for each arch (train)
    shape = SHAPES["train_4k"]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        base = tuner.guideline_plan(cfg, shape, pods=2)
        dp = dataclasses.replace(base, pod_mode="dp", name="dp")
        mp = dataclasses.replace(base, pod_mode="mp", name="mp")
        t_dp = autotune.evaluate(cfg, shape, dp).step_s
        t_mp = autotune.evaluate(cfg, shape, mp).step_s
        pick = "mp" if t_mp < t_dp else "dp"
        name = f"fig16.model.{arch}"
        emit(name, min(t_dp, t_mp) * 1e6,
             f"dp_us={t_dp * 1e6:.0f},mp_us={t_mp * 1e6:.0f},best={pick},"
             f"guideline={base.pod_mode}")
        out.append(dict(name=name, dp_s=t_dp, mp_s=t_mp, best=pick,
                        guideline=base.pod_mode))
    return out


if __name__ == "__main__":
    main()
