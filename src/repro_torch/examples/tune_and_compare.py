"""The paper's contribution in action: analyze each architecture's graph
width, derive the guideline plan, and compare its cost-model step time
with the TensorFlow / Intel recommended-setting analogues and the
exhaustive sweep optimum (Fig. 18 at mesh-plan granularity; counterpart
of ``examples/tune_and_compare.py``).

    PYTHONPATH=src python -m repro_torch.examples.tune_and_compare

Analytic, on the port's ``Hardware()`` (the H100's data sheet): no
device runs, so it takes no ``--device``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import autotune, build_graph


def main(argv: Optional[List[str]] = None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    shape = SHAPES["train_4k"]
    print(f"{'arch':22s} {'avg_w':>5s} {'max_w':>5s} {'plan':>14s} "
          f"{'guideline':>10s} {'tf':>10s} {'intel':>10s} {'optimum':>10s} "
          f"{'gap':>6s}")
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        g = build_graph(cfg, training=True, global_batch=shape.global_batch)
        rows = autotune.compare_settings(cfg, shape)
        opt = rows["global_optimum"].step_s
        gap = rows["guideline"].step_s / opt if opt else float("nan")
        plan = rows["guideline"].plan
        print(f"{arch:22s} {g.avg_width:5d} {g.max_width:5d} "
              f"{'p%d·i%d%s' % (plan.pools, plan.intra, '·fsdp' if plan.fsdp else ''):>14s} "
              f"{rows['guideline'].step_s*1e3:9.1f}ms "
              f"{rows['tf_setting'].step_s*1e3:9.1f}ms "
              f"{rows['intel_setting'].step_s*1e3:9.1f}ms "
              f"{opt*1e3:9.1f}ms {gap:6.2f}")
    print("\ngap = guideline / swept-optimum (1.00 = guideline matches the "
          "exhaustive search, the paper's Fig. 18 claim)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
