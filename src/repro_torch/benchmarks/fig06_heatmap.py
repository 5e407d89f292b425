"""Paper Fig. 6: performance heatmap over (inter-op pools x intra-op
threads), the mesh analogue (counterpart of ``benchmarks/fig06_heatmap.py``).

    python -m repro_torch.benchmarks.fig06_heatmap

The cost model's step-time estimate over every (pools, intra)
factorization of the 16-wide model axis for dbrx-132b (the branch-rich
Inception analogue), train and prefill, on the port's ``Hardware()``
(the card's data-sheet figures).  Analytic: no device runs.
"""

from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import emit
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import autotune, tuner


def main(argv=None) -> List[dict]:
    """Emits the reference's rows; returns them as records."""
    del argv
    cfg = get_config("dbrx-132b")
    out = []
    for shape_name in ("train_4k", "prefill_32k"):
        shape = SHAPES[shape_name]
        best = None
        rows = []
        for pools in (1, 2, 4, 8, 16):
            plan = tuner.Plan(name=f"p{pools}", pools=pools,
                              intra=16 // pools, fsdp=True, seq_shard=False)
            r = autotune.evaluate(cfg, shape, plan)
            rows.append((pools, r))
            if r.fits and (best is None or r.step_s < best[1].step_s):
                best = (pools, r)
        for pools, r in rows:
            name = f"fig06.dbrx.{shape_name}.p{pools}_i{16 // pools}"
            emit(name, r.step_s * 1e6,
                 f"dominant={r.cost.dominant},fits={r.fits},"
                 f"best={'*' if best and pools == best[0] else ''}")
            out.append(dict(name=name, step_s=r.step_s, fits=r.fits,
                            dominant=r.cost.dominant, pools=pools))
        gl = tuner.guideline_plan(cfg, shape)
        matches = best is not None and gl.pools == best[0]
        name = f"fig06.dbrx.{shape_name}.guideline_choice"
        emit(name, 0.0, f"pools={gl.pools},matches_best={matches}")
        out.append(dict(name=name, pools=gl.pools, matches_best=matches))
    return out


if __name__ == "__main__":
    main()
