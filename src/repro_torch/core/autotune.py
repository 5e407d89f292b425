"""Exhaustive plan sweep = the paper's "global optimum" baseline (Fig. 18)
(counterpart of ``repro/core/autotune.py``).

The paper sweeps 96^3 thread-count triples; the mesh analogue sweeps every
(pools, intra, fsdp, seq_shard, pod_mode) factorization and ranks it by
the analytic three-term cost model (``core/cost_model``).  ``sweep``
returns every plan with its cost, so the benchmarks can report
guideline-vs-optimum gaps, as Fig. 18 does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import cost_model, tuner


@dataclasses.dataclass
class RankedPlan:
    plan: tuner.Plan
    cost: cost_model.CostBreakdown
    fits: bool

    @property
    def step_s(self) -> float:
        return self.cost.step_s


def evaluate(cfg: ModelConfig, shape: ShapeConfig, plan: tuner.Plan,
             hw: cost_model.Hardware = cost_model.H100) -> RankedPlan:
    cost = cost_model.estimate(
        cfg, shape, data=plan.data, pools=plan.pools, intra=plan.intra,
        fsdp=plan.fsdp, hw=hw, pod_axis_dp=(plan.pod_mode == "dp"),
        pods=plan.pods, seq_shard=plan.seq_shard)
    fits = cost_model.fits_memory(cfg, shape, data=plan.data,
                                  pools=plan.pools, intra=plan.intra,
                                  fsdp=plan.fsdp, hw=hw)
    return RankedPlan(plan, cost, fits)


def sweep(cfg: ModelConfig, shape: ShapeConfig, *, model_axis: int = 16,
          data_axis: int = 16, pods: int = 1,
          hw: cost_model.Hardware = cost_model.H100,
          seq_shard: Optional[bool] = None) -> List[RankedPlan]:
    plans = tuner.enumerate_plans(cfg, shape, model_axis=model_axis,
                                  data_axis=data_axis, pods=pods)
    if seq_shard is not None:
        plans = [p for p in plans if p.seq_shard == seq_shard]
    ranked = [evaluate(cfg, shape, p, hw) for p in plans]
    ranked.sort(key=lambda r: (not r.fits, r.step_s))
    return ranked


def global_optimum(cfg: ModelConfig, shape: ShapeConfig, **kw
                   ) -> Optional[RankedPlan]:
    ranked = sweep(cfg, shape, **kw)
    feasible = [r for r in ranked if r.fits]
    return feasible[0] if feasible else (ranked[0] if ranked else None)


def compare_settings(cfg: ModelConfig, shape: ShapeConfig, *,
                     model_axis: int = 16, data_axis: int = 16,
                     pods: int = 1,
                     hw: cost_model.Hardware = cost_model.H100):
    """Fig. 18 row: guideline vs TF vs Intel vs swept optimum.  The
    guideline's memory rule reads ``hw`` too (the reference's reads its
    default hardware whatever ``hw`` is; the two agree at the default)."""
    kw = dict(model_axis=model_axis, data_axis=data_axis, pods=pods)
    rows = {
        "guideline": evaluate(
            cfg, shape, tuner.guideline_plan(cfg, shape, hw=hw, **kw), hw),
        "tf_setting": evaluate(cfg, shape, tuner.tf_setting(cfg, shape, **kw),
                               hw),
        "intel_setting": evaluate(
            cfg, shape, tuner.intel_setting(cfg, shape, **kw), hw),
        # SP held fixed at the guideline's choice; it is its own knob
        "global_optimum": global_optimum(cfg, shape, hw=hw,
                                         seq_shard=False, **kw),
    }
    return rows
