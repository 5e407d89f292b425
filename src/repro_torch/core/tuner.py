"""The paper's tuning guideline, re-derived for device meshes
(counterpart of ``repro/core/tuner.py``, the same plans).

Paper §8 collapses five framework knobs into one: the number of inter-op
pools ``p`` = the *average model width*; intra-op threads follow as
``cores / p``.  Here the mesh's model-parallel capacity plays the role of
the cores: ``p`` device groups run independent heavy ops (MoE experts /
parallel branches) and each group tensor-shards its operator ``intra`` ways,
with ``pools * intra = model-axis size``.

``guideline_plan`` is the paper's rule; ``tf_setting`` / ``intel_setting``
are the two recommended-settings baselines of Fig. 18, translated to meshes;
``enumerate_plans`` spans the exhaustive-search space the paper compares
against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import cost_model
from repro_torch.core.graph import build_graph
from repro_torch.models import module as m
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass(frozen=True)
class Plan:
    name: str
    data: int = 16
    pools: int = 1            # inter-op pools: expert/branch parallel degree
    intra: int = 16           # intra-op threads: tensor-parallel degree
    pods: int = 1
    pod_mode: str = "dp"      # "dp" | "mp" (paper §7: DP vs MP across UPI)
    fsdp: bool = False        # ZeRO-3-style param sharding over data axis
    seq_shard: bool = True    # Megatron-SP activation sharding on model axis
    cp: bool = False          # context parallelism: seq on the model axis,
                              # weights fully sharded + gathered per layer
    notes: str = ""

    @property
    def model_axis(self) -> int:
        return self.pools * self.intra

    @property
    def chips(self) -> int:
        return self.data * self.model_axis * self.pods


# ---------------------------------------------------------------------------
# Plan -> logical-axis rules
# ---------------------------------------------------------------------------

def make_rules(plan: Plan, mesh) -> sh.Rules:
    """Map logical axes onto the axes that ``mesh`` actually has.

    Works with both the production meshes (("data","model") and
    ("pod","data","model")) and the tuner's factored meshes
    (("data","pool","intra") / ("pod","data","pool","intra")), as the
    descriptors of ``launch/mesh`` give them or as ``DeviceMesh``es of
    their shapes (``launch/mesh.device_mesh``: sharded training).
    """
    names = tuple(sh.axis_sizes(mesh))
    has_pod = "pod" in names
    factored = "pool" in names

    dp: Tuple[str, ...] = (("pod", "data") if (has_pod and plan.pod_mode == "dp")
                           else ("data",))
    model_all: Tuple[str, ...] = (("pool", "intra") if factored else ("model",))
    if has_pod and plan.pod_mode == "mp":
        model_all = ("pod",) + model_all
    pool_ax: Optional[Tuple[str, ...]] = None
    if plan.pools > 1:
        pool_ax = ("pool",) if factored else model_all

    def t(ax):  # 1-tuples -> plain names
        if ax is None:
            return None
        return ax if len(ax) > 1 else ax[0]

    if plan.cp:
        # context parallelism: tokens (not features) ride the model axis;
        # weights are fully sharded over every axis and gathered per layer
        full = dp + model_all
        table: Dict[str, sh.MeshAxis] = {
            m.VOCAB: None, m.EMBED: t(full), m.HEADS: None,
            m.KV_HEADS: None, m.MLP: None, m.SSM_INNER: None,
            m.EXPERT: t(pool_ax), m.HEAD_DIM: None, m.STATE: None,
            sh.BATCH: t(dp), sh.SEQ: t(model_all), sh.KV_SEQ: t(model_all),
            sh.EMBED: None, sh.HEADS: None, sh.MLP: None,
            sh.EXPERT: t(pool_ax), sh.GROUPS: t(dp), sh.VOCAB: None,
        }
        return sh.Rules(table=table, mesh=mesh, context_parallel=True)
    table: Dict[str, sh.MeshAxis] = {
        # parameter axes
        m.VOCAB: t(model_all),
        m.EMBED: t(dp) if plan.fsdp else None,
        m.HEADS: t(model_all),
        m.KV_HEADS: t(model_all),
        m.MLP: t(model_all),
        m.SSM_INNER: t(model_all),
        m.EXPERT: t(pool_ax),
        m.HEAD_DIM: None,
        m.STATE: None,
        # activation axes
        sh.BATCH: t(dp),
        sh.SEQ: t(model_all) if plan.seq_shard else None,
        sh.KV_SEQ: t(model_all),
        sh.EMBED: None,
        sh.HEADS: t(model_all),
        sh.MLP: t(model_all),
        sh.EXPERT: t(pool_ax),
        sh.GROUPS: t(dp),
        sh.VOCAB: t(model_all),
    }
    return sh.Rules(table=table, mesh=mesh)


# ---------------------------------------------------------------------------
# The guideline (paper §8) and the Fig. 18 baseline settings
# ---------------------------------------------------------------------------

def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def model_width(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int]:
    g = build_graph(cfg, training=(shape.kind == "train"),
                    global_batch=shape.global_batch)
    return g.avg_width, g.max_width


def guideline_plan(cfg: ModelConfig, shape: ShapeConfig, *,
                   model_axis: int = 16, data_axis: int = 16,
                   pods: int = 1, hw: cost_model.Hardware = cost_model.H100
                   ) -> Plan:
    avg_w, max_w = model_width(cfg, shape)
    # pools = avg width, clamped to (a) what the mesh can factor, (b) the
    # realizable branch count (experts for MoE; 1 otherwise — width >1 from
    # qkv/grad parallelism is scheduled inside each group).
    realizable = cfg.moe.num_experts if cfg.moe else 1
    target = min(avg_w, max_w, realizable)
    pools = max(d for d in _divisors(model_axis) if d <= target)
    intra = model_axis // pools
    # memory rule: FSDP when TP-only sharding does not fit HBM
    fsdp = not cost_model.fits_memory(cfg, shape, data=data_axis, pools=pools,
                                      intra=intra, fsdp=False, hw=hw)
    # paper §7: model parallelism across the slow link only when parallel
    # heavy ops of similar size sit on the critical path (width >= 2)
    pod_mode = "mp" if (pods > 1 and pools >= 2 and
                        cfg.moe and cfg.moe.num_experts % (2 * pools) == 0)\
        else "dp"
    # seq_shard (Megatron-SP) stays opt-in: it is a memory lever, not a
    # default (the reference measured its resharding as a loss).
    return Plan(name="guideline", data=data_axis, pools=pools, intra=intra,
                pods=pods, pod_mode=pod_mode, fsdp=fsdp, seq_shard=False,
                notes=f"avg_width={avg_w} max_width={max_w} "
                      f"realizable={realizable}")


def tf_setting(cfg: ModelConfig, shape: ShapeConfig, *, model_axis: int = 16,
               data_axis: int = 16, pods: int = 1) -> Plan:
    """TensorFlow guide analogue: intra-op = all cores, pools = #sockets ->
    pure TP over the model axis, pods as extra data parallelism, no FSDP,
    no sequence sharding."""
    return Plan(name="tf_setting", data=data_axis, pools=1, intra=model_axis,
                pods=pods, pod_mode="dp", fsdp=False, seq_shard=False,
                notes="TF guide: max intra-op, pools=#sockets")


def intel_setting(cfg: ModelConfig, shape: ShapeConfig, *,
                  model_axis: int = 16, data_axis: int = 16,
                  pods: int = 1) -> Plan:
    """Intel guide analogue: threads-per-socket, pools = #sockets -> model
    parallelism across the pod axis when there are 2 'sockets'."""
    return Plan(name="intel_setting", data=data_axis, pools=1,
                intra=model_axis, pods=pods,
                pod_mode=("mp" if pods > 1 else "dp"), fsdp=False,
                seq_shard=False, notes="Intel guide: per-socket intra-op")


def enumerate_plans(cfg: ModelConfig, shape: ShapeConfig, *,
                    model_axis: int = 16, data_axis: int = 16,
                    pods: int = 1) -> List[Plan]:
    """The exhaustive design space (paper: 96^3 points; here the mesh-plan
    cross-product) for the global-optimum comparison."""
    plans = []
    realizable = cfg.moe.num_experts if cfg.moe else 1
    for pools in _divisors(model_axis):
        if pools > 1 and pools > realizable:
            continue
        for fsdp in (False, True):
            for seq_shard in ((False, True) if shape.kind != "decode"
                              else (False,)):
                for pod_mode in (("dp", "mp") if pods > 1 else ("dp",)):
                    plans.append(Plan(
                        name=f"p{pools}_i{model_axis // pools}"
                             f"{'_fsdp' if fsdp else ''}"
                             f"{'_sp' if seq_shard else ''}"
                             f"{'_' + pod_mode if pods > 1 else ''}",
                        data=data_axis, pools=pools,
                        intra=model_axis // pools, pods=pods,
                        pod_mode=pod_mode, fsdp=fsdp, seq_shard=seq_shard))
    return plans
