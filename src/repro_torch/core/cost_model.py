"""Analytic cost model: parameter counts, MODEL_FLOPS, and a three-term
(compute / HBM / interconnect) step-time estimator (counterpart of
``repro/core/cost_model.py``, the same formulas).

``core.autotune`` ranks candidate mesh plans with it: the "global optimum
by exhaustive search" of paper Fig. 18, at mesh-plan granularity.  All
estimates are per device.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs.base import (ATTN, FFN_MOE, SHARED_ATTN,
                                      ModelConfig, ShapeConfig)


# ---------------------------------------------------------------------------
# Hardware model: the card the port runs on
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-device rates and capacity.  The defaults are data-sheet
    figures (not measurements) of an NVIDIA H100 SXM5 80GB HBM3 at its
    700 W limit, one GPU of a DGX H100."""

    name: str = "h100-sxm5-80gb"
    peak_flops: float = 989e12        # dense bf16 tensor FLOP/s per GPU
    hbm_bw: float = 3.35e12           # HBM3 bytes/s per GPU
    ici_bw: float = 450e9             # NVLink 4 bytes/s, one direction
    dcn_bw: float = 50e9              # one 400 Gb/s NDR NIC per GPU
    hbm_bytes: float = 80e9           # capacity per GPU


H100 = Hardware()


# ---------------------------------------------------------------------------
# Parameter counts (exact: derived from the ParamDef tables)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def model_param_count(cfg: ModelConfig) -> int:
    """Exact, from the ``ParamDef`` tables; cached per config (frozen,
    so hashable): the sweeps ask for the same config hundreds of times."""
    from repro_torch.models import module as m
    from repro_torch.models.transformer import model_defs
    return m.param_count(model_defs(cfg))


def _moe_param_count(cfg: ModelConfig) -> int:
    if cfg.moe is None:
        return 0
    n_moe_layers = sum(1 for b in cfg.blocks if b.ffn == FFN_MOE)
    return n_moe_layers * cfg.moe.num_experts * 3 * cfg.d_model * cfg.d_ff


def _embed_param_count(cfg: ModelConfig) -> int:
    n = cfg.vocab_size * cfg.d_model
    return n if cfg.tie_embeddings else 2 * n


def model_active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: MoE experts scaled by top_k/E."""
    total = model_param_count(cfg)
    moe = _moe_param_count(cfg)
    active_moe = moe * (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 0
    return int(total - moe + active_moe)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step, global: 6*N_active*D for training, 2*N_active*D
    for inference (D = tokens processed this step)."""
    n_active = model_active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global attention-score/PV flops on top of the 6ND matmul count."""
    dh = cfg.resolved_head_dim
    total = 0.0
    for b in cfg.blocks:
        if b.mixer not in (ATTN, SHARED_ATTN):
            continue
        if shape.kind == "decode":
            kv = min(shape.seq_len, b.window or shape.seq_len)
            per_seq = 2 * 2 * cfg.num_heads * dh * kv
            total += per_seq * shape.global_batch
        else:
            s = shape.seq_len
            w = b.window or s
            # causal: sum over positions of min(pos, w)
            visible = (s * w - w * (w - 1) / 2) if w < s else s * (s + 1) / 2
            per_seq = 2 * 2 * cfg.num_heads * dh * visible
            mult = 3.0 if shape.kind == "train" else 1.0  # bwd re-does qk/pv
            total += per_seq * shape.global_batch * mult
    return total


# ---------------------------------------------------------------------------
# Per-plan step-time estimate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CostBreakdown:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_s(self) -> float:
        # compute and HBM overlap poorly on the dominant op class; take max
        # with collectives partially overlapped (conservative: no overlap).
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


def estimate(cfg: ModelConfig, shape: ShapeConfig, *, data: int, pools: int,
             intra: int, fsdp: bool, hw: Hardware = H100,
             pod_axis_dp: bool = True, pods: int = 1,
             dtype_bytes: int = 2, seq_shard: bool = True) -> CostBreakdown:
    """Analytic three-term estimate for a (data, pools, intra) mesh plan.

    ``pools`` = expert/branch parallel degree, ``intra`` = tensor-parallel
    degree (pools * intra = model-axis size), mirroring the paper's
    inter-op-pools / intra-op-threads split.
    """
    chips = data * pools * intra * pods
    n_params = model_param_count(cfg)
    n_active = model_active_param_count(cfg)
    flops_global = model_flops(cfg, shape) + attention_flops(cfg, shape)

    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    train = shape.kind == "train"

    # ---- compute: assume near-even split when the plan's parallel degrees
    # match the graph's parallelism; penalize expert imbalance when pools
    # exceed usable width.
    e = cfg.moe.num_experts if cfg.moe else 1
    eff_pools = min(pools, e)
    imbalance = pools / eff_pools
    compute = flops_global / chips * imbalance / hw.peak_flops

    # ---- memory: weights read once per step (per device share) + act traffic
    weight_bytes = n_params * dtype_bytes / (pools * intra) / (data if fsdp else 1)
    if shape.kind == "decode":
        # decode is weight-bound: every active weight is read per token-step
        weight_read = n_active * dtype_bytes / (pools * intra)
    else:
        weight_read = weight_bytes
    act_bytes = tokens / max(data * pods, 1) * cfg.d_model * dtype_bytes
    act_traffic = act_bytes * (12 if train else 4) * cfg.num_layers / max(intra, 1)
    memory = (weight_read + act_traffic) / hw.hbm_bw

    # ---- collectives
    coll_bytes = 0.0
    b_loc = tokens / max(data * pods, 1)
    # TP per layer: with sequence sharding the all-reduce becomes
    # all-gather + reduce-scatter (same ring bytes); without SP the *input*
    # of each sharded matmul is replicated but the output partial-sum
    # all-reduce still moves 2(n-1)/n of the act.
    n_moe = sum(1 for bl in cfg.blocks if bl.ffn == FFN_MOE)
    n_dense_ffn = cfg.num_layers - n_moe
    if intra > 1:
        per_layer = 2 * b_loc * cfg.d_model * dtype_bytes
        coll_bytes += ((n_dense_ffn + cfg.num_layers) * per_layer
                       * (intra - 1) / intra * (3 if train else 1))
    if cfg.moe and n_moe:
        k = cfg.moe.top_k
        capf = cfg.moe.capacity_factor
        if pools > 1:
            # EP all-to-all: dispatch + combine move top_k*d per token
            tok_dev = b_loc / (pools * intra if seq_shard else 1)
            per = 2 * tok_dev * k * cfg.d_model * dtype_bytes \
                * (pools - 1) / pools
        else:
            # pure TP replicates the [*, E, cap, d] dispatch buffer over the
            # model axis: all-gather on the way in, partial-sum all-reduce of
            # the combine buffer on the way out — 3x the EP payload.
            per = 3 * b_loc * k * capf * cfg.d_model * dtype_bytes \
                * (intra - 1) / intra
        coll_bytes += n_moe * per * (3 if train else 1)
    # FSDP all-gather (+reduce-scatter in training)
    if fsdp:
        coll_bytes += (n_params * dtype_bytes / (pools * intra)
                       * (data - 1) / data * (3 if train else 1))
    # gradient all-reduce over data axis
    if train:
        coll_bytes += (2 * n_params * dtype_bytes / (pools * intra)
                       * (data - 1) / data) if not fsdp else 0.0
    collective = coll_bytes / hw.ici_bw
    # pod axis (DCN or slower ICI): gradient sync for DP, activations for MP
    if pods > 1:
        if train and pod_axis_dp:
            collective += (2 * n_params * dtype_bytes / (pools * intra * data)
                           / hw.dcn_bw)
        elif not pod_axis_dp:
            collective += (cfg.num_layers * 2 * b_loc * cfg.d_model
                           * dtype_bytes / hw.dcn_bw)
    return CostBreakdown(compute, memory, collective)


def fits_memory(cfg: ModelConfig, shape: ShapeConfig, *, data: int,
                pools: int, intra: int, fsdp: bool, hw: Hardware = H100,
                train_state_bytes: int = 12) -> bool:
    """Coarse per-chip HBM feasibility check for the autotuner."""
    n_params = model_param_count(cfg)
    shard = (pools * intra) * (data if fsdp else 1)
    per_chip = n_params * 2 / shard
    if shape.kind == "train":
        per_chip += n_params * train_state_bytes / (pools * intra * data)
        tokens_loc = shape.global_batch * shape.seq_len / data
        per_chip += tokens_loc * cfg.d_model * 2 * cfg.num_layers / intra * 0.1
    elif shape.kind == "decode":
        kv = sum(min(shape.seq_len, b.window or shape.seq_len)
                 for b in cfg.blocks if b.mixer in (ATTN, SHARED_ATTN))
        per_chip += (shape.global_batch / data * kv * cfg.num_kv_heads
                     * cfg.resolved_head_dim * 2 * 2 / max(intra, 1))
    return per_chip < hw.hbm_bytes * 0.9
