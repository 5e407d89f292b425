"""Mixture-of-Experts FFN: top-k router, capacity-based scatter dispatch
and batched expert products (counterpart of ``repro/models/moe.py``).

The E expert FFNs of one layer are the paper's canonical case of
inter-operator parallelism.  Dispatch follows the reference step for
step, so tokens, drops and slots are the same:

* tokens are processed in G groups of g (``_num_groups``), each expert
  taking at most ``_capacity(g)`` assignments per group;
* an assignment's place in its expert's queue is its rank in the
  token-major ``[g*k]`` order (the cumsum-of-one-hot trick), overflow
  is dropped and its value zeroed;
* the three batched expert products go through the grouped-matmul op
  (``kernels/moe_gmm``: the Hopper kernel on the card), told how many
  rows of each (group, expert) are live.

Everything stays on the device: no host sync, no data-dependent shape.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.module import EMBED, EXPERT, MLP, ParamDef

GROUP_TOKENS = 4096  # target tokens per dispatch group


def moe_defs(cfg: ModelConfig) -> Dict:
    e = cfg.moe.num_experts
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "router": ParamDef((d, e), (EMBED, EXPERT), dtype=torch.float32),
        "w_gate": ParamDef((e, d, ff), (EXPERT, EMBED, MLP)),
        "w_up": ParamDef((e, d, ff), (EXPERT, EMBED, MLP)),
        "w_down": ParamDef((e, ff, d), (EXPERT, MLP, EMBED)),
    }


def _num_groups(total_tokens: int) -> int:
    g = max(1, total_tokens // GROUP_TOKENS)
    while total_tokens % g:
        g -= 1
    return g


def _capacity(g: int, moe: MoEConfig) -> int:
    cap = int(g * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(1, min(g, cap))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params, x2d: torch.Tensor, moe: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """x2d [T,d] -> (top-k probs [T,k], expert ids [T,k] int64, aux)."""
    logits = torch.matmul(x2d.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, moe.top_k, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = _one_hot(top_e[:, 0], moe.num_experts, torch.float32).mean(dim=0)
    aux = {"load_balance_loss": moe.num_experts * torch.sum(me * ce),
           "router_entropy": -torch.mean(
               torch.sum(probs * torch.log(probs + 1e-9), -1))}
    return top_p, top_e, aux


def _dispatch_indices(top_e: torch.Tensor, e: int, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per group: top_e [..., g, k] -> (slot [..., g, k] in [0, e*cap),
    keep [..., g, k]).  Leading dimensions are groups.

    Position of each assignment inside its expert's queue via the
    cumsum-of-one-hot rank trick; overflow beyond ``cap`` is dropped."""
    *lead, g, k = top_e.shape
    flat = top_e.reshape(*lead, g * k)
    oh = _one_hot(flat, e, torch.int32)                   # [..., g*k, e]
    ranks = torch.cumsum(oh, dim=-2) - oh                 # rank within expert
    pos = torch.gather(ranks, -1, flat[..., None])[..., 0]
    keep = pos < cap
    slot = flat * cap + torch.clamp(pos, max=cap - 1)
    return slot.reshape(*lead, g, k), keep.reshape(*lead, g, k)


def _dispatch(params, x: torch.Tensor, moe: MoEConfig):
    """Route and scatter: x [B,S,d] -> (buffer [G,e,cap,d], live rows per
    (group, expert) [G,e] int32, slot [G,g,k], keep [G,g,k], top-k
    probs [G,g,k] in x's dtype, aux)."""
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    ngroups = _num_groups(t)
    g = t // ngroups
    cap = _capacity(g, moe)

    x2d = x.reshape(t, d)
    top_p, top_e, aux = route(params, x2d, moe)
    xg = x2d.reshape(ngroups, g, d)
    pg = top_p.reshape(ngroups, g, k).to(x.dtype)
    eg = top_e.reshape(ngroups, g, k)
    slot, keep = _dispatch_indices(eg, e, cap)

    # each slot receives at most one nonzero value (a dropped assignment
    # adds 0 to the last row), so the sum is exact in any order
    vals = xg[:, :, None, :].expand(ngroups, g, k, d).reshape(
        ngroups, g * k, d)                                 # repeat, no sync
    vals = vals * keep.reshape(ngroups, g * k, 1).to(x.dtype)
    base = torch.arange(ngroups, device=x.device)[:, None] * (e * cap)
    buf = torch.zeros(ngroups * e * cap, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, (slot.reshape(ngroups, g * k) + base).reshape(-1),
                   vals.reshape(-1, d))
    counts = (_one_hot(eg, e, torch.int32)
              * keep[..., None].to(torch.int32)).sum(dim=(1, 2),
                                                     dtype=torch.int32)
    return buf.reshape(ngroups, e, cap, d), counts, slot, keep, pg, aux


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             pg: torch.Tensor, shape) -> torch.Tensor:
    """Gather each kept assignment's expert output and sum the k of a
    token, weighted by its router probability: -> y of ``shape``."""
    ngroups, g, k = slot.shape
    d = out_buf.shape[-1]
    rows = torch.gather(out_buf.reshape(ngroups, -1, d), 1,
                        slot.reshape(ngroups, g * k, 1).expand(-1, -1, d))
    wts = (pg * keep.to(pg.dtype)).reshape(ngroups, g * k, 1)
    return (rows * wts).reshape(ngroups, g, k, d).sum(dim=2).reshape(shape)


def _act(act: str):
    return F.silu if act == "silu" else F.gelu


def apply(params, x: torch.Tensor, cfg: ModelConfig, act: str = "silu",
          ) -> Tuple[torch.Tensor, Dict]:
    """x [B,S,d] -> (y [B,S,d], aux)."""
    buf, counts, slot, keep, pg, aux = _dispatch(params, x, cfg.moe)
    dt = x.dtype
    hg = gmm_ops.moe_gmm(buf, params["w_gate"].to(dt), counts)
    hu = gmm_ops.moe_gmm(buf, params["w_up"].to(dt), counts)
    hidden = _act(act)(hg) * hu
    out_buf = gmm_ops.moe_gmm(hidden, params["w_down"].to(dt), counts)
    y = _combine(out_buf, slot, keep, pg, x.shape)
    aux["dropped_fraction"] = 1.0 - keep.float().mean()
    return y, aux


# ---------------------------------------------------------------------------
# Scheduling-mechanism study (paper §4): the same expert computation under
# explicitly *synchronous* scheduling — experts executed one at a time.
# ---------------------------------------------------------------------------

def apply_sync_schedule(params, x: torch.Tensor, cfg: ModelConfig,
                        act: str = "silu") -> Tuple[torch.Tensor, Dict]:
    """Numerically equivalent to ``apply`` (same dispatch, same FLOPs), but
    run as a sequential Python loop over experts, one heavy product at a
    time: the paper's synchronous scheduling baseline.  Its per-expert
    products are plain matrix products, as in the reference."""
    buf, _counts, slot, keep, pg, aux = _dispatch(params, x, cfg.moe)
    actf = _act(act)
    dt = x.dtype
    outs = []
    for ei in range(cfg.moe.num_experts):     # static loop: sync schedule
        be = buf[:, ei]
        h = actf(torch.matmul(be, params["w_gate"][ei].to(dt))) * \
            torch.matmul(be, params["w_up"][ei].to(dt))
        outs.append(torch.matmul(h, params["w_down"][ei].to(dt)))
    out_buf = torch.stack(outs, dim=1)
    return _combine(out_buf, slot, keep, pg, x.shape), aux


__all__ = ["GROUP_TOKENS", "moe_defs", "route", "apply",
           "apply_sync_schedule"]
