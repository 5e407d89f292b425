"""Basic layers: RMS norm, group norm, rotary embeddings, token
embeddings, LM head (behind ``grad_fence``), SwiGLU MLP and the token
cross-entropy (counterparts of ``repro/models/layers.py``).

Under a sharded training step (``parallel/sharding.current_layout()``,
set by ``transformer.forward_train`` on a live mesh) each weight is read
through ``sharding.full`` (its FSDP dims gathered) and:

* ``embed`` is vocab-parallel: a rank holds ``V / n`` rows of the table,
  looks up the tokens in its range (zeros elsewhere) and ``tp_out``
  sums the ranks' rows (an all-reduce, or a reduce-scatter onto the
  sequence shards under Megatron-SP);
* ``logits`` is vocab-parallel (``tp_in``, then this rank's columns) and
  ``cross_entropy`` reduces the max, the sum of exponentials and the
  label's logit over the model axis (``_VocabParallelNLL``), then sums
  the masked numerator and the denominator over the ranks that hold
  other tokens: the global masked mean;
* ``mlp`` is column-parallel in ``w_gate``/``w_up`` over ``MLP`` and
  row-parallel in ``w_down`` (``tp_in`` ... ``tp_out``).

A tied table serves both uses, so its gradient is the sum of both."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import (EMBED, MLP, SSM_INNER, VOCAB,
                                        ParamDef)
from repro_torch.parallel import sharding as sh


def rmsnorm_defs(dim: int):
    return {"scale": ParamDef((dim,), (EMBED,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * sh.full(params["scale"]).float()).to(x.dtype)


def groupnorm_defs(dim: int):
    return {"scale": ParamDef((dim,), (SSM_INNER,), init="ones"),
            "bias": ParamDef((dim,), (SSM_INNER,), init="zeros")}


def groupnorm(params, x: torch.Tensor, num_groups: int,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim (RWKV's per-head norm): fp32
    statistics, biased variance."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., S, H, dh]; positions [..., S] (broadcastable).  Angles
    are fp32, with the reference's frequency formula."""
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(1.0 / theta, exps)
    ang = positions[..., :, None].float() * freqs       # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def embedding_defs(cfg: ModelConfig):
    defs = {"table": ParamDef((cfg.vocab_size, cfg.d_model), (VOCAB, EMBED),
                              init="embed", scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                (EMBED, VOCAB))
    return defs


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    table = sh.full(params["table"])
    lay = sh.current_layout()
    entry = None if lay is None else sh.placement(params["table"]).entry(0)
    if entry is None:
        h = F.embedding(tokens, table)
    else:       # vocab-parallel: this rank's rows of the table
        lo = lay.rules.coordinate(entry) * table.shape[0]
        local = tokens.long() - lo
        mine = (local >= 0) & (local < table.shape[0])
        h = F.embedding(torch.where(mine, local, 0), table) \
            * mine[..., None].to(table.dtype)
    if cfg.embed_scale:
        h = h * (cfg.d_model ** 0.5)
    if lay is not None:
        h = sh.tp_out(h, entry, "the embedding table")
    return h


class _GradFence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_fence(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is cast back to x's dtype: the fp32 LM
    head would otherwise push fp32 cotangents into a bf16 residual
    stream."""
    return _GradFence.apply(x)


def logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """LM head; fp32 out whatever the activation dtype."""
    h = grad_fence(h)
    lay = sh.current_layout()
    if lay is not None:
        h = sh.tp_in(h, lay.vocab, "the LM head")
    w = sh.full(params["table"]).t() if cfg.tie_embeddings \
        else sh.full(params["head"])
    out = torch.matmul(h.float(), w.float())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out / c) * c
    return out


def mlp_defs(cfg: ModelConfig):
    d = cfg.d_model
    return {"w_gate": ParamDef((d, cfg.d_ff), (EMBED, MLP)),
            "w_up": ParamDef((d, cfg.d_ff), (EMBED, MLP)),
            "w_down": ParamDef((cfg.d_ff, d), (MLP, EMBED))}


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    entry = None
    if sh.current_layout() is not None:
        entry = sh.placement(params["w_up"]).entry(1)
        x = sh.tp_in(x, entry, "the MLP")
    g = torch.matmul(x, sh.full(params["w_gate"]).to(x.dtype))
    u = torch.matmul(x, sh.full(params["w_up"]).to(x.dtype))
    y = torch.matmul(F.silu(g) * u, sh.full(params["w_down"]).to(x.dtype))
    return sh.tp_out(y, entry, "the MLP")


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``logsumexp - logit[label]`` of logits whose vocab dim is
    split over a process group (this rank's columns start at ``lo``):
    the max and the sum of exponentials all-reduced, the label's logit
    taken from the rank that holds it.  The backward is this rank's
    columns of ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, lf, labels, lo, group):
        mx = sh.all_reduce(lf.amax(dim=-1), group, "max")
        se = sh.all_reduce(torch.exp(lf - mx[..., None]).sum(-1), group)
        lse = torch.log(se) + mx
        local = labels.long() - lo
        mine = (local >= 0) & (local < lf.shape[-1])
        idx = torch.where(mine, local, 0)
        ll = torch.gather(lf, -1, idx[..., None])[..., 0] * mine
        ctx.save_for_backward(lf, lse, idx, mine)
        return lse - sh.all_reduce(ll, group)

    @staticmethod
    def backward(ctx, g):
        lf, lse, idx, mine = ctx.saved_tensors
        p = torch.exp(lf - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -mine[..., None].to(p.dtype))
        return p * g[..., None], None, None, None


def cross_entropy(logits_: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; with ``mask`` the mean over the
    positions it marks (at least one).  Under a sharded step: logits
    split over the vocab (``Layout.vocab``) and the mean over every
    rank's tokens (numerator and denominator summed over
    ``Layout.loss``)."""
    lf = logits_.float()
    lay = sh.current_layout()
    if lay is not None and lay.vocab is not None:
        lo = lay.rules.coordinate(lay.vocab) * lf.shape[-1]
        nll = _VocabParallelNLL.apply(lf, labels, lo,
                                      lay.rules.group(lay.vocab))
    else:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if lay is not None:
        maskf = torch.ones_like(nll) if mask is None else mask.float()
        num = sh.reduce_over((nll * maskf).sum(), lay.loss, lay.rules,
                             lay.grad_scale)
        den = sh.all_reduce(maskf.sum(), lay.rules.group(lay.loss))
        return num / torch.clamp(den, min=1.0)
    if mask is not None:
        maskf = mask.float()
        return (nll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)
    return nll.mean()
