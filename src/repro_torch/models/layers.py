"""Basic layers: RMS norm, group norm, rotary embeddings, token
embeddings, LM head (behind ``grad_fence``), SwiGLU MLP and the token
cross-entropy (counterparts of ``repro/models/layers.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamDef


def rmsnorm_defs(dim: int):
    return {"scale": ParamDef((dim,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def groupnorm_defs(dim: int):
    return {"scale": ParamDef((dim,), init="ones"),
            "bias": ParamDef((dim,), init="zeros")}


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
    defs = {"table": ParamDef((cfg.vocab_size, cfg.d_model), init="embed",
                              scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size))
    return defs


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = F.embedding(tokens, params["table"])
    if cfg.embed_scale:
        h = h * (cfg.d_model ** 0.5)
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
    w = params["table"].t() if cfg.tie_embeddings else params["head"]
    out = torch.matmul(h.float(), w.float())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out / c) * c
    return out


def mlp_defs(cfg: ModelConfig):
    d = cfg.d_model
    return {"w_gate": ParamDef((d, cfg.d_ff)),
            "w_up": ParamDef((d, cfg.d_ff)),
            "w_down": ParamDef((cfg.d_ff, d))}


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    g = torch.matmul(x, params["w_gate"].to(x.dtype))
    u = torch.matmul(x, params["w_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, params["w_down"].to(x.dtype))


def cross_entropy(logits_: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; with ``mask`` the mean over the
    positions it marks (at least one)."""
    lf = logits_.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        maskf = mask.float()
        return (nll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)
    return nll.mean()
