"""Mamba2 (SSD) mixer of the zamba2 backbone (counterpart of
``repro/models/mamba2.py``).

A full prefill runs the chunked SSD scan (``ssd_chunked``): on CUDA
tensors that is one launch of ``kernels/mamba2_scan`` in the model's
layout, on the CPU the reference's chunked algorithm in plain torch ops
(intra-chunk products, then the inter-chunk state recurrence, here a
loop over chunks where the reference runs an associative scan).  Decode
is the O(1) recurrent update in plain torch ops, as in the reference.

State layout per layer:
  conv:  [B, W-1, d_inner + 2N]   (the last conv_width-1 inputs)
  ssm:   [B, H, N, P]             (per-head state matrix)

``apply`` returns new state tensors; the serving cache stores them in
place of the old ones (``serve/cache`` splices a prefill's state into a
slot row in place).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan import ops as scan_ops
from repro_torch.models.layers import rmsnorm, rmsnorm_defs
from repro_torch.models.module import EMBED, HEADS, SSM_INNER, ParamDef


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, state dim N, head dim P)."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    return d_inner, d_inner // ssm.head_dim, ssm.state_dim, ssm.head_dim


def _a_log_init(gen: torch.Generator, shape, device) -> torch.Tensor:
    """log(uniform(1, 16)), the reference's A init."""
    u = torch.rand(shape, generator=gen, device=device)
    return torch.log(1.0 + 15.0 * u)


def mamba2_defs(cfg: ModelConfig) -> Dict:
    """The reference's keys and layouts (projections split z / x / BC /
    dt), so the weight bridge carries them over as they are."""
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, n, _p = dims(cfg)
    return {
        "wz": ParamDef((d, d_inner), (EMBED, SSM_INNER)),
        "wx": ParamDef((d, d_inner), (EMBED, SSM_INNER)),
        "wbc": ParamDef((d, 2 * n), (EMBED, None)),
        "wdt": ParamDef((d, nheads), (EMBED, HEADS)),
        "conv_w": ParamDef((ssm.conv_width, d_inner), (None, SSM_INNER),
                           init="normal", scale=0.5),
        "conv_b": ParamDef((d_inner,), (SSM_INNER,), init="zeros"),
        "conv_w_bc": ParamDef((ssm.conv_width, 2 * n), (None, None),
                              init="normal", scale=0.5),
        "conv_b_bc": ParamDef((2 * n,), (None,), init="zeros"),
        "a_log": ParamDef((nheads,), (HEADS,), init="custom",
                          custom=_a_log_init),
        "dt_bias": ParamDef((nheads,), (HEADS,), init="zeros"),
        "d_skip": ParamDef((nheads,), (HEADS,), init="ones"),
        "norm": rmsnorm_defs(d_inner),
        "out_proj": ParamDef((d_inner, d), (SSM_INNER, EMBED)),
    }


def _conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
          conv_state: Optional[torch.Tensor], width: int,
          length: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv of ``width`` taps as shifted adds.

    x [B,S,C] -> (silu(y) [B,S,C], new_state [B,W-1,C]).  With ``length``
    [B] (right-padded prefill) the carried state is the last ``W-1``
    inputs before the padding: token t sits at ``full[:, W-1+t]``, so the
    state is ``full[:, length : length+W-1]`` (length 0 gives back the
    initial state)."""
    bsz, s, c = x.shape
    if conv_state is None:
        conv_state = x.new_zeros((bsz, width - 1, c))
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = b.to(x.dtype)[None, None].expand(bsz, s, c)
    for i in range(width):
        y = y + full[:, i:i + s] * w[i].to(x.dtype)
    if length is None:
        new_state = full[:, full.shape[1] - (width - 1):]
    else:
        idx = (length.long()[:, None]
               + torch.arange(width - 1, device=x.device)[None, :])
        new_state = torch.gather(full, 1, idx[..., None].expand(-1, -1, c))
    return F.silu(y), new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: x [B,S,H,P], dt [B,S,H] (softplus'd, > 0), a_log
    [H], b_in/c_in [B,S,N] (shared by the heads), h0 [B,H,N,P] or None ->
    (y [B,S,H,P] in x's dtype, final state [B,H,N,P] fp32).

    CUDA tensors: one ``mamba2_scan`` launch (the kernel needs no chunk
    size), differentiable through its backward kernel.  CPU tensors: the reference's chunked algorithm, chunk ``q`` =
    the largest power-of-two divisor of S not above ``chunk``."""
    if x.device.type != "cpu":
        y, h_final = scan_ops.scan_model_layout(x, dt, b_in, c_in, a_log,
                                                h0)
        return y.to(x.dtype), h_final
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))                              # [H]
    da = dt.to(f32) * a                                        # [B,S,H]
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    dac = da.reshape(bsz, nc, q, h)
    bc = b_in.reshape(bsz, nc, q, n).to(f32)
    cc = c_in.reshape(bsz, nc, q, n).to(f32)

    cum = torch.cumsum(dac, dim=2)                             # inclusive
    cum_end = cum[:, :, -1]                                    # [B,nc,H]
    xdt = xc.to(f32) * dtc[..., None]                          # [B,nc,Q,H,P]

    # intra-chunk: y[t] += sum_{j<=t} exp(cum_t - cum_j) (c_t.b_j) dt_j x_j
    lmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,Q,Q,H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    decay = torch.where(mask, torch.exp(torch.where(mask, lmat, -60.0)),
                        0.0)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)           # [B,nc,Q,Q]
    mt = scores[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", mt, xdt)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) dt_j b_j x_j^T
    kdec = torch.exp(cum_end[:, :, None] - cum)                # [B,nc,Q,H]
    chunk_kv = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, kdec, xdt)

    # inter-chunk recurrence: the state before each chunk
    aa = torch.exp(cum_end)                                    # [B,nc,H]
    hs = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
          if h0 is None else h0.to(f32))
    before = []
    for ci in range(nc):
        before.append(hs)
        hs = hs * aa[:, ci, :, None, None] + chunk_kv[:, ci]
    h_before = torch.stack(before, dim=1)                      # [B,nc,H,N,P]

    # inter-chunk contribution: y[t] += exp(cum_t) * c_t . h_before
    y_inter = torch.einsum("bcin,bchnp->bcihp", cc, h_before) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), hs


def apply(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "dense",
          state: Optional[Dict] = None,
          length: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B,S,d] -> (y [B,S,d], new_state or None).

    ``mode``: "dense" (no state out), "prefill" (state out; ``length``
    [B] marks the true lengths of right-padded inputs: padded steps get
    dt = 0, so they decay by exp(0) = 1 and add nothing, and the carried
    state is the state at ``length - 1``) or "decode" (S = 1, from
    ``state``)."""
    if mode not in ("dense", "prefill", "decode"):
        raise ValueError(f"unknown mamba2 mode {mode!r}")
    ssm = cfg.ssm
    d_inner, nheads, n, p = dims(cfg)
    bsz, s, d = x.shape
    x2 = x.reshape(bsz * s, d)
    z = torch.matmul(x2, params["wz"].to(x.dtype)).view(bsz, s, d_inner)
    xs_raw = torch.matmul(x2, params["wx"].to(x.dtype)).view(bsz, s,
                                                             d_inner)
    bc_raw = torch.matmul(x2, params["wbc"].to(x.dtype)).view(bsz, s, 2 * n)
    dt_raw = torch.matmul(x2, params["wdt"].to(x.dtype)).view(bsz, s,
                                                              nheads)

    cs = state["conv"] if state is not None else None
    xs, new_conv_x = _conv(params["conv_w"], params["conv_b"], xs_raw,
                           None if cs is None else cs[..., :d_inner],
                           ssm.conv_width, length)
    bc, new_conv_bc = _conv(params["conv_w_bc"], params["conv_b_bc"],
                            bc_raw, None if cs is None else cs[..., d_inner:],
                            ssm.conv_width, length)
    new_conv = torch.cat([new_conv_x, new_conv_bc], dim=-1)
    b_in, c_in = bc[..., :n], bc[..., n:]

    xh = xs.reshape(bsz, s, nheads, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    if length is not None:
        smask = torch.arange(s, device=x.device)[None, :] \
            < length[:, None]                                  # [B,S]
        dt = dt * smask[..., None].to(dt.dtype)

    new_state = None
    if mode == "decode":
        if state is None:
            raise ValueError("mamba2 decode needs a state")
        f32 = torch.float32
        a = -torch.exp(params["a_log"].float())
        da = torch.exp(dt[:, 0] * a)                               # [B,H]
        bx = torch.einsum("bn,bh,bhp->bhnp", b_in[:, 0].float(), dt[:, 0],
                          xh[:, 0].float())
        h_new = state["ssm"].to(f32) * da[..., None, None] + bx
        y = torch.einsum("bn,bhnp->bhp", c_in[:, 0].float(), h_new)[:, None]
        new_state = {"conv": new_conv, "ssm": h_new}
    else:
        h0 = state["ssm"] if state is not None else None
        y, h_final = ssd_chunked(xh, dt, params["a_log"], b_in, c_in,
                                 ssm.chunk, h0)
        if mode == "prefill":
            new_state = {"conv": new_conv, "ssm": h_final}
    y = y.to(x.dtype) + xh * params["d_skip"].to(x.dtype)[None, None, :,
                                                          None]
    y2 = rmsnorm(params["norm"], y.reshape(bsz, s, d_inner), cfg.norm_eps) \
        * F.silu(z)
    out = torch.matmul(y2.reshape(bsz * s, d_inner),
                       params["out_proj"].to(x.dtype)).view(bsz, s, d)
    return out, new_state


def state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    """{name: shape} of one layer's recurrent state at ``batch`` rows."""
    d_inner, nheads, n, p = dims(cfg)
    return {"conv": (batch, cfg.ssm.conv_width - 1, d_inner + 2 * n),
            "ssm": (batch, nheads, n, p)}
