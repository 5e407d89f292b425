"""RWKV6 (Finch) blocks: time-mix with data-dependent decay + channel-mix
(counterpart of ``repro/models/rwkv6.py``).

The wkv6 recurrence per head (K = V = head_dim):

    y_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t          (w_t in (0,1), per channel)

A full prefill runs ``wkv_chunked``: on CUDA tensors that is one launch
of ``kernels/rwkv6_wkv`` in the model's layout (the per-step recurrence
in fp32), on the CPU the reference's chunked algorithm in plain torch
ops (chunk ``CHUNK_Q``: intra-chunk contributions through a factored
decay product, bounded by the ``LOG_W_MIN`` clamp, then the inter-chunk
state recurrence, here a loop over chunks where the reference runs an
associative scan).  Decode is the O(1) recurrent update in plain torch
ops, as in the reference.

State per layer: {"tshift": [B,1,d], "wkv": [B,H,K,V], "cshift": [B,1,d]}.
``time_mix`` and ``channel_mix`` return new state tensors; the serving
cache stores them in place of the old ones.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.layers import groupnorm, groupnorm_defs
from repro_torch.models.module import EMBED, MLP, SSM_INNER, ParamDef

LOG_W_MIN = -5.0   # fla-style clamp on per-step log decay
CHUNK_Q = 16       # every factored exponent <= |LOG_W_MIN| * CHUNK_Q < 88

MIX_NAMES = ("w", "k", "v", "r", "g")


def hdims(cfg: ModelConfig) -> Tuple[int, int]:
    """(wkv heads, head dim K)."""
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def _w0_init(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uniform(0.5, 3.0), the reference's w0 init."""
    return 0.5 + 2.5 * torch.rand(shape, generator=gen, device=device)


def time_mix_defs(cfg: ModelConfig) -> Dict:
    """The reference's keys and layouts, so the weight bridge carries
    them over as they are."""
    d = cfg.d_model
    r = cfg.rwkv
    nm = len(MIX_NAMES)
    return {
        "mu_inner": ParamDef((d,), (EMBED,), init="zeros"),
        "mu": ParamDef((nm, d), (None, EMBED), init="zeros"),
        "mix_a": ParamDef((nm, d, r.mix_lora), (None, EMBED, None)),
        "mix_b": ParamDef((nm, r.mix_lora, d), (None, None, EMBED),
                          init="zeros"),
        "wr": ParamDef((d, d), (EMBED, SSM_INNER)),
        "wk": ParamDef((d, d), (EMBED, SSM_INNER)),
        "wv": ParamDef((d, d), (EMBED, SSM_INNER)),
        "wg": ParamDef((d, d), (EMBED, SSM_INNER)),
        "wo": ParamDef((d, d), (SSM_INNER, EMBED)),
        "w0": ParamDef((d,), (SSM_INNER,), init="custom", custom=_w0_init),
        "decay_a": ParamDef((d, r.decay_lora), (EMBED, None)),
        "decay_b": ParamDef((r.decay_lora, d), (None, SSM_INNER),
                            init="zeros"),
        "bonus_u": ParamDef((d,), (SSM_INNER,), init="normal", scale=0.3),
        "ln_x": groupnorm_defs(d),
    }


def channel_mix_defs(cfg: ModelConfig) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDef((d,), (EMBED,), init="zeros"),
        "mu_r": ParamDef((d,), (EMBED,), init="zeros"),
        "wk": ParamDef((d, ff), (EMBED, MLP)),
        "wv": ParamDef((ff, d), (MLP, EMBED)),
        "wr": ParamDef((d, d), (EMBED, EMBED)),
    }


def _token_shift(x: torch.Tensor,
                 shift_state: Optional[torch.Tensor]) -> torch.Tensor:
    """Previous token's x (zeros / carried state at position 0)."""
    b, s, d = x.shape
    if s == 1:
        return shift_state if shift_state is not None \
            else torch.zeros_like(x)
    first = shift_state.to(x.dtype) if shift_state is not None \
        else x.new_zeros((b, 1, d))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(params, x: torch.Tensor, xx: torch.Tensor,
            name_idx: int) -> torch.Tensor:
    """Finch data-dependent lerp for stream ``name_idx``."""
    inner = x + xx * params["mu_inner"].to(x.dtype)
    lora = torch.matmul(
        torch.tanh(torch.matmul(inner,
                                params["mix_a"][name_idx].to(x.dtype))),
        params["mix_b"][name_idx].to(x.dtype))
    return x + xx * (params["mu"][name_idx].to(x.dtype) + lora)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lw: torch.Tensor, u: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked wkv6: r, k, v [B,S,H,K]; lw [B,S,H,K] log decays (<= 0,
    clamped); u [H,K]; h0 [B,H,K,V] or None -> (y [B,S,H,K] in r's
    dtype, final state [B,H,K,V] fp32).

    CUDA tensors: one ``rwkv6_wkv`` launch (the kernel needs no chunk
    size), differentiable through its backward kernel.  CPU tensors: the reference's chunked algorithm, chunk ``q``
    = the largest power-of-two divisor of S not above ``CHUNK_Q``."""
    if r.device.type != "cpu":
        # the kernels take fp32 (a no-op on fp32 operands, strides kept)
        y, h_final = wkv_ops.wkv_model_layout(r.float(), k.float(),
                                              v.float(), lw.float(), u, h0)
        return y.to(r.dtype), h_final
    b, s, h, kk = r.shape
    f32 = torch.float32
    q = min(CHUNK_Q, s)
    while s % q:
        q //= 2
    nc = s // q
    rc = r.to(f32).reshape(b, nc, q, h, kk)
    kc = k.to(f32).reshape(b, nc, q, h, kk)
    vc = v.to(f32).reshape(b, nc, q, h, kk)
    lwc = lw.to(f32).reshape(b, nc, q, h, kk)

    cw = torch.cumsum(lwc, dim=2)                      # inclusive
    cwx = cw - lwc                                     # exclusive
    cw_end = cw[:, :, -1]                              # [B,nc,H,K]

    # intra-chunk: A[t,j] = sum_K r_t exp(cwx_t - cw_j) k_j   (j <= t-1)
    r_tilde = rc * torch.exp(cwx)                      # exponents <= 0
    k_tilde = kc * torch.exp(-cw)                      # <= exp(|LOG_W_MIN|*Q)
    amat = torch.einsum("bcihk,bcjhk->bchij", r_tilde, k_tilde)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device),
                      diagonal=-1)                     # strictly lower
    amat = torch.where(mask, amat, 0.0)
    y_intra = torch.einsum("bchij,bcjhv->bcihv", amat, vc)
    # diagonal bonus term: (r_t . (u * k_t)) v_t
    diag = torch.einsum("bcihk,bcihk->bcih", rc, kc * u.to(f32))
    y_intra = y_intra + diag[..., None] * vc

    # chunk kv: sum_j exp(cw_end - cw_j) k_j (x) v_j
    kdec = kc * torch.exp(cw_end[:, :, None] - cw)
    chunk_kv = torch.einsum("bcjhk,bcjhv->bchkv", kdec, vc)

    # inter-chunk recurrence: the state before each chunk
    aa = torch.exp(cw_end)                             # [B,nc,H,K]
    hs = (torch.zeros((b, h, kk, kk), dtype=f32, device=r.device)
          if h0 is None else h0.to(f32))
    before = []
    for ci in range(nc):
        before.append(hs)
        hs = hs * aa[:, ci, :, :, None] + chunk_kv[:, ci]
    h_before = torch.stack(before, dim=1)              # [B,nc,H,K,V]

    y_inter = torch.einsum("bcihk,bchkv->bcihv", r_tilde, h_before)
    y = (y_intra + y_inter).reshape(b, s, h, kk)
    return y.to(r.dtype), hs


def _state_at(x: torch.Tensor,
              length: Optional[torch.Tensor]) -> torch.Tensor:
    """Token-shift carry: x at the last *valid* position (right-padded
    prefill), zeros for empty prompts."""
    if length is None:
        return x[:, -1:]
    b, _s, d = x.shape
    idx = torch.clamp(length.long() - 1, min=0)[:, None, None]
    picked = torch.gather(x, 1, idx.expand(b, 1, d))
    return torch.where((length > 0)[:, None, None], picked,
                       torch.zeros_like(picked))


def time_mix(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
             state: Optional[Dict] = None,
             length: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B,S,d] -> (y, new partial state {"tshift","wkv"} or None).

    ``mode``: "dense" (no state out), "prefill" (state out) or "decode"
    (S = 1, from ``state``).  ``length`` [B] (prefill only): right-padded
    true lengths.  Padded steps get k == 0 and log-decay 0 (w == 1), so
    the wkv state passes through them unchanged and the carried state is
    exact as of ``length - 1``."""
    if mode not in ("dense", "prefill", "decode"):
        raise ValueError(f"unknown rwkv6 mode {mode!r}")
    # heads from the weights, so a shard of the inner dim (the dry-run's
    # per-device view, ``launch/build``) runs as the whole does
    hd = cfg.rwkv.head_dim
    nh = params["wr"].shape[1] // hd
    b, s, d = x.shape
    dt = x.dtype
    prev = _token_shift(x, state["tshift"] if state is not None else None)
    xx = prev - x
    xw, xk, xv, xr, xg = (_ddlerp(params, x, xx, i)
                          for i in range(len(MIX_NAMES)))

    r = torch.matmul(xr, params["wr"].to(dt))
    k = torch.matmul(xk, params["wk"].to(dt))
    v = torch.matmul(xv, params["wv"].to(dt))
    g = torch.matmul(xg, params["wg"].to(dt))

    # data-dependent decay (log space, clamped)
    dlora = torch.matmul(
        torch.tanh(torch.matmul(xw, params["decay_a"].to(dt))),
        params["decay_b"].to(dt))
    lw = -torch.exp(torch.clamp(params["w0"].float() + dlora.float(),
                                -8.0, 2.0))
    lw = torch.clamp(lw, LOG_W_MIN, 0.0)               # [B,S,d]

    rh = r.reshape(b, s, nh, hd)
    kh = k.reshape(b, s, nh, hd)
    vh = v.reshape(b, s, nh, hd)
    lwh = lw.reshape(b, s, nh, hd)
    if length is not None:
        smask = (torch.arange(s, device=x.device)[None, :]
                 < length[:, None])[..., None, None]
        kh = kh * smask.to(kh.dtype)
        lwh = lwh * smask.to(lwh.dtype)
    uh = params["bonus_u"].float().reshape(nh, hd)

    new_state = None
    if mode == "decode":
        if state is None:
            raise ValueError("rwkv6 decode needs a state")
        h_prev = state["wkv"].float()                  # [B,H,K,V]
        r1, k1, v1 = (z[:, 0].float() for z in (rh, kh, vh))
        w1 = torch.exp(lwh[:, 0])
        kv = k1[..., :, None] * v1[..., None, :]       # [B,H,K,V]
        y = torch.einsum("bhk,bhkv->bhv", r1, h_prev + uh[None, :, :, None]
                         * kv)
        h_new = w1[..., None] * h_prev + kv
        y = y[:, None].to(dt).reshape(b, 1, nh * hd)
        new_state = {"tshift": x[:, -1:], "wkv": h_new}
    else:
        h0 = state["wkv"] if state is not None else None
        yh, h_final = wkv_chunked(rh, kh, vh, lwh, uh, h0)
        y = yh.reshape(b, s, nh * hd)
        if mode == "prefill":
            new_state = {"tshift": _state_at(x, length), "wkv": h_final}

    y = groupnorm(params["ln_x"], y, nh, eps=64e-5)
    y = y * F.silu(g)
    return torch.matmul(y, params["wo"].to(dt)), new_state


def channel_mix(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                state: Optional[Dict] = None,
                length: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B,S,d] -> (y, new partial state {"cshift"} or None): the
    squared-ReLU FFN gated by a sigmoid receptance, on token-shifted
    inputs."""
    dt = x.dtype
    prev = _token_shift(x, state["cshift"] if state is not None else None)
    xx = prev - x
    xk = x + xx * params["mu_k"].to(dt)
    xr = x + xx * params["mu_r"].to(dt)
    k = torch.matmul(xk, params["wk"].to(dt))
    v = torch.matmul(torch.square(F.relu(k)), params["wv"].to(dt))
    out = torch.sigmoid(torch.matmul(xr, params["wr"].to(dt))) * v
    if mode == "decode":
        new_state = {"cshift": x[:, -1:]}
    elif mode == "prefill":
        new_state = {"cshift": _state_at(x, length)}
    else:
        new_state = None
    return out, new_state


def state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    """{name: shape} of one layer's recurrent state at ``batch`` rows."""
    nh, hd = hdims(cfg)
    d = cfg.d_model
    return {"tshift": (batch, 1, d), "wkv": (batch, nh, hd, hd),
            "cshift": (batch, 1, d)}
