"""Plain PyTorch versions of the Mamba2 scan.

``mamba2_scan_ref`` (the oracle of ``repro/kernels/mamba2_scan/ref.py``)
runs the per-step recurrence

    h_t = exp(dt_t * a) h_{t-1} + dt_t * b_t (x) x_t
    y_t = c_t . h_t

in fp32, one step at a time, from an optional initial state ``h0``.  It
is what the wrapper runs on CPU tensors and what the kernel is held to.

``mamba2_scan_chunked_ref`` is the CUDA kernel's decomposition of the same
function, for the tests on the CPU: chunks of ``CHUNK_ROWS`` steps (the
last one ragged, padded with zeros), the cumsum restarted per chunk, the
exponent masked before exp is taken, the four products in 3xTF32 as
``kernels/tf32.py`` models them, and the state passed between chunks in
fp32.  Nothing on the main path calls it.

``mamba2_scan_bwd_ref`` is the backward the CUDA kernel's
``mamba2_scan_bwd`` runs (the states recomputed chunk by chunk, the
reverse recurrence of dL/dh_t), for the CPU tests and as the card's
yardstick."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.tf32 import mma_sum

CHUNK_ROWS = 64   # time steps per chunk (csrc/mamba2_scan.cu kQ)
BWD_CHUNK_ROWS = 8   # steps per chunk of the backward (csrc kBwdQ)


def mamba2_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [BH,S,P], dt [BH,S], b/c [BH,S,N], a [BH] (negative decay rate),
    h0 [BH,N,P] or None (zeros) -> (y [BH,S,P] in x's dtype, h_final
    [BH,N,P] fp32)."""
    bh, s, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    af = a.float()
    if h0 is None:
        h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af)                         # [BH]
        upd = torch.einsum("bn,b,bp->bnp", bf[:, t], dtf[:, t], xf[:, t])
        h = h * decay[:, None, None] + upd
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bh, 0, p))
    return y.to(x.dtype), h


def mamba2_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor,
                            b: torch.Tensor, c: torch.Tensor,
                            a: torch.Tensor,
                            h0: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunked SSD form, same arguments and results as
    ``mamba2_scan_ref``.  Per chunk of Q = ``CHUNK_ROWS`` rows, with cum
    the inclusive cumsum of dt * a restarted at the chunk:

        L      = exp(cum_i - cum_j) for j <= i, else 0 (masked to -inf
                 before exp, and clamped at 0 below it)
        y      = ((C B^T) * L * dt_j) X + (exp(cum_i) C) h_prev
        h_next = exp(cum_end) h_prev + (B * exp(cum_end - cum_j) dt_j)^T X

    the last update as one fused multiply-add, and the four products as
    the tensor cores sum them (``mma_sum``: 3xTF32, 64-deep
    accumulators)."""
    bh, s, p = x.shape
    n = b.shape[-1]
    q = CHUNK_ROWS
    nc = -(-s // q)
    pad = nc * q - s
    f32 = torch.float32

    def padded(t: torch.Tensor) -> torch.Tensor:
        t = t.to(f32)
        return F.pad(t, (0, 0, 0, pad)) if t.dim() == 3 else F.pad(t, (0, pad))

    def mm(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return mma_sum(u, v, False, False)

    xf, dtf, bf, cf = padded(x), padded(dt), padded(b), padded(c)
    af = a.to(f32)
    h = (torch.zeros((bh, n, p), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32).clone())
    lower = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    ys = []
    for ci in range(nc):
        rows = slice(ci * q, (ci + 1) * q)
        xs, dts, bs, cs = xf[:, rows], dtf[:, rows], bf[:, rows], cf[:, rows]
        cum = torch.cumsum(dts * af[:, None], dim=1)              # [BH,Q]
        cum_end = cum[:, -1:]
        diff = (cum[:, :, None] - cum[:, None, :]).clamp(max=0.0)
        decay = torch.exp(torch.where(lower, diff, -torch.inf))
        scores = mm(cs, bs.transpose(1, 2))
        y = mm(scores * decay * dts[:, None, :], xs) \
            + mm(cs * torch.exp(cum)[..., None], h)
        wdec = torch.exp((cum_end - cum).clamp(max=0.0)) * dts   # [BH,Q]
        upd = mm((bs * wdec[..., None]).transpose(1, 2), xs)
        h = (torch.exp(cum_end)[..., None].double() * h.double()
             + upd.double()).to(f32)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] if ys else xf.new_zeros((bh, 0, p))
    return y.to(x.dtype), h


def mamba2_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, a: torch.Tensor,
                        h0: Optional[torch.Tensor], dy: torch.Tensor,
                        dh_final: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The backward of ``mamba2_scan_ref`` as the CUDA kernel's
    ``mamba2_scan_bwd`` runs it, in fp32: the kernel's layout and
    arguments plus the cotangents ``dy`` [BH,S,P] and ``dh_final``
    [BH,N,P] (None: zero) -> (dx, ddt, db, dc, da, dh0), dh0 None when
    ``h0`` is None.

    The states are had by recomputation, never by stepping a state back
    through its decay: a forward sweep keeps the state at the start of
    every chunk of ``BWD_CHUNK_ROWS`` steps, and the reverse sweep
    recomputes a chunk's states from its start before it walks the
    chunk backwards with g_t = dL/dh_t:

        g_t   = alpha_{t+1} g_{t+1} + c_t dy_t^T     (g_{S-1} from dh_final)
        dx_t  = dt_t g_t^T b_t
        db_t  = dt_t g_t x_t
        dc_t  = h_t dy_t
        ddt_t = x_t . (g_t^T b_t) + a alpha_t <g_t, h_{t-1}>
        da    = sum_t dt_t alpha_t <g_t, h_{t-1}>
        dh0   = alpha_0 g_0

    with alpha_t = exp(dt_t a) <= 1.  Nothing on the main path calls it:
    the CPU tests hold it against autograd through the plain version and
    the card's kernel is held to it."""
    bh, s, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    xf, dtf, bf, cf = x.to(f32), dt.to(f32), b.to(f32), c.to(f32)
    af, dyf = a.to(f32), dy.to(f32)
    alpha = torch.exp(dtf * af[:, None])                         # [BH,S]
    q = BWD_CHUNK_ROWS

    def step(h: torch.Tensor, t: int) -> torch.Tensor:
        return alpha[:, t, None, None] * h + torch.einsum(
            "bn,b,bp->bnp", bf[:, t], dtf[:, t], xf[:, t])

    h = (torch.zeros((bh, n, p), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    starts = []
    for t in range(s):
        if t % q == 0:
            starts.append(h)
        h = step(h, t)
    dx, dyt = torch.zeros_like(xf), torch.zeros_like(dtf)
    db, dc = torch.zeros_like(bf), torch.zeros_like(cf)
    da = torch.zeros_like(af)
    g_next = (torch.zeros((bh, n, p), dtype=f32, device=x.device)
              if dh_final is None else dh_final.to(f32))
    for ck in reversed(range(len(starts))):
        t0, t1 = ck * q, min(s, ck * q + q)
        hs = [starts[ck]]                       # hs[j] = h_{t0 + j - 1}
        for t in range(t0, t1):
            hs.append(step(hs[-1], t))
        for t in reversed(range(t0, t1)):
            j = t - t0
            g = g_next + cf[:, t, :, None] * dyf[:, t, None, :]
            sx = torch.einsum("bn,bnp->bp", bf[:, t], g)
            dx[:, t] = dtf[:, t, None] * sx
            db[:, t] = dtf[:, t, None] * torch.einsum("bnp,bp->bn", g,
                                                      xf[:, t])
            dc[:, t] = torch.einsum("bnp,bp->bn", hs[j + 1], dyf[:, t])
            gh = (g * hs[j]).sum((1, 2))
            dyt[:, t] = (xf[:, t] * sx).sum(-1) + af * alpha[:, t] * gh
            da = da + dtf[:, t] * alpha[:, t] * gh
            g_next = alpha[:, t, None, None] * g
    return (dx, dyt, db, dc, da, None if h0 is None else g_next)
