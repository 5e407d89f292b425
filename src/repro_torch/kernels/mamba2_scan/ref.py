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

``mamba2_scan_bwd_ref`` is the backward as a per-step recurrence (the
states recomputed chunk by chunk, the reverse recurrence of dL/dh_t):
an algorithm independent of the kernel, for the CPU tests and as the
card's yardstick.

``mamba2_scan_chunked_bwd_ref`` is the CUDA kernel ``mamba2_scan_bwd``'s
algebra: the chunked SSD form transposed, chunks of ``CHUNK_ROWS`` steps,
the exponents summed from 16-row pivots (``SUB_ROWS``), the products in
3xTF32 as ``kernels/tf32.py`` models them and the states passed between
chunks in fp32.  Nothing on the main path calls it."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.tf32 import mma_sum

CHUNK_ROWS = 64   # time steps per chunk (csrc/mamba2_scan.cu kQ)
SUB_ROWS = 16     # rows per pivot of the backward's exponents (csrc kSub)
BWD_CHUNK_ROWS = 8   # steps per chunk of mamba2_scan_bwd_ref's sweep


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
    """The backward of ``mamba2_scan_ref`` as a per-step recurrence, in
    fp32: the kernel's layout and
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
    the card's kernel is held to it.  ``mamba2_scan_chunked_bwd_ref`` is
    the kernel's own algebra."""
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



def chunk_exponents(d: torch.Tensor):
    """The exponents of one chunk from its per-step log-decays ``d`` =
    dt * a [..., Q] (all <= 0), each summed from terms of one sign and
    never taken as the difference of two cumsums (which reach thousands
    under the model's decays and would cancel their digits away):

    * ``seg`` [..., Q, Q]: d summed over (j, i] for j <= i (down each
      column from j + 1), -inf above the diagonal;
    * ``cum`` [..., Q]: d summed over [0, i];
    * ``rest`` [..., Q]: d summed over (j, Q);
    * ``total`` [...]: d summed over the chunk.

    The kernel reaches the same sums through 16-row pivots (``kSub``):
    off the diagonal sub-blocks exp(the sum within row i's sub-block and
    those of the sub-blocks between) times exp(the sum within column j's),
    each factor <= 1; inside a diagonal sub-block down each column."""
    q = d.shape[-1]
    seg = torch.full((*d.shape, q), -torch.inf, dtype=d.dtype,
                     device=d.device)
    cols = torch.arange(q, device=d.device)
    run = torch.zeros_like(d)       # run[j] = d[j+1] + ... + d[j+m]
    for m in range(q):
        j = cols[:q - m]
        seg[..., j + m, j] = run[..., :q - m]
        run = run[..., :q - m - 1] + d[..., m + 1:]
    cum = torch.cumsum(d, -1)
    rev = torch.flip(torch.cumsum(torch.flip(d, [-1]), -1), [-1])
    rest = torch.cat([rev[..., 1:], torch.zeros_like(d[..., :1])], -1)
    return seg, cum, rest, cum[..., -1]


def mamba2_scan_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                                b: torch.Tensor, c: torch.Tensor,
                                a: torch.Tensor, h0: Optional[torch.Tensor],
                                dy: torch.Tensor,
                                dh_final: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, ...]:
    """The backward of the chunked SSD form as the CUDA kernel
    ``mamba2_scan_bwd`` computes it; arguments and results as
    ``mamba2_scan_bwd_ref``'s.  Per chunk of Q = ``CHUNK_ROWS`` rows
    (the last padded with zeros), with the exponents of
    ``chunk_exponents``, e_i = exp(cum_i), E = exp(total), w_j =
    exp(rest_j) dt_j, L = exp(seg), Sc = C B^T and M = Sc . L . dt_j:

    1. each chunk's own update U = (diag(w) B)^T X and Z = (diag(e) C)^T
       dY; then the states: h at each chunk's start, forwards (h_next = E
       h + U, h0 or 0 first), and G = dL/dh at each chunk's end, backwards
       (G_prev = E G + Z, dh_final or 0 last; dh0 = E_0 G_0 + Z_0);
    2. per chunk, from h and G:
         dM  = dY X^T on and below the diagonal, dSc = dM . L . dt_j
         dX  = M^T dY + diag(w) B G
         dC  = dSc B + diag(e) dY h^T
         dB  = dSc^T C + diag(w) X G^T
       and the decays, from R = dM . M, u_i = e_i <C_i, (dY h^T)_i> and
       V_j = <B_j, (X G^T)_j>: D_l = dL/d(cum_l + ... + cum_end) is
         sum_{k >= l, j < l} R_kj + sum_{k >= l} u_k + sum_{j < l} w_j V_j
           + E <G, h>
       (no sum of opposite signs: R's row and column sums cancel exactly
       inside the rectangle, and the w terms inside the prefix), then
         ddt_l = a D_l + sum_i (dM . Sc . L)_il + V_l exp(rest_l)
         da   += sum_l dt_l D_l.

    Every product is summed as ``mma_sum`` models the tensor cores
    (3xTF32, accumulators at most 64 deep); the states and the sums over
    the chunks in fp32."""
    bh, s, p = x.shape
    n = b.shape[-1]
    q = CHUNK_ROWS
    nc = -(-s // q)
    pad = nc * q - s
    f32 = torch.float32
    dev = x.device

    def padded(t: torch.Tensor) -> torch.Tensor:
        t = t.to(f32)
        return F.pad(t, (0, 0, 0, pad)) if t.dim() == 3 else F.pad(t, (0, pad))

    def mm(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return mma_sum(u, v, False, False)

    def fma(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor):
        return (u.double() * v.double() + w.double()).to(f32)

    xf, dtf, bf, cf, dyf = (padded(t) for t in (x, dt, b, c, dy))
    af = a.to(f32)
    xs, dts, bs, cs, dys = (t.reshape(bh, nc, q, *t.shape[2:])
                            for t in (xf, dtf, bf, cf, dyf))
    seg, cum, rest, total = chunk_exponents(dts * af[:, None, None])
    ee, ww = torch.exp(cum), torch.exp(rest) * dts          # [BH,NC,Q]
    big = torch.exp(total)                                  # [BH,NC]
    upd = mm((bs * ww[..., None]).transpose(-1, -2), xs)    # [BH,NC,N,P]
    zz = mm((cs * ee[..., None]).transpose(-1, -2), dys)
    # the states, in fp32: h at each chunk's start, G at each chunk's end
    h = (torch.zeros((bh, n, p), dtype=f32, device=dev) if h0 is None
         else h0.to(f32))
    hs = []
    for ci in range(nc):
        hs.append(h)
        h = fma(big[:, ci, None, None], h, upd[:, ci])
    g = (torch.zeros((bh, n, p), dtype=f32, device=dev) if dh_final is None
         else dh_final.to(f32))
    gs = [None] * nc
    for ci in reversed(range(nc)):
        gs[ci] = g
        g = fma(big[:, ci, None, None], g, zz[:, ci])
    hh, gg = torch.stack(hs, 1), torch.stack(gs, 1)        # [BH,NC,N,P]
    lower = torch.ones(q, q, dtype=torch.bool, device=dev).tril()
    ll = torch.exp(seg)                                     # 0 above
    sc = mm(cs, bs.transpose(-1, -2))
    mmat = sc * ll * dts[..., None, :]
    dm = torch.where(lower, mm(dys, xs.transpose(-1, -2)), 0.0)
    dsc = dm * ll * dts[..., None, :]
    a1 = mm(dys, hh.transpose(-1, -2))                      # [..,Q,N]
    a2 = mm(xs, gg.transpose(-1, -2))
    dx = mm(mmat.transpose(-1, -2), dys) + mm(bs * ww[..., None], gg)
    dc = mm(dsc, bs) + ee[..., None] * a1
    db = mm(dsc.transpose(-1, -2), cs) + ww[..., None] * a2
    # the decays
    rr = dm * mmat
    u = ee * (cs * a1).sum(-1)
    v = (bs * a2).sum(-1)
    gh = (gg * hh).sum((-1, -2))                            # [BH,NC]
    left = torch.cat([torch.zeros_like(rr[..., :1]),     # sum over j < l
                      torch.cumsum(rr, -1)[..., :-1]], -1)
    rect = torch.where(lower, left, 0.0).sum(-2)            # rows k >= l
    usuf = torch.flip(torch.cumsum(torch.flip(u, [-1]), -1), [-1])
    wv = ww * v
    wpre = torch.cat([torch.zeros_like(wv[..., :1]),
                      torch.cumsum(wv, -1)[..., :-1]], -1)
    dd = rect + usuf + wpre + (big * gh)[..., None]
    ddt = af[:, None, None] * dd + (dm * sc * ll).sum(-2) \
        + v * torch.exp(rest)
    da = (dts * dd).sum((-1, -2))

    def unpad(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(bh, nc * q, *t.shape[3:])[:, :s]
    return (unpad(dx).to(x.dtype), unpad(ddt), unpad(db), unpad(dc), da,
            None if h0 is None else g)
