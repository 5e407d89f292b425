"""Plain PyTorch versions of the RWKV6 wkv.

``rwkv6_wkv_ref`` (the oracle of ``repro/kernels/rwkv6_wkv/ref.py``) runs
the per-step recurrence

    y_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)
    S_t = diag(exp(lw_t)) S_{t-1} + k_t (x) v_t

in fp32, one step at a time, from an optional initial state ``h0``.  It
is what the wrapper runs on CPU tensors and what the kernel is held to.

``rwkv6_wkv_chunked_ref`` is the CUDA kernel's decomposition of the same
function, for the tests on the CPU: chunks of ``CHUNK_ROWS`` steps (the
last one ragged, padded with zeros), the cumsum of lw restarted per chunk
and summed row by row in fp32, A built in sub-blocks of ``SUB_ROWS``
rows (through a pivot left of the diagonal and in the lower-left quadrant
of a diagonal sub-block, per element in its two triangles; every
exponent <= 0), the products in 3xTF32 as ``kernels/tf32.py`` models
them, and the state passed between chunks in fp32.  Nothing on
the main path calls it.

``rwkv6_wkv_bwd_ref`` is the backward as a per-step reverse recurrence
of dL/dS_t (the states recomputed chunk by chunk), for the CPU tests and
as the card's yardstick; ``rwkv6_wkv_chunked_bwd_ref`` is the CUDA
kernel ``rwkv6_wkv_bwd``'s own algebra, the chunked form transposed."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.tf32 import mma_sum

CHUNK_ROWS = 64   # time steps per chunk (csrc/rwkv6_wkv.cu kQ)
SUB_ROWS = 16     # rows per sub-block of A (csrc/rwkv6_wkv.cu kSub)
TRI_ROWS = 8      # rows per triangle summed per element (half a sub-block)
BWD_CHUNK_ROWS = 8   # steps between the states rwkv6_wkv_bwd_ref keeps


def chunk_cumsum(lw: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum of min(lw, 0) over a chunk's rows, lw
    [BH,Q,K], summed row by row in fp32 as the kernel sums it, so it never
    rises along the rows."""
    run = torch.zeros_like(lw[:, 0], dtype=torch.float32)
    out = []
    for t in range(lw.shape[1]):
        run = run + lw[:, t].to(torch.float32).clamp(max=0.0)
        out.append(run)
    return torch.stack(out, dim=1)


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, u: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [BH,S,K] (lw: log decays, <= 0), u [BH,K], h0 [BH,K,K]
    or None (zeros) -> (y [BH,S,K] in r's dtype, h_final [BH,K,K] fp32)."""
    bh, s, kk = r.shape
    rf, kf, vf, lwf = r.float(), k.float(), v.float(), lw.float()
    uf = u.float()[:, :, None]
    if h0 is None:
        h = torch.zeros((bh, kk, kk), dtype=torch.float32, device=r.device)
    else:
        h = h0.float()
    ys = []
    for t in range(s):
        kv = kf[:, t, :, None] * vf[:, t, None, :]               # [BH,K,V]
        ys.append(torch.einsum("bk,bkv->bv", rf[:, t], h + uf * kv))
        h = torch.exp(lwf[:, t])[:, :, None] * h + kv
    y = torch.stack(ys, dim=1) if ys else rf.new_zeros((bh, 0, kk))
    return y.to(r.dtype), h


def chunk_scores(rs: torch.Tensor, ks: torch.Tensor, c: torch.Tensor,
                 cx: torch.Tensor, uf: torch.Tensor) -> torch.Tensor:
    """A [BH,Q,Q] of one chunk as the kernels build it: r, k, c and cx
    [BH,Q,K] of the chunk, u [BH,K].  Sub-blocks of ``SUB_ROWS`` rows left
    of the diagonal are r^ k^^T through the pivot p = c at the row before
    the row block (r^_t = r_t exp(cx_t - p), k^_j = k_j exp(p - c_j)); each
    diagonal sub-block is two triangles of ``TRI_ROWS`` rows summed per
    element in fp32, the bonus r_t . (u k_t) on its diagonal, and its
    lower-left quadrant r^ k^^T through the pivot c at its row
    ``TRI_ROWS - 1``; 0 above the diagonal."""
    bh, q, _ = rs.shape
    sub, tri_rows = SUB_ROWS, TRI_ROWS
    tri = torch.ones(tri_rows, tri_rows, dtype=torch.bool,
                     device=rs.device).tril(-1)

    def through_pivot(rows: slice, keys: slice, p: int) -> torch.Tensor:
        """r^ k^^T of these rows and keys through the pivot c_p (p at or
        after every key, before every row)."""
        pivot = c[:, p:p + 1]                                     # [BH,1,K]
        r_hat = rs[:, rows] * torch.exp(cx[:, rows] - pivot)
        k_hat = ks[:, keys] * torch.exp(pivot - c[:, keys])
        return mma_sum(r_hat, k_hat.transpose(1, 2), False, False)
    amat = torch.zeros((bh, q, q), dtype=torch.float32, device=rs.device)
    for b0 in range(0, q, sub):
        blk = slice(b0, b0 + sub)
        for e in (b0, b0 + tri_rows):
            # a triangle, per element; the exponent masked before exp
            tr = slice(e, e + tri_rows)
            diff = cx[:, tr, None, :] - c[:, None, tr, :]        # [BH,t,j,K]
            diff = torch.where(tri[None, :, :, None], diff, -torch.inf)
            amat[:, tr, tr] = (rs[:, tr, None, :] * ks[:, None, tr, :]
                               * torch.exp(diff)).sum(-1)
        amat[:, blk, blk] += torch.diag_embed(
            (rs[:, blk] * uf[:, None, :] * ks[:, blk]).sum(-1))
        mid = b0 + tri_rows
        amat[:, mid:b0 + sub, b0:mid] = through_pivot(
            slice(mid, b0 + sub), slice(b0, mid), mid - 1)
        if b0:                                     # left of the diagonal
            amat[:, blk, :b0] = through_pivot(blk, slice(0, b0), b0 - 1)
    return amat


def rwkv6_wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lw: torch.Tensor,
                          u: torch.Tensor,
                          h0: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunked form, same arguments and results as
    ``rwkv6_wkv_ref``.  Per chunk of Q = ``CHUNK_ROWS`` rows, with c the
    inclusive cumsum of min(lw, 0) restarted at the chunk (``chunk_cumsum``:
    row by row in fp32, never rising) and cx_t = c_{t-1} (cx_0 = 0):

        A[t, j] = sum_k r_t k_j exp(cx_t - c_j)  (j < t),  r_t . (u k_t)
                  (j = t),  0 above the diagonal
        y       = A V + (r exp(cx)) h_prev
        h_next  = exp(c_end) h_prev + (k exp(c_end - c_j))^T V

    A's sub-blocks of ``SUB_ROWS`` rows left of the diagonal are r^ k^^T
    through the pivot p = c at the row before the row block (r^_t = r_t
    exp(cx_t - p), k^_j = k_j exp(p - c_j)).  Each diagonal sub-block is
    two triangles of ``TRI_ROWS`` rows summed per element in fp32, and its
    lower-left quadrant r^ k^^T through the pivot c at its row
    ``TRI_ROWS - 1``.  The last update is one fused multiply-add, and the
    products are summed as the tensor cores sum them (``mma_sum``:
    3xTF32, 64-deep accumulators)."""
    bh, s, kk = r.shape
    q, sub = CHUNK_ROWS, SUB_ROWS
    nc = -(-s // q)
    pad = nc * q - s
    f32 = torch.float32

    def padded(t: torch.Tensor) -> torch.Tensor:
        return F.pad(t.to(f32), (0, 0, 0, pad))

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mma_sum(a, b, False, False)

    rf, kf, vf, lwf = padded(r), padded(k), padded(v), padded(lw)
    uf = u.to(f32)
    h = (torch.zeros((bh, kk, kk), dtype=f32, device=r.device) if h0 is None
         else h0.to(f32).clone())
    ys = []
    for ci in range(nc):
        rows = slice(ci * q, (ci + 1) * q)
        rs, ks, vs, ws = rf[:, rows], kf[:, rows], vf[:, rows], lwf[:, rows]
        c = chunk_cumsum(ws)                                      # [BH,Q,K]
        cx = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)
        amat = chunk_scores(rs, ks, c, cx, uf)
        c_end = c[:, -1:]                                         # [BH,1,K]
        y = mm(amat, vs) + mm(rs * torch.exp(cx), h)
        upd = mm((ks * torch.exp(c_end - c)).transpose(1, 2), vs)
        h = (torch.exp(c_end).transpose(1, 2).double() * h.double()
             + upd.double()).to(f32)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] if ys else rf.new_zeros((bh, 0, kk))
    return y.to(r.dtype), h


def rwkv6_wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lw: torch.Tensor, u: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The backward of the wkv as a per-step reverse recurrence, in fp32:
    the kernel's layout and arguments plus the cotangents ``dy`` [BH,S,K]
    and ``dh_final`` [BH,K,K] (None: zero) -> (dr, dk, dv, dlw, du, dh0),
    dh0 None when ``h0`` is None.

    The decay is w_t = exp(min(lw_t, 0)), as the kernel takes it, so dlw
    is 0 where lw > 0 (the chain rule through ``min``).  The states are
    had by recomputation: a forward sweep keeps the state at the start of
    every chunk of ``BWD_CHUNK_ROWS`` steps, and the reverse sweep
    recomputes a chunk's states from its start before it walks the chunk
    backwards with g_t = dL/dS_t:

        dr_t    = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t    = g_t v_t + r_t u (v_t . dy_t)
        dv_t    = g_t^T k_t + dy_t (r_t . u k_t)
        dlw_t   = w_t * rowsum(g_t * S_{t-1})
        du      = sum_t r_t k_t (v_t . dy_t)
        g_{t-1} = diag(w_t) g_t + r_t dy_t^T     (g_{S-1} = dh_final)
        dh0     = g_{-1}

    Every exponent is <= 0.  Nothing on the main path calls it: the CPU
    tests hold it against autograd through the plain version, and the
    card's tests hold the kernel to it."""
    bh, s, kk = r.shape
    f32 = torch.float32
    rf, kf, vf, dyf = r.to(f32), k.to(f32), v.to(f32), dy.to(f32)
    lwf, uf = lw.to(f32), u.to(f32)
    w = torch.exp(lwf.clamp(max=0.0))
    live = (lwf <= 0.0).to(f32)
    q = BWD_CHUNK_ROWS

    def step(h: torch.Tensor, t: int) -> torch.Tensor:
        return w[:, t, :, None] * h + kf[:, t, :, None] * vf[:, t, None, :]

    h = (torch.zeros((bh, kk, kk), dtype=f32, device=r.device)
         if h0 is None else h0.to(f32))
    starts = []
    for t in range(s):
        if t % q == 0:
            starts.append(h)
        h = step(h, t)
    dr, dk, dv = (torch.zeros_like(rf) for _ in range(3))
    dlw, du = torch.zeros_like(lwf), torch.zeros_like(uf)
    g = (torch.zeros((bh, kk, kk), dtype=f32, device=r.device)
         if dh_final is None else dh_final.to(f32))
    for ck in reversed(range(len(starts))):
        t0, t1 = ck * q, min(s, ck * q + q)
        hs = [starts[ck]]                       # hs[j] = S_{t0 + j - 1}
        for t in range(t0, t1 - 1):
            hs.append(step(hs[-1], t))
        for t in reversed(range(t0, t1)):
            hp = hs[t - t0]
            vdy = (vf[:, t] * dyf[:, t]).sum(-1, keepdim=True)   # [BH,1]
            ruk = (rf[:, t] * uf * kf[:, t]).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bkv,bv->bk", hp, dyf[:, t]) \
                + uf * kf[:, t] * vdy
            dk[:, t] = torch.einsum("bkv,bv->bk", g, vf[:, t]) \
                + rf[:, t] * uf * vdy
            dv[:, t] = torch.einsum("bkv,bk->bv", g, kf[:, t]) \
                + dyf[:, t] * ruk
            dlw[:, t] = w[:, t] * (g * hp).sum(-1) * live[:, t]
            du = du + rf[:, t] * kf[:, t] * vdy
            g = w[:, t, :, None] * g + rf[:, t, :, None] * dyf[:, t, None, :]
    return (dr, dk, dv, dlw, du, None if h0 is None else g)


def rwkv6_wkv_chunked_bwd_ref(r: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lw: torch.Tensor,
                              u: torch.Tensor, h0: Optional[torch.Tensor],
                              dy: torch.Tensor,
                              dh_final: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward of the chunked wkv form as the CUDA kernel
    ``rwkv6_wkv_bwd`` computes it; arguments and results as
    ``rwkv6_wkv_bwd_ref``'s.  Per chunk of Q = ``CHUNK_ROWS`` rows (the
    last padded with zeros), with c, cx and A as ``rwkv6_wkv_chunked_ref``
    has them, K~ = K exp(c_end - c), R~ = R exp(cx), h the state at the
    chunk's start (the forward's) and G = dL/dh at its end:

    1. G backwards over the chunks: dL/dh_start = exp(c_end) G + R~^T dY
       is the G of the chunk before (dh_final or 0 last; dh0 = chunk 0's);
    2. per chunk, dA = dY V^T on and below the diagonal and
         dV = A^T dY + K~ G
         dR = exp(cx) (dY h^T) + [dA through the decays] K + u k_t dA_tt
         dK = exp(c_end - c) (V G^T) + [dA^T through the decays] R
              + u r_t dA_tt
         du = sum_t dA_tt r_t k_t.
       The A terms go through the pivots of ``SUB_ROWS``-row sub-blocks:
       row block T against the keys before it through p = c_{16T - 1}
       (dR), key block J against the rows after it through p' = c_{16J +
       15} (dK), every factor exp(.) <= 1; a diagonal sub-block per
       element, T_tjk = dA_tj r_tk k_jk exp(cx_tk - c_jk) for j < t.
    3. the decays: dlw_s = [lw_s <= 0] times
         sum_{t > s > j} T_tj + sum_{t > s} (R~ . dY h^T)_t
           + exp(c_end) rowsum(h . G) + sum_{j < s} (K~ . V G^T)_j.
       The rectangle is never the difference of two cumsums (the pairs t
       = j + 1 enter both at full size under a strong decay and would
       cancel the answer's digits away): for s in sub-block b it is the
       pairs inside b (per element in its triangles; its quadrant's keys
       before s or rows after s), the rows of b after s against the keys
       before b (rho), the keys of b before s against the rows after b
       (kappa), and the rows after b against the keys before b, read from
       the dR product's accumulator after 16 b keys.

    Every product is summed as ``mma_sum`` models the tensor cores
    (3xTF32, accumulators at most 64 deep); the states in fp32."""
    bh, s, kk = r.shape
    q, sub = CHUNK_ROWS, SUB_ROWS
    nb = q // sub
    nc = -(-s // q)
    pad = nc * q - s
    f32 = torch.float32
    dev = r.device

    def chunked(t: torch.Tensor) -> torch.Tensor:       # [BH*NC, Q, K]
        return F.pad(t.to(f32), (0, 0, 0, pad)).reshape(bh * nc, q, kk)

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mma_sum(a, b, False, False)

    def tr(t: torch.Tensor) -> torch.Tensor:
        return t.transpose(-1, -2)

    def fma(a: torch.Tensor, b: torch.Tensor, c_: torch.Tensor):
        return (a.double() * b.double() + c_.double()).to(f32)

    n = bh * nc
    rf, kf, vf, lwf, dyf = (chunked(t) for t in (r, k, v, lw, dy))
    uf = u.to(f32)[:, None].expand(bh, nc, kk).reshape(n, kk)
    live = (lwf <= 0.0).to(f32)
    c = chunk_cumsum(lwf) if n else lwf
    cx = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)
    c_end = c[:, -1:]                                             # [N,1,K]
    ek = torch.exp(c_end - c)                                     # [N,Q,K]
    # 1. the states: h at each chunk's start, G at each chunk's end
    big = torch.exp(c_end).reshape(bh, nc, kk, 1)
    upd = mm(tr(kf * ek), vf).reshape(bh, nc, kk, kk)
    zz = mm(tr(rf * torch.exp(cx)), dyf).reshape(bh, nc, kk, kk)
    h = (torch.zeros((bh, kk, kk), dtype=f32, device=dev) if h0 is None
         else h0.to(f32))
    hs = []
    for ci in range(nc):
        hs.append(h)
        h = fma(big[:, ci], h, upd[:, ci])
    g = (torch.zeros((bh, kk, kk), dtype=f32, device=dev)
         if dh_final is None else dh_final.to(f32))
    gs = [g] * nc
    for ci in reversed(range(nc)):
        gs[ci] = g
        g = fma(big[:, ci], g, zz[:, ci])
    if not nc:
        z = rf.new_zeros((bh, s, kk))
        return (z, z.clone(), z.clone(), z.clone(), u.new_zeros(u.shape,
                dtype=f32), None if h0 is None else g)
    hh = torch.stack(hs, 1).reshape(n, kk, kk)
    gg = torch.stack(gs, 1).reshape(n, kk, kk)
    # 2. dA, dV, and the products of dR and dK
    amat = chunk_scores(rf, kf, c, cx, uf)
    lower = torch.ones(q, q, dtype=torch.bool, device=dev).tril()
    da = torch.where(lower, mm(dyf, tr(vf)), 0.0)
    dv = mm(tr(amat), dyf) + mm(kf * ek, gg)
    dr_h = torch.exp(cx) * mm(dyf, tr(hh))                       # R~ part
    dk_g = ek * mm(vf, tr(gg))                                    # K~ part
    dr_a, dk_a = torch.zeros_like(rf), torch.zeros_like(kf)
    rho, kappa = torch.zeros_like(rf), torch.zeros_like(kf)
    rect = torch.zeros_like(rf)
    for b in range(1, nb):                # row block b, the keys before it
        rows = slice(sub * b, sub * b + sub)
        p = c[:, sub * b - 1:sub * b]
        k_hat = kf[:, :sub * b] * torch.exp(p - c[:, :sub * b])
        r_hat = rf[:, rows] * torch.exp(cx[:, rows] - p)
        acc = mm(da[:, rows, :sub * b], k_hat)
        dr_a[:, rows] = torch.exp(cx[:, rows] - p) * acc
        rho[:, rows] = r_hat * acc
        for bs in range(1, b):            # rows after bs, keys before bs
            part = mm(da[:, rows, :sub * bs], k_hat[:, :sub * bs])
            rect[:, sub * bs:sub * bs + sub] += (r_hat * part).sum(
                1, keepdim=True)
    for b in range(nb - 1):               # key block b, the rows after it
        keys = slice(sub * b, sub * b + sub)
        p = c[:, sub * b + sub - 1:sub * b + sub]
        r_hat = rf[:, sub * b + sub:] * torch.exp(cx[:, sub * b + sub:] - p)
        acc = mm(tr(da[:, sub * b + sub:, keys]), r_hat)
        dk_a[:, keys] = torch.exp(p - c[:, keys]) * acc
        kappa[:, keys] = kf[:, keys] * dk_a[:, keys]
    # the diagonal sub-blocks: their two triangles per element, their
    # lower-left quadrant (rows TRI_ROWS .., keys .. TRI_ROWS - 1) through
    # the pivot c at their row TRI_ROWS - 1; its part of the rectangle is
    # the quadrant's keys before s (kappa, s in the first half) or its rows
    # after s (rho, s in the second half)
    tri = TRI_ROWS
    strict = torch.ones(tri, tri, dtype=torch.bool, device=dev).tril(-1)
    idx = torch.arange(tri, device=dev)
    between = ((idx[None, :, None] > idx[:, None, None])
               & (idx[:, None, None] > idx[None, None, :])).to(f32)
    for b in range(nb):
        for e0 in (sub * b, sub * b + tri):
            half = slice(e0, e0 + tri)
            diff = cx[:, half, None, :] - c[:, None, half, :]       # [N,t,j,K]
            e = torch.exp(torch.where(strict[None, :, :, None], diff,
                                      -torch.inf))
            w = da[:, half, half, None] * e
            dr_a[:, half] += (w * kf[:, None, half, :]).sum(2)
            dk_a[:, half] += (w * rf[:, half, None, :]).sum(1)
            tt = w * rf[:, half, None, :] * kf[:, None, half, :]
            rect[:, half] += torch.einsum("stj,ntjk->nsk", between, tt)
        top = slice(sub * b, sub * b + tri)
        bot = slice(sub * b + tri, sub * b + sub)
        p = c[:, sub * b + tri - 1:sub * b + tri]
        k_hat = kf[:, top] * torch.exp(p - c[:, top])
        r_hat = rf[:, bot] * torch.exp(cx[:, bot] - p)
        dr_q = torch.exp(cx[:, bot] - p) * mm(da[:, bot, top], k_hat)
        dk_q = torch.exp(p - c[:, top]) * mm(tr(da[:, bot, top]), r_hat)
        dr_a[:, bot] += dr_q
        dk_a[:, top] += dk_q
        rho_q, kappa_q = rf[:, bot] * dr_q, kf[:, top] * dk_q
        rect[:, bot] += rho_q.flip(1).cumsum(1).flip(1) - rho_q     # t > s
        rect[:, top] += kappa_q.cumsum(1) - kappa_q                 # j < s
    bonus = torch.diagonal(da, dim1=1, dim2=2)[..., None]         # [N,Q,1]
    dr = dr_h + dr_a + uf[:, None] * kf * bonus
    dk = dk_g + dk_a + uf[:, None] * rf * bonus
    du = (bonus * rf * kf).sum(1).reshape(bh, nc, kk).sum(1)
    # 3. the decays: suffixes and prefixes within each sub-block, whole
    # sub-blocks' sums after (before) it for the R~ (K~) terms
    a_row = (rf * dr_h).reshape(n, nb, sub, kk)
    b_row = (kf * dk_g).reshape(n, nb, sub, kk)
    xs = a_row + rho.reshape(n, nb, sub, kk)
    yb = b_row + kappa.reshape(n, nb, sub, kk)
    suf = xs.flip(2).cumsum(2).flip(2) - xs                       # t > s
    pre = yb.cumsum(2) - yb                                       # j < s
    a_tot, b_tot = a_row.sum(2, keepdim=True), b_row.sum(2, keepdim=True)
    later = a_tot.flip(1).cumsum(1).flip(1) - a_tot
    earlier = b_tot.cumsum(1) - b_tot
    hg = (torch.exp(c_end[:, 0]) * (hh * gg).sum(-1))[:, None, None]
    dlw = live * (suf + later + pre + earlier + hg).reshape(n, q, kk) \
        + live * rect

    def unchunk(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(bh, nc * q, kk)[:, :s]
    return (unchunk(dr), unchunk(dk), unchunk(dv), unchunk(dlw), du,
            None if h0 is None else g)
