"""Plain PyTorch version of paged decode attention: gather-then-attend.

The torch counterpart of ``repro/kernels/paged_attention/ref.py``.  It
gathers each table entry's page into a contiguous ``[B, ring, Hkv, dh]``
buffer and runs masked attention over it.  Validity is the ring formula
``u = t - ((t - r) mod R)`` (floor-mod: ``torch.remainder``), the
per-row causal mask at position ``t - (S-1) + i``, the optional window,
and the trash-page convention (an entry equal to the last pool row
masks its whole page).  8-bit pools come with ``k_scale``/``v_scale``
[num_pages+1, Hkv]: the gathered pages are dequantized before attending.
The softmax is the masked-accumulate form — weights zeroed where
invalid, denominator clamped — so a row with no valid position comes
out exactly 0, as the CUDA kernel's does.  ``paged_attention_split_ref``
computes the same function by the kernel's split-KV decomposition
(per-split partials, then the log-sum-exp combine), so the CPU tests can
hold that arithmetic to the plain version and to JAX's oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def take_pages(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` for any pool dtype: 8-bit pools are indexed through a
    uint8 view, so the gather needs no float8 indexing kernel."""
    if pool.element_size() == 1:
        return pool.view(torch.uint8)[idx.long()].view(pool.dtype)
    return pool[idx.long()]


def _scores(q, pool_k, pool_v, page_table, cache_len, window, softcap,
            k_scale, v_scale):
    """Gather, dequantize and score: s [B,Hkv,G,S,R] fp32 (softcapped),
    valid [B,1,1,S,R], cv [B,Hkv,R,dh] (fp32 for 8-bit pools)."""
    b, sq, h, dh = q.shape
    npg, page_size, hkv, _ = pool_k.shape
    nb = page_table.shape[1]
    ring = nb * page_size
    g = h // hkv
    pt = page_table.long()
    gk = take_pages(pool_k, pt)                       # [B, nb, P, Hkv, dh]
    gv = take_pages(pool_v, pt)
    if k_scale is not None:    # dequant: scale per (page, kv head)
        gk = gk.float() * k_scale[pt][:, :, None, :, None]
        gv = gv.float() * v_scale[pt][:, :, None, :, None]
    ck = gk.reshape(b, ring, hkv, dh).transpose(1, 2)          # [B,Hkv,R,dh]
    cv = gv.reshape(b, ring, hkv, dh).transpose(1, 2)
    cl = cache_len.long()
    t = (cl - 1)[:, None]
    r = torch.arange(ring, device=q.device)[None, :]
    u = t - torch.remainder(t - r, ring)                         # [B, R]
    qpos = (cl - sq)[:, None] + torch.arange(sq, device=q.device)[None, :]
    valid = (u >= 0)[:, None, :] & (u[:, None, :] <= qpos[:, :, None])
    if window is not None:
        valid = valid & (u[:, None, :] > qpos[:, :, None] - window)
    not_trash = torch.repeat_interleave(pt != npg - 1, page_size, dim=1)
    valid = valid & not_trash[:, None, :]                        # [B,S,R]
    q2 = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqkgd,bksd->bkgqs", q2, ck).float() * dh ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    return s, valid[:, None, None], cv


def paged_attention_ref(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, page_table: torch.Tensor,
                        cache_len: torch.Tensor, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q [B,H,dh] or [B,S,H,dh] (S query rows, newest last); pools
    [num_pages+1,P,Hkv,dh] fp32, or 8-bit with ``k_scale``/``v_scale``
    [num_pages+1,Hkv] fp32; page_table [B,nb] int; cache_len [B]
    (including the newest query token) -> output shaped like ``q``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    s, mask, cv = _scores(q, pool_k, pool_v, page_table, cache_len, window,
                          softcap, k_scale, v_scale)
    s = torch.where(mask, s, NEG_INF)
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = torch.where(mask, w, 0.0)
    l = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bksd->bqkgd", (w / l).to(cv.dtype), cv)
    out = out.reshape(q.shape)
    return out[:, 0] if squeeze else out


def paged_attention_split_ref(q: torch.Tensor, pool_k: torch.Tensor,
                              pool_v: torch.Tensor, page_table: torch.Tensor,
                              cache_len: torch.Tensor, *,
                              pages_per_split: int,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``paged_attention_ref`` by the CUDA kernel's decomposition: the ring
    cut into splits of ``pages_per_split`` pages, each split's partial
    (running max m floored at -1e30, denominator l, unnormalised acc) over
    its valid positions, then the log-sum-exp combine over the splits with
    l > 0.  A row with no valid position comes out 0 / max(0, 1e-30) = 0."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    s, mask, cv = _scores(q, pool_k, pool_v, page_table, cache_len, window,
                          softcap, k_scale, v_scale)
    span = pages_per_split * pool_k.shape[1]
    m_all = torch.full(s.shape[:-1], NEG_INF, device=q.device)
    l_all = torch.zeros_like(m_all)
    acc_all = torch.zeros(*s.shape[:-1], cv.shape[-1], device=q.device)
    parts = []
    for lo in range(0, s.shape[-1], span):
        ss = s[..., lo:lo + span]
        valid = mask[..., lo:lo + span].expand_as(ss)
        m = torch.where(valid, ss, NEG_INF).amax(dim=-1)
        w = torch.where(valid, torch.exp(ss - m[..., None]), 0.0)
        acc = torch.einsum("bkgqs,bksd->bkgqd", w, cv[:, :, lo:lo + span])
        parts.append((m, w.sum(dim=-1), acc))
        m_all = torch.where(parts[-1][1] > 0, torch.maximum(m_all, m), m_all)
    for m, l, acc in parts:
        wt = torch.where(l > 0, torch.exp(m - m_all), 0.0)
        l_all = l_all + wt * l
        acc_all = acc_all + wt[..., None] * acc
    out = acc_all / l_all.clamp_min(1e-30)[..., None]        # [B,Hkv,G,S,dh]
    out = out.permute(0, 3, 1, 2, 4).reshape(q.shape)
    return out[:, 0] if squeeze else out
