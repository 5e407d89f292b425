"""Plain PyTorch version of paged decode attention: gather-then-attend.

The torch counterpart of ``repro/kernels/paged_attention/ref.py``.  It
gathers each table entry's page into a contiguous ``[B, ring, Hkv, dh]``
buffer and runs masked attention over it.  Validity is the ring formula
``u = t - ((t - r) mod R)`` (floor-mod: ``torch.remainder``), the
per-row causal mask at position ``t - (S-1) + i``, the optional window,
and the trash-page convention (an entry equal to the last pool row
masks its whole page).  The softmax is the masked-accumulate form —
weights zeroed where invalid, denominator clamped — so a row with no
valid position comes out exactly 0, as the CUDA kernel's does.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, page_table: torch.Tensor,
                        cache_len: torch.Tensor, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,H,dh] or [B,S,H,dh] (S query rows, newest last); pools
    [num_pages+1,P,Hkv,dh] fp32; page_table [B,nb] int; cache_len [B]
    (including the newest query token) -> output shaped like ``q``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, sq, h, dh = q.shape
    npg, page_size, hkv, _ = pool_k.shape
    nb = page_table.shape[1]
    ring = nb * page_size
    g = h // hkv
    pt = page_table.long()
    ck = pool_k[pt].reshape(b, ring, hkv, dh).transpose(1, 2)  # [B,Hkv,R,dh]
    cv = pool_v[pt].reshape(b, ring, hkv, dh).transpose(1, 2)
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
    mask = valid[:, None, None]                                  # [B,1,1,S,R]
    s = torch.where(mask, s, NEG_INF)
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = torch.where(mask, w, 0.0)
    l = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bksd->bqkgd", (w / l).to(cv.dtype), cv)
    out = out.reshape(b, sq, h, dh)
    return out[:, 0] if squeeze else out
