"""Plain PyTorch version of flash attention (the oracle of
``repro/kernels/flash_attention/ref.py``): direct full-softmax attention
in fp32, kv heads repeated by the GQA group, the kernel's mask rule
(finite ``-1e30``), the output cast to q's dtype.  ``q_offset`` places
query ``i`` at key position ``q_offset + i`` (a context-parallel rank's
queries against its gathered keys)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q [B,H,Sq,dh]; k,v [B,Hkv,Skv,dh] -> [B,H,Sq,dh].  Query ``i``
    sits at key position ``q_offset + i`` for the causal and window
    masks."""
    _b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=1)
        v = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
