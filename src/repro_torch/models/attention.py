"""GQA attention of the port: the paged decode, prefill, dense and
cross-attention parts of ``repro/models/attention.py``.

``apply`` runs in these modes:

* ``mode="decode"`` over a paged cache (the serving engines' chunks):
  projections + rope, then ``paged_decode_step`` writes the new KV
  through the page table and reads it back either by gathering each
  slot's ring (``paged_kernel=False``) or pool-direct through
  ``kernels/paged_attention`` (``paged_kernel=True``: the Hopper kernel
  on the card).  Pool writes are **in place** — the reference returns
  new pools, the port mutates the cache's tensors and returns them.
* ``mode="prefill"`` (the two-executable engine's bucketed prefill):
  ``chunked_attention`` over the whole prompt, which runs
  ``kernels/flash_attention`` (the Hopper kernel on the card), and
  returns the prompt's K/V ``[B,Hkv,S,dh]`` for the splice.  With
  ``ctx`` it is a suffix prefill: the matched prefix is gathered
  (dequantized, for 8-bit pools) from the paged pool and attended by
  ``prefix_prefill_attention`` in plain torch ops, as the reference's
  XLA einsums.

8-bit pools (int8 / fp8_e4m3, with per-page, per-kv-head fp32 scales
"ks"/"vs") are written by a re-quantizing read-modify-write of whole
pages (``rmw_quantized_pages``) and read either through the kernel,
which folds the scales in, or by gathering and dequantizing.

``mode="decode"`` also runs over a dense per-slot cache ``{"k","v":
[B,Hkv,T,dh]}`` (``init_cache_shape``; the model drafter's draft cache
and ``transformer.prepare_decode_cache``'s): one token per slot, written
in place at ``(len - 1) mod T`` and read with a position-order mask.
``mode="dense"`` (teacher-forced logits, whisper's encoder) is
``chunked_attention`` with no cache, causal or not.

Cross-attention (whisper's decoder): ``encode_kv`` projects the encoder
output once into ``{"k","v": [B,Hkv,Senc,dh]}``, the flash kernel's
layout, and ``cross_apply`` attends to it, non-causal, through
``kernels/flash_attention``.

Under a sharded training step (``parallel/sharding.current_layout()``)
the dense mode is head-parallel: ``wq``/``wk``/``wv`` hold this rank's
heads and ``wo`` its rows, between ``tp_in`` and ``tp_out`` (no-ops
without a layout).  When the
model axis does not divide the KV heads, ``KV_HEADS`` falls back to
replicated weights and a rank computes the ``max(1, Hkv * H_local / H)``
KV heads its query heads group to (``launch/build.local_view``'s rule)
from its slice of them; the leaf's gradient is then summed over the
model axes it is not sharded on (``optim/adamw``).  Under context
parallelism ``cp_attention`` keeps q on this rank's sequence shard,
all-gathers K and V once and runs ``kernels/flash_attention`` with a
query offset on the keys that the causal and window masks leave.

Every function here is free of host synchronization: no ``.item()``,
no boolean-mask indexing, no Python branch on a tensor value.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.ref import take_pages
from repro_torch.models.layers import rope
from repro_torch.models.module import (EMBED, HEAD_DIM, HEADS, KV_HEADS,
                                        ParamDef)
from repro_torch.parallel import sharding as sh

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig) -> Dict:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    return {"wq": ParamDef((d, cfg.num_heads, dh), (EMBED, HEADS, HEAD_DIM)),
            "wk": ParamDef((d, cfg.num_kv_heads, dh),
                           (EMBED, KV_HEADS, HEAD_DIM)),
            "wv": ParamDef((d, cfg.num_kv_heads, dh),
                           (EMBED, KV_HEADS, HEAD_DIM)),
            "wo": ParamDef((cfg.num_heads, dh, d), (HEADS, HEAD_DIM, EMBED))}


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     cache_len: Optional[torch.Tensor] = None, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Sq,H,dh]; cache [B,Hkv,S,dh]; ``cache_len`` [B] counts valid
    entries *including* the newest query token.

    The default mask is position order (the dense decode cache: entry
    ``j`` holds position ``j``, valid below ``cache_len`` and, with
    ``window``, at or past ``cache_len - window``).  ``valid`` overrides
    it: [B,S] for Sq == 1 (the paged gather path's ring-order mask) or
    one mask per query row [B,Sq,S], which Sq > 1 requires."""
    b, sq, h, dh = q.shape
    hkv, s = ck.shape[1], ck.shape[2]
    g = h // hkv
    scale = dh ** -0.5
    if sq == 1:
        q2 = q[:, 0].reshape(b, hkv, g, dh)
        scores = torch.einsum("bkgd,bksd->bkgs", q2, ck).float() * scale
        scores = _softcap(scores, softcap)
        if valid is None:
            pos = torch.arange(s, device=q.device)[None, :]
            cl = cache_len.long()[:, None]
            valid = pos < cl                                   # [B, S]
            if window is not None:
                valid = valid & (pos >= cl - window)
        scores = torch.where(valid[:, None, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(cv.dtype)
        out = torch.einsum("bkgs,bksd->bkgd", p, cv)
        return out.reshape(b, 1, h, dh)
    if valid is None or valid.dim() != 3:
        raise ValueError("multi-query decode attention needs a per-query "
                         "[B,Sq,S] mask")
    q2 = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqkgd,bksd->bkgqs", q2, ck).float()
    scores = _softcap(scores * scale, softcap)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgqs,bksd->bqkgd", p, cv)
    return out.reshape(b, sq, h, dh)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      q_chunk: Optional[int] = None) -> torch.Tensor:
    """q [B,Sq,H,dh]; k,v [B,Skv,Hkv,dh] -> [B,Sq,H,dh].

    For causal self-attention query ``i`` sits at position ``i``.  The
    reference's query-chunked XLA loop becomes one call of
    ``kernels/flash_attention`` in its ``[B,H,S,dh]`` layout (one
    contiguous copy per tensor), which tiles the queries itself:
    ``q_chunk`` is accepted for the reference's signature and unused."""
    del q_chunk
    out = flash_ops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window,
        softcap=softcap)
    return out.transpose(1, 2)


def cp_kv_slice(offset: int, s_loc: int, skv: int, causal: bool,
                window: Optional[int]) -> Tuple[int, int]:
    """(first key, key count) that context-parallel queries at positions
    ``offset .. offset + s_loc - 1`` attend to among ``skv`` gathered
    keys: a causal windowed layer keeps ``window + s_loc`` of them from
    ``clip(offset + s_loc - klen, 0, skv - klen)``, as the reference
    slices them; every other layer keeps all."""
    klen = min((window or skv) + s_loc, skv) if causal else skv
    if not causal or klen >= skv:
        return 0, skv
    return min(max(offset + s_loc - klen, 0), skv - klen), klen


def cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """Context-parallel attention (the reference's ``cp_attention``):
    q, k, v [B,s_loc,H(kv),dh] hold this rank's sequence shard (rank
    ``i`` of the ``SEQ`` axes: rows ``i s_loc .. (i+1) s_loc - 1``); K and
    V are all-gathered once (the backward reduce-scatters their
    cotangents), sliced to ``cp_kv_slice``'s keys and attended through
    ``kernels/flash_attention`` with ``q_offset`` = the shard's first
    position within them -> [B,s_loc,H,dh]."""
    lay = sh.current_layout()
    s_loc = q.shape[1]
    offset = lay.rules.coordinate(lay.seq) * s_loc
    k_all = sh.gather_along(k, 1, lay.seq, lay.rules)
    v_all = sh.gather_along(v, 1, lay.seq, lay.rules)
    start, klen = cp_kv_slice(offset, s_loc, k_all.shape[1], causal, window)
    out = flash_ops.flash_attention(
        q.transpose(1, 2).contiguous(),
        k_all[:, start:start + klen].transpose(1, 2).contiguous(),
        v_all[:, start:start + klen].transpose(1, 2).contiguous(),
        causal=causal, window=window, softcap=softcap,
        q_offset=offset - start)
    return out.transpose(1, 2)


def prefix_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, ck: torch.Tensor,
                             cv: torch.Tensor, off, *,
                             softcap: Optional[float] = None
                             ) -> torch.Tensor:
    """Suffix-prefill attention against a shared-prefix KV context.

    q/k/v [B,S,H(kv),dh] carry the suffix tokens at absolute positions
    ``off + i`` (rope applied); ck/cv [B,C,Hkv,dh] are the prefix KV
    gathered from the paged pool in block order, so context token ``j``
    sits at position ``j`` and is valid iff ``j < off`` (the tail is
    trash-page padding).  ``off`` is a host int or a 0-d tensor.  Plain
    torch ops in the reference's order: repeat kv by the group, fp32
    scores, softcap, mask, softmax."""
    b, s, h, dh = q.shape
    c = ck.shape[1]
    g = h // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
        ck = ck.repeat_interleave(g, dim=2)
        cv = cv.repeat_interleave(g, dim=2)
    kall = torch.cat([ck.to(q.dtype), k], dim=1)
    vall = torch.cat([cv.to(q.dtype), v], dim=1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kall).float() * dh ** -0.5
    scores = _softcap(scores, softcap)
    ar_s = torch.arange(s, device=q.device)
    ar_c = torch.arange(c, device=q.device)
    qpos = (off + ar_s)[:, None]                              # [S,1]
    kpos = torch.cat([ar_c, off + ar_s])
    kvalid = torch.cat([ar_c < off,
                        torch.ones(s, dtype=torch.bool, device=q.device)])
    mask = (kpos[None, :] <= qpos) & kvalid[None, :]          # [S,C+S]
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(vall.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vall)


def ring_token_positions(cache_len: torch.Tensor, ring: int) -> torch.Tensor:
    """Absolute token held by each ring slot ([B, ring]): slot ``r`` holds
    the latest ``u <= t`` with ``u == r (mod ring)``; negative means never
    written.  ``cache_len`` [B] counts tokens including the current one.
    Floor-mod (``torch.remainder``) as in the reference: ``t - r`` is
    often negative."""
    t = (cache_len.long() - 1)[:, None]
    r = torch.arange(ring, device=cache_len.device)[None, :]
    return t - torch.remainder(t - r, ring)


def ring_valid(cache_len: torch.Tensor, ring: int,
               window: Optional[int]) -> torch.Tensor:
    """[B, ring] validity of a ring-ordered KV layout: written slots only,
    window-masked by absolute position."""
    u = ring_token_positions(cache_len, ring)
    valid = u >= 0
    if window is not None:
        valid = valid & (u > (cache_len.long() - 1)[:, None] - window)
    return valid


def paged_ring_blocks(window: Optional[int], max_blocks: int,
                      page_size: int, spec_slack: int = 0) -> int:
    """Logical ring width in pages of a paged layer; must agree with
    ``serve/cache.CacheSpec``'s per-layer ``ring_blocks``."""
    if window is None:
        return max_blocks
    return min(max_blocks, -(-(window + spec_slack) // page_size))


def page_group_key(ring_blocks: int) -> str:
    """Key of the pool group with the given ring width."""
    return f"ring{ring_blocks}"


def kv_pool_qmax(pool_dtype: torch.dtype) -> Optional[float]:
    """Symmetric quantization range of an 8-bit pool dtype; ``None`` for
    a pool that stores K/V directly and carries no scale pool."""
    if pool_dtype == torch.int8:
        return 127.0
    if pool_dtype == torch.float8_e4m3fn:
        return 448.0
    return None


def quantize_pages(x: torch.Tensor, pool_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize full pages to an 8-bit pool dtype with per-(page, kv-head)
    symmetric amax scales: x [..., P, Hkv, dh] -> (q [..., P, Hkv, dh]
    ``pool_dtype``, scale [..., Hkv] fp32) with ``x ~= q * scale``.  The
    reference's order of operations, so codes and scales are bitwise
    equal to its: amax, floor 1e-30, / qmax, divide, clip, round (int8),
    cast.  The floor keeps all-zero pages (and the trash page) at a
    finite scale, so they round-trip to exact zeros."""
    qmax = kv_pool_qmax(pool_dtype)
    x = x.float()
    amax = x.abs().amax(dim=(-3, -1))
    scale = torch.clamp(amax, min=1e-30) / qmax
    y = x / scale[..., None, :, None]
    y = torch.clamp(y, -qmax, qmax)  # pre-clip: round(127.49) must not hit 128
    if pool_dtype == torch.int8:
        y = torch.round(y)
    return y.to(pool_dtype), scale


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`: q [..., P, Hkv, dh] 8-bit,
    scale [..., Hkv] -> fp32 [..., P, Hkv, dh]."""
    return q.float() * scale[..., None, :, None]


def put_pages(pool: torch.Tensor, idx: torch.Tensor,
              pages: torch.Tensor) -> None:
    """``pool[idx] = pages`` in place, through a uint8 view for 8-bit
    pools (as ``take_pages``)."""
    if pool.element_size() == 1:
        pool.view(torch.uint8)[idx.long()] = pages.view(torch.uint8)
    else:
        pool[idx.long()] = pages


def rmw_quantized_pages(pool: torch.Tensor, scales: torch.Tensor,
                        phys: torch.Tensor, new_vals: torch.Tensor,
                        wrote: torch.Tensor) -> None:
    """Re-quantizing read-modify-write of whole pages, in place.

    Gathers the ``phys`` pages [...] from ``pool`` [npg+1, P, Hkv, dh],
    dequantizes them with ``scales`` [npg+1, Hkv], overlays ``new_vals``
    [..., P, Hkv, dh] where ``wrote`` [..., P] is set, recomputes each
    page's amax scale and scatters pages and scales back.  Every page is
    read before any is written.  Distinct non-trash entries of ``phys``
    name distinct pages (shared pages go copy-on-write at admission);
    duplicate trash entries race benignly: the trash page is never
    attended and its scale stays finite."""
    ex = dequantize_pages(take_pages(pool, phys), scales[phys.long()])
    merged = torch.where(wrote[..., None, None], new_vals.float(), ex)
    q, s = quantize_pages(merged, pool.dtype)
    put_pages(pool, phys, q)
    scales[phys.long()] = s


def paged_decode_step(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
                      cache: Dict, cache_len: torch.Tensor, *,
                      window: Optional[int], softcap: Optional[float],
                      paged_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Dict]:
    """``S``-token attention against a block-paged KV pool (``S == 1``:
    one decode token per slot; ``S > 1``: a fused chunk's prompt slice or
    verify rows, newest last).

    cache: {"pk","pv": [num_pages+1, P, Hkv, dh], "pt": [B, ring_blocks],
    optional "wm": [B] or [B,S] bool write mask, optional "ks","vs":
    [num_pages+1, Hkv] fp32 scales of 8-bit pools}.  Writes the new KV
    through the page table **in place** (write-then-attend), redirecting
    masked rows — and, for ``S > 1``, writes past a ring that must not
    wrap — to the trash page, then attends.  8-bit pools are written by
    re-quantizing every touched page (``rmw_quantized_pages``) and read
    with their scales.  The returned cache carries the pools and, when
    quantized, the scale pools."""
    pool_k, pool_v, pt = cache["pk"], cache["pv"], cache["pt"]
    ks, vs = cache.get("ks"), cache.get("vs")
    quant = ks is not None
    b, s = q.shape[0], q.shape[1]
    page_size = pool_k.shape[1]
    trash = pool_k.shape[0] - 1
    wm = cache.get("wm")
    new = {"pk": pool_k, "pv": pool_v}
    if quant:
        new["ks"], new["vs"] = ks, vs

    if s == 1:
        blocks = paged_ring_blocks(window, pt.shape[1], page_size)
        ring = blocks * page_size
        table = pt[:, :blocks]
        t = cache_len.long() - 1                              # [B]
        lb = torch.remainder(torch.div(t, page_size, rounding_mode="floor"),
                             blocks)
        phys = torch.gather(table.long(), 1, lb[:, None])[:, 0]
        if wm is not None:
            phys = torch.where(wm, phys, trash)                # dead -> trash
        off = torch.remainder(t, page_size)
        if quant:
            # one-page overlay per slot, then re-quantize the page
            bi = torch.arange(b, device=q.device)
            wrote = off[:, None] == torch.arange(page_size,
                                                 device=q.device)[None, :]
            shape = (b, page_size) + tuple(kk.shape[2:])
            nk = torch.zeros(shape, dtype=torch.float32, device=q.device)
            nv = torch.zeros(shape, dtype=torch.float32, device=q.device)
            nk[bi, off] = kk[:, 0].float()
            nv[bi, off] = vv[:, 0].float()
            rmw_quantized_pages(pool_k, ks, phys, nk, wrote)
            rmw_quantized_pages(pool_v, vs, phys, nv, wrote)
        else:
            pool_k[phys, off] = kk[:, 0].to(pool_k.dtype)
            pool_v[phys, off] = vv[:, 0].to(pool_v.dtype)
        if paged_kernel:
            out = paged_attention(q[:, 0].contiguous(), pool_k, pool_v,
                                  table.contiguous(), cache_len,
                                  window=window, softcap=softcap,
                                  k_scale=ks, v_scale=vs)
            return out[:, None], new
        ck, cv = _gather_ring(pool_k, pool_v, table, ring, ks, vs)
        return decode_attention(q, ck, cv, softcap=softcap,
                                valid=ring_valid(cache_len, ring, window)), new

    # multi-row step: the table is the layer's own group table, so its
    # width IS the ring width
    blocks = pt.shape[1]
    ring = blocks * page_size
    g_pos = ((cache_len.long() - s)[:, None]
             + torch.arange(s, device=q.device)[None, :])       # [B,S] abs
    lb = torch.remainder(torch.div(g_pos, page_size, rounding_mode="floor"),
                         blocks)
    phys = torch.gather(pt.long(), 1, lb)                      # [B,S]
    ok = torch.ones_like(g_pos, dtype=torch.bool)
    if not (window is not None and ring >= window + s - 1):
        ok = ok & (g_pos < ring)        # non-wrapping ring: no write aliasing
    if wm is not None:
        ok = ok & (wm if wm.dim() == 2 else wm[:, None])
    off = torch.remainder(g_pos, page_size)
    if quant:
        _write_quantized_rows(pool_k, pool_v, ks, vs, pt, kk, vv, g_pos, off,
                              ok, trash)
    else:
        phys = torch.where(ok, phys, trash)
        pool_k[phys, off] = kk.to(pool_k.dtype)
        pool_v[phys, off] = vv.to(pool_v.dtype)
    if paged_kernel:
        out = paged_attention(q.contiguous(), pool_k, pool_v, pt, cache_len,
                              window=window, softcap=softcap,
                              k_scale=ks, v_scale=vs)
        return out, new
    ck, cv = _gather_ring(pool_k, pool_v, pt, ring, ks, vs)
    u = ring_token_positions(cache_len, ring)                  # [B, ring]
    valid = (u >= 0)[:, None, :] & (u[:, None, :] <= g_pos[:, :, None])
    if window is not None:
        valid = valid & (u[:, None, :] > g_pos[:, :, None] - window)
    return decode_attention(q, ck, cv, softcap=softcap, valid=valid), new


def _write_quantized_rows(pool_k, pool_v, ks, vs, pt, kk, vv, g_pos, off,
                          ok, trash) -> None:
    """S-row write into 8-bit pools, page-granular: the S tokens of a row
    touch at most ``J = (S-1)//P + 2`` consecutive logical pages from the
    page of its earliest token.  Tokens are scattered into per-page fp32
    overlays, then each touched page is re-quantized once.  Rows that are
    not ``ok`` mark nothing written, and a page none of them touches goes
    to the trash page."""
    b, s = g_pos.shape
    page_size = pool_k.shape[1]
    blocks = pt.shape[1]
    dev = g_pos.device
    J = (s - 1) // page_size + 2
    page = torch.div(g_pos, page_size, rounding_mode="floor")
    base = page[:, :1]                                   # [B,1] earliest
    jtok = page - base                                   # [B,S] in [0, J)
    lp = base + torch.arange(J, device=dev)[None, :]     # [B,J] logical
    bi = torch.arange(b, device=dev)[:, None]
    page_live = torch.zeros((b, J), dtype=torch.int32, device=dev)
    page_live = page_live.scatter_add_(1, jtok, ok.to(torch.int32)) > 0
    if J > blocks:
        # a ring narrower than the touched span aliases: of logical pages
        # congruent mod `blocks`, only the newest may be written
        page_live = page_live & (torch.arange(J, device=dev)[None, :]
                                 + blocks >= J)
    pphys = torch.gather(pt.long(), 1, torch.remainder(lp, blocks))
    pphys = torch.where(page_live, pphys, trash)
    wrote = torch.zeros((b, J, page_size), dtype=torch.bool, device=dev)
    wrote[bi, jtok, off] = ok
    shape = (b, J, page_size) + tuple(kk.shape[2:])
    nk = torch.zeros(shape, dtype=torch.float32, device=dev)
    nv = torch.zeros(shape, dtype=torch.float32, device=dev)
    nk[bi, jtok, off] = kk.float()
    nv[bi, jtok, off] = vv.float()
    rmw_quantized_pages(pool_k, ks, pphys, nk, wrote)
    rmw_quantized_pages(pool_v, vs, pphys, nv, wrote)


def _gather_ring(pool_k, pool_v, table, ring, ks=None, vs=None):
    """Gather each slot's logical ring, dequantized when the pools are
    8-bit: -> [B, Hkv, ring, dh] K and V."""
    b = table.shape[0]
    gk = take_pages(pool_k, table)          # [B, blocks, P, Hkv, dh]
    gv = take_pages(pool_v, table)
    if ks is not None:
        gk = dequantize_pages(gk, ks[table.long()])
        gv = dequantize_pages(gv, vs[table.long()])
    gk = gk.reshape(b, ring, *pool_k.shape[2:])
    gv = gv.reshape(b, ring, *pool_v.shape[2:])
    return gk.transpose(1, 2), gv.transpose(1, 2)


def apply(params, x: torch.Tensor, *, cfg: ModelConfig,
          window: Optional[int], positions: torch.Tensor, mode: str,
          cache: Optional[Dict] = None,
          cache_len: Optional[torch.Tensor] = None,
          causal: bool = True, q_chunk: Optional[int] = None,
          ctx: Optional[Dict] = None, paged_kernel: bool = False
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B,S,d] -> (y [B,S,d], new_cache).

    ``mode="prefill"`` returns the new KV as ``{"k","v": [B,Hkv,S,dh]}``;
    with ``ctx`` (``{"pk","pv", optional "ks","vs": pool, "row": [Cb]
    page ids, "off": prefix length}``) the layer's queries sit at
    ``off + i`` (``positions`` already carry the offset) and attend to
    the ``off`` prefix tokens gathered from the pool.  ``mode="decode"``
    over a paged cache (``"pk"``; ``paged_kernel``: read it through the
    kernel) takes S >= 1 rows; over a dense cache (``{"k","v":
    [B,Hkv,T,dh]}``, the model drafter's) one row, written in place at
    ``(cache_len - 1) mod T``.  ``mode="dense"`` attends over ``x``
    alone (``causal``: query ``i`` at position ``i``; whisper's encoder
    passes ``causal=False``) and returns no cache."""
    if mode not in ("dense", "prefill", "decode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    lay = sh.current_layout()
    if lay is not None and (mode != "dense" or ctx is not None):
        raise NotImplementedError(
            "a sharded step runs the dense mode only (training)")
    wq, wk = sh.full(params["wq"]), sh.full(params["wk"])
    wv, wo = sh.full(params["wv"]), sh.full(params["wo"])
    pl = sh.placement(params["wq"])
    entry = None if pl is None else pl.entry(1)
    x = sh.tp_in(x, entry, "the query heads")
    h = wq.shape[1]                 # this rank's query heads
    if lay is not None and entry is not None and \
            wk.shape[1] * cfg.num_heads != cfg.num_kv_heads * h:
        sl = _local_kv(params["wk"], cfg, entry, h, lay.rules)
        wk, wv = wk[:, sl], wv[:, sl]
    b, s, d = x.shape
    hkv, dh = wk.shape[1], cfg.resolved_head_dim
    x2 = x.reshape(b * s, d)
    q = torch.matmul(x2, wq.reshape(d, h * dh)).view(b, s, h, dh)
    kk = torch.matmul(x2, wk.reshape(d, hkv * dh)).view(b, s, hkv, dh)
    vv = torch.matmul(x2, wv.reshape(d, hkv * dh)).view(b, s, hkv, dh)
    q = rope(q, positions, cfg.rope_theta)
    kk = rope(kk, positions, cfg.rope_theta)
    if mode == "decode" and "pk" in cache:
        out, new_cache = paged_decode_step(
            q, kk, vv, cache, cache_len, window=window,
            softcap=cfg.attn_softcap, paged_kernel=paged_kernel)
    elif mode == "decode":
        if s != 1:
            raise NotImplementedError(
                "multi-token decode (speculative verify) needs a paged "
                "cache; the dense ring-buffer path is single-token only")
        size = cache["k"].shape[2]
        # a windowed layer may keep a ring of ``window`` entries; keys
        # carry absolute rope positions, so entry order does not matter
        # and ring occupancy enforces the window
        idx = torch.remainder(cache_len.long() - 1, size)
        ck = _update_cache(cache["k"], kk.transpose(1, 2), idx)
        cv = _update_cache(cache["v"], vv.transpose(1, 2), idx)
        ring = window is not None and size <= window
        out = decode_attention(q, ck, cv, cache_len,
                               window=None if ring else window,
                               softcap=cfg.attn_softcap)
        new_cache = {"k": ck, "v": cv}
    elif ctx is not None:
        # prefix sharing: gather the matched prefix KV from the paged pool
        # (block order is position order in the non-wrapping full-attention
        # group) and prefill only the suffix against it
        gk = take_pages(ctx["pk"], ctx["row"])          # [Cb, P, Hkv, dh]
        gv = take_pages(ctx["pv"], ctx["row"])
        if ctx.get("ks") is not None:       # 8-bit pool: dequantize pages
            gk = dequantize_pages(gk, ctx["ks"][ctx["row"].long()])
            gv = dequantize_pages(gv, ctx["vs"][ctx["row"].long()])
        cb, psz = gk.shape[0], gk.shape[1]
        ck = gk.reshape(1, cb * psz, *gk.shape[2:])
        cv = gv.reshape(1, cb * psz, *gv.shape[2:])
        out = prefix_prefill_attention(q, kk, vv, ck, cv, ctx["off"],
                                       softcap=cfg.attn_softcap)
        new_cache = {"k": kk.transpose(1, 2), "v": vv.transpose(1, 2)}
    elif lay is not None and lay.cp:
        out = cp_attention(q, kk, vv, causal=causal, window=window,
                           softcap=cfg.attn_softcap)
        new_cache = None
    else:
        out = chunked_attention(q, kk, vv, causal=causal, window=window,
                                softcap=cfg.attn_softcap, q_chunk=q_chunk)
        new_cache = None if mode == "dense" else {
            "k": kk.transpose(1, 2), "v": vv.transpose(1, 2)}
    y = torch.matmul(out.reshape(b * s, h * dh),
                     wo.reshape(h * dh, d)).view(b, s, d)
    return sh.tp_out(y, entry, "the query heads"), new_cache


def _local_kv(wk: torch.Tensor, cfg: ModelConfig, entry, h_loc: int,
              rules) -> slice:
    """The slice of ``wk``'s (local) KV heads that this rank's ``h_loc``
    query heads (its coordinate on ``entry``) group to, when the model
    axis does not shard the KV heads as it shards the query heads."""
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    g = h // hkv
    want = max(1, hkv * h_loc // h)
    if h_loc < g and g % h_loc:
        raise NotImplementedError(
            f"{h_loc} query heads a rank straddle groups of {g}")
    first = rules.coordinate(entry) * h_loc // g
    pl = sh.placement(wk)
    stored = rules.local_range(pl.spec, pl.shape, 1)[0]
    return slice(first - stored, first - stored + want)


def init_cache_shape(cfg: ModelConfig, batch: int,
                     max_len: int) -> Tuple[int, int, int, int]:
    """Shape of one layer's dense decode cache (K or V)."""
    return (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)


def _update_cache(cache: torch.Tensor, new: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [B,Hkv,1,dh] at sequence position ``idx`` [B] of
    ``cache`` [B,Hkv,T,dh], in place; returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, idx] = new[:, :, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper's decoder)
# ---------------------------------------------------------------------------

def cross_attn_defs(cfg: ModelConfig) -> Dict:
    return attn_defs(cfg)


def cross_apply(params, x: torch.Tensor, enc_kv: Dict, *,
                cfg: ModelConfig) -> torch.Tensor:
    """x [B,S,d]; enc_kv ``{"k","v": [B,Hkv,Senc,dh]}`` precomputed by
    :func:`encode_kv` -> y [B,S,d].  No rope and no mask: every query row
    sees every encoder position.  ``enc_kv`` is already in the flash
    kernel's layout, so it goes to the kernel as it is (``contiguous`` is
    a no-op on ``encode_kv``'s tensors)."""
    b, s, d = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q = torch.matmul(x.reshape(b * s, d), params["wq"].reshape(d, h * dh))
    q = q.view(b, s, h, dh).transpose(1, 2).contiguous()
    out = flash_ops.flash_attention(
        q, enc_kv["k"].to(q.dtype).contiguous(),
        enc_kv["v"].to(q.dtype).contiguous(), causal=False)
    return torch.matmul(out.transpose(1, 2).reshape(b * s, h * dh),
                        params["wo"].reshape(h * dh, d)).view(b, s, d)


def encode_kv(params, enc_out: torch.Tensor, *, cfg: ModelConfig) -> Dict:
    """The encoder output [B,Senc,d] projected once per decoder layer:
    ``{"k","v": [B,Hkv,Senc,dh]}``, contiguous."""
    b, s, d = enc_out.shape
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    x2 = enc_out.reshape(b * s, d)

    def proj(w):
        y = torch.matmul(x2, w.reshape(d, hkv * dh)).view(b, s, hkv, dh)
        return y.transpose(1, 2).contiguous()

    return {"k": proj(params["wk"]), "v": proj(params["wv"])}
