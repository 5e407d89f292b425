"""Model assembly for the port: decoder stacks of attention blocks with
dense or MoE FFNs over block-paged KV (counterpart of
``repro/models/transformer.py``).

Entry points (functions of ``(params, cfg, tokens, cache)``):
    forward_decode(params, cfg, tokens [B,1], cache)  -> (logits [B,V], cache)
    forward_verify(params, cfg, tokens [B,S], cache)  -> (logits [B,S,V], cache)

Both update the cache's pools in place.  Other mixers (mamba2, rwkv6,
shared attention), other FFNs, encoders and the dense prefill/train
passes are not ported yet and raise (ROADMAP A13, A15).  Serving drops
the MoE router's aux values, as the reference's ``forward_verify`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE, BlockSpec,
                                      ModelConfig)
from repro_torch.models import attention, layers, moe


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.cross_attention or cfg.enc_layers or cfg.frontend \
            or cfg.num_shared_groups:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention, modality frontends and "
            "shared blocks are not ported yet (ROADMAP A13)")
    for b in cfg.blocks:
        if b.mixer != ATTN or b.ffn not in (FFN_DENSE, FFN_MOE):
            raise NotImplementedError(
                f"{cfg.name}: a {b.mixer}/{b.ffn} block is not ported yet; "
                "the port runs attention blocks with dense or MoE FFNs "
                "(ROADMAP A13)")


def _block_defs(cfg: ModelConfig, block: BlockSpec) -> Dict:
    ffn = moe.moe_defs(cfg) if block.ffn == FFN_MOE else layers.mlp_defs(cfg)
    return {"ln1": layers.rmsnorm_defs(cfg.d_model),
            "mixer": attention.attn_defs(cfg),
            "ln2": layers.rmsnorm_defs(cfg.d_model),
            "ffn": ffn}


def model_defs(cfg: ModelConfig) -> Dict:
    _check_supported(cfg)
    return {"embed": layers.embedding_defs(cfg),
            "final_ln": layers.rmsnorm_defs(cfg.d_model),
            "layers": [_block_defs(cfg, b) for b in cfg.blocks]}


def _apply_block(lp, h: torch.Tensor, cfg: ModelConfig, block: BlockSpec, *,
                 positions: torch.Tensor, cache: Dict,
                 cache_len: torch.Tensor, paged_kernel: bool
                 ) -> Tuple[torch.Tensor, Dict]:
    """One decoder layer (pre-norm attention, then a pre-norm SwiGLU or
    MoE FFN; the MoE aux values are dropped)."""
    xn = layers.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    y, new_cache = attention.apply(
        lp["mixer"], xn, cfg=cfg, window=block.window, positions=positions,
        mode="decode", cache=cache, cache_len=cache_len,
        paged_kernel=paged_kernel)
    h = h + y
    xn = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if block.ffn == FFN_MOE:
        y, _aux = moe.apply(lp["ffn"], xn, cfg)
    else:
        y = layers.mlp(lp["ffn"], xn)
    return h + y, new_cache


def _decoder(params, cfg: ModelConfig, h: torch.Tensor, *,
             positions: torch.Tensor, caches: List,
             cache_len: torch.Tensor, paged_kernel: bool
             ) -> Tuple[torch.Tensor, List]:
    new_caches: List = []
    for i, block in enumerate(cfg.blocks):
        h, nc = _apply_block(params["layers"][i], h, cfg, block,
                             positions=positions, cache=caches[i],
                             cache_len=cache_len, paged_kernel=paged_kernel)
        new_caches.append(nc)
    return layers.rmsnorm(params["final_ln"], h, cfg.norm_eps), new_caches


def _thread_page_tables(cfg: ModelConfig, cache: Dict,
                        write_mask: Optional[torch.Tensor],
                        spec_slack: int = 0) -> List:
    """Thread each paged layer's pool-group page table (keyed by ring
    width) and the optional write mask into its cache view."""
    page_tables = cache.get("page_tables")
    layer_caches = cache["layers"]
    if not page_tables:
        return layer_caches
    widest = max(t.shape[1] for t in page_tables.values())
    threaded = []
    for block, c in zip(cfg.blocks, layer_caches):
        if c is not None and "pk" in c:
            ring = attention.paged_ring_blocks(
                block.window, widest, c["pk"].shape[1], spec_slack)
            c = dict(c, pt=page_tables[attention.page_group_key(ring)])
            if write_mask is not None:
                c["wm"] = write_mask
        threaded.append(c)
    return threaded


def forward_decode(params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: Dict, write_mask: Optional[torch.Tensor] = None,
                   paged_kernel: bool = False
                   ) -> Tuple[torch.Tensor, Dict]:
    """tokens [B,1]; ``cache["len"]`` counts tokens already cached.  Writes
    the new KV through the page tables and returns next-token logits
    [B,V] and the cache with ``len`` advanced by one."""
    cache_len = cache["len"] + 1
    positions = cache["len"][:, None]
    layer_caches = _thread_page_tables(cfg, cache, write_mask)
    h = layers.embed(params["embed"], cfg, tokens)
    h, new_caches = _decoder(params, cfg, h, positions=positions,
                             caches=layer_caches, cache_len=cache_len,
                             paged_kernel=paged_kernel)
    lg = layers.logits(params["embed"], cfg, h)
    return lg[:, 0], dict(cache, layers=new_caches, len=cache_len)


def verify_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Dict, write_mask: Optional[torch.Tensor] = None,
                  paged_kernel: bool = False, spec_slack: int = 0,
                  n_rows: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """:func:`forward_verify` up to the final norm: returns the hidden
    states [B,S,d], so a caller that samples one row pays the LM head for
    that row only."""
    b, s = tokens.shape
    cols = torch.arange(s, device=tokens.device, dtype=torch.int32)[None, :]
    if n_rows is None:
        cache_len = cache["len"] + s
        positions = cache["len"][:, None] + cols
    else:
        n_rows = n_rows.to(torch.int32)
        cache_len = cache["len"] + n_rows
        positions = torch.clamp(
            cache["len"][:, None] + cols - (s - n_rows)[:, None], min=0)
    layer_caches = _thread_page_tables(cfg, cache, write_mask, spec_slack)
    h = layers.embed(params["embed"], cfg, tokens)
    h, new_caches = _decoder(params, cfg, h, positions=positions,
                             caches=layer_caches, cache_len=cache_len,
                             paged_kernel=paged_kernel)
    return h, dict(cache, layers=new_caches)


def forward_verify(params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: Dict, write_mask: Optional[torch.Tensor] = None,
                   paged_kernel: bool = False, spec_slack: int = 0,
                   n_rows: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """Run ``S`` tokens per slot in one pass.  tokens [B,S]; token ``i``
    sits at absolute position ``cache["len"] + i`` and its KV is written
    through the page table (write-then-attend with a per-row causal ring
    mask).  Returns logits for all ``S`` rows ([B,S,V], fp32) and the
    cache with ``len`` UNCHANGED (the caller owns the length update).

    ``spec_slack`` must equal the ``spec_tokens`` the ``CacheSpec`` was
    built with.  ``n_rows`` [B] (fused prefill+decode chunks): per-slot
    count of real rows, right-aligned — slot ``b``'s live tokens occupy
    rows ``S - n_rows[b] .. S - 1``; ``cache_len`` becomes
    ``len + n_rows`` and leading pad rows clip to position 0 (they must
    be write-masked through a 2-D ``write_mask``)."""
    h, new_cache = verify_hidden(params, cfg, tokens, cache,
                                 write_mask=write_mask,
                                 paged_kernel=paged_kernel,
                                 spec_slack=spec_slack, n_rows=n_rows)
    return layers.logits(params["embed"], cfg, h), new_cache


__all__ = ["model_defs", "forward_decode", "forward_verify",
           "verify_hidden"]
