"""Model assembly for the port: decoder stacks of attention blocks with
dense or MoE FFNs, the zamba2 hybrid (Mamba2 backbone + shared
attention blocks) and the attention-free rwkv6 stack (time-mix +
channel-mix), over block-paged KV and dense recurrent state
(counterpart of ``repro/models/transformer.py``).

Entry points:
    forward_prefill(params, cfg, {"tokens": [B,S]}, length=, ctx=)
                                   -> (last-token logits [B,V], cache)
    forward_decode(params, cfg, tokens [B,1], cache)  -> (logits [B,V], cache)
    forward_verify(params, cfg, tokens [B,S], cache)  -> (logits [B,S,V], cache)

``forward_prefill`` is the two-executable engine's bucketed prefill (its
attention runs ``kernels/flash_attention`` on the card, or a suffix
prefill against paged context; its Mamba2 layers run
``kernels/mamba2_scan``, its rwkv6 layers ``kernels/rwkv6_wkv``); it
returns per-layer KV for the splice and each recurrent layer's state.
``forward_decode`` writes KV into the pools (or a dense per-slot cache)
in place and returns new state tensors for the Mamba2 and rwkv6 layers.
``forward_verify`` runs attention-only stacks (the fused chunk and the
speculative verify).  Encoders, cross-attention,
modality frontends and the train pass are not ported yet and raise
(A13, A15).  Serving drops the MoE router's aux values, as the
reference's entry points do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE, FFN_NONE,
                                      FFN_RWKV, MAMBA2, RWKV6, SHARED_ATTN,
                                      BlockSpec, ModelConfig)
from repro_torch.models import attention, layers, mamba2, moe, rwkv6
from repro_torch.models.module import ParamDef

_PORTED = {(ATTN, FFN_DENSE), (ATTN, FFN_MOE), (MAMBA2, FFN_NONE),
           (SHARED_ATTN, FFN_DENSE), (RWKV6, FFN_RWKV)}


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.cross_attention or cfg.enc_layers or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention and modality frontends "
            "are not ported yet (ROADMAP A13)")
    for b in cfg.blocks:
        if (b.mixer, b.ffn) not in _PORTED:
            raise NotImplementedError(
                f"{cfg.name}: a {b.mixer}/{b.ffn} block is not ported yet; "
                "the port runs attention blocks with dense or MoE FFNs, "
                "Mamba2 blocks, shared attention blocks and rwkv6 blocks "
                "(ROADMAP A13)")


def _block_defs(cfg: ModelConfig, block: BlockSpec) -> Dict:
    """The reference's per-layer keys: a shared attention layer keeps
    only its (unused) ``ln1``, its weights live in ``shared``."""
    defs: Dict = {"ln1": layers.rmsnorm_defs(cfg.d_model)}
    if block.mixer == ATTN:
        defs["mixer"] = attention.attn_defs(cfg)
    elif block.mixer == MAMBA2:
        defs["mixer"] = mamba2.mamba2_defs(cfg)
    elif block.mixer == RWKV6:
        defs["mixer"] = rwkv6.time_mix_defs(cfg)
    if block.ffn != FFN_NONE and block.mixer != SHARED_ATTN:
        defs["ln2"] = layers.rmsnorm_defs(cfg.d_model)
        if block.ffn == FFN_MOE:
            defs["ffn"] = moe.moe_defs(cfg)
        elif block.ffn == FFN_RWKV:
            defs["ffn"] = rwkv6.channel_mix_defs(cfg)
        else:
            defs["ffn"] = layers.mlp_defs(cfg)
    return defs


def _shared_group_defs(cfg: ModelConfig) -> Dict:
    """zamba2's shared transformer block: attention + MLP on
    ``concat(h, h0) @ proj_in``."""
    d = cfg.d_model
    return {"proj_in": ParamDef((2 * d, d)),
            "ln_attn": layers.rmsnorm_defs(d),
            "attn": attention.attn_defs(cfg),
            "ln_mlp": layers.rmsnorm_defs(d),
            "mlp": layers.mlp_defs(cfg)}


def model_defs(cfg: ModelConfig) -> Dict:
    _check_supported(cfg)
    defs = {"embed": layers.embedding_defs(cfg),
            "final_ln": layers.rmsnorm_defs(cfg.d_model),
            "layers": [_block_defs(cfg, b) for b in cfg.blocks]}
    if cfg.num_shared_groups:
        defs["shared"] = [_shared_group_defs(cfg)
                          for _ in range(cfg.num_shared_groups)]
    return defs


def _apply_block(lp, shared, h: torch.Tensor, h0: torch.Tensor,
                 cfg: ModelConfig, block: BlockSpec, *, mode: str,
                 positions: torch.Tensor, cache: Optional[Dict],
                 cache_len: Optional[torch.Tensor], paged_kernel: bool,
                 length: Optional[torch.Tensor] = None,
                 ctx: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One decoder layer.  Attention: pre-norm attention, then a pre-norm
    SwiGLU or MoE FFN (the MoE aux values are dropped).  Mamba2: a
    pre-norm Mamba2 mixer and no FFN (``length``: the true lengths of a
    right-padded prefill).  rwkv6: a pre-norm time-mix, then a pre-norm
    channel-mix, their states ``{tshift, wkv}`` and ``{cshift}`` merged
    into one dict.  Shared attention: the block of
    ``shared[block.shared_group]`` on ``concat(h, h0)``, where ``h0`` is
    the embedding output."""
    if block.mixer == SHARED_ATTN:
        sp = shared[block.shared_group]
        d = h.shape[-1]
        xin = torch.cat([h, h0], dim=-1)
        x = torch.matmul(xin.reshape(-1, 2 * d),
                         sp["proj_in"].to(h.dtype)).view(h.shape)
        y, new_cache = attention.apply(
            sp["attn"], layers.rmsnorm(sp["ln_attn"], x, cfg.norm_eps),
            cfg=cfg, window=block.window, positions=positions, mode=mode,
            cache=cache, cache_len=cache_len, paged_kernel=paged_kernel)
        x = x + y
        x = x + layers.mlp(sp["mlp"],
                           layers.rmsnorm(sp["ln_mlp"], x, cfg.norm_eps))
        return h + x, new_cache
    if ctx is not None and block.mixer != ATTN:
        raise ValueError(
            f"a suffix prefill reached a {block.mixer} layer; only pure "
            "full-attention stacks are sharing-capable")
    xn = layers.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    if block.mixer == MAMBA2:
        y, new_cache = mamba2.apply(lp["mixer"], xn, cfg, mode=mode,
                                    state=cache, length=length)
        return h + y, new_cache
    if block.mixer == RWKV6:
        y, tm_state = rwkv6.time_mix(lp["mixer"], xn, cfg, mode=mode,
                                     state=cache, length=length)
        h = h + y
        y, cm_state = rwkv6.channel_mix(
            lp["ffn"], layers.rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg,
            mode=mode, state=cache, length=length)
        new_cache = None if tm_state is None else {**tm_state, **cm_state}
        return h + y, new_cache
    y, new_cache = attention.apply(
        lp["mixer"], xn, cfg=cfg, window=block.window, positions=positions,
        mode=mode, cache=cache, cache_len=cache_len, ctx=ctx,
        paged_kernel=paged_kernel)
    h = h + y
    xn = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if block.ffn == FFN_MOE:
        y, _aux = moe.apply(lp["ffn"], xn, cfg)
    else:
        y = layers.mlp(lp["ffn"], xn)
    return h + y, new_cache


def _decoder(params, cfg: ModelConfig, h: torch.Tensor, *, mode: str,
             positions: torch.Tensor, caches: Optional[List],
             cache_len: Optional[torch.Tensor], paged_kernel: bool = False,
             length: Optional[torch.Tensor] = None,
             ctx_list: Optional[List] = None
             ) -> Tuple[torch.Tensor, List]:
    h0 = h
    shared = params["shared"] if "shared" in params else None
    new_caches: List = []
    for i, block in enumerate(cfg.blocks):
        h, nc = _apply_block(
            params["layers"][i], shared, h, h0, cfg, block, mode=mode,
            positions=positions,
            cache=caches[i] if caches is not None else None,
            cache_len=cache_len, paged_kernel=paged_kernel, length=length,
            ctx=ctx_list[i] if ctx_list is not None else None)
        new_caches.append(nc)
    return layers.rmsnorm(params["final_ln"], h, cfg.norm_eps), new_caches


def prefill_hidden(params, cfg: ModelConfig, batch: Dict, *,
                   length: Optional[torch.Tensor] = None,
                   ctx: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, List]:
    """:func:`forward_prefill` up to the final norm: the hidden states of
    every position [B,S,d] and the per-layer caches, so a caller that
    needs logits at other positions than the last (a teacher-forced
    check of generated tokens) pays the LM head for those rows only."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    ctx_list = None
    if ctx is not None:
        positions = ctx["off"] + positions
        ctx_list = [None if lc is None else
                    {"pk": lc["pk"], "pv": lc["pv"], "ks": lc.get("ks"),
                     "vs": lc.get("vs"), "row": ctx["row"],
                     "off": ctx["off"]}
                    for lc in ctx["layers"]]
    h = layers.embed(params["embed"], cfg, tokens)
    return _decoder(params, cfg, h, mode="prefill", positions=positions,
                    caches=None, cache_len=None, length=length,
                    ctx_list=ctx_list)


def forward_prefill(params, cfg: ModelConfig, batch: Dict, *,
                    length: Optional[torch.Tensor] = None,
                    ctx: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Returns (last-token logits [B,V], cache).

    ``batch["tokens"]`` [B,S], right-padded to a shape bucket; ``length``
    [B] int32, their true lengths: logits are taken at ``length - 1`` and
    the cache records ``length`` (causality already hides the padding
    from every real token; Mamba2 layers take dt = 0 past it, rwkv6
    layers k = 0 and a log decay of 0).  The cache holds per-layer
    ``{"k","v"}`` [B,Hkv,S,dh] for attention layers (padding included;
    the splice drops it), ``{"conv","ssm"}`` for Mamba2 layers and
    ``{"tshift","wkv","cshift"}`` for rwkv6 layers (the state at
    ``length - 1``), and ``len``.

    ``ctx`` makes this a suffix prefill for prefix sharing: ``{"off":
    prefix length (host int), "row": [Cb] int32 page ids, "layers":
    per-layer {"pk","pv"[,"ks","vs"]} pools}``.  ``tokens`` then hold
    only the suffix, at positions ``off + i``, and each layer attends to
    the ``off`` prefix tokens through the pages named in ``row``.  The
    returned cache carries suffix KV only, for a splice at ``off``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h, caches = prefill_hidden(params, cfg, batch, length=length, ctx=ctx)
    if length is None:
        h_last = h[:, -1:]
        clen = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    else:
        idx = torch.clamp(length.long() - 1, min=0)[:, None, None]
        h_last = torch.gather(h, 1, idx.expand(b, 1, h.shape[2]))
        clen = length.to(torch.int32)
    lg = layers.logits(params["embed"], cfg, h_last)
    return lg[:, 0], {"layers": caches, "len": clen}


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
    the new KV through the page tables (a cache with ``page_tables``) or
    into a dense per-slot cache (per-layer ``{"k","v": [B,Hkv,T,dh]}``
    and no ``page_tables``: the model drafter's draft cache), and returns
    next-token logits [B,V] and the cache with ``len`` advanced by one
    and each recurrent (Mamba2, rwkv6) layer's new state (every row's:
    the write mask does not cover state, as in the reference)."""
    cache_len = cache["len"] + 1
    positions = cache["len"][:, None]
    layer_caches = _thread_page_tables(cfg, cache, write_mask)
    h = layers.embed(params["embed"], cfg, tokens)
    h, new_caches = _decoder(params, cfg, h, mode="decode",
                             positions=positions, caches=layer_caches,
                             cache_len=cache_len, paged_kernel=paged_kernel)
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
    h, new_caches = _decoder(params, cfg, h, mode="decode",
                             positions=positions, caches=layer_caches,
                             cache_len=cache_len, paged_kernel=paged_kernel)
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


__all__ = ["model_defs", "forward_prefill", "forward_decode",
           "forward_verify", "prefill_hidden", "verify_hidden"]
