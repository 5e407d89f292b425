"""Model assembly for the port: decoder stacks of attention blocks with
dense or MoE FFNs, the zamba2 hybrid (Mamba2 backbone + shared
attention blocks), the attention-free rwkv6 stack (time-mix +
channel-mix), pixtral's patch frontend and whisper's encoder and
cross-attention, over block-paged KV, dense KV and dense recurrent
state (counterpart of ``repro/models/transformer.py``).

Entry points:
    forward_train(params, cfg, batch)         -> (loss, metrics)
    forward_dense_logits(params, cfg, batch)  -> logits [B,S,V]
    forward_prefill(params, cfg, batch, length=, ctx=)
                                   -> (last-token logits [B,V], cache)
    prepare_decode_cache(cfg, cache, max_len) -> dense decode cache
    forward_decode(params, cfg, tokens [B,1], cache) -> (logits [B,V], cache)
    forward_verify(params, cfg, tokens [B,S], cache)
                                   -> (logits [B,S,V], cache)

``batch`` holds ``tokens`` [B,S] and, for a frontend arch, its stub:
``frames`` [B,F,d] (whisper: the encoder's input) or ``frontend``
[B,F,d] (pixtral: it replaces the first F token embeddings).

``forward_train`` is the training pass: the dense mode of every layer
(attention through ``kernels/flash_attention``, MoE through
``kernels/moe_gmm``, both differentiable), the mean token cross-entropy
plus 0.01 x the MoE load-balance loss.  ``forward_dense_logits`` is
the teacher-forced pass (every attention layer through
``kernels/flash_attention`` on the card, causal; whisper's encoder
non-causal).  ``forward_prefill`` is the two-executable engine's
bucketed prefill (its attention runs ``kernels/flash_attention`` on the
card, or a suffix prefill against paged context; its Mamba2 layers run
``kernels/mamba2_scan``, its rwkv6 layers ``kernels/rwkv6_wkv``); it
returns per-layer KV for the splice, each recurrent layer's state and,
for whisper, each decoder layer's cross-attention KV (``enc_kv``).
``forward_decode`` writes KV into the pools (or a dense per-slot cache)
in place and returns new state tensors for the Mamba2 and rwkv6 layers.
``forward_verify`` runs attention-only stacks (the fused chunk and the
speculative verify).  Every layer returns its MoE router's aux values;
``_decoder`` averages them over the layers in the dense mode, and only
``forward_train`` reads them.

Under ``parallel/sharding.axis_rules(rules)`` on a ``DeviceMesh`` (a
tuner plan's rules, ``core/tuner.make_rules``), ``forward_train`` runs
this rank's share of the step on parameters placed by
``sharding.place``: the batch rows of its ``BATCH`` range, the residual
stream sequence-sharded under ``seq_shard`` and ``cp`` (``Layout``), the
layers tensor-parallel (``models/layers``, ``models/attention``), and
the loss the global masked mean.  Dense attention archs only: a MoE arch
raises (ROADMAP A19: global-capacity dispatch), Mamba2 / rwkv6 stacks
(A20) and encoder or frontend archs (A23) too.  The other entry points
run on one device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE, FFN_NONE,
                                      FFN_RWKV, MAMBA2, RWKV6, SHARED_ATTN,
                                      BlockSpec, ModelConfig)
from repro_torch.models import attention, layers, mamba2, moe, rwkv6
from repro_torch.models.module import EMBED, ParamDef
from repro_torch.parallel import sharding as sh

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
    return {"proj_in": ParamDef((2 * d, d), (EMBED, None)),
            "ln_attn": layers.rmsnorm_defs(d),
            "attn": attention.attn_defs(cfg),
            "ln_mlp": layers.rmsnorm_defs(d),
            "mlp": layers.mlp_defs(cfg)}


def _encoder_block_defs(cfg: ModelConfig) -> Dict:
    return {"ln1": layers.rmsnorm_defs(cfg.d_model),
            "attn": attention.attn_defs(cfg),
            "ln2": layers.rmsnorm_defs(cfg.d_model),
            "ffn": layers.mlp_defs(cfg)}


def model_defs(cfg: ModelConfig) -> Dict:
    """The reference's tree: a cross-attention arch's decoder layers gain
    ``ln_cross`` and ``cross``, an encoder arch an ``encoder`` of learned
    positions ``pos [frontend_len, d]``, its layers and ``final_ln``."""
    defs = {"embed": layers.embedding_defs(cfg),
            "final_ln": layers.rmsnorm_defs(cfg.d_model),
            "layers": [_block_defs(cfg, b) for b in cfg.blocks]}
    if cfg.num_shared_groups:
        defs["shared"] = [_shared_group_defs(cfg)
                          for _ in range(cfg.num_shared_groups)]
    if cfg.cross_attention:
        for lp in defs["layers"]:
            lp.update(ln_cross=layers.rmsnorm_defs(cfg.d_model),
                      cross=attention.cross_attn_defs(cfg))
    if cfg.enc_layers:
        defs["encoder"] = {
            "pos": ParamDef((cfg.frontend_len, cfg.d_model), (None, EMBED),
                            init="normal", scale=0.02),
            "layers": [_encoder_block_defs(cfg)
                       for _ in range(cfg.enc_layers)],
            "final_ln": layers.rmsnorm_defs(cfg.d_model)}
    return defs


def _apply_block(lp, shared, h: torch.Tensor, h0: torch.Tensor,
                 cfg: ModelConfig, block: BlockSpec, *, mode: str,
                 positions: torch.Tensor, cache: Optional[Dict],
                 cache_len: Optional[torch.Tensor], paged_kernel: bool,
                 length: Optional[torch.Tensor] = None,
                 ctx: Optional[Dict] = None,
                 enc_kv: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """One decoder layer -> (h, new cache, aux): a pre-norm mixer
    (attention, Mamba2 or the rwkv6 time-mix), for a cross-attention
    arch a pre-norm cross-attention over ``enc_kv``, then a pre-norm FFN
    (SwiGLU, MoE, whose router's aux values are returned, or the rwkv6
    channel-mix), each added to the residual.  ``length``: the true
    lengths of a right-padded prefill (the recurrent mixers' state is
    taken there).  An rwkv6 block's states ``{tshift, wkv}`` and
    ``{cshift}`` merge into one dict.  Shared attention: the block of ``shared[block.shared_group]``
    on ``concat(h, h0)``, where ``h0`` is the embedding output."""
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
        return h + x, new_cache, {}
    if ctx is not None and block.mixer != ATTN:
        raise ValueError(
            f"a suffix prefill reached a {block.mixer} layer; only pure "
            "full-attention stacks are sharing-capable")
    xn = layers.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    if block.mixer == ATTN:
        y, new_cache = attention.apply(
            lp["mixer"], xn, cfg=cfg, window=block.window,
            positions=positions, mode=mode, cache=cache,
            cache_len=cache_len, ctx=ctx, paged_kernel=paged_kernel)
    elif block.mixer == MAMBA2:
        y, new_cache = mamba2.apply(lp["mixer"], xn, cfg, mode=mode,
                                    state=cache, length=length)
    elif block.mixer == RWKV6:
        y, new_cache = rwkv6.time_mix(lp["mixer"], xn, cfg, mode=mode,
                                      state=cache, length=length)
    else:
        raise ValueError(f"unknown mixer {block.mixer!r}")
    h = h + y
    if cfg.cross_attention and enc_kv is not None:
        h = h + attention.cross_apply(
            lp["cross"], layers.rmsnorm(lp["ln_cross"], h, cfg.norm_eps),
            enc_kv, cfg=cfg)
    aux: Dict = {}
    if block.ffn == FFN_NONE:
        return h, new_cache, aux
    xn = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if block.ffn == FFN_DENSE:
        y = layers.mlp(lp["ffn"], xn)
    elif block.ffn == FFN_MOE:
        y, aux = moe.apply(lp["ffn"], xn, cfg)
    elif block.ffn == FFN_RWKV:
        y, cm_state = rwkv6.channel_mix(lp["ffn"], xn, cfg, mode=mode,
                                        state=cache, length=length)
        if cm_state is not None:
            new_cache = {**(new_cache or {}), **cm_state}
    else:
        raise ValueError(f"unknown ffn {block.ffn!r}")
    return h + y, new_cache, aux


def _decoder(params, cfg: ModelConfig, h: torch.Tensor, *, mode: str,
             positions: torch.Tensor, caches: Optional[List],
             cache_len: Optional[torch.Tensor], paged_kernel: bool = False,
             length: Optional[torch.Tensor] = None,
             ctx_list: Optional[List] = None,
             enc_kv_list: Optional[List] = None, remat: bool = False
             ) -> Tuple[torch.Tensor, List, Dict]:
    """The layer stack and the final norm -> (h, per-layer caches, aux).
    In the dense mode (``forward_train``'s) each aux value is summed over
    the layers and divided by their number, as the reference does; the
    serving modes skip that sum, which only ``forward_train`` reads.
    ``remat`` (dense mode only) recomputes each block's activations in
    the backward (``torch.utils.checkpoint``, non-reentrant)."""
    h0 = h
    shared = params["shared"] if "shared" in params else None
    new_caches: List = []
    aux_all: Dict = {}
    for i, block in enumerate(cfg.blocks):
        kw = dict(mode=mode, positions=positions,
                  cache=caches[i] if caches is not None else None,
                  cache_len=cache_len, paged_kernel=paged_kernel,
                  length=length,
                  ctx=ctx_list[i] if ctx_list is not None else None,
                  enc_kv=enc_kv_list[i] if enc_kv_list is not None
                  else None)
        if remat and mode == "dense":
            h, nc, aux = checkpoint(_apply_block, params["layers"][i],
                                    shared, h, h0, cfg, block,
                                    use_reentrant=False, **kw)
        else:
            h, nc, aux = _apply_block(params["layers"][i], shared, h, h0,
                                      cfg, block, **kw)
        new_caches.append(nc)
        if mode == "dense":
            for k, v in aux.items():
                aux_all[k] = aux_all.get(k, 0.0) + v / cfg.num_layers
    return (layers.rmsnorm(params["final_ln"], h, cfg.norm_eps), new_caches,
            aux_all)


def _encoder(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """whisper's encoder over stub frame embeddings [B,F,d]: learned
    positions added, then pre-norm non-causal self-attention (roped by
    frame index, as the reference ropes it) and a SwiGLU MLP per layer,
    and a final norm."""
    enc = params["encoder"]
    f = frames.shape[1]
    h = frames + enc["pos"][None, :f].to(frames.dtype)
    positions = torch.arange(f, device=frames.device)[None, :]
    for lp in enc["layers"]:
        y, _ = attention.apply(
            lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg=cfg,
            window=None, positions=positions, mode="dense", causal=False)
        h = h + y
        h = h + layers.mlp(lp["ffn"],
                           layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    return layers.rmsnorm(enc["final_ln"], h, cfg.norm_eps)


def _embed_with_frontend(params, cfg: ModelConfig, tokens: torch.Tensor,
                         frontend: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings; a patch frontend's ``F`` embeddings take the
    place of the first ``F`` positions (the sequence keeps its length,
    which must be at least ``F``)."""
    h = layers.embed(params["embed"], cfg, tokens)
    if frontend is not None and cfg.frontend and cfg.family != "audio":
        f = frontend.shape[1]
        if tokens.shape[1] < f:
            raise ValueError(
                f"{cfg.name}: a {tokens.shape[1]}-token sequence is shorter "
                f"than the {f}-position frontend it starts with")
        h = torch.cat([frontend.to(h.dtype), h[:, f:]], dim=1)
    return h


def _cross_kv_list(params, cfg: ModelConfig,
                   enc_out: torch.Tensor) -> List[Dict]:
    return [attention.encode_kv(lp["cross"], enc_out, cfg=cfg)
            for lp in params["layers"]]


def _enc_kv_of(params, cfg: ModelConfig, batch: Dict) -> Optional[List]:
    """Each decoder layer's cross-attention KV over ``batch["frames"]``
    (whisper), else None."""
    if cfg.family != "audio":
        return None
    return _cross_kv_list(params, cfg, _encoder(params, cfg,
                                                batch["frames"]))


def forward_dense_logits(params, cfg: ModelConfig,
                         batch: Dict) -> torch.Tensor:
    """Full-sequence logits [B,S,V] (teacher-forced), for tests and
    evaluation: every layer in the dense mode, no cache."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    enc_kv_list = _enc_kv_of(params, cfg, batch)
    h = _embed_with_frontend(params, cfg, tokens, batch.get("frontend"))
    h, _, _ = _decoder(params, cfg, h, mode="dense", positions=positions,
                       caches=None, cache_len=None, enc_kv_list=enc_kv_list)
    return layers.logits(params["embed"], cfg, h)


def refuse_under_plan(cfg: ModelConfig) -> None:
    """Raise for an arch that the sharded step does not run, naming the
    ROADMAP item that lifts it."""
    if any(b.ffn == FFN_MOE for b in cfg.blocks):
        raise NotImplementedError(
            f"{cfg.name}: MoE under a plan needs the global-capacity "
            "dispatch (ROADMAP A19)")
    if any(b.mixer in (MAMBA2, RWKV6, SHARED_ATTN) for b in cfg.blocks):
        raise NotImplementedError(
            f"{cfg.name}: recurrent layers under a plan (ROADMAP A20)")
    if cfg.enc_layers or cfg.frontend or cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: encoder and frontend archs under a plan "
            "(ROADMAP A23)")


def _layout(params, cfg: ModelConfig, rules: sh.Rules, b: int, s: int
            ) -> sh.Layout:
    """How this step lays out its activations on ``rules``' mesh."""
    data = rules.table.get(sh.BATCH)
    if rules.spec_for((sh.BATCH,), (b,)) != ((data,) if data else ()):
        raise ValueError(f"batch {b} does not divide the data axes "
                         f"{sh.axes_of(data)}")
    seq = rules.table.get(sh.SEQ)
    split = seq is not None and rules.spec_for((sh.SEQ,), (s,)) == (seq,)
    model = rules.table.get(sh.HEADS)
    if seq is not None and not split and not rules.context_parallel:
        raise ValueError(f"sequence {s} does not divide the sequence axes "
                         f"{sh.axes_of(seq)} of Megatron-SP")
    cp = rules.context_parallel and split
    head = params["embed"]["table"] if cfg.tie_embeddings \
        else params["embed"]["head"]
    vocab = sh.placement(head).entry(0 if cfg.tie_embeddings else 1)
    loss = sh.axes_of(data) + (sh.axes_of(seq) if cp else ())
    scale = 1.0
    if rules.context_parallel and not split:
        # the model axes hold copies of one sequence; the weights'
        # gradients sum over them
        scale = 1.0 / rules.mesh_size(seq)
    return sh.Layout(rules=rules, seq=seq if split else None,
                     cp=cp, model=model, vocab=vocab, loss=loss,
                     grad_scale=scale)


def _forward_train_sharded(params, cfg: ModelConfig, batch: Dict,
                           rules: sh.Rules, remat: bool
                           ) -> Tuple[torch.Tensor, Dict]:
    """``forward_train`` on this rank's shards (``batch`` the global
    one): see the module docstring."""
    refuse_under_plan(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    lay = _layout(params, cfg, rules, b, s)
    axes = (sh.BATCH, sh.SEQ if lay.cp else None)
    tokens, labels = sh.shard(tokens, *axes), sh.shard(labels, *axes)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = sh.shard(mask, *axes)
    positions = torch.arange(s, device=tokens.device)[None, :]
    if lay.cp:
        positions = sh.shard(positions, None, sh.SEQ)
    with sh.step_layout(lay):
        h = layers.embed(params["embed"], cfg, tokens)
        h, _, _ = _decoder(params, cfg, h, mode="dense",
                           positions=positions, caches=None,
                           cache_len=None, remat=remat)
        lg = layers.logits(params["embed"], cfg, h)
        loss = layers.cross_entropy(lg, labels, mask)
    return loss, {"loss": loss}


def forward_train(params, cfg: ModelConfig, batch: Dict, *,
                  q_chunk: Optional[int] = None, remat: bool = False
                  ) -> Tuple[torch.Tensor, Dict]:
    """-> (loss, metrics): the mean next-token cross-entropy of
    ``batch["labels"]`` [B,S] over the dense pass of ``batch["tokens"]``
    (whisper: its encoder over ``batch["frames"]`` and each decoder
    layer's cross-attention KV; pixtral: ``batch["frontend"]`` in the
    first ``frontend_len`` positions, which the loss masks unless
    ``batch["loss_mask"]`` is given), plus 0.01 x the MoE load-balance
    loss averaged over the layers.  ``metrics`` holds ``loss`` and the
    averaged aux values.  ``remat``: recompute each block in the
    backward.  ``q_chunk`` is accepted for the reference's signature:
    the flash kernel picks its own tiles.  Under live sharding rules
    (``parallel/sharding.live_rules``) ``batch`` is the global batch and
    the step is this rank's share of it (the module docstring)."""
    del q_chunk
    rules = sh.live_rules()
    if rules is not None:
        return _forward_train_sharded(params, cfg, batch, rules, remat)
    tokens, labels = batch["tokens"], batch["labels"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    enc_kv_list = _enc_kv_of(params, cfg, batch)
    h = _embed_with_frontend(params, cfg, tokens, batch.get("frontend"))
    h, _, aux = _decoder(params, cfg, h, mode="dense", positions=positions,
                         caches=None, cache_len=None,
                         enc_kv_list=enc_kv_list, remat=remat)
    lg = layers.logits(params["embed"], cfg, h)
    mask = batch.get("loss_mask")
    if mask is None and cfg.frontend and cfg.family != "audio":
        mask = (torch.arange(s, device=tokens.device)
                >= cfg.frontend_len)[None, :].expand(labels.shape)
    loss = layers.cross_entropy(lg, labels, mask)
    if "load_balance_loss" in aux:
        loss = loss + 0.01 * aux["load_balance_loss"]
    return loss, {"loss": loss, **aux}


def _prefill(params, cfg: ModelConfig, batch: Dict, *,
             length: Optional[torch.Tensor], ctx: Optional[Dict]
             ) -> Tuple[torch.Tensor, List, Optional[List]]:
    """(hidden states [B,S,d], per-layer caches, cross-attention KV)."""
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
    enc_kv_list = _enc_kv_of(params, cfg, batch)
    h = _embed_with_frontend(params, cfg, tokens, batch.get("frontend"))
    h, caches, _ = _decoder(params, cfg, h, mode="prefill",
                            positions=positions, caches=None,
                            cache_len=None, length=length,
                            ctx_list=ctx_list, enc_kv_list=enc_kv_list)
    return h, caches, enc_kv_list


def prefill_hidden(params, cfg: ModelConfig, batch: Dict, *,
                   length: Optional[torch.Tensor] = None,
                   ctx: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, List]:
    """:func:`forward_prefill` up to the final norm: the hidden states of
    every position [B,S,d] and the per-layer caches, so a caller that
    needs logits at other positions than the last (a teacher-forced
    check of generated tokens) pays the LM head for those rows only."""
    h, caches, _ = _prefill(params, cfg, batch, length=length, ctx=ctx)
    return h, caches


def forward_prefill(params, cfg: ModelConfig, batch: Dict, *,
                    length: Optional[torch.Tensor] = None,
                    ctx: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Returns (last-token logits [B,V], cache).

    ``batch["tokens"]`` [B,S], right-padded to a shape bucket (and
    ``frames`` or ``frontend`` for a frontend arch); ``length`` [B]
    int32, their true lengths: logits are taken at ``length - 1`` and
    the cache records ``length`` (causality already hides the padding
    from every real token; Mamba2 layers take dt = 0 past it, rwkv6
    layers k = 0 and a log decay of 0).  The cache holds per-layer
    ``{"k","v"}`` [B,Hkv,S,dh] for attention layers (padding included;
    the splice drops it), ``{"conv","ssm"}`` for Mamba2 layers and
    ``{"tshift","wkv","cshift"}`` for rwkv6 layers (the state at
    ``length - 1``), ``enc_kv`` (whisper: per decoder layer ``{"k","v"}``
    [B,Hkv,F,dh] over the frames; else None) and ``len``.

    ``ctx`` makes this a suffix prefill for prefix sharing: ``{"off":
    prefix length (host int), "row": [Cb] int32 page ids, "layers":
    per-layer {"pk","pv"[,"ks","vs"]} pools}``.  ``tokens`` then hold
    only the suffix, at positions ``off + i``, and each layer attends to
    the ``off`` prefix tokens through the pages named in ``row``.  The
    returned cache carries suffix KV only, for a splice at ``off``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h, caches, enc_kv_list = _prefill(params, cfg, batch, length=length,
                                      ctx=ctx)
    if length is None:
        h_last = h[:, -1:]
        clen = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    else:
        idx = torch.clamp(length.long() - 1, min=0)[:, None, None]
        h_last = torch.gather(h, 1, idx.expand(b, 1, h.shape[2]))
        clen = length.to(torch.int32)
    lg = layers.logits(params["embed"], cfg, h_last)
    return lg[:, 0], {"layers": caches, "enc_kv": enc_kv_list, "len": clen}


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
    the write mask does not cover state, as in the reference).  A
    cache's ``enc_kv`` (whisper) is cross-attended by every decoder
    layer and passed on unchanged."""
    cache_len = cache["len"] + 1
    positions = cache["len"][:, None]
    layer_caches = _thread_page_tables(cfg, cache, write_mask)
    h = layers.embed(params["embed"], cfg, tokens)
    h, new_caches, _ = _decoder(params, cfg, h, mode="decode",
                                positions=positions, caches=layer_caches,
                                cache_len=cache_len,
                                paged_kernel=paged_kernel,
                                enc_kv_list=cache.get("enc_kv"))
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
    h, new_caches, _ = _decoder(params, cfg, h, mode="decode",
                                positions=positions, caches=layer_caches,
                                cache_len=cache_len,
                                paged_kernel=paged_kernel,
                                enc_kv_list=cache.get("enc_kv"))
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


def prepare_decode_cache(cfg: ModelConfig, cache: Dict,
                         max_len: int) -> Dict:
    """Grow a prefill cache (KV seq dims sized to the prompt) into a dense
    decode cache for ``max_len`` tokens.  Windowed layers keep a ring of
    ``min(max_len, window)`` entries; when the prompt is longer than the
    ring, its last ``ring`` tokens are kept, rolled so token ``t`` sits
    at entry ``t % ring`` (the decode write rule).  Recurrent states and
    ``enc_kv`` pass through.  Reads ``len`` on the host (row 0: every
    row shares one prompt length, as in the reference)."""
    plen = int(cache["len"].reshape(-1)[0])
    new_layers = []
    for block, entry in zip(cfg.blocks, cache["layers"]):
        if entry is None or "k" not in entry:
            new_layers.append(entry)
            continue
        ring = min(max_len, block.window or max_len)
        e = dict(entry)
        for key in ("k", "v"):
            x = e[key]
            if x.shape[2] > ring:
                x = torch.roll(x[:, :, -ring:], plen % ring, dims=2)
            if x.shape[2] < ring:
                x = F.pad(x, (0, 0, 0, ring - x.shape[2]))
            e[key] = x.contiguous()
        new_layers.append(e)
    return dict(cache, layers=new_layers)


def cache_structure(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """The dense decode cache as nested ``{name: (shape, logical axes)}``
    (the reference's): per layer ``{"k","v"}`` [B,Hkv,ring,dh] (ring =
    ``min(max_len, window)``; the sequence on ``KV_SEQ``), a Mamba2
    layer's ``{"conv","ssm"}``, an rwkv6 layer's
    ``{"tshift","wkv","cshift"}``, ``len`` [B] and, for a
    cross-attention arch, ``enc_kv`` per layer [B,Hkv,F,dh]."""
    per_layer: List[Optional[Dict]] = []
    for block in cfg.blocks:
        if block.mixer in (ATTN, SHARED_ATTN):
            shape = attention.init_cache_shape(
                cfg, batch, min(max_len, block.window or max_len))
            axes = (sh.BATCH, None, sh.KV_SEQ, None)
            entry = {"k": (shape, axes), "v": (shape, axes)}
        elif block.mixer == MAMBA2:
            st = mamba2.state_shapes(cfg, batch)
            entry = {"conv": (st["conv"], (sh.BATCH, None, None)),
                     "ssm": (st["ssm"], (sh.BATCH, sh.HEADS, None, None))}
        elif block.mixer == RWKV6:
            st = rwkv6.state_shapes(cfg, batch)
            entry = {"tshift": (st["tshift"], (sh.BATCH, None, None)),
                     "wkv": (st["wkv"], (sh.BATCH, sh.HEADS, None, None)),
                     "cshift": (st["cshift"], (sh.BATCH, None, None))}
        else:
            entry = None
        per_layer.append(entry)
    out: Dict = {"layers": per_layer, "len": ((batch,), (sh.BATCH,))}
    if cfg.cross_attention:
        kv_shape = (batch, cfg.num_kv_heads, cfg.frontend_len,
                    cfg.resolved_head_dim)
        kv_axes = (sh.BATCH, None, None, None)
        out["enc_kv"] = [{"k": (kv_shape, kv_axes), "v": (kv_shape, kv_axes)}
                         for _ in range(cfg.num_layers)]
    return out


def is_structure_leaf(node) -> bool:
    """Whether ``node`` is a ``(shape, logical axes)`` leaf of a
    ``cache_structure`` (or ``serve/cache.CacheSpec.structure``) tree."""
    return isinstance(node, tuple) and len(node) == 2 \
        and isinstance(node[0], tuple)


def map_structure(struct, fn):
    """``fn(shape, axes)`` over the leaves of a ``cache_structure`` (or
    ``CacheSpec.structure``) tree, rebuilding its dicts and lists;
    ``None`` entries stay ``None``."""
    if is_structure_leaf(struct):
        return fn(*struct)
    if isinstance(struct, dict):
        return {k: map_structure(v, fn) for k, v in struct.items()}
    if isinstance(struct, list):
        return [map_structure(v, fn) for v in struct]
    return struct


__all__ = ["model_defs", "forward_train", "forward_dense_logits",
           "forward_prefill", "forward_decode", "forward_verify",
           "prefill_hidden", "verify_hidden", "prepare_decode_cache",
           "cache_structure", "map_structure", "is_structure_leaf"]
