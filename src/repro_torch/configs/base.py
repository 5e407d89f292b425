"""Model configuration for the PyTorch port.

An own copy of ``repro.configs.base`` (the port imports nothing of the
JAX package): ``ModelConfig`` describes a stack of blocks, each block a
``(mixer, ffn)`` pair.  The dataclasses keep every field of the
reference, so a reference config and its port compare field for field;
what the port can run today is decided by the model code, which raises
on a mixer or FFN it does not implement yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

ATTN = "attn"            # GQA attention mixer
MAMBA2 = "mamba2"        # Mamba2 SSD mixer
RWKV6 = "rwkv6"          # RWKV6 time-mix mixer
SHARED_ATTN = "shared_attn"  # zamba2-style shared transformer block

FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_RWKV = "rwkv_cmix"
FFN_NONE = "none"        # mixer-only layer (mamba backbone layers)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer of the stack."""

    mixer: str = ATTN
    ffn: str = FFN_DENSE
    window: Optional[int] = None       # sliding-window size; None = global
    shared_group: int = -1             # zamba2 shared block group (-1 = own)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    blocks: Tuple[BlockSpec, ...] = ()      # len == num_layers
    enc_layers: int = 0
    enc_blocks: Tuple[BlockSpec, ...] = ()
    cross_attention: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None   # final-logit softcap
    attn_softcap: Optional[float] = None    # attention-score softcap
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    embed_scale: bool = False               # multiply embeddings by sqrt(d)
    frontend: Optional[str] = None
    frontend_len: int = 0
    num_shared_groups: int = 0
    norm_eps: float = 1e-5
    max_position: int = 1 << 20

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def supports_long_context(self) -> bool:
        """True when every attention layer is sliding-window bounded (or
        the stack has no attention at all)."""
        for b in self.blocks:
            if b.mixer in (ATTN, SHARED_ATTN) and b.window is None:
                return False
        return True


# ---------------------------------------------------------------------------
# Shapes: the cells the paper's tuner and cost model are read at
# ---------------------------------------------------------------------------

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", TRAIN, 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", PREFILL, 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", DECODE, 32_768, 128),
    "long_500k": ShapeConfig("long_500k", DECODE, 524_288, 1),
}


def shape_applicable(cfg: ModelConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live cell: a 512k-token decode needs
    every attention layer window-bounded (or none at all)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "full-attention layers make 512k-token decode quadratic/"
            "unbounded-KV; skipped")
    return True, ""


def uniform_blocks(n: int, mixer: str = ATTN, ffn: str = FFN_DENSE,
                   window: Optional[int] = None) -> Tuple[BlockSpec, ...]:
    return tuple(BlockSpec(mixer=mixer, ffn=ffn, window=window)
                 for _ in range(n))


def alternating_windows(n: int, pattern: Sequence[Optional[int]],
                        ffn: str = FFN_DENSE) -> Tuple[BlockSpec, ...]:
    """gemma-style local:global alternation: ``pattern`` repeats, e.g.
    ``[4096, None]`` for gemma2 (1:1) or ``[1024]*5 + [None]`` for
    gemma3 (5:1)."""
    return tuple(BlockSpec(mixer=ATTN, ffn=ffn,
                           window=pattern[i % len(pattern)])
                 for i in range(n))


def zamba2_blocks(n: int, shared_every: int, num_shared_groups: int,
                  window: Optional[int]) -> Tuple[BlockSpec, ...]:
    """Mamba2 backbone with a shared attention + MLP block applied every
    ``shared_every`` layers, cycling through ``num_shared_groups``
    parameter groups."""
    blocks = []
    shared_i = 0
    for i in range(n):
        if shared_every and i % shared_every == shared_every - 1:
            blocks.append(BlockSpec(
                mixer=SHARED_ATTN, ffn=FFN_DENSE, window=window,
                shared_group=shared_i % max(num_shared_groups, 1)))
            shared_i += 1
        else:
            blocks.append(BlockSpec(mixer=MAMBA2, ffn=FFN_NONE))
    return tuple(blocks)


def validate(cfg: ModelConfig) -> ModelConfig:
    """Structural checks; raise ``ValueError`` on an inconsistent config."""
    if len(cfg.blocks) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(cfg.blocks)} blocks for "
                         f"{cfg.num_layers} layers")
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"{cfg.name}: num_heads {cfg.num_heads} is not a "
                         f"multiple of num_kv_heads {cfg.num_kv_heads}")
    if cfg.enc_layers and len(cfg.enc_blocks) != cfg.enc_layers:
        raise ValueError(f"{cfg.name}: encoder block count mismatch")
    needs = ((FFN_MOE, "moe", [b.ffn for b in cfg.blocks]),
             (MAMBA2, "ssm", [b.mixer for b in cfg.blocks]),
             (RWKV6, "rwkv", [b.mixer for b in cfg.blocks]))
    for kind, field, used in needs:
        if kind in used and getattr(cfg, field) is None:
            raise ValueError(f"{cfg.name}: {kind} layers need cfg.{field}")
    return cfg


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 4, kv_heads: Optional[int] = None, d_ff: int = 128,
            vocab: int = 256, experts: int = 4,
            frontend_len: int = 8) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's rule:
    same block pattern at the reduced depth, windows shrunk to 16)."""
    kv = kv_heads or max(1, heads // max(1, cfg.num_heads // cfg.num_kv_heads))
    if cfg.blocks:
        stride = max(1, cfg.num_layers // layers)
        blocks = tuple(cfg.blocks[min(i * stride, cfg.num_layers - 1)]
                       for i in range(layers))
        blocks = tuple(
            dataclasses.replace(b, window=(16 if b.window else None))
            for b in blocks)
        if cfg.family == "hybrid" and not any(b.mixer == SHARED_ATTN
                                              for b in blocks):
            blocks = blocks[:-1] + (BlockSpec(mixer=SHARED_ATTN,
                                              ffn=FFN_DENSE, window=16,
                                              shared_group=0),)
    else:
        blocks = uniform_blocks(layers)
    moe = None
    if cfg.moe is not None:
        top_k = min(cfg.moe.top_k, experts)
        moe = dataclasses.replace(cfg.moe, num_experts=experts, top_k=top_k,
                                  capacity_factor=experts / top_k + 0.01)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk=8)
    rwkv = None
    if cfg.rwkv is not None:
        rwkv = dataclasses.replace(cfg.rwkv, head_dim=16, decay_lora=8,
                                   mix_lora=8, chunk=8)
    enc_layers = layers if cfg.enc_layers else 0
    enc_blocks = uniform_blocks(layers) if cfg.enc_layers else ()
    return validate(dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers, d_model=d_model, num_heads=heads,
        num_kv_heads=kv, d_ff=d_ff, vocab_size=vocab, head_dim=None,
        blocks=blocks, enc_layers=enc_layers, enc_blocks=enc_blocks,
        moe=moe, ssm=ssm, rwkv=rwkv,
        frontend_len=(frontend_len if cfg.frontend else 0),
        num_shared_groups=(1 if cfg.family == "hybrid" else 0),
    ))
