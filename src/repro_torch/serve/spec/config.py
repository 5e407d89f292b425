"""Speculative-decoding configuration and capability gate (counterpart
of ``repro/serve/spec/config.py``).

``SpecConfig`` is the one knob surface: which drafter proposes tokens
(``"ngram"``, the model-free prompt-lookup drafter, or the name or
config of a small draft model), how many tokens it drafts per verify
step (``k``), and the n-gram order of the lookup drafter.  The engine
takes it as ``Engine(spec=...)``.

Speculation rewrites each decode micro-step as draft ``K`` / verify
``K+1`` / accept, which needs every layer's decode state to roll back
by *not advancing a position counter*.  Block-paged attention KV does
(a rejected token's cell is overwritten by the real token later);
recurrent state (Mamba2, rwkv6) does not.  The same condition admits
an arch to the fused chunked-prefill mode: attention-only stacks, no
modality frontend, no cross-attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.configs.base import ATTN, ModelConfig


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding settings for ``serve/engine.Engine``.

    draft:        ``"ngram"`` (prompt lookup, no second model) or the
                  name of a draft model config; ``draft_cfg`` /
                  ``draft_params`` override / supply the model.
    k:            drafted tokens per verify step (the verify runs
                  ``k + 1`` query rows).
    ngram:        n-gram order of the lookup drafter.
    draft_cfg:    the draft ``ModelConfig`` (model drafter only).
    draft_params: the draft model's parameters (a ``ParamTree`` on the
                  engine's device); drawn from a generator seeded with
                  the engine's ``seed + 17`` when None.
    """

    draft: str = "ngram"
    k: int = 4
    ngram: int = 3
    draft_cfg: Optional[ModelConfig] = None
    draft_params: Any = None


def spec_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot serve speculatively (or run multi-row paged
    steps), or None when it can."""
    if cfg.cross_attention:
        return "cross-attention decoders are not served by Engine"
    if cfg.frontend:
        return ("modality-frontend archs prepend non-token state the "
                "drafters cannot model")
    bad = sorted({b.mixer for b in cfg.blocks if b.mixer != ATTN})
    if bad:
        return (f"{'/'.join(bad)} layers keep recurrent state that cannot "
                "roll back rejected drafts without materializing every "
                "intermediate state")
    return None


def check_spec_capable(cfg: ModelConfig, what: str = "speculative "
                       "decoding") -> None:
    """Raise with an actionable message when ``cfg`` cannot run ``what``."""
    reason = spec_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(f"{cfg.name} does not support {what}: {reason}")
