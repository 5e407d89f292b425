"""Structural gate shared with speculative decoding (counterpart of
``repro/serve/spec/config.py``; only ``spec_unsupported_reason`` is
ported — speculation itself is ROADMAP A10).

The engine's fused chunked-prefill mode needs every layer's decode
state to live in block-paged attention KV, which is the same condition
as speculative rollback: attention-only stacks, no modality frontend,
no cross-attention.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ATTN, ModelConfig


def spec_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot run multi-row paged steps, or None when it can."""
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
