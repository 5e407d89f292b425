"""Speculative-decoding gate of the port (drafters: ROADMAP A10)."""

from repro_torch.serve.spec.config import spec_unsupported_reason

__all__ = ["spec_unsupported_reason"]
