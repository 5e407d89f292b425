"""Paged decode attention: Hopper CUDA kernel, its wrapper and its plain
PyTorch version (port of ``repro/kernels/paged_attention``)."""

from repro_torch.kernels.paged_attention.ops import paged_attention, supported
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_attention_split_ref)

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_split_ref", "supported"]
