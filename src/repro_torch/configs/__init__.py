"""Architecture registry of the port: ``get_config("internlm2-1.8b")``.

All ten architectures of the reference, in its order: the hybrid
zamba2-7b (Mamba2 backbone + shared attention), the attention-free
rwkv6-7b, the MoE dbrx-132b and grok-1-314b, pixtral-12b (a patch
frontend stub before a dense decoder), the dense mistral-large-123b,
internlm2-1.8b, gemma2-2b and gemma3-12b (local/global sliding windows,
tied and scaled embeddings; gemma2's softcaps) and the encoder-decoder
whisper-medium (a frame frontend stub, cross-attention).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, alternating_windows,
                                      reduced)

_ARCH_MODULES = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _cache:
        if arch not in _ARCH_MODULES:
            raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
        _cache[arch] = importlib.import_module(_ARCH_MODULES[arch]).config()
    return _cache[arch]


__all__ = ["ARCH_IDS", "ModelConfig", "alternating_windows", "get_config",
           "reduced"]
