"""Architecture registry of the port: ``get_config("internlm2-1.8b")``.

Only the architectures the port can serve are registered: the dense
internlm2-1.8b and gemma2-2b (local/global sliding windows, softcaps,
tied and scaled embeddings), the MoE dbrx-132b and grok-1-314b, the
hybrid zamba2-7b (Mamba2 backbone + shared attention) and the
attention-free rwkv6-7b.  The others of the reference join as their
configs and layers are ported (ROADMAP A13).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, alternating_windows,
                                      reduced)

_ARCH_MODULES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _cache:
        if arch not in _ARCH_MODULES:
            raise KeyError(f"unknown arch {arch!r} for the PyTorch port; "
                           f"known: {ARCH_IDS} (more arrive with ROADMAP "
                           "A13)")
        _cache[arch] = importlib.import_module(_ARCH_MODULES[arch]).config()
    return _cache[arch]


__all__ = ["ARCH_IDS", "ModelConfig", "alternating_windows", "get_config",
           "reduced"]
