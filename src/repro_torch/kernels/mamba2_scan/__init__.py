"""Mamba2 (SSD) scan: Hopper CUDA kernel, its wrapper and its plain
PyTorch version (port of ``repro/kernels/mamba2_scan``)."""

from repro_torch.kernels.mamba2_scan.ops import (mamba2_scan,
                                                 scan_model_layout,
                                                 supported)
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref

__all__ = ["mamba2_scan", "mamba2_scan_ref", "scan_model_layout",
           "supported"]
