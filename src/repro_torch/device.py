"""Device resolution shared by every entry point of the port.

``device=None`` means the card.  With no CUDA device the entry points
raise instead of falling back to the CPU; a caller that wants the CPU
(the parity tests) says so with ``device="cpu"``.  Resolving a device
also pins fp32 numerics: TF32 is switched off for matrix products and
cuDNN, because the reference computes params, pools and logits in fp32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_to_device(values, device: torch.device,
                   dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Host values (a list or numpy array) as a tensor on ``device``,
    without a host synchronization: on the card the copy goes through
    pinned memory with ``non_blocking=True``, so it is safe under
    ``torch.cuda.set_sync_debug_mode("error")``.  On the CPU it is a
    plain tensor."""
    t = torch.as_tensor(values, dtype=dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
