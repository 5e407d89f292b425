"""Hand-written Hopper kernels of the port, one folder per kernel of the
reference's ``repro/kernels`` (``csrc/`` CUDA source, ``ops.py`` wrapper,
``ref.py`` plain PyTorch version), built by ``build.py`` at first use.

Every kernel on a training path is differentiable: ``flash_attention``,
``moe_gmm`` and ``fused_matmul`` through explicit-product backwards,
``mamba2_scan`` and ``rwkv6_wkv`` through backward kernels of their own.
``paged_attention`` reads the serving engine's KV pools and never
trains: its wrapper calls ``refuse_autograd`` before a launch, because a
launch writes through raw pointers, so its output would carry no
gradient, and a step would go on without a word."""

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when autograd would record a launch of a kernel that has no
    backward: grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: it serves from the KV pools and "
            "never trains; run it under torch.no_grad() or on frozen "
            "tensors")
