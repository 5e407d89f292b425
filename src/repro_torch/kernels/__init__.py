"""Hand-written Hopper kernels of the port, one folder per kernel of the
reference's ``repro/kernels`` (``csrc/`` CUDA source, ``ops.py`` wrapper,
``ref.py`` plain PyTorch version), built by ``build.py`` at first use.

``flash_attention``, ``moe_gmm`` and ``fused_matmul`` are differentiable.
The wrappers of the forward-only kernels (``mamba2_scan``,
``rwkv6_wkv``, ``paged_attention``) call ``refuse_autograd`` before a
launch: a launch writes through raw pointers, so its output would carry
no gradient, and a training step would go on without a word."""

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when autograd would record a launch of a forward-only
    kernel: grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward on the card (ROADMAP A15's "
            "remainder): run it under torch.no_grad() or on frozen "
            "parameters, or train this arch on the CPU")
