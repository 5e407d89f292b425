"""Hand-written Hopper kernels of the port, one folder per kernel of the
reference's ``repro/kernels`` (``csrc/`` CUDA source, ``ops.py`` wrapper,
``ref.py`` plain PyTorch version), built by ``build.py`` at first use.

Every kernel on a training path is differentiable: ``flash_attention``,
``moe_gmm`` and ``fused_matmul`` through explicit-product backwards,
``mamba2_scan`` and ``rwkv6_wkv`` through backward kernels of their own.
``paged_attention`` reads the serving engine's KV pools and never
trains: its wrapper calls ``refuse_autograd`` before a launch, because a
launch writes through raw pointers, so its output would carry no
gradient, and a step would go on without a word.

A wrapper reports each launch's work to the active work counter
(``analysis/count.StepCounter``, which registers itself in ``_COUNTERS``
while it is entered): ``record_kernel`` at a launch, ``scope`` around a
backward made of plain products.  With no counter entered both do
nothing."""

import contextlib
from typing import List

import torch

_COUNTERS: List = []   # the work counters entered, innermost last


def active():
    """The innermost work counter entered, or None."""
    return _COUNTERS[-1] if _COUNTERS else None


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's launch and its work, on the active
    counter (a no-op when none is active)."""
    counter = active()
    if counter is not None:
        counter.add(name, flops, nbytes, calls=1)


@contextlib.contextmanager
def scope(name: str):
    """Attribute the aten ops run inside to ``name`` (one call of it) on
    the active counter; a no-op when none is active."""
    counter = active()
    if counter is None:
        yield
        return
    counter.add(name, 0.0, 0.0, calls=1)
    counter.scopes.append(name)
    try:
        yield
    finally:
        counter.scopes.pop()


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when autograd would record a launch of a kernel that has no
    backward: grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: it serves from the KV pools and "
            "never trains; run it under torch.no_grad() or on frozen "
            "tensors")


def causal_pairs(s: int, chunk: int, strict: bool = False) -> int:
    """Causal (row, key) pairs within chunks of ``chunk`` rows of a
    length-``s`` sequence, the last chunk ragged; ``strict`` leaves out
    the diagonal: the scans' chunked products count these (their
    ``work`` formulas)."""
    total = 0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        total += q * (q - 1) // 2 if strict else q * (q + 1) // 2
    return total
