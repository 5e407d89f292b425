"""Public grouped-matmul op: the Hopper kernel on the card, its plain
version on the CPU.

``moe_gmm`` is what ``models/moe.apply`` calls for the three batched
expert products of an MoE FFN.  Dispatch is by where ``x`` lies, and
nothing else:

* a CPU tensor runs ``ref.moe_gmm_ref`` (fp32 einsum);
* a CUDA tensor launches ``csrc/moe_gmm.cu`` (built by
  ``kernels/build.py`` at first use) or raises — there is no fallback.

x is [E,C,D] or, with a leading group dimension, [G,E,C,D]; w [E,D,F] is
shared by the groups; ``row_counts`` [E] or [G,E] int32 marks the live
rows of each expert (rows at or past it come out as 0).  fp32 or bf16,
x and w alike; the kernel accumulates in fp32.  ``launches`` counts
kernel launches (one per call on a CUDA tensor), so a run can show that
its main path went through the kernel.  ``supported()`` runs the
smallest real launch; tests use it to skip.

The op is differentiable in x and w (``forward_train`` runs it in every
MoE layer): its backward, ``moe_gmm_bwd``, is explicit products per
expert on either device, dx = dy · wᵀ and dw = Σ_g xᵀ · dy, with dy
zeroed at rows at or past ``row_counts`` (those rows of the output are
constants), so they get a zero dx and add nothing to dw.  fp32
products with TF32 off.  ``bwd_launches`` counts backward calls on
CUDA tensors; it is not a kernel of its own yet.

A ``meta`` tensor (the dry-run, ``launch/build``) launches nothing: the
op returns an output of the right shape and records ``work(...)`` on the
active ``analysis/count.StepCounter``; a CUDA launch records the same
while a counter is active.  The work is counted from shapes, every row
of every expert's capacity (a count on ``meta`` has no value), so the
card and ``meta`` count alike; PERF.md's bound counts live rows only.
The backward's products run inside ``scope("moe_gmm_bwd")``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, active, record_kernel, scope
from repro_torch.kernels.fused_matmul.ref import tf32_off
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"

# element type -> the kernel's dtype code (csrc: moe_gmm_fwd)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0    # kernel launches since import (callers may reset it)
bwd_launches = 0   # backward calls on CUDA tensors (callers may reset it)

# the C signature of csrc's moe_gmm_fwd: 4 tensor pointers, G, E, C, D,
# F and the dtype code, the stream
FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.moe_gmm_fwd.argtypes = FWD_ARGTYPES
    lib.moe_gmm_fwd.restype = ctypes.c_int
    lib.moe_gmm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def work(x_shape, w_shape, elem_bytes: int, counted: bool):
    """(flops, bytes) of one call from shapes: every row of x [G,E,C,D]
    times its expert's w [E,D,F] (2 D F flops a row), x and w read once
    (and the [G,E] int32 counts when ``counted``), the output written
    once."""
    g, e, c, d = x_shape
    f = w_shape[2]
    nbytes = elem_bytes * (g * e * c * d + e * d * f + g * e * c * f) \
        + (4 * g * e if counted else 0)
    return 2 * g * e * c * d * f, nbytes


def _check(x: torch.Tensor, w: torch.Tensor,
           row_counts: Optional[torch.Tensor]) -> None:
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and w must be one of {list(DTYPE_CODES)} and "
                        f"of one dtype, got {x.dtype}/{w.dtype}")
    named = [("x", x), ("w", w)]
    if row_counts is not None:
        if row_counts.dtype != torch.int32:
            raise TypeError(f"row_counts must be int32, got "
                            f"{row_counts.dtype}")
        named.append(("row_counts", row_counts))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4 or w.dim() != 3 or w.shape[0] != x.shape[1] \
            or w.shape[1] != x.shape[3]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if row_counts is not None and row_counts.shape != x.shape[:2]:
        raise ValueError(f"row_counts must be {list(x.shape[:2])}, got "
                         f"{list(row_counts.shape)}")


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            row_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [E,C,D] or [G,E,C,D] @ w [E,D,F] -> [E,C,F] or [G,E,C,F], in
    x's dtype; rows ``>= row_counts`` ([E] or [G,E] int32) are 0.
    Differentiable in x and w."""
    return _MoeGmm.apply(x, w, row_counts)


def _forward(x: torch.Tensor, w: torch.Tensor,
             row_counts: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w, row_counts)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm runs on cuda, cpu or meta tensors, got "
                         f"{x.device}")
    squeeze = x.dim() == 3
    x4 = x.unsqueeze(0) if squeeze else x
    counts = row_counts
    if squeeze and row_counts is not None:
        counts = row_counts.unsqueeze(0)
    _check(x4, w, counts)
    g, e, c, d = x4.shape
    f = w.shape[2]
    out = torch.empty(g, e, c, f, dtype=x.dtype, device=x.device)
    if active() is not None:
        record_kernel("moe_gmm", *work(
            x4.shape, w.shape, x.element_size(), counts is not None))
    if x.device.type == "meta":
        return out.squeeze(0) if squeeze else out
    vp = ctypes.c_void_p
    lib = _lib()
    rc = lib.moe_gmm_fwd(
        vp(x4.data_ptr()), vp(w.data_ptr()),
        vp(None if counts is None else counts.data_ptr()),
        vp(out.data_ptr()), g, e, c, d, f, DTYPE_CODES[x.dtype],
        vp(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("moe_gmm kernel launch failed: "
                           + lib.moe_gmm_error_string(rc).decode())
    global launches
    launches += 1
    return out.squeeze(0) if squeeze else out


class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, row_counts):
        ctx.save_for_backward(x, w, row_counts)
        return _forward(x, w, row_counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, row_counts = ctx.saved_tensors
        with scope("moe_gmm_bwd"):
            dx, dw = moe_gmm_bwd(x, w, row_counts, dy)
        if dy.device.type == "cuda":
            global bwd_launches
            bwd_launches += 1
        return dx, dw, None


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor,
                row_counts: Optional[torch.Tensor], dy: torch.Tensor):
    """(dx, dw) of ``moe_gmm(x, w, row_counts)`` for the output cotangent
    ``dy``, in the dtypes of x and w."""
    squeeze = x.dim() == 3
    x4 = x.unsqueeze(0) if squeeze else x
    dy4 = (dy.unsqueeze(0) if squeeze else dy).float()
    if row_counts is not None:
        counts = row_counts.unsqueeze(0) if squeeze else row_counts
        live = (torch.arange(x4.shape[2], device=x.device)[None, None, :]
                < counts[..., None])
        dy4 = dy4 * live[..., None]
    with tf32_off():
        wf = w.float()
        dx = torch.einsum("gecf,edf->gecd", dy4, wf)
        dw = torch.einsum("gecd,gecf->edf", x4.float(), dy4)
    dx = dx.squeeze(0) if squeeze else dx
    return dx.to(x.dtype), dw.to(w.dtype)


@functools.lru_cache(maxsize=None)
def supported() -> bool:
    """Probe, don't version-sniff: True when the smallest real kernel
    launch (ragged edges, a zero count, a partial one) builds, runs and
    agrees with the plain version.  Probe launches are not counted."""
    if not torch.cuda.is_available():
        return False
    global launches
    before = launches
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(3, 5, 7, generator=gen, device=dev)
        w = torch.randn(3, 7, 9, generator=gen, device=dev)
        counts = torch.tensor([5, 0, 2], dtype=torch.int32, device=dev)
        got = moe_gmm(x, w, counts)
        want = moe_gmm_ref(x, w, counts)
        torch.cuda.synchronize()
        return bool(torch.allclose(got, want, atol=1e-5))
    except (RuntimeError, OSError):
        return False
    finally:
        launches = before
