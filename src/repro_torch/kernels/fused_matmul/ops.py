"""Public fused-prep matmul ops: the Hopper kernel on the card, its plain
version on the CPU.

``fused_matmul`` is what fig11's "fused" case calls
(``repro_torch/benchmarks/fig11_fused_prep.py``): the upcast of x and its
per-row scale happen per tile inside the kernel that consumes the tile,
so the prepared x never reaches device memory.  Dispatch is by where
``x`` lies, and nothing else:

* a CPU tensor runs ``ref.matmul1`` (prep, then an fp32 product);
* a CUDA tensor launches ``csrc/fused_matmul.cu`` (built by
  ``kernels/build.py`` at first use) or raises — there is no fallback.

x ``[M,K]`` is int8, bf16, fp16 or fp32; w ``[K,N]`` fp32 or bf16;
x_scale, when given, fp32 ``[M,1]``; the output fp32 or bf16 (w's dtype
by default).  Every tensor is contiguous and on x's device; anything
else raises ``TypeError`` or ``ValueError`` naming the tensor, on either
device.  The reference's ``block_m/n/k`` are TPU tile sizes that only
restrict which shapes its kernel accepts (M, N and K multiples of the
blocks); the port's kernel masks its own ragged edges, so any M, N,
K >= 1 is accepted.  That computes the same function.

``matmul`` is the counterpart of the reference's ``jax.custom_vjp`` op:
a ``torch.autograd.Function`` whose forward is ``fused_matmul`` and
whose backward mirrors the reference's ``_bwd`` in plain products (the
reference's backward has no Pallas kernel either).

``launches`` counts kernel launches (one per call on a CUDA tensor), so
a run can show that its main path went through the kernel.
``supported()`` runs the smallest real launch; tests use it to skip.

A ``meta`` tensor (the dry-run) launches nothing: the op returns an
output of the right shape and records ``work(...)`` on the active
``analysis/count.StepCounter``; a CUDA launch records the same while a
counter is active.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, active, record_kernel
from repro_torch.kernels.fused_matmul.ref import matmul1, prep, tf32_off

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_matmul.cu"

# element type -> the kernel's dtype codes (csrc: fused_matmul_fwd)
X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.int8: 3}
W_CODES = {torch.float32: 0, torch.bfloat16: 1}
OUT_CODES = W_CODES

launches = 0    # kernel launches since import (callers may reset it)

# the C signature of csrc's fused_matmul_fwd: 4 tensor pointers, M, N, K
# and the three dtype codes, the stream
FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.fused_matmul_fwd.argtypes = FWD_ARGTYPES
    lib.fused_matmul_fwd.restype = ctypes.c_int
    lib.fused_matmul_error_string.argtypes = [ctypes.c_int]
    lib.fused_matmul_error_string.restype = ctypes.c_char_p
    return lib


def work(m: int, k: int, n: int, x_bytes: int, w_bytes: int,
         out_bytes: int, scaled: bool):
    """(flops, bytes) of one call: x, its row scale and w read once, the
    output written once; 2 M N K flops."""
    nbytes = m * k * x_bytes + (4 * m if scaled else 0) + k * n * w_bytes \
        + m * n * out_bytes
    return 2 * m * n * k, nbytes


def _check(x: torch.Tensor, w: torch.Tensor,
           x_scale: Optional[torch.Tensor], out_dtype: torch.dtype) -> None:
    for name, t, codes in (("x", x, X_CODES), ("w", w, W_CODES)):
        if t.dtype not in codes:
            raise TypeError(f"{name} must be one of {list(codes)}, got "
                            f"{t.dtype}")
    if out_dtype not in OUT_CODES:
        raise TypeError(f"out_dtype must be one of {list(OUT_CODES)}, got "
                        f"{out_dtype}")
    named = [("x", x), ("w", w)]
    if x_scale is not None:
        if x_scale.dtype != torch.float32:
            raise TypeError(f"x_scale must be torch.float32, got "
                            f"{x_scale.dtype}")
        named.append(("x_scale", x_scale))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} (want [M,K] and [K,N])")
    if min(x.shape[0], x.shape[1], w.shape[1]) < 1:
        raise ValueError(f"M, N and K must be >= 1: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x_scale is not None and tuple(x_scale.shape) != (x.shape[0], 1):
        raise ValueError(f"x_scale must be [{x.shape[0]}, 1], got "
                         f"{list(x_scale.shape)}")


def fused_matmul(x: torch.Tensor, w: torch.Tensor,
                 x_scale: Optional[torch.Tensor] = None, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M,K] (int8/bf16/fp16/fp32) @ w [K,N] (fp32/bf16) -> [M,N] in
    ``out_dtype`` (default w's dtype); ``x_scale`` [M,1] fp32 applies the
    per-row dequantization as the fused prep; fp32 accumulation."""
    out_dtype = out_dtype or w.dtype
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fused_matmul runs on cuda, cpu or meta tensors, "
                         f"got {x.device}")
    _check(x, w, x_scale, out_dtype)
    if x.device.type == "cpu":
        return matmul1(x, w, x_scale, out_dtype=out_dtype)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    if active() is not None:
        record_kernel("fused_matmul", *work(
            m, k, n, x.element_size(), w.element_size(), out.element_size(),
            x_scale is not None))
    if x.device.type == "meta":
        return out
    vp = ctypes.c_void_p
    lib = _lib()
    rc = lib.fused_matmul_fwd(
        vp(x.data_ptr()), vp(w.data_ptr()),
        vp(None if x_scale is None else x_scale.data_ptr()),
        vp(out.data_ptr()), m, n, k, X_CODES[x.dtype], W_CODES[w.dtype],
        OUT_CODES[out_dtype],
        vp(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("fused_matmul kernel launch failed: "
                           + lib.fused_matmul_error_string(rc).decode())
    global launches
    launches += 1
    return out


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, x_scale):
        ctx.save_for_backward(x, w, x_scale)
        return fused_matmul(x, w, x_scale)

    @staticmethod
    def backward(ctx, g):
        x, w, x_scale = ctx.saved_tensors
        gf = g.to(torch.float32)
        with tf32_off():
            dx_f = gf @ w.to(torch.float32).T    # [M,K] in prepared space
            dw = (prep(x, x_scale).T @ gf).to(w.dtype)
        dx = dscale = None
        if x_scale is not None:
            dscale = (dx_f * x.to(torch.float32)).sum(
                1, keepdim=True).to(x_scale.dtype)
            dx_f = dx_f * x_scale.to(torch.float32)
        if x.is_floating_point():
            dx = dx_f.to(x.dtype)
        return dx, dw, dscale


def matmul(x: torch.Tensor, w: torch.Tensor,
           x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused-prep matmul with autodiff, out in w's dtype: the forward is
    ``fused_matmul``; the backward gives dx = (g @ wᵀ) ⊙ x_scale in x's
    dtype, dw = prep(x)ᵀ @ g in w's and dscale = Σ_k (g @ wᵀ) ⊙ x in
    x_scale's, as the reference's ``_bwd``.  An integer x gets no
    gradient (``None``): torch keeps none on integer tensors, where the
    reference returns one cast to int8."""
    return _Matmul.apply(x, w, x_scale)


@functools.lru_cache(maxsize=None)
def supported() -> bool:
    """Probe, don't version-sniff: True when the smallest real kernel
    launch (int8 x, a row scale, ragged M, N and K) builds, runs and
    agrees with the plain version.  Probe launches are not counted."""
    if not torch.cuda.is_available():
        return False
    global launches
    before = launches
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randint(-127, 127, (5, 7), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randn(7, 9, generator=gen, device=dev)
        sc = torch.rand(5, 1, generator=gen, device=dev)
        got = fused_matmul(x, w, sc)
        want = matmul1(x, w, sc)
        torch.cuda.synchronize()
        return bool(torch.allclose(got, want, atol=1e-4))
    except (RuntimeError, OSError):
        return False
    finally:
        launches = before
