"""Public flash-attention op: the Hopper kernel on the card, its plain
version on the CPU.

``flash_attention`` is what ``models/attention.chunked_attention`` calls
for every full prefill of the two-executable serving path.  Dispatch is
by where ``q`` lies, and nothing else:

* a CPU tensor runs ``ref.flash_attention_ref`` (full fp32 softmax);
* a CUDA tensor launches ``csrc/flash_attention.cu`` (built by
  ``kernels/build.py`` at first use) or raises — there is no fallback.

q [B,H,Sq,dh], k/v [B,Hkv,Skv,dh], fp32 or bf16 alike, contiguous; the
output is in q's dtype.  The kernel takes dh in {16, 32, 64, 112, 128, 256}
and, when causal, Sq <= Skv (query i sits at key position i, so every
row sees a key).  ``launches`` counts kernel launches (one per call on a
CUDA tensor), so a run can show that its main path went through the
kernel.  ``supported()`` runs the smallest real launch; tests use it to
skip.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# element type -> the kernel's dtype code (csrc: flash_attention_fwd)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# 112: zamba2-7b's shared attention; 16: the reduced configs (fig14)
HEAD_DIMS = (16, 32, 64, 112, 128, 256)

launches = 0    # kernel launches since import (callers may reset it)

# the C signature of csrc's flash_attention_fwd: 4 tensor pointers, B, H,
# Hkv, Sq, Skv, dh, the dtype code, causal and window, softcap and
# scale, the stream
FWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.flash_attention_fwd.argtypes = FWD_ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be one of {list(DTYPE_CODES)} and "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes dh in {HEAD_DIMS}, got {dh}")
    if skv < 1 or (causal and sq > skv):
        raise ValueError(f"the kernel takes Skv >= 1 and, causal, Sq <= "
                         f"Skv; got Sq={sq}, Skv={skv}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,H,Sq,dh]; k,v [B,Hkv,Skv,dh] -> [B,H,Sq,dh] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    _check(q, k, v, causal)
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    vp = ctypes.c_void_p
    lib = _lib()
    rc = lib.flash_attention_fwd(
        vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
        vp(out.data_ptr()), b, h, hkv, sq, skv, dh, DTYPE_CODES[q.dtype],
        int(bool(causal)), int(window or 0), float(softcap or 0.0),
        float(dh ** -0.5),
        vp(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    global launches
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def supported() -> bool:
    """Probe, don't version-sniff: True when the smallest real kernel
    launch (ragged tiles, GQA, a window) builds, runs and agrees with the
    plain version.  Probe launches are not counted."""
    if not torch.cuda.is_available():
        return False
    global launches
    before = launches
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(1, 2, 37, 32, generator=gen, device=dev)
        k = torch.randn(1, 1, 37, 32, generator=gen, device=dev)
        v = torch.randn(1, 1, 37, 32, generator=gen, device=dev)
        got = flash_attention(q, k, v, window=20)
        want = flash_attention_ref(q, k, v, window=20)
        torch.cuda.synchronize()
        return bool(torch.allclose(got, want, atol=1e-5))
    except (RuntimeError, OSError):
        return False
    finally:
        launches = before
