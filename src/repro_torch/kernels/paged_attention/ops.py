"""Public paged decode-attention op: the Hopper kernel on the card, its
plain version on the CPU.

``paged_attention`` is what ``models/attention.paged_decode_step`` calls
when the engine's ``paged_kernel`` flag is on.  Dispatch is by where the
query lies, and nothing else:

* a CPU tensor runs ``ref.paged_attention_ref`` (gather-then-attend);
* a CUDA tensor launches ``csrc/paged_attention.cu`` (built by
  ``kernels/build.py`` at first use) or raises — there is no fallback.

``launches`` counts kernel launches (one per call on a CUDA tensor), so
a run can show that its main path went through the kernel.
``supported()`` runs the smallest real launch; tests use it to skip.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

launches = 0    # kernel launches since import (callers may reset it)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_fwd.argtypes = (
        [ptr] * 6 + [i32] * 9 + [ctypes.c_float] * 2 + [ptr])
    lib.paged_attention_fwd.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, pool_k, pool_v, page_table, cache_len) -> None:
    dev = q.device
    for name, x, dt in (("q", q, torch.float32),
                        ("pool_k", pool_k, torch.float32),
                        ("pool_v", pool_v, torch.float32),
                        ("page_table", page_table, torch.int32),
                        ("cache_len", cache_len, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype} (the "
                            "kernel serves fp32 pools; 8-bit pools are "
                            "ROADMAP B2)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, _s, h, dh = q.shape
    _npg, page_size, hkv, dh2 = pool_k.shape
    if pool_v.shape != pool_k.shape or dh2 != dh or h % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}")
    if dh % 4 or dh > 256 or page_size > 64 or page_size & (page_size - 1):
        raise ValueError(f"the kernel takes dh % 4 == 0, dh <= 256 and a "
                         f"power-of-two page size <= 64; got dh={dh}, "
                         f"page_size={page_size}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(cache_len.shape) != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / "
                         f"cache_len {tuple(cache_len.shape)} do not match "
                         f"batch {b}")


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, page_table: torch.Tensor,
                    cache_len: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Pool-direct decode attention for 1..S query rows per slot (``q``
    [B,H,dh] or [B,S,H,dh]); pools [num_pages+1,P,Hkv,dh] fp32,
    page_table [B,nb] int32, cache_len [B] int32 -> output like ``q``."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, page_table, cache_len,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    squeeze = q.dim() == 3
    q4 = q.unsqueeze(1) if squeeze else q
    _check(q4, pool_k, pool_v, page_table, cache_len)
    b, s, h, dh = q4.shape
    npg, page_size, hkv, _ = pool_k.shape
    out = torch.empty_like(q4)
    vp = ctypes.c_void_p
    lib = _lib()
    rc = lib.paged_attention_fwd(
        vp(q4.data_ptr()), vp(pool_k.data_ptr()), vp(pool_v.data_ptr()),
        vp(page_table.data_ptr()), vp(cache_len.data_ptr()),
        vp(out.data_ptr()), b, s, h, hkv, dh, page_size,
        page_table.shape[1], npg, int(window or 0), float(softcap or 0.0),
        float(dh ** -0.5), vp(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.paged_attention_error_string(rc).decode())
    global launches
    launches += 1
    return out.squeeze(1) if squeeze else out


@functools.lru_cache(maxsize=None)
def supported() -> bool:
    """Probe, don't version-sniff: True when the smallest real kernel
    launch builds, runs and agrees with the plain version."""
    if not torch.cuda.is_available():
        return False
    global launches
    before = launches
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(1, 2, 32, generator=gen, device=dev)
        pool = torch.randn(3, 4, 1, 32, generator=gen, device=dev)
        pt = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
        cl = torch.tensor([5], dtype=torch.int32, device=dev)
        got = paged_attention(q, pool, pool, pt, cl)
        want = paged_attention_ref(q, pool, pool, pt, cl)
        torch.cuda.synchronize()
        return bool(torch.allclose(got, want, atol=1e-5))
    except (RuntimeError, OSError):
        return False
    finally:
        launches = before
