"""Public paged decode-attention op: the Hopper kernel on the card, its
plain version on the CPU.

``paged_attention`` is what ``models/attention.paged_decode_step`` calls
when the engine's ``paged_kernel`` flag is on.  Dispatch is by where the
query lies, and nothing else:

* a CPU tensor runs ``ref.paged_attention_ref`` (gather-then-attend);
* a CUDA tensor launches ``csrc/paged_attention.cu`` (built by
  ``kernels/build.py`` at first use) or raises — there is no fallback.

Pools are fp32, or int8 / fp8_e4m3 with ``k_scale``/``v_scale``
[num_pages+1, Hkv] fp32 (one kernel, its element type a template
parameter).  The kernel splits the ring across blocks; with more than
one split the wrapper allocates the partials' fp32 scratch
(``torch.empty`` of the size the library's
``paged_attention_scratch_floats`` gives from shapes only, so a call
stays free of host syncs) and the call makes two device kernels, the
second combining the splits.  ``launches`` counts
calls that launched (one per call on a CUDA tensor) and
``launches_by_dtype`` the same by pool dtype, so a run can show that
its main path went through the kernel.
``supported(kv_dtype)`` runs the smallest real launch in that pool
dtype; tests use it to skip.
Serving only: on a CUDA tensor the wrapper raises under autograd (the
kernel has no backward).

A ``meta`` tensor (the dry-run) launches nothing: the op returns an
output of the right shape and records ``work(...)`` on the active
``analysis/count.StepCounter``; a CUDA launch records the same while a
counter is active.  The work is counted from shapes (every page of the
table, every query row against the whole ring or window), since a
length on ``meta`` has no value; PERF.md's bound counts live pages.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, active, record_kernel, refuse_autograd
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

# pool dtype -> the kernel's element-type code (csrc: kv_dtype)
KV_DTYPE_CODES = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
KV_DTYPE_NAMES = {torch.float32: "fp32", torch.int8: "int8",
                  torch.float8_e4m3fn: "fp8_e4m3"}

launches = 0    # kernel launches since import (callers may reset it)
launches_by_dtype = {name: 0 for name in KV_DTYPE_NAMES.values()}


# the C signatures of csrc's paged_attention_fwd (8 tensor pointers and
# the scratch, 10 ints: shapes, dtype code, window; softcap and scale, the
# stream) and paged_attention_scratch_floats (7 shapes)
FWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
SCRATCH_ARGTYPES = [ctypes.c_int] * 7


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    i32 = ctypes.c_int
    lib.paged_attention_fwd.argtypes = FWD_ARGTYPES
    lib.paged_attention_fwd.restype = i32
    lib.paged_attention_scratch_floats.argtypes = SCRATCH_ARGTYPES
    lib.paged_attention_scratch_floats.restype = ctypes.c_longlong
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_floats(*shape: int) -> int:
    """The library's scratch size for these shapes (B, S, H, Hkv, dh, P,
    nb), asked once per shape."""
    return _lib().paged_attention_scratch_floats(*shape)


def work(q_shape, pool_shape, page_table_shape, kv_bytes: int,
         quantized: bool, window: Optional[int] = None):
    """(flops, bytes) of one call from shapes: q [B,S,H,dh] read and the
    output written (fp32), every page of the table read at its stored
    width (8-bit pages with their fp32 scale per kv head, K and V), the
    table and the lengths; 4 dh flops per (query head, row, position of
    the ring, or of the window when it is shorter)."""
    b, s, h, dh = q_shape
    _npg, p, hkv, _ = pool_shape
    nb = page_table_shape[1]
    page = p * hkv * dh * kv_bytes * 2 + (hkv * 4 * 2 if quantized else 0)
    ring = nb * p
    span = min(ring, window) if window else ring
    nbytes = 2 * b * s * h * dh * 4 + b * nb * page + b * nb * 4 + b * 4
    return 4 * dh * h * b * s * span, nbytes


def _check(q, pool_k, pool_v, page_table, cache_len, k_scale,
           v_scale) -> None:
    dev = q.device
    if pool_k.dtype not in KV_DTYPE_CODES or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"pools must be one of {list(KV_DTYPE_NAMES)} and "
                        f"of one dtype, got {pool_k.dtype}/{pool_v.dtype}")
    quant = pool_k.dtype != torch.float32
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError(f"{pool_k.dtype} pools take k_scale and v_scale "
                         "exactly when they are 8-bit")
    named = [("q", q, torch.float32), ("pool_k", pool_k, pool_k.dtype),
             ("pool_v", pool_v, pool_k.dtype),
             ("page_table", page_table, torch.int32),
             ("cache_len", cache_len, torch.int32)]
    if quant:
        named += [("k_scale", k_scale, torch.float32),
                  ("v_scale", v_scale, torch.float32)]
    for name, x, dt in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, _s, h, dh = q.shape
    npg, page_size, hkv, dh2 = pool_k.shape
    if pool_v.shape != pool_k.shape or dh2 != dh or h % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}")
    if quant and (tuple(k_scale.shape) != (npg, hkv)
                  or tuple(v_scale.shape) != (npg, hkv)):
        raise ValueError(f"scales must be [{npg}, {hkv}], got "
                         f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
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
                    softcap: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pool-direct decode attention for 1..S query rows per slot (``q``
    [B,H,dh] or [B,S,H,dh]); pools [num_pages+1,P,Hkv,dh] fp32, or int8
    / fp8_e4m3 with ``k_scale``/``v_scale`` [num_pages+1,Hkv] fp32;
    page_table [B,nb] int32, cache_len [B] int32 -> output like ``q``."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, page_table, cache_len,
                                   window=window, softcap=softcap,
                                   k_scale=k_scale, v_scale=v_scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_attention runs on cuda, cpu or meta "
                         f"tensors, got {q.device}")
    refuse_autograd("paged_attention", q, pool_k, pool_v)
    squeeze = q.dim() == 3
    q4 = q.unsqueeze(1) if squeeze else q
    _check(q4, pool_k, pool_v, page_table, cache_len, k_scale, v_scale)
    b, s, h, dh = q4.shape
    npg, page_size, hkv, _ = pool_k.shape
    nb = page_table.shape[1]
    out = torch.empty_like(q4)
    if active() is not None:
        record_kernel("paged_attention", *work(
            q4.shape, pool_k.shape, page_table.shape,
            pool_k.element_size(), k_scale is not None, window))
    if q.device.type == "meta":
        return out.squeeze(1) if squeeze else out
    n = _scratch_floats(b, s, h, hkv, dh, page_size, nb)
    scratch = torch.empty(n, device=q.device) if n else None
    vp = ctypes.c_void_p

    def ptr(x):
        return vp(None if x is None else x.data_ptr())

    lib = _lib()
    rc = lib.paged_attention_fwd(
        ptr(q4), ptr(pool_k), ptr(pool_v), ptr(k_scale), ptr(v_scale),
        ptr(page_table), ptr(cache_len), ptr(out), ptr(scratch),
        b, s, h, hkv, dh, page_size, nb, npg,
        KV_DTYPE_CODES[pool_k.dtype], int(window or 0),
        float(softcap or 0.0), float(dh ** -0.5),
        vp(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.paged_attention_error_string(rc).decode())
    global launches
    launches += 1
    launches_by_dtype[KV_DTYPE_NAMES[pool_k.dtype]] += 1
    return out.squeeze(1) if squeeze else out


@functools.lru_cache(maxsize=None)
def supported(kv_dtype: str = "fp32") -> bool:
    """Probe, don't version-sniff: True when the smallest real kernel
    launch with ``kv_dtype`` pools ("fp32", "int8", "fp8_e4m3") builds,
    runs and agrees with the plain version.  Probe launches are not
    counted."""
    dtypes = {name: dt for dt, name in KV_DTYPE_NAMES.items()}
    if kv_dtype not in dtypes:
        raise ValueError(f"kv_dtype must be one of {list(dtypes)}, got "
                         f"{kv_dtype!r}")
    if not torch.cuda.is_available():
        return False
    global launches
    before = launches, dict(launches_by_dtype)
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(1, 2, 32, generator=gen, device=dev)
        pool = torch.randn(3, 4, 1, 32, generator=gen, device=dev)
        scale = None
        if kv_dtype != "fp32":
            scale = pool.abs().amax(dim=(1, 3)) / 100.0
            pool = (pool / scale[:, None, :, None]).round().to(
                dtypes[kv_dtype])
        pt = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
        cl = torch.tensor([5], dtype=torch.int32, device=dev)
        kw = dict(k_scale=scale, v_scale=scale)
        got = paged_attention(q, pool, pool, pt, cl, **kw)
        want = paged_attention_ref(q, pool, pool, pt, cl, **kw)
        torch.cuda.synchronize()
        return bool(torch.allclose(got, want, atol=1e-5))
    except (RuntimeError, OSError):
        return False
    finally:
        launches = before[0]
        launches_by_dtype.update(before[1])
