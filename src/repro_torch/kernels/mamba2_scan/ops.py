"""Public Mamba2 scan ops: the Hopper kernel on the card, its plain
version on the CPU.

``scan_model_layout`` is what ``models/mamba2.ssd_chunked`` calls for
every Mamba2 layer of a full prefill; ``mamba2_scan`` is the kernel's
own (Pallas) layout.  Dispatch is by where ``x`` lies, and nothing else:

* a CPU tensor runs ``ref.mamba2_scan_ref`` (the per-step recurrence);
* a CUDA tensor launches ``csrc/mamba2_scan.cu`` (built by
  ``kernels/build.py`` at first use) or raises — there is no fallback.

The kernel computes the same function in the chunked SSD form (chunks of
64 steps, its four products in 3xTF32 on the tensor cores, the state
carried in fp32; ``ref.mamba2_scan_chunked_ref`` is that decomposition in
plain PyTorch, for the CPU tests).  It takes fp32 operands with N <= 128,
any S and P, dt >= 0 and a <= 0 (so every exponent it takes is <= 0).
Its one entry point addresses every operand through (batch, head, time)
strides, so the model's layout, whose b/c rows ``[B,S,N]`` are shared by
the H heads of a batch row, is read in place: no broadcast copy of b/c
and no transpose of x.  ``launches`` counts calls that launch the kernel
(one per call on a CUDA tensor), so a run can show that its main path
went through the kernel.  ``supported()`` runs the smallest real launch;
tests use it to skip.

The op is differentiable on both devices.  On a CUDA tensor the forward
launch and its backward, ``csrc/mamba2_scan.cu``'s ``mamba2_scan_bwd``
(the chunked SSD form transposed, chunks of 64 on the tensor cores in
3xTF32: the chunks' states h and gradients dL/dh walked once each way,
then every chunk's products in parallel, eight heads that share b/c to a
block; every sum in a fixed order, so two calls give the same bits), are
one ``torch.autograd.Function`` for both layouts: in the model's layout
the backward sums db and dc over the heads that share b/c and da over
the batch rows that share a.  ``ref.mamba2_scan_chunked_bwd_ref`` is
that backward's algebra in plain PyTorch; ``ref.mamba2_scan_bwd_ref``,
the per-step reverse recurrence, is the card's yardstick.
``bwd_launches`` counts backward calls on CUDA tensors.  There is no
fallback: a backward that fails to build or launch raises.  The plain
version on the CPU differentiates through autograd.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba2_scan.cu"
MAX_STATE = 128

launches = 0    # kernel launches since import (callers may reset it)
bwd_launches = 0   # backward calls on CUDA tensors (callers may reset it)

# the C signature of csrc's mamba2_scan_fwd: 8 tensor pointers, B, H, S,
# P, N, the strides of x, dt, b/c (batch, head, time) and a (batch,
# head), the stream
FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 16 \
    + [ctypes.c_void_p]
# mamba2_scan_bwd: 15 pointers (the forward's 6 operands, dy, dh_final,
# the 6 gradients, the scratch), B, H, S, P, N, the strides of x, dt, b/c
# (batch, head, time), a (batch, head) and ddt, a's element count, the
# stream; mamba2_scan_bwd_scratch_floats: B, H, S, P, N
BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 20 \
    + [ctypes.c_void_p]
BWD_SCRATCH_ARGTYPES = [ctypes.c_int] * 5


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.mamba2_scan_fwd.argtypes = FWD_ARGTYPES
    lib.mamba2_scan_fwd.restype = ctypes.c_int
    lib.mamba2_scan_bwd.argtypes = BWD_ARGTYPES
    lib.mamba2_scan_bwd.restype = ctypes.c_int
    lib.mamba2_scan_bwd_scratch_floats.argtypes = BWD_SCRATCH_ARGTYPES
    lib.mamba2_scan_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.mamba2_scan_error_string.argtypes = [ctypes.c_int]
    lib.mamba2_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(named: Sequence[Tuple[str, Optional[torch.Tensor]]],
           shapes: dict) -> None:
    """fp32 on one CUDA device, the expected shapes, unit inner stride
    and 32-bit strides; x contiguous (y takes its strides)."""
    dev = named[0][1].device
    for name, t in named:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes fp32 operands; {name} is "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"shape mismatch: {name} {tuple(t.shape)}, "
                             f"want {shapes[name]}")
        if t.dim() and t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} needs a unit innermost stride")
        if any(st >= 2 ** 31 for st in t.stride()):
            raise ValueError(f"{name}'s strides exceed 32 bits")
    x, h0 = named[0][1], dict(named).get("h0")
    if not x.is_contiguous() or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("x and h0 must be contiguous")
    n = shapes["b"][-1]
    if n > MAX_STATE:
        raise ValueError(f"the kernel takes N <= {MAX_STATE}, got {n}")


def _bht(t: torch.Tensor, layout: str) -> Tuple[int, int, int]:
    """(batch, head, time) element strides of an x-like [BH,S,P] or dt-like
    [BH,S] operand ("kernel"), or of [B,S,H,P] / [B,S,H] ("model")."""
    if layout == "kernel":
        return t.stride(0), 0, t.stride(1)
    return t.stride(0), t.stride(2), t.stride(1)


def _geometry(x, dt, b, a, layout: str) -> dict:
    """B, H, S, P, N and the strides of one launch over B*H streams: b/c
    rows have a head stride of 0 in both layouts (one head a stream in
    the kernel's), and a is indexed by stream ("kernel") or by head."""
    if layout == "kernel":
        (bsz, s, p), h = x.shape, 1
        a_st = (a.stride(0), 0)
    else:
        bsz, s, h, p = x.shape
        a_st = (0, a.stride(0))
    return dict(B=bsz, H=h, S=s, P=p, N=b.shape[-1], layout=layout,
                x_st=_bht(x, layout), dt_st=_bht(dt, layout),
                bc_st=(b.stride(0), 0, b.stride(1)), a_st=a_st)


def _launch(x, dt, b, c, a, h0, *, B: int, H: int, S: int, P: int, N: int,
            layout: str, x_st: Tuple[int, int, int],
            dt_st: Tuple[int, int, int], bc_st: Tuple[int, int, int],
            a_st: Tuple[int, int]):
    """One kernel launch over B*H streams; strides are (batch, head,
    time) in elements.  Returns (y with x's strides, h_final [B*H,N,P])."""
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535")
    y = torch.empty_like(x)
    hout = torch.empty((B * H, N, P), dtype=torch.float32, device=x.device)
    vp = ctypes.c_void_p
    lib = _lib()
    rc = lib.mamba2_scan_fwd(
        vp(x.data_ptr()), vp(dt.data_ptr()), vp(b.data_ptr()),
        vp(c.data_ptr()), vp(a.data_ptr()),
        vp(h0.data_ptr() if h0 is not None else 0), vp(y.data_ptr()),
        vp(hout.data_ptr()), B, H, S, P, N, *x_st, *dt_st, *bc_st, *a_st,
        vp(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("mamba2_scan kernel launch failed: "
                           + lib.mamba2_scan_error_string(rc).decode())
    global launches
    launches += 1
    return y, hout


def _launch_bwd(x, dt, b, c, a, h0, dy, dh_final, *, B: int, H: int,
                S: int, P: int, N: int, layout: str,
                x_st: Tuple[int, int, int], dt_st: Tuple[int, int, int],
                bc_st: Tuple[int, int, int], a_st: Tuple[int, int]):
    """One call of ``mamba2_scan_bwd``: dy takes x's strides (x is
    contiguous), dh_final [B*H,N,P] contiguous or None.  Returns (dx,
    ddt, db, dc, da, dh0): each in its operand's shape (db and dc
    contiguous, summed over the heads that share b/c; da over the streams
    that share a), dh0 [B*H,N,P] or None."""
    dev = x.device
    dx = torch.empty_like(x)
    ddt = torch.empty(dt.shape, dtype=torch.float32, device=dev)
    db = torch.empty(b.shape, dtype=torch.float32, device=dev)
    dc = torch.empty(b.shape, dtype=torch.float32, device=dev)
    da = torch.empty(a.shape, dtype=torch.float32, device=dev)
    dh0 = None if h0 is None else torch.empty(
        (B * H, N, P), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    lib = _lib()
    n = lib.mamba2_scan_bwd_scratch_floats(B, H, S, P, N)
    scratch = torch.empty(max(n, 1), dtype=torch.float32, device=dev)

    def ptr(t):
        return vp(t.data_ptr() if t is not None else 0)
    rc = lib.mamba2_scan_bwd(
        ptr(x), ptr(dt), ptr(b), ptr(c), ptr(a), ptr(h0), ptr(dy),
        ptr(dh_final), ptr(dx), ptr(ddt), ptr(db), ptr(dc), ptr(da),
        ptr(dh0), ptr(scratch), B, H, S, P, N, *x_st, *dt_st, *bc_st,
        *a_st, *_bht(ddt, layout), a.numel(),
        vp(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError("mamba2_scan backward launch failed: "
                           + lib.mamba2_scan_error_string(rc).decode())
    global bwd_launches
    bwd_launches += 1
    return dx, ddt, db, dc, da, dh0


class _Scan(torch.autograd.Function):
    """The kernel's launch and its backward, for either layout (the
    geometry from ``_geometry``); h0 [B*H,N,P] or None."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, h0, geom):
        y, hout = _launch(x, dt, b, c, a, h0, **geom)
        ctx.save_for_backward(x, dt, b, c, a, h0)
        ctx.geom = geom
        ctx.set_materialize_grads(False)
        return y, hout

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, b, c, a, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        grads = _launch_bwd(x, dt, b, c, a, h0, dy, dh_final, **ctx.geom)
        return (*grads, None)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_scan runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return True


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, a: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout: x [BH,S,P], dt [BH,S] (softplus'd, > 0),
    b/c [BH,S,N], a [BH] (negative), h0 [BH,N,P] or None -> (y [BH,S,P],
    h_final [BH,N,P] fp32)."""
    if not _on_cuda(x):
        return mamba2_scan_ref(x, dt, b, c, a, h0)
    bh, s, p = x.shape
    n = b.shape[-1]
    if c.stride() != b.stride():
        raise ValueError("b and c must share their strides")
    _check([("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a),
            ("h0", h0)],
           {"x": (bh, s, p), "dt": (bh, s), "b": (bh, s, n),
            "c": (bh, s, n), "a": (bh,), "h0": (bh, n, p)})
    a = a.contiguous()
    return _Scan.apply(x, dt, b, c, a, h0,
                       _geometry(x, dt, b, a, "kernel"))


def scan_model_layout(xh: torch.Tensor, dt: torch.Tensor,
                      b_in: torch.Tensor, c_in: torch.Tensor,
                      a_log: torch.Tensor,
                      h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's layout: xh [B,S,H,P], dt [B,S,H], b_in/c_in [B,S,N]
    (n_groups = 1: shared by the heads), a_log [H], h0 [B,H,N,P] or None
    -> (y [B,S,H,P], h_final [B,H,N,P] fp32).  On the card: one launch
    that reads this layout in place (b/c may be column slices of one
    [B,S,2N] tensor).  On the CPU: the reference adapter's broadcast to
    the kernel's layout, then the plain version."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    a = -torch.exp(a_log.float())                                # [H]
    if not _on_cuda(xh):
        x2 = xh.transpose(1, 2).reshape(bsz * h, s, p)
        dt2 = dt.transpose(1, 2).reshape(bsz * h, s)
        bb = b_in[:, None].expand(bsz, h, s, n).reshape(bsz * h, s, n)
        cc = c_in[:, None].expand(bsz, h, s, n).reshape(bsz * h, s, n)
        aa = a[None].expand(bsz, h).reshape(bsz * h)
        y, hf = mamba2_scan(x2, dt2, bb, cc, aa, None if h0 is None
                            else h0.reshape(bsz * h, n, p))
        return y.reshape(bsz, h, s, p).transpose(1, 2), \
            hf.reshape(bsz, h, n, p)
    if c_in.stride() != b_in.stride():
        raise ValueError("b_in and c_in must share their strides")
    h0f = None if h0 is None else h0.reshape(bsz * h, n, p)
    _check([("x", xh), ("dt", dt), ("b", b_in), ("c", c_in), ("a", a),
            ("h0", h0f)],
           {"x": (bsz, s, h, p), "dt": (bsz, s, h), "b": (bsz, s, n),
            "c": (bsz, s, n), "a": (h,), "h0": (bsz * h, n, p)})
    y, hf = _Scan.apply(xh, dt, b_in, c_in, a, h0f,
                        _geometry(xh, dt, b_in, a, "model"))
    return y, hf.view(bsz, h, n, p)


@functools.lru_cache(maxsize=None)
def supported() -> bool:
    """Probe, don't version-sniff: True when the smallest real kernel
    launch (ragged P and S, N padded, an initial state) builds, runs and
    agrees with the plain version.  Probe launches are not counted."""
    if not torch.cuda.is_available():
        return False
    global launches
    before = launches
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(2, 37, 20, generator=gen, device=dev)
        dt = torch.rand(2, 37, generator=gen, device=dev) * 0.1
        b = torch.randn(2, 37, 20, generator=gen, device=dev)
        c = torch.randn(2, 37, 20, generator=gen, device=dev)
        a = -torch.rand(2, generator=gen, device=dev) - 0.5
        h0 = torch.randn(2, 20, 20, generator=gen, device=dev)
        got = mamba2_scan(x, dt, b, c, a, h0)
        want = mamba2_scan_ref(x, dt, b, c, a, h0)
        torch.cuda.synchronize()
        return all(bool(torch.allclose(g, w, atol=1e-4))
                   for g, w in zip(got, want))
    except (RuntimeError, OSError):
        return False
    finally:
        launches = before
