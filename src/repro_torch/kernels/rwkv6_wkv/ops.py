"""Public RWKV6 wkv ops: the Hopper kernel on the card, its plain version
on the CPU.

``wkv_model_layout`` is what ``models/rwkv6.wkv_chunked`` calls for
every rwkv6 layer of a full prefill; ``rwkv6_wkv`` is the kernel's own
(Pallas) layout.  Dispatch is by where ``r`` lies, and nothing else:

* a CPU tensor runs ``ref.rwkv6_wkv_ref`` (the per-step recurrence);
* a CUDA tensor launches ``csrc/rwkv6_wkv.cu`` (built by
  ``kernels/build.py`` at first use) or raises — there is no fallback.

The kernel takes fp32 operands with K <= 128 and any S, lw <= 0.  It runs
the chunked form in three CUDA kernels (each chunk's update, the state
carried across chunks, each chunk's output) through an fp32 scratch the
wrapper allocates at the size ``rwkv6_wkv_scratch_floats`` gives from
shapes.  Its one entry point addresses r, k, v, lw and y through (batch,
head, time) strides and u through (batch, head) strides, so the model's
layout (``[B,S,H,K]`` views of the ``[B,S,d]`` projections, u ``[H,K]``
shared by the batch rows) is read in place: no transpose and no
broadcast copy.  ``launches`` counts calls that launch the kernels (one
per call on a CUDA tensor, however many CUDA kernels it issues), so a
run can show that its main path went through the kernel.
``supported()`` runs a small real call; tests use it to skip.

The op is differentiable on both devices.  On a CUDA tensor the forward
call and its backward, ``csrc/rwkv6_wkv.cu``'s ``rwkv6_wkv_bwd`` (the
chunked form transposed: each chunk's R~^T dY and the gradient of the
state walked back across the chunks, then per (stream, chunk) every
product of the backward in 3xTF32 on the tensor cores, the decays
through 16-row pivots with every exponent <= 0; every sum in a fixed
order, so two calls give the same bits), are one
``torch.autograd.Function`` for both layouts: in the model's layout the
backward sums du over the batch rows that share u.  The backward reads
the forward call's scratch (each chunk's starting state and exp(c_end),
K^2 + K floats a stream and chunk), held on autograd's context: it lives
as long as the graph, and a call under ``no_grad`` records no graph, so
its scratch is freed at once.  The kernel reads the decay as
exp(min(lw, 0)), so dlw is 0 where lw > 0.
``ref.rwkv6_wkv_chunked_bwd_ref`` is that backward in plain PyTorch,
``ref.rwkv6_wkv_bwd_ref`` the per-step one.  ``bwd_launches`` counts
backward calls on CUDA tensors.  There is no fallback: a backward that
fails to build or launch raises.  The plain version on the CPU
differentiates through autograd.

A ``meta`` tensor (the dry-run, ``launch/build``) takes the kernels'
path, checks included, and launches nothing: each call returns outputs
of the right shape (and the forward's kept scratch, sized as the
library sizes it) and records ``work(...)`` (``work_bwd(...)`` for the
backward), the FLOPs of the chunked form's tensor-core products and the
bytes of PERF.md's bound, on the active ``analysis/count.StepCounter``;
a CUDA call records the same while a counter is active.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, active, causal_pairs, record_kernel
from repro_torch.kernels.rwkv6_wkv.ref import (CHUNK_ROWS, SUB_ROWS,
                                               rwkv6_wkv_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_wkv.cu"
MAX_HEAD = 128

launches = 0    # calls that launched the kernels (callers may reset it)
bwd_launches = 0   # backward calls on CUDA tensors (callers may reset it)

# the C signatures of csrc's rwkv6_wkv_fwd (8 tensor pointers, the
# scratch, B, H, S, K, the strides of r, k, v, lw and y (batch, head,
# time) and of u (batch, head), the stream) and rwkv6_wkv_scratch_floats
# (B, H, S, K)
FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 21 \
    + [ctypes.c_void_p]
SCRATCH_ARGTYPES = [ctypes.c_int] * 4
# rwkv6_wkv_bwd: 15 pointers (r, k, v, lw, u, the forward call's
# scratch, dy, dh_final, the 6 gradients, the scratch), B, H, S, K, the
# strides of r, k, v, lw and of dy and the gradients (batch, head, time),
# of u (batch, head), u's row count, the stream;
# rwkv6_wkv_bwd_scratch_floats: B, H, S, K
BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 22 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.rwkv6_wkv_fwd.argtypes = FWD_ARGTYPES
    lib.rwkv6_wkv_fwd.restype = ctypes.c_int
    lib.rwkv6_wkv_scratch_floats.argtypes = SCRATCH_ARGTYPES
    lib.rwkv6_wkv_scratch_floats.restype = ctypes.c_longlong
    lib.rwkv6_wkv_bwd.argtypes = BWD_ARGTYPES
    lib.rwkv6_wkv_bwd.restype = ctypes.c_int
    lib.rwkv6_wkv_bwd_scratch_floats.argtypes = SCRATCH_ARGTYPES
    lib.rwkv6_wkv_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.rwkv6_wkv_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_wkv_error_string.restype = ctypes.c_char_p
    return lib


def scratch_floats(B: int, H: int, S: int, K: int) -> int:
    """The forward call's scratch, as ``rwkv6_wkv_scratch_floats`` sizes
    it: each chunk's starting state and exp(c_end), K^2 + K floats a
    stream and chunk."""
    if B < 1 or H < 1 or S < 0 or K < 1:
        return 0
    return B * H * (-(-S // CHUNK_ROWS)) * (K * K + K)


@functools.lru_cache(maxsize=1024)
def work(B: int, H: int, S: int, K: int, u_rows: int, h0: bool):
    """(flops, bytes) of one forward call over B*H streams, PERF.md's
    bound: r, k, v, lw and u (``u_rows`` rows of K) read, y and the final
    state written, h0 read when given, fp32; the chunked form's
    tensor-core products (chunks of ``CHUNK_ROWS`` in sub-blocks of
    ``SUB_ROWS``): A left of the diagonal and in each diagonal
    sub-block's lower-left quadrant, the causal part of A V, r h_prev and
    the update (q K^2 each), 2 flops a multiply-add."""
    bh = B * H
    nbytes = 4 * (5 * bh * S * K + u_rows * K
                  + bh * K * K * (2 if h0 else 1))
    macs = 0
    half = SUB_ROWS // 2
    for t0 in range(0, S, CHUNK_ROWS):
        q = min(CHUNK_ROWS, S - t0)
        for b0 in range(0, q, SUB_ROWS):
            rows = min(SUB_ROWS, q - b0)
            macs += rows * b0 * K
            macs += max(0, rows - half) * min(half, rows) * K
        macs += q * (q + 1) // 2 * K + 2 * q * K * K
    return 2 * bh * macs, nbytes


@functools.lru_cache(maxsize=1024)
def work_bwd(B: int, H: int, S: int, K: int, u_rows: int, h0: bool):
    """(flops, bytes) of one backward call, PERF.md's bound: the
    forward's operands, dy (and dh_final and h0 when given) read once,
    the gradients written once, fp32; the chunked backward's products per
    stream: A, dA = dY V^T and A^T dY on the causal pairs and dR's and
    dK's pivot products on the pairs below the diagonal (x K each), and
    R~^T dY, K~ G, dY h^T and V G^T (q K^2 each)."""
    bh = B * H
    nbytes = 4 * (9 * bh * S * K + 2 * u_rows * K
                  + (3 if h0 else 0) * bh * K * K)
    flops = 2 * bh * K * (3 * causal_pairs(S, CHUNK_ROWS)
                          + 2 * causal_pairs(S, CHUNK_ROWS, True)
                          + 4 * S * K)
    return flops, nbytes


def _check(named: Sequence[Tuple[str, Optional[torch.Tensor]]],
           shapes: dict) -> None:
    """fp32 on one device, the expected shapes, unit inner stride and
    32-bit strides; h0 contiguous; K <= 128."""
    dev = named[0][1].device
    for name, t in named:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes fp32 operands; {name} is "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, r on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"shape mismatch: {name} {tuple(t.shape)}, "
                             f"want {shapes[name]}")
        if t.dim() and t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} needs a unit innermost stride")
        if any(st >= 2 ** 31 for st in t.stride()):
            raise ValueError(f"{name}'s strides exceed 32 bits")
    h0 = dict(named).get("h0")
    if h0 is not None and not h0.is_contiguous():
        raise ValueError("h0 must be contiguous")
    kk = shapes["r"][-1]
    if kk > MAX_HEAD:
        raise ValueError(f"the kernel takes K <= {MAX_HEAD}, got {kk}")


def _bht(t: torch.Tensor, layout: str) -> Tuple[int, int, int]:
    """(batch, head, time) element strides of a [BH,S,K] ("kernel") or
    [B,S,H,K] ("model") operand."""
    if layout == "kernel":
        return t.stride(0), 0, t.stride(1)
    return t.stride(0), t.stride(2), t.stride(1)


def _launch(r, k, v, lw, u, h0, *, B: int, H: int, S: int, K: int,
            layout: str, u_st: Tuple[int, int]):
    """One call of the kernels over B*H streams.  Returns (y contiguous in
    r's shape, h_final [B*H,K,K], the scratch: each chunk's starting state
    and exp(c_end), which the backward reads)."""
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    hout = torch.empty((B * H, K, K), dtype=torch.float32, device=r.device)
    if active() is not None:
        record_kernel("rwkv6_wkv", *work(
            B, H, S, K, u.numel() // K, h0 is not None))
    if r.device.type == "meta":
        n = scratch_floats(B, H, S, K)
        return y, hout, (torch.empty(n, dtype=torch.float32,
                                     device=r.device) if n else None)
    vp = ctypes.c_void_p
    lib = _lib()
    n = lib.rwkv6_wkv_scratch_floats(B, H, S, K)
    scratch = torch.empty(n, dtype=torch.float32, device=r.device) \
        if n else None
    strides = [s for t in (r, k, v, lw, y) for s in _bht(t, layout)]
    rc = lib.rwkv6_wkv_fwd(
        vp(r.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
        vp(lw.data_ptr()), vp(u.data_ptr()),
        vp(h0.data_ptr() if h0 is not None else 0), vp(y.data_ptr()),
        vp(hout.data_ptr()),
        vp(scratch.data_ptr() if scratch is not None else 0), B, H, S, K,
        *strides, *u_st,
        vp(torch.cuda.current_stream(r.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("rwkv6_wkv kernel launch failed: "
                           + lib.rwkv6_wkv_error_string(rc).decode())
    global launches
    launches += 1
    return y, hout, scratch


def _launch_bwd(r, k, v, lw, u, h0, fwd_scratch, dy, dh_final, *, B: int,
                H: int, S: int, K: int, layout: str,
                u_st: Tuple[int, int]):
    """One call of ``rwkv6_wkv_bwd``: the forward's operands and its
    call's scratch (None when S = 0), dy contiguous in r's shape, dh_final
    [B*H,K,K] contiguous or None.  Returns (dr, dk, dv, dlw, du, dh0): the
    first four contiguous in r's shape, du in u's (summed over the streams
    that share a row of u), dh0 [B*H,K,K] or None (h0 None)."""
    dev = r.device
    dr, dk, dv, dlw = (torch.empty(r.shape, dtype=torch.float32,
                                   device=dev) for _ in range(4))
    du = torch.empty(u.shape, dtype=torch.float32, device=dev)
    dh0 = None if h0 is None else torch.empty(
        (B * H, K, K), dtype=torch.float32, device=dev)
    if active() is not None:
        record_kernel("rwkv6_wkv_bwd", *work_bwd(
            B, H, S, K, u.numel() // K, h0 is not None))
    if dev.type == "meta":
        return dr, dk, dv, dlw, du, dh0
    vp = ctypes.c_void_p
    lib = _lib()
    n = lib.rwkv6_wkv_bwd_scratch_floats(B, H, S, K)
    scratch = torch.empty(max(n, 1), dtype=torch.float32, device=dev)

    def ptr(t):
        return vp(t.data_ptr() if t is not None else 0)
    strides = [s for t in (r, k, v, lw, dr) for s in _bht(t, layout)]
    rc = lib.rwkv6_wkv_bwd(
        ptr(r), ptr(k), ptr(v), ptr(lw), ptr(u), ptr(fwd_scratch), ptr(dy),
        ptr(dh_final), ptr(dr), ptr(dk), ptr(dv), ptr(dlw), ptr(du),
        ptr(dh0), ptr(scratch), B, H, S, K, *strides, *u_st,
        u.numel() // K, vp(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError("rwkv6_wkv backward launch failed: "
                           + lib.rwkv6_wkv_error_string(rc).decode())
    global bwd_launches
    bwd_launches += 1
    return dr, dk, dv, dlw, du, dh0


class _Wkv(torch.autograd.Function):
    """The kernels' call and its backward, for either layout (``geom``:
    B, H, S, K, the layout and u's strides); h0 [B*H,K,K] or None."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, h0, geom):
        y, hout, scratch = _launch(r, k, v, lw, u, h0, **geom)
        ctx.save_for_backward(r, k, v, lw, u, h0)
        ctx.fwd_scratch = scratch   # the states the backward reads
        ctx.geom = geom
        ctx.set_materialize_grads(False)
        return y, hout

    @staticmethod
    def backward(ctx, dy, dh_final):
        r, k, v, lw, u, h0 = ctx.saved_tensors
        dy = (torch.zeros(r.shape, dtype=torch.float32, device=r.device)
              if dy is None else dy.contiguous())
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        grads = _launch_bwd(r, k, v, lw, u, h0, ctx.fwd_scratch, dy,
                            dh_final, **ctx.geom)
        return (*grads, None)


def _on_cuda(r: torch.Tensor) -> bool:
    """True for the kernels' path: a CUDA tensor, or a ``meta`` one (the
    dry-run: checked and counted, never launched)."""
    if r.device.type == "cpu":
        return False
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_wkv runs on cuda, cpu or meta tensors, "
                         f"got {r.device}")
    return True


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout: r, k, v, lw [BH,S,K] (lw <= 0), u [BH,K], h0
    [BH,K,K] or None -> (y [BH,S,K], h_final [BH,K,K] fp32)."""
    if not _on_cuda(r):
        return rwkv6_wkv_ref(r, k, v, lw, u, h0)
    bh, s, kk = r.shape
    _check([("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u),
            ("h0", h0)],
           {"r": (bh, s, kk), "k": (bh, s, kk), "v": (bh, s, kk),
            "lw": (bh, s, kk), "u": (bh, kk), "h0": (bh, kk, kk)})
    u = u.contiguous()
    return _Wkv.apply(r, k, v, lw, u, h0,
                      dict(B=bh, H=1, S=s, K=kk, layout="kernel",
                           u_st=(u.stride(0), 0)))


def wkv_model_layout(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     lwh: torch.Tensor, uh: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's layout: rh, kh, vh, lwh [B,S,H,K], uh [H,K], h0
    [B,H,K,K] or None -> (y [B,S,H,K], h_final [B,H,K,K] fp32).  On the
    card: one launch that reads this layout in place.  On the CPU: the
    reference adapter's transpose to the kernel's layout, then the plain
    version."""
    bsz, s, h, kk = rh.shape
    if not _on_cuda(rh):
        def flat(z):
            return z.transpose(1, 2).reshape(bsz * h, s, kk)
        u2 = uh[None].expand(bsz, h, kk).reshape(bsz * h, kk)
        y, hf = rwkv6_wkv(flat(rh), flat(kh), flat(vh), flat(lwh), u2,
                          None if h0 is None
                          else h0.reshape(bsz * h, kk, kk))
        return y.reshape(bsz, h, s, kk).transpose(1, 2), \
            hf.reshape(bsz, h, kk, kk)
    h0f = None if h0 is None else h0.reshape(bsz * h, kk, kk)
    shape = (bsz, s, h, kk)
    _check([("r", rh), ("k", kh), ("v", vh), ("lw", lwh), ("u", uh),
            ("h0", h0f)],
           {"r": shape, "k": shape, "v": shape, "lw": shape, "u": (h, kk),
            "h0": (bsz * h, kk, kk)})
    uh = uh.contiguous()
    y, hf = _Wkv.apply(rh, kh, vh, lwh, uh, h0f,
                       dict(B=bsz, H=h, S=s, K=kk, layout="model",
                            u_st=(0, uh.stride(0))))
    return y, hf.view(bsz, h, kk, kk)


@functools.lru_cache(maxsize=None)
def supported() -> bool:
    """Probe, don't version-sniff: True when a small real call (a ragged
    K, two chunks, the last ragged, an initial state) builds, runs and
    agrees with the plain version.  Probe launches are not counted."""
    if not torch.cuda.is_available():
        return False
    global launches
    before = launches
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        r, k, v = (torch.randn(2, 100, 20, generator=gen, device=dev) * 0.5
                   for _ in range(3))
        lw = -torch.rand(2, 100, 20, generator=gen, device=dev) * 5.0
        u = torch.randn(2, 20, generator=gen, device=dev) * 0.3
        h0 = torch.randn(2, 20, 20, generator=gen, device=dev)
        got = rwkv6_wkv(r, k, v, lw, u, h0)
        want = rwkv6_wkv_ref(r, k, v, lw, u, h0)
        torch.cuda.synchronize()
        return all(bool(torch.allclose(g, w, atol=1e-4))
                   for g, w in zip(got, want))
    except (RuntimeError, OSError):
        return False
    finally:
        launches = before
