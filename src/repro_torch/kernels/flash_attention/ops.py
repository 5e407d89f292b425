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
and, when causal, q_offset + Sq <= Skv: query i sits at key position
q_offset + i (0 unless a context-parallel rank passes the position of
its first query within its keys), so every row sees a key.
``launches`` counts kernel launches (one per call on a CUDA tensor), so
a run can show that its main path went through the kernel.
``supported()`` runs the smallest real launch; tests use it to skip.

The op is differentiable (``forward_train`` runs it in every attention
layer): its backward, ``flash_attention_bwd``, is the flash backward in
explicit products on the saved q, k, v and output, on either device —
the scores recomputed, the softcap's chain rule, the masks, P, D =
rowsum(dO ⊙ O), dV = Pᵀ dO, dS = P ⊙ (dO Vᵀ − D), dQ = dS K · scale,
dK = dSᵀ Q · scale, dK and dV summed over each GQA group — in fp32 with
TF32 off, a slab of (batch, kv head) pairs at a time so that one score
tensor stays under ``BWD_SCORE_ELEMS``.  ``bwd_launches`` counts backward
calls on CUDA tensors.  It is not a kernel of its own yet.

A ``meta`` tensor (the dry-run, ``launch/build``) launches nothing: the
op returns an output of the right shape and records ``work(...)``, the
kernel's FLOPs and bytes from shapes, on the active
``analysis/count.StepCounter``; a CUDA launch records the same while a
counter is active.  The backward runs its explicit products on ``meta``
as on the card, inside ``scope("flash_attention_bwd")``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, active, record_kernel, scope
from repro_torch.kernels.flash_attention.ref import NEG_INF, \
    flash_attention_ref
from repro_torch.kernels.fused_matmul.ref import tf32_off

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# element type -> the kernel's dtype code (csrc: flash_attention_fwd)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# 112: zamba2-7b's shared attention; 16: the reduced configs (fig14)
HEAD_DIMS = (16, 32, 64, 112, 128, 256)

launches = 0    # kernel launches since import (callers may reset it)
bwd_launches = 0   # backward calls on CUDA tensors (callers may reset it)
# one slab's score tensor [n, G, Sq, Skv] holds at most this many fp32s
BWD_SCORE_ELEMS = 1 << 26

# the C signature of csrc's flash_attention_fwd: 4 tensor pointers, B, H,
# Hkv, Sq, Skv, dh, the dtype code, causal, window and q_offset, softcap
# and scale, the stream
FWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.flash_attention_fwd.argtypes = FWD_ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=4096)
def live_scores(sq: int, skv: int, causal: bool,
                window: Optional[int], q_offset: int = 0) -> int:
    """The unmasked (query row, key) pairs of one head: query ``i`` sits
    at key position ``q_offset + i``; causal keeps keys at or before it,
    a window keys less than ``window`` before it."""
    live = 0
    for i in range(q_offset, q_offset + sq):
        hi = min(i + 1, skv) if causal else skv
        lo = max(0, i - window + 1) if window is not None else 0
        live += max(0, hi - lo)
    return live


def work(q_shape, kv_shape, elem_bytes: int, causal: bool = True,
         window: Optional[int] = None, q_offset: int = 0):
    """(flops, bytes) of one call, PERF.md's bound: q, k, v read once and
    the output written once; 4 dh flops per (query head, live score)."""
    b, h, sq, dh = q_shape
    hkv, skv = kv_shape[1], kv_shape[2]
    nbytes = elem_bytes * (2 * b * h * sq * dh + 2 * b * hkv * skv * dh)
    return 4 * b * h * live_scores(sq, skv, causal, window,
                                   q_offset) * dh, nbytes


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, q_offset: int = 0) -> None:
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
    if skv < 1 or q_offset < 0 or (causal and q_offset + sq > skv):
        raise ValueError(f"the kernel takes Skv >= 1, q_offset >= 0 and, "
                         f"causal, q_offset + Sq <= Skv; got Sq={sq}, "
                         f"Skv={skv}, q_offset={q_offset}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,H,Sq,dh]; k,v [B,Hkv,Skv,dh] -> [B,H,Sq,dh] in q's dtype,
    differentiable in q, k and v; query ``i`` at key position
    ``q_offset + i``."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap,
                                 int(q_offset))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int],
             softcap: Optional[float], q_offset: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta "
                         f"tensors, got {q.device}")
    _check(q, k, v, causal, q_offset)
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if active() is not None:
        record_kernel("flash_attention", *work(
            q.shape, k.shape, q.element_size(), causal, window, q_offset))
    if q.device.type == "meta":
        return out
    vp = ctypes.c_void_p
    lib = _lib()
    rc = lib.flash_attention_fwd(
        vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
        vp(out.data_ptr()), b, h, hkv, sq, skv, dh, DTYPE_CODES[q.dtype],
        int(bool(causal)), int(window or 0), q_offset,
        float(softcap or 0.0), float(dh ** -0.5),
        vp(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    global launches
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        out = _forward(q, k, v, causal, window, softcap, q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        with scope("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, do, **ctx.opts)
        if do.device.type == "cuda":
            global bwd_launches
            bwd_launches += 1
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0):
    """The flash backward in explicit products: (dq, dk, dv) in the
    dtypes of q, k and v, for q [B,H,Sq,dh], k,v [B,Hkv,Skv,dh], the
    forward's output ``out`` and its cotangent ``do`` [B,H,Sq,dh].
    Query ``i`` sits at key position ``q_offset + i`` for the masks, as
    in the forward."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = dh ** -0.5
    n_all = b * hkv
    qf = q.reshape(n_all, g, sq, dh)
    of = out.reshape(n_all, g, sq, dh)
    dof = do.reshape(n_all, g, sq, dh)
    kf = k.reshape(n_all, skv, dh)
    vf = v.reshape(n_all, skv, dh)
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    dq3 = dq.view(n_all, g, sq, dh)
    dk3, dv3 = dk.view(n_all, skv, dh), dv.view(n_all, skv, dh)
    step = max(1, BWD_SCORE_ELEMS // (g * sq * skv))
    with tf32_off():
        for lo in range(0, n_all, step):
            sl = slice(lo, min(n_all, lo + step))
            qs, ks, vs = qf[sl].float(), kf[sl].float(), vf[sl].float()
            dos = dof[sl].float()
            s = torch.einsum("ngqd,nkd->ngqk", qs, ks) * scale
            if softcap is not None:
                t = torch.tanh(s / softcap)
                s = t * softcap
            s = torch.where(mask, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            del s
            d = (dos * of[sl].float()).sum(-1, keepdim=True)
            dv3[sl] = torch.einsum("ngqk,ngqd->nkd", p, dos)
            ds = p * (torch.einsum("ngqd,nkd->ngqk", dos, vs) - d)
            del p
            if softcap is not None:
                ds = ds * (1.0 - t * t)
                del t
            dq3[sl] = torch.einsum("ngqk,nkd->ngqd", ds, ks) * scale
            dk3[sl] = torch.einsum("ngqk,ngqd->nkd", ds, qs) * scale
            del ds
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
