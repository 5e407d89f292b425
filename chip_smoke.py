#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the fused chunked-prefill engine serving
full-width internlm2-1.8b (random weights from a seed) from fp32, int8
and fp8_e4m3 KV page pools — and holds every CUDA kernel on them against
its plain PyTorch version.  Phases, each printing JSON lines:

1. device: the card's name and power limit (as nvidia-smi reports them),
   torch and CUDA versions; TF32 off.
2. build: every kernel source compiled by nvcc (in parallel), seconds.
3. kernels: the paged-attention kernel on fp32, int8 and fp8_e4m3 pools
   (8-bit pools quantized by the port's ``quantize_pages``) against its
   plain version at the main path's shapes and at edge cases (max abs
   error <= 1e-4), timed with CUDA events beside its plain version, one
   library call as a yardstick (never used by the port) and its bound on
   this card.
4. engine, once per pool dtype: full-width serving, 12 greedy requests
   with a shared prompt head; checks 32 tokens each, kernel launches of
   that dtype == layers x micro-steps (counts zeroed just before, read
   just after), 0 leaked pages, prefix hits with copy-on-write of a
   partially matched page, and one chunk free of host syncs.  For 8-bit
   pools it also prints, as information, greedy agreement with the fp32
   run and the teacher-forced max logit difference against fp32 pools.
5. paths, on the fp32 and the int8 engine: full-width ``forward_verify``
   logits through the kernel against the gather path on the same mid-run
   cache state (<= 1e-3).

The last two lines are the kernel table and ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before them.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
DEV = "cuda"
KERNEL_TOL = 1e-4     # fp32, TF32 off: only the summation order differs
PATH_TOL = 1e-3       # 24 layers of that difference, on logits
KV_DTYPES = ("fp32", "int8", "fp8_e4m3")
SHARED_HEAD = 264     # tokens of the prompt head every other request shares


class SmokeFailure(Exception):
    pass


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, iters: int = 30, flush=None) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` calls, each between
    two CUDA events; ``flush`` (a large buffer) is rewritten before each
    call so the call finds L2 cold, as the serving loop does."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Phase 3: paged attention against its plain version
# ---------------------------------------------------------------------------

def paged_case(torch, gen, *, B, H, Hkv, dh, P, nb, S, lens, window=None,
               softcap=None, trash_tail=0, dead_slots=(), pool_dtype=None,
               quantize=None):
    """Random pools and a valid table: distinct pages per slot, entries
    past each slot's reservation (and an optional tail) on the trash page,
    ``dead_slots`` wholly trash.  An 8-bit ``pool_dtype``: the random fp32
    pages quantized by ``quantize`` (the port's ``quantize_pages``)."""
    dev = torch.device(DEV)
    npg = B * nb
    pool_k = torch.randn(npg + 1, P, Hkv, dh, generator=gen, device=dev)
    pool_v = torch.randn(npg + 1, P, Hkv, dh, generator=gen, device=dev)
    k_scale = v_scale = None
    if pool_dtype not in (None, torch.float32):
        pool_k, k_scale = quantize(pool_k, pool_dtype)
        pool_v, v_scale = quantize(pool_v, pool_dtype)
    q = torch.randn(B, S, H, dh, generator=gen, device=dev)
    perm = torch.randperm(npg, generator=gen, device=dev).view(B, nb)
    pt = perm.clone()
    for b in range(B):
        need = min(nb, -(-max(lens[b], 1) // P) + 1)
        pt[b, need:] = npg
        if trash_tail:
            pt[b, nb - trash_tail:] = npg
        if b in dead_slots:
            pt[b] = npg
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return dict(q=q, pool_k=pool_k, pool_v=pool_v,
                page_table=pt.to(torch.int32).contiguous(), cache_len=cl,
                window=window, softcap=softcap, k_scale=k_scale,
                v_scale=v_scale)


def paged_need(torch, case):
    """Bytes and flops this call's data needs: live pages (non-trash, some
    row valid) read once at their stored width (8-bit pages with their two
    fp32 scales per kv head), q read and the output written once; 4*dh
    flops per (query head, row, valid position)."""
    q, pk, pt, cl = (case["q"], case["pool_k"], case["page_table"],
                     case["cache_len"])
    B, S, H, dh = q.shape
    npg, P, Hkv, _ = pk.shape
    nb = pt.shape[1]
    ring = nb * P
    t = (cl.long().cpu() - 1)[:, None]
    r = torch.arange(ring)[None, :]
    u = t - torch.remainder(t - r, ring)                       # [B, R]
    qpos = t + 1 - S + torch.arange(S)[None, :]               # [B, S]
    valid = (u >= 0)[:, None] & (u[:, None] <= qpos[:, :, None])
    if case["window"] is not None:
        valid &= u[:, None] > qpos[:, :, None] - case["window"]
    live_tab = (pt.cpu() != npg - 1)
    valid &= live_tab.repeat_interleave(P, dim=1)[:, None]
    live_pages = int(valid.view(B, S, nb, P).any(dim=3).any(dim=1).sum())
    page_bytes = P * Hkv * dh * pk.element_size() * 2
    if case["k_scale"] is not None:
        page_bytes += Hkv * 4 * 2
    nbytes = (live_pages * page_bytes + 2 * q.numel() * 4
              + pt.numel() * 4 + cl.numel() * 4)
    flops = int(valid.sum()) * H * 4 * dh
    return nbytes, flops


def phase_kernels(torch, ops, quantize, kv_pool_dtype):
    """Every case once per pool dtype.  Returns, per dtype, the worst
    error over its cases and the timed main-shape records."""
    gen = torch.Generator(device=DEV).manual_seed(1234)
    # the main path: internlm2-1.8b, 8 slots, max_len 1024 / page 16, the
    # fused chunk's S = 32 rows (and plain decode's S = 1)
    main = dict(B=8, H=16, Hkv=8, dh=128, P=16, nb=64)
    lens32 = [1024, 900, 700, 512, 333, 200, 97, 40]
    cases = [
        ("main_s32", dict(main, S=32, lens=lens32)),
        ("main_s1", dict(main, S=1, lens=lens32)),
        ("window_wrap", dict(B=4, H=8, Hkv=4, dh=128, P=16, nb=8, S=7,
                             lens=[300, 129, 64, 5], window=100)),
        ("softcap", dict(main, S=5, lens=lens32, softcap=30.0)),
        ("trash_tail", dict(main, S=3, lens=lens32, trash_tail=40)),
        ("no_valid_rows", dict(B=4, H=16, Hkv=8, dh=128, P=16, nb=8, S=4,
                               lens=[0, 2, 60, 128], dead_slots=(2,))),
        ("gqa_8to1", dict(B=4, H=64, Hkv=8, dh=128, P=16, nb=16, S=5,
                          lens=[256, 100, 17, 1])),
        ("odd_head_dim_p8", dict(B=3, H=12, Hkv=4, dh=80, P=8, nb=12, S=9,
                                 lens=[96, 50, 9])),
        ("page64_dh64", dict(B=2, H=4, Hkv=2, dh=64, P=64, nb=4, S=33,
                             lens=[256, 70])),
        ("dh256_p4", dict(B=2, H=4, Hkv=2, dh=256, P=4, nb=16, S=3,
                          lens=[61, 7])),
    ]
    worst = {kv: 0.0 for kv in KV_DTYPES}
    rows = {kv: {} for kv in KV_DTYPES}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    for kv_dtype in KV_DTYPES:
        for name, kw in cases:
            case = paged_case(torch, gen, quantize=quantize,
                              pool_dtype=kv_pool_dtype(kv_dtype), **kw)
            args = (case["q"], case["pool_k"], case["pool_v"],
                    case["page_table"], case["cache_len"])
            opts = dict(window=case["window"], softcap=case["softcap"],
                        k_scale=case["k_scale"], v_scale=case["v_scale"])
            got = ops.paged_attention(*args, **opts)
            want = ops.paged_attention_ref(*args, **opts)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{kv_dtype} {name}: non-finite output")
            err = float((got - want).abs().max())
            worst[kv_dtype] = max(worst[kv_dtype], err)
            rec = {"case": name, "kv_dtype": kv_dtype, "max_abs_err": err,
                   "tol": KERNEL_TOL}
            if name == "no_valid_rows":
                # slot 0 (nothing written) and slot 2 (all-trash table)
                zero = (bool((got[0] == 0).all())
                        and bool((got[2] == 0).all()))
                rec["dead_rows_exactly_zero"] = zero
                check(zero, f"{kv_dtype} {name}: rows with no valid "
                            "position are not 0")
            check(err <= KERNEL_TOL,
                  f"{kv_dtype} {name}: max abs err {err} > {KERNEL_TOL}")
            if name.startswith("main"):
                nbytes, flops = paged_need(torch, case)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_flops = flops / FP32_FLOPS * 1e3
                rec.update(
                    ms=cuda_ms(torch,
                               lambda: ops.paged_attention(*args, **opts),
                               flush=flush),
                    plain_ms=cuda_ms(
                        torch,
                        lambda: ops.paged_attention_ref(*args, **opts),
                        flush=flush),
                    library_ms=sdpa_ms(torch, case, flush),
                    bound_ms=max(t_bytes, t_flops),
                    bound_by="bytes" if t_bytes >= t_flops
                    else "operations",
                    bytes=nbytes, flops=flops)
                rows[kv_dtype][name] = rec
            emit("kernel_check", kernel="paged_decode_attention", **rec)
    return worst, rows


def sdpa_ms(torch, case, flush) -> float:
    """Yardstick only (the port never calls it): PyTorch's
    ``scaled_dot_product_attention`` over a pre-gathered, pre-masked (and,
    for 8-bit pools, pre-dequantized fp32) buffer holding the same work;
    gathering and dequantizing are outside the timed call."""
    import torch.nn.functional as F
    q, pk, pv, pt, cl = (case["q"], case["pool_k"], case["pool_v"],
                         case["page_table"], case["cache_len"])
    B, S, H, dh = q.shape
    _, P, Hkv, _ = pk.shape
    ring = pt.shape[1] * P
    idx = pt.long()
    gk, gv = pk.float()[idx], pv.float()[idx]
    if case["k_scale"] is not None:
        gk = gk * case["k_scale"][idx][:, :, None, :, None]
        gv = gv * case["v_scale"][idx][:, :, None, :, None]
    k = gk.reshape(B, ring, Hkv, dh).transpose(1, 2)
    v = gv.reshape(B, ring, Hkv, dh).transpose(1, 2)
    k = k.repeat_interleave(H // Hkv, dim=1).contiguous()
    v = v.repeat_interleave(H // Hkv, dim=1).contiguous()
    t = (cl.long() - 1)[:, None]
    r = torch.arange(ring, device=q.device)[None, :]
    u = t - torch.remainder(t - r, ring)
    qpos = t + 1 - S + torch.arange(S, device=q.device)[None, :]
    mask = (u >= 0)[:, None] & (u[:, None] <= qpos[:, :, None])
    mask &= (pt != pk.shape[0] - 1).repeat_interleave(P, dim=1)[:, None]
    mask = mask[:, None]                                       # [B,1,S,R]
    qt = q.transpose(1, 2).contiguous()
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask), flush=flush)


# ---------------------------------------------------------------------------
# Phases 4-5: the engine at full width
# ---------------------------------------------------------------------------

def make_requests(Request, vocab: int, n: int, seed: int, rid0: int,
                  max_new: int = 32):
    """Prompts of 100-700 tokens; every other one opens with one shared
    264-token head: 16 full pages of 16 and half of the 17th, so radix
    prefix hits run and copy the partially matched page (copy-on-write)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, SHARED_HEAD).tolist()
    reqs = []
    for i in range(n):
        plen = int(rng.integers(100, 701))
        if i % 2 == 0 and plen > SHARED_HEAD:
            prompt = head + rng.integers(1, vocab,
                                         plen - SHARED_HEAD).tolist()
        else:
            prompt = rng.integers(1, vocab, plen).tolist()
        reqs.append(Request(rid=rid0 + i, prompt=prompt,
                            max_new_tokens=max_new))
    return reqs


def init_model(torch, rt):
    cfg = rt["get_config"]("internlm2-1.8b")
    t0 = time.time()
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit("params", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         params=n_params, seconds=time.time() - t0)
    return cfg, params


def make_engine(rt, cfg, params, kv_dtype):
    return rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                        kv_dtype=kv_dtype, device=DEV)


def phase_engine(torch, ops, rt, cfg, params, kv_dtype):
    """Serve the 12 requests from ``kv_dtype`` pools.  The kernel's launch
    counts are zeroed just before and read just after the run."""
    eng = make_engine(rt, cfg, params, kv_dtype)
    check(eng.paged_kernel, "paged_kernel='auto' did not pick the kernel")
    check(eng.kv_dtype == kv_dtype, f"engine serves {eng.kv_dtype} pools")
    t0 = time.time()
    eng.warmup()
    torch.cuda.synchronize()
    emit("warmup", kv_dtype=kv_dtype, seconds=time.time() - t0)

    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    steps0 = eng.steps
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    for k in ops.launches_by_dtype:
        ops.launches_by_dtype[k] = 0
    t0 = time.time()
    for r in reqs:
        check(eng.submit(r) is None, f"rid {r.rid} rejected")
    sync_checked = False
    while eng.queue or eng._live():
        if not sync_checked and eng.chunks >= 2 and eng._live():
            eng._admit()
            torch.cuda.set_sync_debug_mode("error")
            try:
                toks = eng.step_chunk()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eng._drain(toks)
            sync_checked = True
        else:
            eng.step()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launches_by_dtype[kv_dtype]
    all_launches = ops.launches
    micro = eng.steps - steps0
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    stats = eng.memory_stats()
    pstats = eng.prefix_stats()
    emit("engine", kv_dtype=kv_dtype, requests=len(reqs), micro_steps=micro,
         chunks=eng.chunks, wall_s=wall, generated_tokens=gen_tokens,
         prompt_tokens=prompt_tokens,
         prefill_tokens_computed=prompt_tokens
         - pstats["prefill_tokens_skipped"],
         generated_tokens_per_s=gen_tokens / wall,
         ms_per_micro_step=wall / micro * 1e3, kernel_launches=launches,
         kernel_launches_all_dtypes=all_launches,
         host_syncs=eng.host_syncs, sync_free_chunk=sync_checked,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         pool_bytes=stats["paged_kv_bytes"], memory_stats=stats,
         prefix_stats=pstats, leaked_pages=eng.leaked_pages())
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"{kv_dtype} rid {r.rid}: {len(r.out_tokens)} tokens, "
              f"done={r.done}")
    check(sync_checked, "no chunk ran under sync debug mode")
    check(launches == cfg.num_layers * micro and all_launches == launches,
          f"{kv_dtype} kernel launches {launches} (all dtypes "
          f"{all_launches}) != {cfg.num_layers} x {micro}")
    check(eng.leaked_pages() == 0, f"{kv_dtype}: leaked pages")
    check(pstats["prefix_hits"] > 0, f"{kv_dtype}: no prefix hits")
    check(pstats["cow_copies"] > 0, f"{kv_dtype}: no copy-on-write ran")
    tokens = {r.rid: list(r.out_tokens) for r in reqs}
    return eng, launches, tokens


def greedy_agreement(ref: dict, got: dict) -> float:
    """Share of positions where two runs of the same requests emitted the
    same token."""
    same = total = 0
    for rid, toks in ref.items():
        total += len(toks)
        same += sum(a == b for a, b in zip(toks, got[rid]))
    return same / total


def teacher_forced_logit_diff(torch, rt, cfg, params, kv_dtype,
                              chunks: int = 4) -> float:
    """Max |logit| difference between ``kv_dtype`` pools and fp32 pools on
    the same random tokens, fed 32 per slot per step to all 8 slots of
    two fresh engines (teacher forcing: both see the same tokens)."""
    from repro_torch.serve import cache as cache_mod
    engs = [make_engine(rt, cfg, params, d) for d in ("fp32", kv_dtype)]
    gen = torch.Generator(device=DEV).manual_seed(5)
    key = engs[0].spec.groups[0].key
    nb = engs[0].spec.groups[0].ring_blocks
    for e in engs:
        for slot in range(8):
            cache_mod.install_slot_rows(
                e.spec, e.cache, slot, 0,
                {key: list(range(slot * nb, (slot + 1) * nb))})
    worst = 0.0
    for _ in range(chunks):
        toks = torch.randint(1, cfg.vocab_size, (8, 32), generator=gen,
                             device=DEV, dtype=torch.int32)
        out = []
        for e in engs:
            logits, e.cache = rt["forward_verify"](
                params, cfg, toks, e.cache, paged_kernel=True,
                spec_slack=e.spec.spec_tokens)
            e.cache = dict(e.cache, len=e.cache["len"] + 32)
            out.append(logits)
        worst = max(worst, float((out[0] - out[1]).abs().max()))
    return worst


def profile_chunk(torch, eng) -> dict:
    """Device time of one chunk by kernel family, from ``torch.profiler``:
    the paged-attention kernel, matrix products, everything else, and the
    device's idle share of the chunk's wall time (profiler on, so the
    wall time includes its overhead)."""
    from torch.profiler import ProfilerActivity, profile
    eng._admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        toks = eng.step_chunk()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    eng._drain(toks)
    fam = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        us = evt.time_range.elapsed_us()
        name = evt.name.lower()
        if "paged_attention" in name:
            fam["paged_attention"] += us / 1e3
        elif "gemm" in name or "gemv" in name or "cutlass" in name:
            fam["matmul"] += us / 1e3
        else:
            fam["other"] += us / 1e3
    busy = sum(fam.values())
    if n_kernels == 0:
        return {"measured": False, "reason": "no device events traced"}
    return {"measured": True, "micro_steps": eng.sync_interval,
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_ms_by_family": fam, "device_kernels": n_kernels,
            "idle_share": max(0.0, 1.0 - busy / wall_ms)}


def phase_paths(torch, eng, cfg, rt):
    """One full-width ``forward_verify`` on a mid-run cache state, through
    the kernel and through the gather path, on two copies of the cache
    (scale pools included).  Before it, one chunk of that run is
    profiled."""
    for r in make_requests(rt["Request"], cfg.vocab_size, 8, seed=11,
                           rid0=100):
        eng.submit(r)
    eng.step()
    eng.step()
    try:
        prof = profile_chunk(torch, eng)
    except (RuntimeError, AttributeError) as e:   # an optional reading
        prof = {"measured": False, "reason": repr(e)}
    emit("profile", kv_dtype=eng.kv_dtype, **prof)
    ex = eng.executor
    toks, wm, n, _pre, _comp = ex.micro_inputs(eng.cache, eng.state)
    out = {}
    for kernel in (True, False):
        cache = dict(eng.cache, len=eng.cache["len"].clone(),
                     layers=[{k: v.clone() for k, v in c.items()}
                             for c in eng.cache["layers"]])
        logits, _ = rt["forward_verify"](
            eng.params, cfg, toks, cache, write_mask=wm,
            paged_kernel=kernel, spec_slack=eng.spec.spec_tokens, n_rows=n)
        out[kernel] = logits
        del cache
    real = wm                                   # live, non-pad rows
    diff = (out[True] - out[False]).abs()[real]
    err = float(diff.max())
    agree = float((out[True].argmax(-1) == out[False].argmax(-1))[real]
                  .float().mean())
    emit("paths", kv_dtype=eng.kv_dtype, rows_compared=int(real.sum()),
         logits_max_abs_diff=err, tol=PATH_TOL, greedy_agreement=agree)
    check(bool(torch.isfinite(out[True][real]).all()), "non-finite logits")
    check(err <= PATH_TOL,
          f"{eng.kv_dtype}: kernel vs gather logits differ by {err}")
    eng.run(max_steps=10 ** 6)
    check(eng.leaked_pages() == 0,
          f"{eng.kv_dtype}: leaked pages after the second wave")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.device import resolve_device
        from repro_torch.kernels import build
        from repro_torch.kernels.paged_attention import ops
        from repro_torch.models import forward_verify, model_defs
        from repro_torch.models.attention import quantize_pages
        from repro_torch.models.module import init_params
        from repro_torch.serve.cache import kv_pool_dtype
        from repro_torch.serve.engine import Engine, Request
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    rt = dict(get_config=get_config, init_params=init_params,
              model_defs=model_defs, Engine=Engine, Request=Request,
              forward_verify=forward_verify)
    try:
        resolve_device("cuda")        # TF32 off
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        print(smi.stdout.strip().splitlines()[0], flush=True)
        emit("device", name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda,
             tf32=[torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32])

        t0 = time.time()
        sources = [ops.SOURCE]
        with ThreadPoolExecutor(len(sources)) as pool:
            built = list(pool.map(build.compile_source, sources))
        for src, (lib, log) in zip(sources, built):
            emit("build", source=str(src.relative_to(ROOT)), library=lib.name,
                 ptxas=[ln.strip() for ln in log.splitlines()
                        if "entry function" in ln or "registers" in ln
                        or "spill" in ln])
        emit("build_done", seconds=time.time() - t0)

        worst, rows = phase_kernels(torch, ops, quantize_pages,
                                    kv_pool_dtype)
        cfg, params = init_model(torch, rt)
        launches, tokens = {}, {}
        for kv_dtype in KV_DTYPES:
            eng, launches[kv_dtype], tokens[kv_dtype] = phase_engine(
                torch, ops, rt, cfg, params, kv_dtype)
            if kv_dtype != "fp32":
                # information only: with random weights near-ties flip
                # greedy tokens, so neither number is gated
                emit("quantized_vs_fp32", kv_dtype=kv_dtype,
                     greedy_agreement=greedy_agreement(tokens["fp32"],
                                                       tokens[kv_dtype]),
                     teacher_forced_max_logit_diff=teacher_forced_logit_diff(
                         torch, rt, cfg, params, kv_dtype))
            if kv_dtype in ("fp32", "int8"):
                phase_paths(torch, eng, cfg, rt)
            del eng
            torch.cuda.empty_cache()
    except SmokeFailure as e:
        emit("failed", reason=str(e))
        return 1
    source = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
    entries = []
    for kv_dtype in KV_DTYPES:
        main32 = rows[kv_dtype]["main_s32"]
        quant = kv_dtype != "fp32"
        entries.append({
            "name": "paged_decode_attention"
                    + (f"_{kv_dtype}" if quant else ""),
            "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/paged_attention/kernel.py:"
                        + ("140" if quant else "170"),
            "launches": launches[kv_dtype],
            "max_abs_err": worst[kv_dtype], "ms": main32["ms"],
            "plain_ms": main32["plain_ms"], "bound_ms": main32["bound_ms"],
            "bound_by": main32["bound_by"],
            "library_ms": main32["library_ms"],
            "max_err": worst[kv_dtype], "kernel_ms": main32["ms"],
            "shape": f"B=8 S=32 H=16 Hkv=8 dh=128 P=16 nb=64 {kv_dtype}"})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
