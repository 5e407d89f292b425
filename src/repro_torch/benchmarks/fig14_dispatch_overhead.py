"""Paper Fig. 14: the cost of dispatch, on the card — per operator, then
at serving-engine scale (counterpart of
``benchmarks/fig14_dispatch_overhead.py``).

    python -m repro_torch.benchmarks.fig14_dispatch_overhead \\
        [--out BENCH_serve_torch.json] [--trials 3]

The dispatch trio runs ``v + 1`` on an ``[8, 8]`` fp32 tensor N = 1000
times, three ways, under the reference's emit names:

* ``fig14.per_dispatch_jit``: 1000 eager launches, one synchronize at
  the end (the reference: 1000 calls of one small ``jit``);
* ``fig14.per_op_fused``: the same 1000 ops captured once in a
  ``torch.cuda.CUDAGraph`` and timed over one replay (the reference: one
  ``jit`` holding the 1000 ops);
* ``fig14.per_op_eager``: eager, with a host read after every op, the
  round trip ``ReferenceEngine`` pays per token; 100 ops timed and
  scaled to N, as the reference does.

The trio times CUDA launches, so it runs on the card only and raises on
another device.

The serve workloads hold the old engine against the new, on reduced
internlm2-1.8b at the reference's sizes (4 slots, ``max_len`` 64 or
256, 12 requests of 16 new tokens):

* ``serve_engine_comparison``: ``serve/reference.ReferenceEngine``
  (per-token host syncs, a prefill per prompt length, a Python splice)
  against ``Engine(chunked_prefill=False, sync_interval=16)``: tokens/s,
  steps/s, host syncs per step, the shape counters in the compile
  counts' keys, memory telemetry.  The chunk is sync-free two ways: one
  chunk runs under ``torch.cuda.set_sync_debug_mode("error")`` on the
  card (the reference's transfer guard; on the CPU both are vacuous),
  and the engine's own count is exactly ``1 / sync_interval`` syncs per
  step.
  Its traced twin (``trace=True``) runs the same trials: tokens/s
  against the untraced engine (``trace_overhead_ratio``), a sync-free
  traced chunk, and its ``export_trace`` validated in-process by the
  port's ``benchmarks/check_trace.validate`` with a complete
  submit-to-terminal chain for every request (``trace_*`` keys).
* ``shared_prefix_comparison``, ``paged_kernel_comparison``,
  ``speculative_comparison``, ``chunked_prefill_comparison``: as the
  reference's, token parity among the engines and the dense reference
  recorded beside the times.
* ``fault_tolerance_comparison``: an oversubscribed pool (12 pages
  against 16 for full occupancy) that must preempt, one request whose
  deadline has passed (reaped ``TIMED_OUT``, never admitted), and token
  parity of the preempted-then-resumed run against an uncontended
  engine (``ft_*`` keys).
* ``quantized_pool_comparison``: the reduced model trained (the port's
  ``forward_train`` and ``optim/adamw``) until it follows a token chain,
  then served on int8 pools against fp32 pools: greedy agreement, the
  teacher-forced logit error, slots at equal pool bytes, preemption and
  copy-on-write parity on int8 pools (``qp_*`` keys).

Left out, and absent from the record (not zero): the HLO checks of
``paged_kernel_comparison`` and ``chunked_prefill_comparison``
(``_decode_executable``, ``_ring_gather_shapes``: keys
``paged_kernel_gather_free``, ``gather_path_materializes_ring``,
``paged_kernel_peak_temp_bytes``, ``paged_gather_peak_temp_bytes``,
``cp_fused_gather_free``), which have no torch counterpart.
fig04's ``slo_*`` and ``trep_*`` keys come from the port's
``benchmarks/fig04_scheduling.py``, merged into the same run.
``main`` writes the record to ``BENCH_serve_torch.json``, never to the
reference's ``BENCH_serve.json``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.benchmarks.common import (assert_clean_teardown, emit,
                                           write_bench_json)
from repro_torch.device import DeviceLike, resolve_device

N_TASKS = 1000
ARCH = "internlm2-1.8b"


def _model(device: torch.device):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_defs
    from repro_torch.models.module import init_params

    cfg = reduced(get_config(ARCH))
    return cfg, init_params(model_defs(cfg), 0, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sync_free_chunk(eng):
    """One chunk under ``torch.cuda.set_sync_debug_mode("error")`` on the
    card: ``(tokens, True)``, or ``(None, False)`` when the chunk
    synchronized with the host.  On the CPU there is nothing to
    synchronize, and the guard is vacuous, as the reference's is there."""
    if eng.device.type != "cuda":
        return eng.step_chunk(), True
    torch.cuda.synchronize(eng.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = eng.step_chunk()
    except RuntimeError as e:
        if "synchroniz" not in str(e).lower():
            raise            # a real crash, not the guard firing
        return None, False
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return toks, True


def _ragged(n_req: int, max_new: int):
    """``n_req`` requests with ragged prompts of 2..12 tokens (several
    prefill buckets)."""
    from repro_torch.serve.engine import Request

    return [Request(rid=i, prompt=[(3 * i + j) % 250 + 1
                                   for j in range(2 + (5 * i) % 11)],
                    max_new_tokens=max_new) for i in range(n_req)]


def _serve(eng, requests, seen: dict):
    """Serve ``requests`` to the end: ``({rid: tokens}, seconds)``.  The
    finished requests go to ``seen[id(eng)]`` for the teardown check."""
    for r in requests:
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run(max_steps=100_000)
    dt = time.perf_counter() - t0
    assert len(done) == len(requests)
    seen.setdefault(id(eng), []).extend(done)
    eng.finished = []
    return {r.rid: list(r.out_tokens) for r in done}, dt


def _best_of(eng, make_requests, trials: int, seen: dict):
    """One warm run, then ``trials`` timed ones: the last run's tokens
    and the best tokens/s (overhead takes the min time; the tail is
    scheduler noise)."""
    _serve(eng, make_requests(), seen)
    best = 0.0
    for _ in range(trials):
        out, dt = _serve(eng, make_requests(), seen)
        best = max(best, sum(map(len, out.values())) / dt)
    return out, best


def _pool_telemetry(eng, prefix: str) -> dict:
    """Bytes of leased pool per live token sampled mid-flight via a probe
    request, the pool precision, and the concurrent-slot high-water."""
    from repro_torch.serve.engine import Request

    eng.submit(Request(rid=990_001, prompt=[1, 2, 3], max_new_tokens=4))
    eng._admit()
    ms = eng.memory_stats()
    eng.run(max_steps=100_000)
    eng.finished = []
    return {
        f"{prefix}pool_bytes_per_live_token":
            ms["pool_bytes_per_live_token"],
        f"{prefix}kv_dtype": ms["kv_dtype"],
        f"{prefix}peak_live_slots": eng.memory_stats()["peak_live_slots"],
    }


def dispatch_trio(device: DeviceLike = None, n: int = N_TASKS) -> dict:
    """Seconds per op of ``v + 1`` on an [8, 8] fp32 tensor: eager
    launches, one CUDA-graph replay, eager with a host read per op."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"the dispatch trio times CUDA launches and graph replays; "
            f"device {dev} is not a CUDA device")
    x = torch.zeros((8, 8), dtype=torch.float32, device=dev)

    def body(v):
        for _ in range(n):
            v = v + 1.0
        return v

    body(x)                                    # warm the launch path
    _sync(dev)
    t0 = time.perf_counter()
    v = body(x)
    _sync(dev)
    t_dispatch = time.perf_counter() - t0
    assert float(v[0, 0]) == n

    # capture: warm up on a side stream, then one graph of the n ops
    static = x.clone()
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body(static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body(static)
    graph.replay()                             # first replay uploads it
    _sync(dev)
    t0 = time.perf_counter()
    graph.replay()
    _sync(dev)
    t_fused = time.perf_counter() - t0
    assert float(out[0, 0]) == n, "the captured graph computed another sum"

    m = 100
    t0 = time.perf_counter()
    v = x
    for _ in range(m):
        v = v + 1.0
        float(v[0, 0])                         # one device-to-host read
    t_eager = (time.perf_counter() - t0) * (n / m)

    emit("fig14.per_dispatch_jit", t_dispatch / n * 1e6,
         f"total_ms={t_dispatch * 1e3:.1f}")
    emit("fig14.per_op_fused", t_fused / n * 1e6,
         f"overhead_ratio={t_dispatch / t_fused:.1f}x")
    emit("fig14.per_op_eager", t_eager / n * 1e6,
         f"total_ms_est={t_eager * 1e3:.1f}")
    return {"per_dispatch_us": t_dispatch / n * 1e6,
            "per_op_fused_us": t_fused / n * 1e6,
            "per_op_eager_us": t_eager / n * 1e6}


def serve_engine_comparison(n_req: int = 12, max_new: int = 16, *,
                            device: DeviceLike = None,
                            trials: int = 3) -> dict:
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.reference import ReferenceEngine

    dev = resolve_device(device)
    cfg, params = _model(dev)
    seen = {}

    def timed_trials(eng):
        """Best tokens/s + steps/s over ``trials`` runs after a warm one
        (first shapes, host-path warm)."""
        _serve(eng, _ragged(n_req, max_new), seen)
        best_tps, best_sps, syncs_per_step = 0.0, 0.0, 0.0
        for _ in range(trials):
            steps0, syncs0 = eng.steps, eng.host_syncs
            out, dt = _serve(eng, _ragged(n_req, max_new), seen)
            toks = sum(map(len, out.values()))
            if toks / dt > best_tps:
                best_tps = toks / dt
                best_sps = (eng.steps - steps0) / dt
                syncs_per_step = (eng.host_syncs - syncs0) / (eng.steps
                                                              - steps0)
        return best_tps, best_sps, syncs_per_step

    ref = ReferenceEngine(cfg, params, slots=4, max_len=64, device=dev)
    ref_tps, ref_sps, ref_syncs = timed_trials(ref)

    eng = Engine(cfg, params, slots=4, max_len=64, sync_interval=16,
                 chunked_prefill=False, device=dev)
    eng.warmup()

    # memory telemetry: bytes/live-token mid-flight, peak pages at the end
    eng.submit(Request(rid=10_000, prompt=[1, 2, 3], max_new_tokens=max_new))
    eng._admit()
    mem_live = eng.memory_stats()
    eng.run(max_steps=100_000)
    eng.finished = []

    eng_tps, eng_sps, eng_syncs = timed_trials(eng)

    toks, sync_free = _sync_free_chunk(eng)
    if sync_free:
        eng._drain(toks)
    assert sync_free, "decode chunk synchronized with the host"
    assert abs(eng_syncs - 1.0 / eng.sync_interval) < 1e-9, eng_syncs
    mem_end = eng.memory_stats()
    assert_clean_teardown(eng, seen[id(eng)], label="serve_engine")

    # tracing overhead on the same workload: a traced twin runs the same
    # trials; the tracer records host-side at chunk boundaries, so the
    # chunk stays sync-free and every request leaves a complete chain
    from repro_torch.benchmarks.check_trace import validate
    from repro_torch.serve.trace import TERMINAL_KINDS

    traced = Engine(cfg, params, slots=4, max_len=64, sync_interval=16,
                    chunked_prefill=False, trace=True, device=dev)
    traced.warmup()
    trace_tps, _, _ = timed_trials(traced)
    toks, trace_sync_free = _sync_free_chunk(traced)
    if trace_sync_free:
        traced._drain(toks)
    assert_clean_teardown(traced, seen[id(traced)],
                          label="serve_engine_traced")
    trace_failures = validate(traced.export_trace())
    term_events = [e for e in traced.tracer.events()
                   if e.kind in TERMINAL_KINDS]
    # one warm run and ``trials`` timed ones of n_req requests each
    chains_complete = not any("without" in f for f in trace_failures) \
        and len(term_events) >= (1 + trials) * n_req \
        and {e.rid for e in term_events} >= set(range(n_req))
    for f in trace_failures:
        print(f"# trace schema failure: {f}")
    rec_trace = {
        "trace_tokens_per_s": trace_tps,
        "trace_overhead_ratio": trace_tps / eng_tps,
        "trace_decode_sync_free": trace_sync_free,
        "trace_decode_compiles": traced.decode_compiles,
        "trace_events": len(traced.tracer),
        "trace_dropped": traced.tracer.dropped,
        "trace_schema_valid": not trace_failures,
        "trace_complete_chains": chains_complete,
    }

    rec = {
        "arch": cfg.name,
        "requests": n_req,
        "max_new": max_new,
        "ref_steps_per_s": ref_sps,
        "new_steps_per_s": eng_sps,
        "ref_tokens_per_s": ref_tps,
        "new_tokens_per_s": eng_tps,
        "speedup": eng_tps / ref_tps,
        "ref_host_syncs_per_step": ref_syncs,
        "new_host_syncs_per_step": eng_syncs,
        # shape counters: the executables the reference compiles
        "ref_prefill_compiles": ref.prefill_compiles,
        "new_prefill_compiles": eng.prefill_compiles,
        "new_decode_compiles": eng.decode_compiles,
        "new_admit_compiles": eng.admit_compiles,
        "buckets": list(eng.buckets),
        "sync_interval": eng.sync_interval,
        "decode_sync_free": sync_free,
        "page_size": mem_end["page_size"],
        "num_pages": mem_end["num_pages"],
        "peak_pages_in_use": mem_end["peak_pages_in_use"],
        "hbm_bytes_per_live_token": mem_live["hbm_bytes_per_live_token"],
        "dense_vs_paged_capacity_ratio":
            mem_end["dense_vs_paged_capacity_ratio"],
        "paged_kv_bytes": mem_end["paged_kv_bytes"],
        "dense_kv_bytes": mem_end["dense_kv_bytes"],
        "pool_bytes_per_live_token": mem_live["pool_bytes_per_live_token"],
        "kv_dtype": mem_end["kv_dtype"],
        "peak_live_slots": mem_end["peak_live_slots"],
    }
    rec.update(rec_trace)
    emit("fig14.trace_overhead_ratio", rec["trace_overhead_ratio"],
         f"traced={trace_tps:.0f}tok/s,untraced={eng_tps:.0f}tok/s,"
         f"events={rec['trace_events']},"
         f"schema_valid={rec['trace_schema_valid']}")
    emit("fig14.engine_ref_steps_per_s", 1e6 / rec["ref_steps_per_s"],
         f"syncs_per_step={rec['ref_host_syncs_per_step']:.2f}")
    emit("fig14.engine_new_steps_per_s", 1e6 / rec["new_steps_per_s"],
         f"syncs_per_step={rec['new_host_syncs_per_step']:.3f}")
    emit("fig14.engine_speedup", rec["speedup"],
         f"sync_free={sync_free},prefill_compiles="
         f"{rec['new_prefill_compiles']}/{rec['ref_prefill_compiles']}")
    emit("fig14.paged_kv_mem", rec["hbm_bytes_per_live_token"],
         f"peak_pages={rec['peak_pages_in_use']}/{rec['num_pages']},"
         f"dense_vs_paged={rec['dense_vs_paged_capacity_ratio']:.2f}")
    return rec


def shared_prefix_comparison(n_req: int = 12, max_new: int = 16, *,
                             device: DeviceLike = None,
                             trials: int = 1) -> dict:
    """Shared-prefix workload: ``n_req`` requests with one common 16-token
    prompt head, radix/CoW admission against exclusive page ownership
    (pages reserved, prefill tokens skipped), tokens identical to both
    and to the dense reference; plus the windowed pools' bytes per live
    token (gemma2's spec).  ``trials`` timed runs after a warm one."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.serve.cache import CacheSpec
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.reference import ReferenceEngine

    dev = resolve_device(device)
    cfg, params = _model(dev)
    prefix = [(3 * j) % 200 + 1 for j in range(16)]
    seen = {}

    def requests():
        return [Request(rid=i, prompt=prefix + [(7 * i + j) % 150 + 1
                                                for j in range(1 + i % 4)],
                        max_new_tokens=max_new) for i in range(n_req)]

    # the two-executable admission path, as the reference's trajectory
    excl = Engine(cfg, params, slots=4, max_len=64, sync_interval=16,
                  prefix_sharing=False, chunked_prefill=False, device=dev)
    excl.warmup()
    out_excl, excl_tps = _best_of(excl, requests, trials, seen)

    eng = Engine(cfg, params, slots=4, max_len=64, sync_interval=16,
                 chunked_prefill=False, device=dev)
    eng.warmup()
    out_share, share_tps = _best_of(eng, requests, trials, seen)

    ref = ReferenceEngine(cfg, params, slots=4, max_len=64, device=dev)
    out_ref, _ = _serve(ref, requests(), seen)
    outputs_match = out_share == out_excl == out_ref
    ps = eng.prefix_stats()
    pages_saved = (excl.scheduler.peak_pages_in_use
                   - eng.scheduler.peak_pages_in_use)

    wspec = CacheSpec.from_config(reduced(get_config("gemma2-2b")),
                                  slots=4, max_len=64, page_size=8)
    full = {g.key: g.num_pages for g in wspec.groups}
    wstats = wspec.memory_stats(full, 4 * 64)    # pools fully occupied

    toks, sync_free = _sync_free_chunk(eng)
    if sync_free:
        eng._drain(toks)
    rec = {
        "prefix_requests": n_req,
        "prefix_hit_rate": ps["prefix_hit_rate"],
        "prefill_tokens_skipped": ps["prefill_tokens_skipped"],
        "prefix_shared_page_attaches": ps["shared_page_attaches"],
        "prefix_cow_copies": ps["cow_copies"],
        "prefix_outputs_match_exclusive": outputs_match,
        "prefix_tokens_per_s": share_tps,
        "exclusive_tokens_per_s": excl_tps,
        "prefix_peak_pages": eng.scheduler.peak_pages_in_use,
        "exclusive_peak_pages": excl.scheduler.peak_pages_in_use,
        "prefix_pages_saved": pages_saved,
        "prefix_decode_compiles": eng.decode_compiles,
        "prefix_decode_sync_free": sync_free,
        "windowed_dense_vs_paged_ratio":
            wstats["dense_vs_paged_capacity_ratio"],
        "windowed_hbm_bytes_per_live_token":
            wstats["hbm_bytes_per_live_token"],
    }
    rec.update(_pool_telemetry(eng, "prefix_"))
    assert_clean_teardown(excl, seen[id(excl)], label="prefix_exclusive")
    assert_clean_teardown(eng, seen[id(eng)], label="prefix_shared")

    emit("fig14.prefix_hit_rate", rec["prefix_hit_rate"],
         f"tokens_skipped={rec['prefill_tokens_skipped']},"
         f"cow={rec['prefix_cow_copies']}")
    emit("fig14.prefix_pages_saved", pages_saved,
         f"peak={rec['prefix_peak_pages']}/"
         f"{rec['exclusive_peak_pages']},match={outputs_match}")
    emit("fig14.windowed_paged_ratio",
         rec["windowed_dense_vs_paged_ratio"],
         f"bytes_per_live_tok={rec['windowed_hbm_bytes_per_live_token']:.0f}")
    return rec


def paged_kernel_comparison(n_req: int = 12, max_new: int = 16, *,
                            device: DeviceLike = None,
                            trials: int = 3) -> dict:
    """Gather-then-attend decode against the pool-direct paged-attention
    path (``kernels/paged_attention``: the CUDA kernel on the card, its
    plain version on the CPU) on an oversubscribed pool (table width 32
    blocks at ``max_len`` 256, 28 physical pages): tokens/s both ways,
    tokens equal between the two engines and the dense reference."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.reference import ReferenceEngine

    dev = resolve_device(device)
    cfg, params = _model(dev)
    kw = dict(slots=4, max_len=256, page_size=8, num_pages=28,
              sync_interval=16, prefix_sharing=False,
              chunked_prefill=False, device=dev)
    seen = {}

    def requests():
        return _ragged(n_req, max_new)

    gather = Engine(cfg, params, paged_kernel=False, **kw)
    gather.warmup()
    out_gather, gather_tps = _best_of(gather, requests, trials, seen)

    paged = Engine(cfg, params, paged_kernel=True, **kw)
    paged.warmup()
    out_paged, paged_tps = _best_of(paged, requests, trials, seen)

    ref = ReferenceEngine(cfg, params, slots=4, max_len=256, device=dev)
    out_ref, _ = _serve(ref, requests(), seen)
    outputs_match = out_paged == out_gather == out_ref

    toks, sync_free = _sync_free_chunk(paged)
    if sync_free:
        paged._drain(toks)
    rec = {
        "paged_kernel_backend": ("cuda-sm90a" if dev.type == "cuda"
                                 else "torch-plain"),
        "paged_kernel_tokens_per_s": paged_tps,
        "paged_gather_tokens_per_s": gather_tps,
        "paged_kernel_speedup": paged_tps / gather_tps,
        "paged_kernel_outputs_match": outputs_match,
        "paged_kernel_decode_compiles": paged.decode_compiles,
        "paged_kernel_decode_sync_free": sync_free,
        "paged_kernel_num_pages": kw["num_pages"],
        "paged_kernel_table_blocks": paged.spec.max_blocks,
    }
    rec.update(_pool_telemetry(paged, "paged_kernel_"))
    assert_clean_teardown(gather, seen[id(gather)], label="paged_gather")
    assert_clean_teardown(paged, seen[id(paged)], label="paged_kernel")
    emit("fig14.paged_kernel_speedup", rec["paged_kernel_speedup"],
         f"paged={paged_tps:.0f}tok/s,gather={gather_tps:.0f}tok/s,"
         f"backend={rec['paged_kernel_backend']},match={outputs_match}")
    return rec


def speculative_comparison(max_new: int = 48, *, device: DeviceLike = None,
                           trials: int = 1) -> dict:
    """Speculative (n-gram drafter, K = 4) against plain decoding on
    constant-token prompts: greedy tokens equal to the plain engine's and
    the dense reference's, acceptance rate, committed tokens per verify
    step, and steady-state decode tokens/s at full slot occupancy (no
    admission or drain inside the timed chunks)."""
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.reference import ReferenceEngine
    from repro_torch.serve.spec import SpecConfig

    dev = resolve_device(device)
    cfg, params = _model(dev)
    toks = [50, 80, 116, 176, 98, 128, 224, 194]
    kw = dict(slots=4, max_len=256, page_size=8, sync_interval=8,
              prefix_sharing=False, chunked_prefill=False, device=dev)
    seen = {}

    def requests():
        return [Request(rid=i, prompt=[t] * 20, max_new_tokens=max_new)
                for i, t in enumerate(toks)]

    def decode_tps(eng, chunks: int = 4):
        """Tokens committed per second of chunk wall time, every slot
        live; the budget exceeds what the window can commit."""
        for i, t in enumerate(toks[:kw["slots"]]):
            eng.submit(Request(rid=100 + i, prompt=[t] * 20,
                               max_new_tokens=kw["max_len"] - 24))
        eng._admit()
        eng.step_chunk()                              # warm dispatch
        _sync(dev)
        start = int(eng.state["out_len"].sum())
        t0 = time.perf_counter()
        for _ in range(chunks):
            eng.step_chunk()
        _sync(dev)
        dt = time.perf_counter() - t0
        emitted = int(eng.state["out_len"].sum()) - start
        assert bool(eng.state["active"].all()), \
            "decode-throughput window must keep every slot live"
        return emitted / dt

    spec_cfg = SpecConfig(draft="ngram", k=4, ngram=3)
    base = Engine(cfg, params, **kw)
    base.warmup()
    out_base, base_tps = _best_of(base, requests, trials, seen)

    spec = Engine(cfg, params, spec=spec_cfg, **kw)
    spec.warmup()
    out_spec, spec_tps = _best_of(spec, requests, trials, seen)
    stats = spec.spec_stats()

    ref = ReferenceEngine(cfg, params, slots=4, max_len=256, device=dev)
    out_ref, _ = _serve(ref, requests(), seen)
    outputs_match = out_spec == out_base == out_ref

    base_d = Engine(cfg, params, **kw)
    base_d.warmup()
    base_decode_tps = decode_tps(base_d)
    spec_d = Engine(cfg, params, spec=spec_cfg, **kw)
    spec_d.warmup()
    spec_decode_tps = decode_tps(spec_d)
    _, sync_free = _sync_free_chunk(spec_d)   # spec_d is discarded

    rec = {
        "spec_drafter": "ngram",
        "spec_k": 4,
        "spec_outputs_match": outputs_match,
        "spec_acceptance_rate": stats["acceptance_rate"],
        "spec_tokens_per_step": stats["tokens_per_step"],
        "spec_steps": stats["spec_steps"],
        "spec_tokens_per_s": spec_tps,
        "spec_baseline_tokens_per_s": base_tps,
        "spec_decode_tokens_per_s": spec_decode_tps,
        "spec_baseline_decode_tokens_per_s": base_decode_tps,
        "spec_decode_speedup": spec_decode_tps / base_decode_tps,
        "spec_decode_sync_free": sync_free,
        "spec_decode_compiles": spec.decode_compiles,
        "spec_admit_compiles": spec.admit_compiles,
    }
    rec.update(_pool_telemetry(spec, "spec_"))
    # base_d / spec_d hold live slots (the steady-state window) and are
    # excluded from the drained-teardown contract
    assert_clean_teardown(base, seen[id(base)], label="spec_baseline")
    assert_clean_teardown(spec, seen[id(spec)], label="spec_engine")
    emit("fig14.spec_acceptance", rec["spec_acceptance_rate"],
         f"tokens_per_step={rec['spec_tokens_per_step']:.2f},"
         f"match={outputs_match}")
    emit("fig14.spec_decode_speedup", rec["spec_decode_speedup"],
         f"spec={spec_decode_tps:.0f}tok/s,base={base_decode_tps:.0f}tok/s,"
         f"e2e={spec_tps:.0f}/{base_tps:.0f}")
    return rec


def fault_tolerance_comparison(n_req: int = 8, max_new: int = 16, *,
                               device: DeviceLike = None) -> dict:
    """Oversubscribed pool + deadlines: survive instead of throwing.

    4 slots would reserve 16 worst-case pages against a 12-page budget,
    so the engine must preempt: victims' prompt pages are preserved in
    the radix index, they requeue and resume with their emitted tokens
    replayed.  One extra request is submitted with a deadline already
    past and must be reaped ``TIMED_OUT`` without taking a slot.  Goodput
    is deadline attainment over everything submitted
    (``n_req / (n_req + 1)``); the preempted-then-resumed tokens must
    equal an uncontended engine's; zero leaked pages, one chunk shape, a
    sync-free chunk.  The recovered-prefill fraction is reported, not
    gated: under pure page pressure the preserved pages are refcount-1
    radix leaves that the admission which caused the eviction usually
    reclaims at once."""
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.scheduler import RequestStatus

    dev = resolve_device(device)
    cfg, params = _model(dev)
    kw = dict(slots=4, max_len=64, page_size=8, sync_interval=8,
              chunked_prefill=False, device=dev)
    prompts = [[(3 * i + j) % 250 + 1 for j in range(2 + (5 * i) % 11)]
               for i in range(n_req)]
    seen = {}

    def load(eng, ttl=None, doomed=False):
        for i, p in enumerate(prompts):
            assert eng.submit(Request(rid=i, prompt=list(p),
                                      max_new_tokens=max_new,
                                      ttl=ttl)) is None
        if doomed:
            # a deadline in the past (the monotonic clock is > 0): reaped
            # TIMED_OUT at the first chunk boundary, no slot wasted
            assert eng.submit(Request(rid=n_req, prompt=[1, 2, 3],
                                      max_new_tokens=max_new,
                                      deadline=0.0)) is None
        done = eng.run(max_steps=100_000)
        assert len(done) == n_req + (1 if doomed else 0)
        out = {r.rid: list(r.out_tokens) for r in done
               if r.status == RequestStatus.FINISHED}
        statuses = {r.rid: r.status for r in done}
        preempted = sorted(r.rid for r in done if r.preemptions > 0)
        seen.setdefault(id(eng), []).extend(done)
        eng.finished = []
        return out, statuses, preempted

    calm = Engine(cfg, params, **kw)
    calm.warmup()
    out_calm, _, calm_preempted = load(calm)
    assert not calm_preempted, "uncontended run must not preempt"

    eng = Engine(cfg, params, num_pages=12, **kw)
    eng.warmup()
    out_ft, statuses, preempted = load(eng, ttl=600.0, doomed=True)
    fs = eng.fault_stats()
    submitted = n_req + 1
    goodput = len(out_ft) / submitted
    outputs_match = out_ft == out_calm
    timed_out = sum(1 for s in statuses.values()
                    if s == RequestStatus.TIMED_OUT)
    leaked = eng.leaked_pages()
    toks, sync_free = _sync_free_chunk(eng)
    if sync_free:
        eng._drain(toks)

    rec = {
        "ft_requests": submitted,
        "ft_goodput": goodput,
        "ft_preemptions": fs["preemptions"],
        "ft_pressure_preemptions": fs["pressure_preemptions"],
        "ft_resumes": fs["resumes"],
        "ft_preempted_requests": len(preempted),
        "ft_outputs_match": outputs_match,
        "ft_recovered_prefill_fraction": fs["recovered_prefill_fraction"],
        "ft_resume_replayed_tokens": fs["resume_replayed_tokens"],
        "ft_timed_out": timed_out,
        "ft_leaked_pages": leaked,
        "ft_num_pages": 12,
        "ft_peak_pages": eng.scheduler.peak_pages_in_use,
        "ft_decode_compiles": eng.decode_compiles,
        "ft_decode_sync_free": sync_free,
    }
    rec.update(_pool_telemetry(eng, "ft_"))
    assert_clean_teardown(calm, seen[id(calm)], label="ft_calm")
    assert_clean_teardown(eng, seen[id(eng)], label="ft_oversubscribed")
    emit("fig14.ft_goodput", goodput,
         f"preemptions={fs['preemptions']},"
         f"resumes={fs['resumes']},"
         f"preempted_reqs={len(preempted)},match={outputs_match}")
    emit("fig14.ft_recovered_prefill", fs["recovered_prefill_fraction"],
         f"timed_out={timed_out},leaked={leaked},"
         f"peak_pages={rec['ft_peak_pages']}/12")
    return rec


def chunked_prefill_comparison(n_arrivals: int = 3, prompt_len: int = 120,
                               budget: int = 4, *,
                               device: DeviceLike = None,
                               trials: int = 1) -> dict:
    """Long-prompt arrivals into a busy decode batch, fused against two
    executables: three background requests decode while ``n_arrivals``
    long prompts arrive at fixed chunk boundaries.  Every ``step()`` is
    timed; per-chunk decode-token latency is chunk wall time /
    ``sync_interval``.  Records token parity, p50/p99 per-chunk latency
    and each engine's TTFT p50/p99 (seconds) over the arrivals of its
    last ``trials`` drives (one warm drive before them)."""
    from repro_torch.serve.engine import Engine, Request

    dev = resolve_device(device)
    cfg, params = _model(dev)
    kw = dict(slots=4, max_len=256, page_size=8, sync_interval=4,
              prefix_sharing=False, seed=0, device=dev)
    arrival_gap = 10                       # chunks between arrivals
    warm_chunks = 2                        # untimed settle-in chunks
    seen = {}

    def long_prompt(r):
        return [(3 * r + j) % 250 + 1 for j in range(prompt_len)]

    def drive(eng):
        """Timed arrival window, then drain: (outputs, per-chunk seconds
        in the window, TTFT seconds per arrival)."""
        background = [Request(rid=i, prompt=[5 + i, 9, 2 + i],
                              max_new_tokens=200)
                      for i in range(3)]
        for r in background:
            eng.submit(r)
        arrivals = {}
        chunk_times = []
        submit_t = {}
        ttft = {}
        chunk = 0
        while True:
            gap = chunk - warm_chunks
            if gap >= 0 and gap % arrival_gap == 0 \
                    and len(arrivals) < n_arrivals:
                rid = 10 + len(arrivals)
                req = Request(rid=rid, prompt=long_prompt(rid),
                              max_new_tokens=12)
                arrivals[rid] = req
                eng.submit(req)
                submit_t[rid] = time.perf_counter()
            t0 = time.perf_counter()
            eng.step()
            dt = time.perf_counter() - t0
            if chunk >= warm_chunks:
                chunk_times.append(dt)
            for rid, req in arrivals.items():
                if rid not in ttft and req.out_tokens:
                    ttft[rid] = time.perf_counter() - submit_t[rid]
            chunk += 1
            if len(arrivals) == n_arrivals \
                    and all(r.done for r in arrivals.values()):
                break
            assert chunk < 500, "arrival window failed to drain"
        done = eng.run(max_steps=200_000)
        out = {r.rid: list(r.out_tokens) for r in done}
        seen.setdefault(id(eng), []).extend(done)
        eng.finished = []
        return out, chunk_times, [ttft[r] for r in sorted(ttft)]

    def measured(eng):
        drive(eng)                                    # warm
        times, ttfts = [], []
        for _ in range(trials):
            out, t, f = drive(eng)
            times += t
            ttfts += f
        return out, times, ttfts

    legacy = Engine(cfg, params, chunked_prefill=False, **kw)
    legacy.warmup()
    out_legacy, legacy_times, legacy_ttft = measured(legacy)

    fused = Engine(cfg, params, chunked_prefill=True,
                   prefill_budget=budget, **kw)
    fused.warmup()
    out_fused, fused_times, fused_ttft = measured(fused)

    outputs_match = out_fused == out_legacy
    si = kw["sync_interval"]

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) / si * 1e3

    legacy_p50, legacy_p99 = pct(legacy_times, 50), pct(legacy_times, 99)
    fused_p50, fused_p99 = pct(fused_times, 50), pct(fused_times, 99)
    p99_ratio = legacy_p99 / fused_p99

    fused.submit(Request(rid=99, prompt=[1, 2, 3], max_new_tokens=32))
    fused._admit()
    toks, sync_free = _sync_free_chunk(fused)
    if sync_free:
        fused._drain(toks)
    fused.run(max_steps=200_000)
    fused.finished = []

    rec = {
        "cp_prefill_budget": budget,
        "cp_long_prompt_len": prompt_len,
        "cp_arrivals": n_arrivals,
        "cp_outputs_match": outputs_match,
        "cp_decode_latency_p99_ratio": p99_ratio,
        "cp_fused_chunk_token_p50_ms": fused_p50,
        "cp_fused_chunk_token_p99_ms": fused_p99,
        "cp_legacy_chunk_token_p50_ms": legacy_p50,
        "cp_legacy_chunk_token_p99_ms": legacy_p99,
        "cp_fused_jitter": fused_p99 / fused_p50,
        "cp_legacy_jitter": legacy_p99 / legacy_p50,
        "cp_fused_ttft_p50_s": float(np.percentile(fused_ttft, 50)),
        "cp_fused_ttft_p99_s": float(np.percentile(fused_ttft, 99)),
        "cp_legacy_ttft_p50_s": float(np.percentile(legacy_ttft, 50)),
        "cp_legacy_ttft_p99_s": float(np.percentile(legacy_ttft, 99)),
        "cp_fused_prefill_compiles": fused.prefill_compiles
            + fused.suffix_prefill_compiles,
        "cp_fused_decode_compiles": fused.decode_compiles,
        "cp_fused_admit_compiles": fused.admit_compiles,
        "cp_fused_decode_sync_free": sync_free,
    }
    rec.update(_pool_telemetry(fused, "cp_"))
    assert_clean_teardown(legacy, seen[id(legacy)], label="cp_legacy")
    assert_clean_teardown(fused, seen[id(fused)], label="cp_fused")
    emit("fig14.cp_p99_ratio", p99_ratio,
         f"fused_p99={fused_p99:.2f}ms,legacy_p99={legacy_p99:.2f}ms,"
         f"match={outputs_match}")
    emit("fig14.cp_fused_jitter", rec["cp_fused_jitter"],
         f"legacy_jitter={rec['cp_legacy_jitter']:.2f},"
         f"ttft_p99={rec['cp_fused_ttft_p99_s']:.2f}s/"
         f"{rec['cp_legacy_ttft_p99_s']:.2f}s")
    return rec


def _chain(start: int, n: int, vocab: int):
    """``n`` tokens of the chain ``next = (cur * 31 + 17) % vocab``."""
    toks = [start % vocab]
    for _ in range(n - 1):
        toks.append((toks[-1] * 31 + 17) % vocab)
    return toks


def chain_batch(it: int, vocab: int, device: torch.device) -> torch.Tensor:
    """Training step ``it``'s batch: 8 chains of 33 tokens."""
    return torch.tensor([_chain(1 + 8 * it + bi, 33, vocab)
                         for bi in range(8)], dtype=torch.int32,
                        device=device)


def train_chain_model(cfg, params, steps: int = 80, lr: float = 3e-3):
    """Overfit ``params`` (trainable, in place) on the token chain, as the
    reference does: ``steps`` AdamW steps at ``lr`` on ``chain_batch``'s
    batches, each ``forward_train`` on tokens[:, :-1] against
    tokens[:, 1:].  Returns the losses, one per step, on the host."""
    from repro_torch.models import forward_train
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import adamw

    ocfg = adamw.AdamWConfig(lr=lr)
    opt = adamw.init(params, ocfg)
    leaves = tree_leaves(params)
    dev = leaves[0].device
    losses = []
    for it in range(steps):
        toks = chain_batch(it, cfg.vocab_size, dev)
        loss, _ = forward_train(params, cfg, {"tokens": toks[:, :-1],
                                              "labels": toks[:, 1:]})
        loss.backward()
        adamw.update(None, opt, params, ocfg)
        for p in leaves:
            p.grad = None
        losses.append(loss.detach())
    return [float(x) for x in torch.stack(losses).cpu()]


def quantized_pool_comparison(n_req: int = 8, max_new: int = 48, *,
                              device: DeviceLike = None) -> dict:
    """Quantized (int8) KV page pools against fp32 pools: quality and
    capacity, as the reference's.

    Greedy parity needs a model whose argmax is confident (at random init
    the top-2 logit gap sits below the int8 noise), so the reduced model
    is first trained from seed-0 weights on the chain ``next = (cur * 31
    + 17) % vocab`` (``train_chain_model``: 80 AdamW steps at lr 3e-3,
    batches of 8 chains of 33 tokens) until it follows the chain; then:

    * greedy agreement int8 vs fp32 over ``n_req * max_new`` positions,
      and the max absolute logit error of teacher-forced decode on int8
      pools against fp32 pools (the prompt admitted through the
      quantizing splice, new KV through the re-quantizing write);
    * an int8 pool sized to at most the fp32 engine's pool bytes serving
      twice the slots, the slot high-water proving them concurrent;
    * preemption on an oversubscribed int8 pool (12 pages): outputs equal
      to the calm int8 run, nothing leaked;
    * prefix sharing with copy-on-write on int8 pools against an
      exclusive engine: equal outputs;
    * one decode shape and a sync-free decode chunk.

    ``qp_decode_compiles`` is the port's decode shape counter."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import (forward_decode, forward_prefill,
                                    model_defs)
    from repro_torch.models.module import init_params
    from repro_torch.serve import cache as cm
    from repro_torch.serve.cache import CacheSpec
    from repro_torch.serve.engine import Engine, Request

    dev = resolve_device(device)
    cfg = reduced(get_config(ARCH))
    vocab = cfg.vocab_size
    kv_dtype = "int8"
    params = init_params(model_defs(cfg), 0, device=dev, trainable=True)
    train_loss = train_chain_model(cfg, params)[-1]
    for p in params.parameters():
        p.requires_grad_(False)

    prompts = [_chain(11 + 7 * i, 16, vocab) for i in range(n_req)]
    kw = dict(slots=4, max_len=256, page_size=8, sync_interval=8,
              prefix_sharing=False, device=dev)
    seen = {}

    def load(eng, reqs, ttl=None):
        for rid, prompt, mn in reqs:
            eng.submit(Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=mn, ttl=ttl))
        done = eng.run(max_steps=200_000)
        out = {r.rid: list(r.out_tokens) for r in done}
        seen.setdefault(id(eng), []).extend(done)
        eng.finished = []
        return out

    reqs = [(i, prompt, max_new) for i, prompt in enumerate(prompts)]
    base = Engine(cfg, params, kv_dtype="fp32", **kw)
    base.warmup()
    out32 = load(base, reqs)

    quant = Engine(cfg, params, kv_dtype=kv_dtype, **kw)
    assert quant.kv_dtype == kv_dtype, quant.kv_dtype
    quant.warmup()
    out8 = load(quant, reqs)

    total = n_req * max_new
    agree = sum(sum(a == b for a, b in zip(out32[i], out8[i]))
                for i in range(n_req))
    greedy_match = agree / total
    exact = sum(out32[i] == out8[i] for i in range(n_req))
    follows = sum(out32[i] == _chain(prompts[i][-1], max_new + 1, vocab)[1:]
                  for i in range(n_req))

    # the teacher-forced logit probe: the same tokens decoded against fp32
    # and int8 pools
    def admitted(sp, prompt):
        _, dense = forward_prefill(params, cfg, {"tokens": torch.tensor(
            [prompt], dtype=torch.int32, device=dev)})
        rows = {g.key: np.arange(1, g.ring_blocks + 1, dtype=np.int32)
                for g in sp.groups}
        return cm.admit_cache(sp, sp.init_paged_cache(dev), dense, 0, 0,
                              len(prompt), rows)

    probe = prompts[0]
    with torch.no_grad():
        c32 = admitted(CacheSpec.from_config(cfg, 1, 64, page_size=8),
                       probe)
        c8 = admitted(CacheSpec.from_config(cfg, 1, 64, page_size=8,
                                            kv_dtype=kv_dtype), probe)
        errs = []
        for t in _chain(probe[-1], 9, vocab)[1:]:
            tk = torch.tensor([[t]], dtype=torch.int32, device=dev)
            lg32, c32 = forward_decode(params, cfg, tk, c32)
            lg8, c8 = forward_decode(params, cfg, tk, c8)
            errs.append((lg32 - lg8).abs().max())
        max_logit_err = float(torch.stack(errs).max())

    # capacity at equal bytes: an int8 pool of at most the fp32 engine's
    # page-pool bytes (scale rows included) serving twice the slots
    budget = base.spec.paged_kv_bytes()
    probe_a = CacheSpec.from_config(cfg, 8, 256, page_size=8, num_pages=64,
                                    kv_dtype=kv_dtype)
    probe_b = CacheSpec.from_config(cfg, 8, 256, page_size=8, num_pages=65,
                                    kv_dtype=kv_dtype)
    per_page = probe_b.paged_kv_bytes() - probe_a.paged_kv_bytes()
    fixed = probe_a.paged_kv_bytes() - 64 * per_page
    npages = int((budget - fixed) // per_page)
    cap = Engine(cfg, params, slots=8, max_len=256, page_size=8,
                 sync_interval=8, prefix_sharing=False, num_pages=npages,
                 kv_dtype=kv_dtype, device=dev)
    quant_bytes = cap.spec.paged_kv_bytes()
    assert quant_bytes <= budget, (quant_bytes, budget)
    cap.warmup()
    load(cap, [(i, prompt, 16) for i, prompt in enumerate(prompts)])
    cap_peak = cap.memory_stats()["peak_live_slots"]
    slot_ratio = cap.spec.slots / base.spec.slots
    page_ratio = (base.spec.paged_kv_bytes()
                  / CacheSpec.from_config(cfg, 4, 256, page_size=8,
                                          kv_dtype=kv_dtype)
                  .paged_kv_bytes())

    # preemption on an oversubscribed int8 pool: 12 pages against 8
    # worst-case pages a request
    pre = Engine(cfg, params, num_pages=12, kv_dtype=kv_dtype, **kw)
    pre.warmup()
    out_pre = load(pre, reqs, ttl=600.0)
    pre_fs = pre.fault_stats()
    pre_match = out_pre == out8
    pre_leaked = pre.leaked_pages()

    # copy-on-write: a shared chain head, an off-chain branch token each
    head = _chain(701, 16, vocab)
    cow_reqs = [(i, head + [(40 + 13 * i) % vocab], 24)
                for i in range(n_req)]
    share = Engine(cfg, params, slots=4, max_len=256, page_size=8,
                   sync_interval=8, prefix_sharing=True, kv_dtype=kv_dtype,
                   device=dev)
    share.warmup()
    out_share = load(share, cow_reqs)
    excl = Engine(cfg, params, kv_dtype=kv_dtype, **kw)
    excl.warmup()
    out_excl = load(excl, cow_reqs)
    ps = share.prefix_stats()
    cow_match = out_share == out_excl

    quant.submit(Request(rid=99, prompt=[1, 2, 3], max_new_tokens=32))
    quant._admit()
    toks, sync_free = _sync_free_chunk(quant)
    if sync_free:
        quant._drain(toks)
    quant.run(max_steps=200_000)
    quant.finished = []

    rec = {
        "qp_requests": n_req,
        "qp_max_new": max_new,
        "qp_train_loss": train_loss,
        "qp_fp32_follows_chain": follows / n_req,
        "qp_greedy_match": greedy_match,
        "qp_exact_matches": exact,
        "qp_total_positions": total,
        "qp_max_logit_err": max_logit_err,
        "qp_fp32_pool_bytes": int(budget),
        "qp_quant_pool_bytes": int(quant_bytes),
        "qp_equal_bytes_slots": cap.spec.slots,
        "qp_baseline_slots": base.spec.slots,
        "qp_equal_bytes_slot_ratio": slot_ratio,
        "qp_equal_bytes_peak_live_slots": int(cap_peak),
        "qp_equal_bytes_num_pages": npages,
        "qp_bytes_per_page_ratio": page_ratio,
        "qp_preemptions": pre_fs["preemptions"],
        "qp_preempt_outputs_match": pre_match,
        "qp_preempt_leaked_pages": int(pre_leaked),
        "qp_cow_outputs_match": cow_match,
        "qp_prefix_hits": ps["prefix_hits"],
        "qp_cow_copies": ps["cow_copies"],
        "qp_shared_attaches": ps["shared_page_attaches"],
        "qp_decode_compiles": quant.decode_compiles,
        "qp_decode_sync_free": sync_free,
    }
    rec.update(_pool_telemetry(quant, "qp_"))
    for e, lbl in ((base, "qp_fp32"), (quant, "qp_int8"),
                   (cap, "qp_capacity"), (pre, "qp_preempt"),
                   (share, "qp_cow"), (excl, "qp_exclusive")):
        assert_clean_teardown(e, seen[id(e)], label=lbl)
    emit("fig14.qp_greedy_match", greedy_match,
         f"exact={exact}/{n_req},logit_err={max_logit_err:.4f},"
         f"loss={train_loss:.3f}")
    emit("fig14.qp_equal_bytes_slot_ratio", slot_ratio,
         f"bytes={int(quant_bytes)}<={int(budget)},"
         f"peak_live={int(cap_peak)}/{cap.spec.slots},"
         f"page_ratio={page_ratio:.2f}")
    emit("fig14.qp_fault_parity", float(pre_match and cow_match),
         f"preemptions={pre_fs['preemptions']},leaked={int(pre_leaked)},"
         f"cow={ps['cow_copies']},hits={ps['prefix_hits']}")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default); the trio needs it")
    ap.add_argument("--out", default="BENCH_serve_torch.json",
                    help="trajectory file the record is appended to")
    ap.add_argument("--trials", type=int, default=3,
                    help="timed runs per engine where the reference "
                         "takes the best of three")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    trio = dispatch_trio(dev)
    rec = {"device": torch.cuda.get_device_name(dev), **trio}
    rec.update(serve_engine_comparison(device=dev, trials=args.trials))
    rec.update(shared_prefix_comparison(device=dev))
    rec.update(paged_kernel_comparison(device=dev, trials=args.trials))
    rec.update(speculative_comparison(device=dev))
    rec.update(fault_tolerance_comparison(device=dev))
    rec.update(chunked_prefill_comparison(device=dev))
    rec.update(quantized_pool_comparison(device=dev))
    path = write_bench_json(args.out, rec)
    print(f"# serve trajectory appended to {path}", flush=True)
    return rec


if __name__ == "__main__":
    main()
