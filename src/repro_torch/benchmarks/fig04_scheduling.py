"""Paper Fig. 4: asynchronous against synchronous scheduling, on the
card (counterpart of ``benchmarks/fig04_scheduling.py``).

    python -m repro_torch.benchmarks.fig04_scheduling [--device cpu]
    python -m repro_torch.benchmarks.fig04_scheduling --slo-mix \\
        [--trace-report] [--out BENCH_serve_torch.json]

A plain run does the two halves of the figure:

* the MoE layer (``moe_layer_comparison``): ``models/moe.apply`` (the
  experts' three products as three grouped ``moe_gmm`` launches, every
  expert at once) against ``moe.apply_sync_schedule`` (one expert at a
  time, a plain product each), the same dispatch and the same weights.
  On the card one dbrx-132b MoE layer at full width (d 6144, d_ff 10752,
  16 experts, top 4; x [4, 512, 6144] fp32, 12.7 GB of expert weights);
  on the CPU the reference's reduced layer (8 experts, top 2, d 128,
  d_ff 256; x [4, 512, 128]);
* the cost model (``prod_estimates``): the guideline's plan against
  pools = 1 for every arch at ``train_4k`` on the production mesh, with
  the port's ``Hardware()`` (analytic: no device runs).

The serving half: ``--slo-mix`` (``slo_scheduling_comparison``): reduced
internlm2-1.8b on an oversubscribed pool (4 slots against 24 requests,
12 pages below the full-occupancy worst case) replays one
``serve/traffic`` Poisson trace under both policies on the same
``VirtualClock``: TTFT/TPOT p50/p99 per class, goodput, throttles and
preemptions, token parity across the policies, a byte-identical
regenerated trace, zero leaked pages, one sync-free chunk (``slo_*``
keys).  ``--trace-report`` (``trace_report``): the same trace on a
traced SLO engine, rendered into per-class phase times (queued /
running / requeued), preemptions by class, the export's schema validity
(``benchmarks/check_trace``) and the fingerprint's determinism across
two replays (``trep_*`` keys).  Each record is merged into the last run
of ``--out`` (default ``BENCH_serve_torch.json``, the file fig14
writes); a plain run writes nothing and ignores ``--out``, as the
reference's does.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.benchmarks.common import (assert_clean_teardown, emit,
                                           merge_into_last_run, time_fn)
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced
from repro_torch.core import autotune, tuner
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import moe
from repro_torch.models.module import init_params

MOE_BATCH = (4, 512)     # x [4, 512, d], as the reference's
MOE_WARMUP, MOE_ITERS = 2, 10


def moe_layer_inputs(device: DeviceLike = None, seed: int = 0):
    """(cfg, params, x) of the MoE-layer comparison: dbrx-132b's layer
    at full width on a CUDA device, the reference's reduced one
    elsewhere; weights from ``seed``, x from ``seed + 1``."""
    dev = resolve_device(device)
    cfg = get_config("dbrx-132b")
    if dev.type != "cuda":
        cfg = reduced(cfg, experts=8, d_model=128, d_ff=256)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, top_k=2))
    params = init_params(moe.moe_defs(cfg), seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    x = torch.randn(*MOE_BATCH, cfg.d_model, generator=gen, device=dev)
    return cfg, params, x


def moe_layer_comparison(cfg, params, x) -> dict:
    """``moe.apply`` against ``moe.apply_sync_schedule`` on the same
    tensors: median seconds a call (CUDA events on the card),
    ``MOE_WARMUP + MOE_ITERS`` calls each (``calls``)."""
    dev = x.device
    with torch.no_grad():
        t_async = time_fn(lambda: moe.apply(params, x, cfg)[0], device=dev,
                          warmup=MOE_WARMUP, iters=MOE_ITERS)
        t_sync = time_fn(lambda: moe.apply_sync_schedule(params, x, cfg)[0],
                         device=dev, warmup=MOE_WARMUP, iters=MOE_ITERS)
    emit("fig04.moe_layer.async", t_async * 1e6,
         f"speedup_vs_sync={t_sync / t_async:.2f}x")
    emit("fig04.moe_layer.sync", t_sync * 1e6, "baseline")
    return dict(async_s=t_async, sync_s=t_sync, speedup=t_sync / t_async,
                calls=MOE_WARMUP + MOE_ITERS, d_model=cfg.d_model,
                d_ff=cfg.d_ff, experts=cfg.moe.num_experts,
                top_k=cfg.moe.top_k, x_shape=list(x.shape),
                device=str(dev))


def prod_estimates() -> List[dict]:
    """Per arch at ``train_4k``: the guideline's plan against the same
    plan at pools = 1 (synchronous: one expert group at a time)."""
    shape = SHAPES["train_4k"]
    rows = []
    for arch in ARCH_IDS:
        acfg = get_config(arch)
        gl = tuner.guideline_plan(acfg, shape)
        sync = dataclasses.replace(gl, pools=1, intra=16, name="sync")
        t_gl = autotune.evaluate(acfg, shape, gl).step_s
        t_sync = autotune.evaluate(acfg, shape, sync).step_s
        name = f"fig04.prod.{arch}"
        emit(name, t_gl * 1e6,
             f"async_speedup={t_sync / t_gl:.2f}x,pools={gl.pools}")
        rows.append(dict(name=name, step_s=t_gl, sync_step_s=t_sync,
                         pools=gl.pools))
    return rows


GEN_KW = dict(rate=100.0, process="poisson",
              class_mix={"interactive": 0.4, "batch": 0.4,
                         "best_effort": 0.2})
ENGINE_KW = dict(slots=4, max_len=64, page_size=8, num_pages=12,
                 sync_interval=4, prefix_sharing=False, seed=0)


def _model(device):
    from repro_torch.benchmarks.fig14_dispatch_overhead import _model
    return _model(device)


def slo_scheduling_comparison(n_req: int = 24, seed: int = 11, *,
                              device: DeviceLike = None) -> dict:
    """SLO least-slack policy against FIFO on one seeded mixed-class
    trace.  The rate is far above the service rate, so the whole trace
    arrives within the first chunks and a deep mixed-class queue forms;
    under FIFO interactive arrivals wait behind earlier batch work, under
    the SLO policy they jump the queue and batch slots yield (class-aware
    victims and the prefill-budget throttle).  Batch-class percentiles
    are reported beside them: the price batch pays is part of the
    record."""
    from repro_torch.benchmarks.fig14_dispatch_overhead import (
        _pool_telemetry, _sync_free_chunk)
    from repro_torch.serve import traffic
    from repro_torch.serve.engine import Engine

    dev = resolve_device(device)
    cfg, params = _model(dev)
    trace = traffic.TrafficGenerator(seed, **GEN_KW).generate(n_req)
    regen = traffic.TrafficGenerator(seed, **GEN_KW).generate(n_req)
    trace_deterministic = (traffic.trace_fingerprint(trace)
                           == traffic.trace_fingerprint(regen))

    def run(policy):
        clk = traffic.VirtualClock(dt=0.05)
        eng = Engine(cfg, params, policy=policy, clock=clk, device=dev,
                     **ENGINE_KW)
        eng.warmup()
        traffic.replay(eng, trace, clock=clk)
        return eng, eng.latency_stats(), {r.rid: list(r.out_tokens)
                                          for r in eng.finished}

    fifo, ls_fifo, toks_fifo = run("fifo")
    slo, ls_slo, toks_slo = run("slo")
    fifo_reqs, slo_reqs = list(fifo.finished), list(slo.finished)

    def cls(ls, name, key):
        c = ls["classes"].get(name)
        return c[key] if c else None

    rec = {
        "slo_requests": n_req,
        "slo_trace_seed": seed,
        "slo_trace_deterministic": trace_deterministic,
        "slo_num_pages": ENGINE_KW["num_pages"],
        "slo_outputs_match": toks_slo == toks_fifo,
        "slo_goodput": ls_slo["goodput"],
        "slo_fifo_goodput": ls_fifo["goodput"],
        "slo_interactive_ttft_p50": cls(ls_slo, "interactive", "ttft_p50"),
        "slo_interactive_ttft_p99": cls(ls_slo, "interactive", "ttft_p99"),
        "slo_fifo_interactive_ttft_p50":
            cls(ls_fifo, "interactive", "ttft_p50"),
        "slo_fifo_interactive_ttft_p99":
            cls(ls_fifo, "interactive", "ttft_p99"),
        "slo_interactive_tpot_p99": cls(ls_slo, "interactive", "tpot_p99"),
        "slo_fifo_interactive_tpot_p99":
            cls(ls_fifo, "interactive", "tpot_p99"),
        "slo_interactive_goodput": cls(ls_slo, "interactive", "goodput"),
        "slo_fifo_interactive_goodput":
            cls(ls_fifo, "interactive", "goodput"),
        "slo_batch_ttft_p99": cls(ls_slo, "batch", "ttft_p99"),
        "slo_fifo_batch_ttft_p99": cls(ls_fifo, "batch", "ttft_p99"),
        "slo_batch_goodput": cls(ls_slo, "batch", "goodput"),
        "slo_budget_throttles": ls_slo["budget_throttles"],
        "slo_preemptions": slo.fault_stats()["preemptions"],
        "slo_leaked_pages": slo.leaked_pages(),
        "slo_fifo_leaked_pages": fifo.leaked_pages(),
        "slo_decode_compiles": slo.decode_compiles,
    }
    rec["slo_interactive_ttft_improvement"] = (
        rec["slo_fifo_interactive_ttft_p99"]
        / rec["slo_interactive_ttft_p99"]
        if rec["slo_interactive_ttft_p99"] else float("inf"))
    toks, sync_free = _sync_free_chunk(slo)
    if sync_free:
        slo._drain(toks)
    rec["slo_decode_sync_free"] = sync_free
    rec.update(_pool_telemetry(slo, "slo_"))
    assert_clean_teardown(fifo, fifo_reqs, label="slo_mix_fifo")
    assert_clean_teardown(slo, slo_reqs, label="slo_mix_slo")

    emit("fig04.slo_interactive_ttft_p99",
         rec["slo_interactive_ttft_p99"],
         f"fifo={rec['slo_fifo_interactive_ttft_p99']},"
         f"improvement={rec['slo_interactive_ttft_improvement']:.2f}x,"
         f"match={rec['slo_outputs_match']}")
    emit("fig04.slo_goodput", rec["slo_goodput"],
         f"fifo={rec['slo_fifo_goodput']:.3f},"
         f"throttles={rec['slo_budget_throttles']},"
         f"preemptions={rec['slo_preemptions']},"
         f"leaked={rec['slo_leaked_pages']}")
    return rec


def trace_report(n_req: int = 24, seed: int = 11, *,
                 device: DeviceLike = None) -> dict:
    """The SLO mix's trace on a traced SLO engine under a
    ``VirtualClock``: per-class seconds queued / running / requeued
    (summed over requests: where the TTFT went), preemptions by class,
    the Chrome-trace export's schema validity, an ``explain`` that
    renders a whole chain, and the fingerprint's byte-determinism across
    two replays (virtual timestamps flow into the events)."""
    from repro_torch.benchmarks.check_trace import validate
    from repro_torch.benchmarks.fig14_dispatch_overhead import (
        _pool_telemetry)
    from repro_torch.serve import traffic
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.trace import _lifecycle_phases

    dev = resolve_device(device)
    cfg, params = _model(dev)
    trace = traffic.TrafficGenerator(seed, **GEN_KW).generate(n_req)

    def run_traced():
        clk = traffic.VirtualClock(dt=0.05)
        eng = Engine(cfg, params, policy="slo", clock=clk, trace=True,
                     device=dev, **ENGINE_KW)
        eng.warmup()
        traffic.replay(eng, trace, clock=clk)
        return eng

    eng = run_traced()
    reqs = list(eng.finished)
    deterministic = (eng.tracer.fingerprint()
                     == run_traced().tracer.fingerprint())

    evs = eng.tracer.events()
    cls_of = {e.rid: e.attrs.get("slo_class", "best_effort")
              for e in evs if e.kind == "submit"}
    by_rid = {}
    for e in evs:
        if e.rid is not None:
            by_rid.setdefault(e.rid, []).append(e)
    phase_s = {}                    # (class, phase) -> summed seconds
    for rid, revs in by_rid.items():
        for name, a, b, _slot in _lifecycle_phases(revs):
            end = revs[-1].ts if b is None else b
            key = (cls_of.get(rid, "best_effort"), name)
            phase_s[key] = phase_s.get(key, 0.0) + (end - a)
    preempts = [e for e in evs if e.kind == "preempt"]
    preempt_by_cls = {}
    for e in preempts:
        c = cls_of.get(e.rid, "best_effort")
        preempt_by_cls[c] = preempt_by_cls.get(c, 0) + 1

    failures = validate(eng.export_trace())
    for f in failures:
        print(f"# trace schema failure: {f}")
    sample = preempts[0].rid if preempts else reqs[0].rid
    txt = eng.explain(sample)
    rec = {
        "trep_requests": n_req,
        "trep_trace_seed": seed,
        "trep_events": len(eng.tracer),
        "trep_dropped": eng.tracer.dropped,
        "trep_fingerprint_deterministic": deterministic,
        "trep_schema_valid": not failures,
        "trep_preemptions": len(preempts),
        "trep_explain_ok": "phase durations:" in txt and "terminal:" in txt,
    }
    for c in ("interactive", "batch", "best_effort"):
        for phase in ("queued", "running", "requeued"):
            rec[f"trep_{c}_{phase}_s"] = phase_s.get((c, phase), 0.0)
        rec[f"trep_{c}_preemptions"] = preempt_by_cls.get(c, 0)
    rec.update(_pool_telemetry(eng, "trep_"))
    assert_clean_teardown(eng, reqs, label="trace_report")

    emit("fig04.trep_schema_valid", float(rec["trep_schema_valid"]),
         f"events={rec['trep_events']},dropped={rec['trep_dropped']},"
         f"deterministic={deterministic}")
    emit("fig04.trep_interactive_queued_s",
         rec["trep_interactive_queued_s"],
         f"running={rec['trep_interactive_running_s']:.3f}s,"
         f"batch_queued={rec['trep_batch_queued_s']:.3f}s,"
         f"preempts={rec['trep_preemptions']}")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slo-mix", action="store_true",
                    help="run the SLO-vs-FIFO serving workload and merge "
                         "its slo_* record into the last run of --out "
                         "instead of the MoE/cost-model halves")
    ap.add_argument("--trace-report", action="store_true",
                    help="replay the SLO mix on a traced engine and merge "
                         "its trep_* record into the last run of --out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default="BENCH_serve_torch.json",
                    help="trajectory file whose last run takes the serving "
                         "record; a plain run (the MoE and cost halves) "
                         "writes nothing")
    args = ap.parse_args(argv)
    if not (args.slo_mix or args.trace_report):
        return dict(moe_layer=moe_layer_comparison(
            *moe_layer_inputs(args.device)), prod=prod_estimates())
    rec = {}
    if args.slo_mix:
        rec.update(slo_scheduling_comparison(device=args.device))
    if args.trace_report:
        rec.update(trace_report(device=args.device))
    path = merge_into_last_run(args.out, rec)
    print(f"# fig04 record merged into the last run of {path}", flush=True)
    return rec


if __name__ == "__main__":
    main()
