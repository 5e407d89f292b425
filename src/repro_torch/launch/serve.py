"""Batched serving driver of the port (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --requests 6 --max-new 12 --warmup

runs on the card; ``--device cpu`` runs the same path on the CPU, with
every kernel's plain version.  ``--smoke`` (the default, as in the
reference, where it cannot be turned off) serves
``reduced(get_config(arch))``; ``--no-smoke`` serves the unreduced
config, at full width.

The flags are the reference's, with its names, defaults and meanings.
The synthetic workload sends every request the same ``--shared-prefix``
prompt head, so prefix sharing shows in the printed hit rate.
``--spec-draft ngram --spec-k 4`` turns on speculative decoding
(``serve/spec``).  ``--slo-class`` tags every request, and it,
``--policy slo`` or ``--traffic`` print the per-class TTFT/TPOT
percentiles and goodput from ``Engine.latency_stats()`` (seconds, or
virtual units ``vu`` under ``--traffic``).

Robustness and SLO flags, as the reference's: ``--chaos SEED`` serves
under ``ChaosMonkey.smoke(SEED)`` (admission denials, preemption storms,
slot stalls ended by the watchdog, sharing faults) and fails unless
every request ends in a terminal status with zero leaked pages;
``--queue-limit`` with ``--shed-policy reject|block|evict-lru-prefix``,
``--ttl`` (a deadline per request, reaped at the next chunk boundary),
``--policy slo``; ``--traffic poisson:SEED`` or ``bursty:SEED``
replays a seeded mixed-class arrival trace (``serve/traffic.py``,
``--traffic-rate`` arrivals per unit) on a virtual clock that ticks 0.05
per chunk, in place of the synthetic workload; ``--trace OUT.json``
records the request lifecycle and writes its Chrome-trace / Perfetto
timeline there, then prints ``Engine.observe()``'s trace counts and
``Engine.explain()`` of the first request
(``python -m repro_torch.benchmarks.check_trace OUT.json`` validates
it).  The ``faults:`` line (preemptions by cause, resumes, recovered
prefill, timeouts, cancellations, rejections, leaked pages) is printed
on every run.  An 8-bit ``--kv-dtype`` is served in 8 bits or the
launch raises; the port never falls back to fp32 pools.

The totals line prints the engine's shape counters where the reference
prints its compile counts: the distinct shapes each path ran, which are
the executables the reference compiles on the same traffic.  The last
line, which the reference lacks, counts each kernel's CUDA launches
(warmup included): on the card it shows that the run went through the
kernels.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve reduced(get_config(arch)) (default, as in "
                         "the reference, whose --smoke cannot be turned "
                         "off); --no-smoke serves the unreduced config at "
                         "full width, the one flag the reference lacks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain versions of every kernel)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64,
                    help="logical per-slot token cap (widest page-table "
                         "width x page size)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (serve/cache.py paged pools)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page budget of the widest (full-attention) pool "
                         "group; default slots*max_len/page_size (the old "
                         "dense cache's token capacity).  Sliding-window "
                         "groups are always window-sized: slots x "
                         "ceil(window/page_size) pages each")
    ap.add_argument("--kv-dtype", choices=["auto", "fp32", "int8",
                                           "fp8_e4m3"], default="auto",
                    help="paged KV pool storage precision: 8-bit pools "
                         "('int8'/'fp8_e4m3') store per-page fp32 scales "
                         "alongside and dequantize inside the attention "
                         "read (in-kernel on the card).  'auto'/'fp32' "
                         "keep full-precision pools; an 8-bit dtype the "
                         "device cannot serve raises (no fallback)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable radix prefix sharing / copy-on-write "
                         "page reuse (exclusive page ownership)")
    ap.add_argument("--paged-kernel", choices=["auto", "on", "off"],
                    default="auto",
                    help="decode-attention pool reads: 'on' forces the "
                         "pool-direct path (the CUDA kernel on the card, "
                         "its plain version elsewhere), 'off' forces "
                         "gather-then-attend (parity debugging), 'auto' "
                         "picks the kernel on a CUDA device")
    ap.add_argument("--spec-draft", default="off",
                    help="speculative decoding drafter: 'off' (default), "
                         "'ngram' (prompt-lookup, no second model), or a "
                         "configs/ arch name served reduced as the draft "
                         "model (attention-only archs only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify step (the fused chunk "
                         "verifies K+1 positions per slot per micro-step)")
    ap.add_argument("--shared-prefix", type=int, default=12,
                    help="length of the prompt head shared by every "
                         "request in the synthetic workload (0 = fully "
                         "distinct prompts)")
    ap.add_argument("--chunked-prefill", choices=["auto", "on", "off"],
                    default="auto",
                    help="fused mixed prefill+decode chunks (Sarathi-"
                         "style): prompts stream through the decode chunk "
                         "prefill_budget tokens per micro-step, with no "
                         "prefill pass at all.  'auto' enables it "
                         "whenever the arch is paged-KV capable with no "
                         "model drafter")
    ap.add_argument("--prefill-budget", type=int, default=32,
                    help="prompt tokens each fused chunk micro-step "
                         "spends per admitting slot (the TTFT-vs-decode-"
                         "jitter knob; only with chunked prefill)")
    ap.add_argument("--sync-interval", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--warmup", action="store_true",
                    help="run every prefill bucket and one chunk before "
                         "the first request (kernel builds, first use of "
                         "each shape)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run under a seeded fault-injection schedule "
                         "(serve/chaos.py smoke preset: admission "
                         "denials, preemption storms, slot stalls, "
                         "sharing faults); fails unless every request "
                         "reaches a terminal status and zero pages leak")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the admission queue; overflow is "
                         "handled by --shed-policy")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "block", "evict-lru-prefix"],
                    help="load-shedding at a full admission queue")
    ap.add_argument("--ttl", type=float, default=None,
                    help="per-request deadline in seconds from submit; "
                         "expired requests are reaped as TIMED_OUT at "
                         "the next chunk boundary")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "slo"],
                    help="admission/victim policy: 'slo' orders the "
                         "queue least-slack-first by SLO class "
                         "(interactive > batch > best_effort), picks "
                         "lowest-class preemption victims, and throttles "
                         "non-interactive prefill budgets when an "
                         "interactive TTFT slack goes negative")
    ap.add_argument("--slo-class", default=None,
                    choices=["interactive", "batch", "best_effort"],
                    help="SLO class for every synthetic request (default: "
                         "best_effort); prints the per-class TTFT/TPOT "
                         "percentiles and goodput")
    ap.add_argument("--traffic", default=None, metavar="PROC:SEED",
                    help="replace the synthetic workload with a seeded "
                         "arrival trace from serve/traffic.py: "
                         "'poisson:SEED' or 'bursty:SEED' (mixed SLO "
                         "classes and lengths, virtual-clock replay)")
    ap.add_argument("--traffic-rate", type=float, default=8.0,
                    help="arrivals per virtual clock unit for --traffic")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record request-lifecycle trace events "
                         "(serve/trace.py ring buffer, recorded on the "
                         "host at chunk boundaries) and write a "
                         "Chrome-trace/Perfetto timeline JSON here at "
                         "exit")
    return ap.parse_args(argv)


def build_engine(args: argparse.Namespace, params=None):
    """The engine ``args`` describe.  ``params``: the model's weights
    (the parity tests pass the reference's through the weight bridge);
    without them, ``init_params`` from seed 0 on the engine's device."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_defs
    from repro_torch.models.module import init_params
    from repro_torch.serve.chaos import ChaosMonkey
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.spec import SpecConfig
    from repro_torch.serve.traffic import VirtualClock

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if params is None:
        params = init_params(model_defs(cfg), 0, device=args.device)
    spec = None
    if args.spec_draft != "off":
        spec = SpecConfig(draft=args.spec_draft, k=args.spec_k)
    chaos = None
    if args.chaos is not None:
        chaos = ChaosMonkey.smoke(args.chaos)
    # --traffic: arrival times, TTFT/TPOT and deadlines all move in trace
    # units, one tick per chunk boundary (``run`` ticks the engine's clock)
    clock = VirtualClock(dt=0.05) if args.traffic is not None else None
    return Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                  policy=args.policy, clock=clock, page_size=args.page_size,
                  num_pages=args.num_pages,
                  prefix_sharing=not args.no_prefix_sharing,
                  paged_kernel={"auto": "auto", "on": True,
                                "off": False}[args.paged_kernel],
                  spec=spec, temperature=args.temperature, top_k=args.top_k,
                  sync_interval=args.sync_interval,
                  queue_limit=args.queue_limit,
                  shed_policy=args.shed_policy, chaos=chaos,
                  chunked_prefill={"auto": "auto", "on": True,
                                   "off": False}[args.chunked_prefill],
                  prefill_budget=args.prefill_budget,
                  kv_dtype=args.kv_dtype, device=args.device,
                  trace=args.trace is not None)


def prompts(args: argparse.Namespace) -> List[List[int]]:
    """The synthetic workload's prompts: the ``--shared-prefix`` head,
    then a 4-token tail of each request's own."""
    head = [1 + (3 * j) % 97 for j in range(max(args.shared_prefix, 0))]
    return [head + [1 + i, 2, 3, 4 + i % 3] for i in range(args.requests)]


def run(eng, args: argparse.Namespace) -> None:
    """Warm up (``--warmup``), serve the synthetic workload or replay the
    ``--traffic`` trace, and print the reference's summary lines."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import RequestStatus
    from repro_torch.serve.traffic import TrafficGenerator, replay

    if args.warmup:
        t0 = time.perf_counter()
        eng.warmup()
        if eng.chunked_prefill:
            print(f"warmup: fused prefill+decode chunk "
                  f"(prefill_budget={eng.prefill_budget}) ran in "
                  f"{time.perf_counter() - t0:.2f}s")
        else:
            print(f"warmup: {len(eng.buckets)} prefill buckets "
                  f"{eng.buckets} + decode chunk ran in "
                  f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    if args.traffic is not None:
        proc, _, seed = args.traffic.partition(":")
        seed = int(seed or 0)
        trace = TrafficGenerator(seed, rate=args.traffic_rate,
                                 process=proc).generate(args.requests)
        # the engine's clock is the VirtualClock ``build_engine`` gave it
        replay(eng, trace, clock=eng._clock)
        done = list(eng.finished)
        submitted = done + list(eng.rejected)
        print(f"traffic[{proc}:{seed}]: {len(trace)} arrivals over "
              f"{trace[-1].arrival:.2f} virtual units, classes="
              f"{sorted(set(tr.slo_class for tr in trace))}")
    else:
        submitted = []
        for i, prompt in enumerate(prompts(args)):
            req = Request(rid=i, prompt=prompt,
                          max_new_tokens=args.max_new, ttl=args.ttl,
                          slo_class=args.slo_class or "best_effort")
            submitted.append(req)
            eng.submit(req)
        done = eng.run(max_steps=100_000 if eng.chaos is not None
                       else 1000)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: {r.out_tokens}")
    print(f"{len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {eng.steps} engine steps, "
          f"{eng.host_syncs} host syncs, "
          f"{eng.prefill_compiles} prefill shapes / "
          f"{eng.suffix_prefill_compiles} suffix shapes / "
          f"{eng.decode_compiles} decode shapes / "
          f"{eng.admit_compiles} admit shapes)")
    ms = eng.memory_stats()
    groups = ", ".join(
        f"{k}:{v['num_pages']}p{'w' if v['windowed'] else ''}"
        for k, v in ms["pool_groups"].items())
    print(f"paged KV: page_size={ms['page_size']} pools=[{groups}] "
          f"kv_dtype={ms['kv_dtype']} "
          f"peak_pages_in_use={ms['peak_pages_in_use']} "
          f"dense/paged capacity ratio="
          f"{ms['dense_vs_paged_capacity_ratio']:.2f} "
          f"decode_attention="
          f"{'pool-direct' if eng.paged_kernel else 'gather'} "
          f"prefill="
          f"{'fused-chunked' if eng.chunked_prefill else 'bucketed'}")
    ss = eng.spec_stats()
    if ss["spec"]:
        print(f"speculative [{ss['drafter']}, k={ss['spec_k']}]: "
              f"acceptance={ss['acceptance_rate']:.2f} "
              f"({ss['accepted_tokens']}/{ss['drafted_tokens']} drafts), "
              f"{ss['tokens_per_step']:.2f} tokens/verify-step over "
              f"{ss['spec_steps']} steps")
    fs = eng.fault_stats()
    print(f"faults: {fs['preemptions']} preemptions "
          f"({fs['pressure_preemptions']} pressure / "
          f"{fs['chaos_preemptions']} chaos / "
          f"{fs['watchdog_preemptions']} watchdog), "
          f"{fs['resumes']} resumes "
          f"(recovered_prefill={fs['recovered_prefill_fraction']:.2f}), "
          f"{fs['timed_out']} timed out, {fs['cancelled']} cancelled, "
          f"{fs['rejected']} rejected, "
          f"{eng.leaked_pages()} leaked pages")
    if eng.chaos is not None:
        cs = fs["chaos"]
        print(f"chaos[seed={cs['seed']}]: "
              f"{cs['admission_denials']} admission denials, "
              f"{cs['forced_preemptions']} forced preemptions, "
              f"{cs['stalls_started']} stalls, "
              f"{cs['sharing_faults']} sharing faults")
        bad = [r for r in submitted
               if r.status not in RequestStatus.TERMINAL]
        if bad:
            raise RuntimeError(f"non-terminal requests after drain: "
                               f"{[(r.rid, r.status) for r in bad]}")
        if eng.leaked_pages():
            raise RuntimeError(f"leaked {eng.leaked_pages()} pages at "
                               "drain")
        print("chaos: clean drain (all terminal statuses, zero leaked "
              "pages)")
    if args.traffic is not None or args.slo_class is not None \
            or args.policy != "fifo":
        ls = eng.latency_stats()
        unit = "vu" if args.traffic is not None else "s"
        for name, c in sorted(ls["classes"].items()):
            print(f"slo[{name}]: n={c['count']} "
                  f"goodput={c['goodput']} "
                  f"ttft_p50/p99={c['ttft_p50']}/{c['ttft_p99']}{unit} "
                  f"tpot_p50/p99={c['tpot_p50']}/{c['tpot_p99']}{unit}")
        print(f"slo overall: goodput={ls['goodput']} "
              f"budget_throttles={ls['budget_throttles']} "
              f"policy={args.policy}")
    ps = eng.prefix_stats()
    if ps["prefix_sharing"]:
        print(f"prefix sharing: hit_rate={ps['prefix_hit_rate']:.2f} "
              f"({ps['prefix_hits']}/{ps['admissions']} admissions), "
              f"{ps['prefill_tokens_skipped']} prefill tokens skipped, "
              f"{ps['shared_page_attaches']} shared attaches, "
              f"{ps['cow_copies']} CoW copies, "
              f"{ps['radix_evictions']} evictions, "
              f"{ps['radix_pages']} pages indexed")
    if args.trace is not None:
        eng.export_trace(args.trace)
        obs = eng.observe(spec=False)
        print(f"trace: {obs['trace.events']} lifecycle events "
              f"({obs['trace.dropped']} dropped) over "
              f"{obs['engine.chunks']} chunks -> {args.trace} "
              f"(open in ui.perfetto.dev)")
        if done:
            print(eng.explain(min(r.rid for r in done)))
    print("kernel launches: " + " ".join(
        f"{name}={mod.launches}" for name, mod in _kernel_ops()))


def _kernel_ops():
    """(name, ops module) of each kernel on the serving paths; each
    module counts its CUDA launches (warmup included; 0 on the CPU,
    where the plain versions run)."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.mamba2_scan import ops as scan
    from repro_torch.kernels.moe_gmm import ops as gmm
    from repro_torch.kernels.paged_attention import ops as paged
    from repro_torch.kernels.rwkv6_wkv import ops as wkv
    return (("paged_attention", paged), ("flash_attention", flash),
            ("moe_gmm", gmm), ("mamba2_scan", scan), ("rwkv6_wkv", wkv))


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    run(build_engine(args), args)


if __name__ == "__main__":
    main()
