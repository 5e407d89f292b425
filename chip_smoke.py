#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the trainer (``Trainer`` and the train
launcher on full-width, full-depth internlm2-1.8b, with the backwards of
``flash_attention`` and ``moe_gmm``, and on full-width zamba2-7b and
rwkv6-7b cut in depth, with the scans' backward kernels), the fused
chunked-prefill engine serving full-width internlm2-1.8b (random
weights from a seed) from fp32, int8 and fp8_e4m3 KV page pools, the
same engine as a data-parallel rank (``rules=``, a one-rank NCCL mesh)
beside the paper's branch schedules, the two-executable engine (bucketed,
suffix and segmented prefill, S = 1 decode) serving it from fp32 and
int8 pools, both engines serving it speculatively (n-gram and model
drafters), the serving launcher serving it as a user would start it,
the dense ``ReferenceEngine`` against both engines, fig14's dispatch
study (per-op costs and the old engine against the new), the engine's
robustness, SLO policy and lifecycle tracing (pool-pressure preemption,
deadlines, cancellation, a chaos schedule, a traced run, a seeded
traffic replay under both policies, the launcher's flags), full-width,
full-depth gemma2-2b at max_len 8192 with a
window ring that wraps, full-width, full-depth zamba2-7b (Mamba2 + shared
attention) and rwkv6-7b (attention-free) through the two-executable
engine, then full-width dbrx-132b (MoE, depth cut to 4 layers) from
fp32 pools, then the last four archs one at a time (whisper-medium's
encoder and cross-attention, gemma3-12b cut to 36 layers,
mistral-large-123b cut to 2 layers, pixtral-12b's patch frontend) — the paper's §5 operator
study (fig09 and fig11, the fused-prep matmul) and its tuning machinery
with figs 01, 04, 06, 13 and 18, and holds every CUDA kernel on them
against its plain PyTorch version.  Phases, each
printing JSON lines:

1. device: the card's name and power limit (as nvidia-smi reports them),
   torch and CUDA versions; TF32 off.
2. build: every kernel source compiled by nvcc (in parallel), seconds.
3. kernels: the paged-attention kernel on fp32, int8 and fp8_e4m3 pools
   (8-bit pools quantized by the port's ``quantize_pages``) against its
   plain version at the main path's shapes, at dbrx's 48:8 heads and at
   edge cases, among them the split-KV ones (a ring that is not a whole
   number of splits, a split of trash pages only, dead slots on the
   tensor-core tile path and over three splits on both paths, a
   wrapping window on the tile path, S*G = 15 and 16 on
   either side of the tile/GEMV boundary, dh 36) and at the
   speculative verify shapes (internlm2 S = 5; gemma2 dh 256 with
   window 4096 and softcap 50 on wrapped rings at S = 1, 5 and 32,
   their launches from the engine phases below), at mistral-large's G =
   12 (S = 1, GEMV; S = 32, tile) and on gemma3's wrapped 1024-window
   rings at dh 256 (S = 1, S = 32) (max abs error <=
   1e-4), timed with CUDA events beside its plain version, one library
   call as a yardstick (never used by the port) and its bound on this
   card: bytes at 3.35 TB/s against the products at 495 TFLOP/s times
   the TF32 products per fp32 product (3, or 2 on 8-bit pools) where
   the kernel runs them on tensor cores, at 67 TFLOP/s where it does
   not (``bound_fp32_cores_ms`` keeps the CUDA-core bound beside it; a
   kernel faster than its bound fails the run).  The fused chunk's
   S = 32 and both S = 1 decode shapes are timed.  Then the ``moe_gmm``
   kernel in fp32 and bf16 at dbrx's and grok's expert shapes, with and
   without row counts, with a group dimension and at ragged edges,
   counts 65, 72 and 80 at full width, counts 0 and 1 beside a full
   expert, C = 300 with every row live and D, F not multiples of 4 (fp32
   max abs error <= 1e-4, bf16 <= 2e-2 x max|want|, rows past a count
   exactly 0; the rows the kernel computes printed beside each case).
   Then the ``flash_attention`` kernel in fp32 and bf16 at internlm2's
   prefill shapes (S = 128, 512, 1024) and at edge cases (window,
   softcap, non-causal Sq != Skv, GQA 8:1, dh 16/32/64/256, odd lengths,
   B = 2, zamba2's dh 112 with H = Hkv = 32, a window starting mid-tile,
   one query row, causal Sq < Skv, three batches of ragged tiles, dh 112
   with GQA and a window) and at the last four archs' calls (whisper's
   non-causal encoder, B 8 x 1500 frames at dh 64, and its
   cross-attention of 16 rows and of one row against them; gemma3's dh
   256 window 1024 at S = 1500 and 2048; mistral-large's 96:8 heads at S
   = 1024; pixtral's at 2048) and at fig01's (B 8, S 64), same gates
   (bf16 per query row, against the row's own max|want|); the main
   shapes, zamba2's and the last four archs' timed beside the plain
   version,
   ``scaled_dot_product_attention`` (a yardstick: causal, non-causal or
   with the window's band as a mask) and the bound (3 TF32 products per
   fp32 product on the tensor cores).  The
   paged kernel also runs zamba2's S = 1 decode shape (dh 112, window
   4096).  Then the ``mamba2_scan``
   kernel on the reference's three test cases, S = 1000, an initial
   state with ragged P and N, the model's layout with b/c shared by the
   heads (with and without an initial state), strong decay (a = -16, dt
   up to 1.5: cum falls by ~770 over one of the kernel's 64-row chunks)
   and zamba2's prefill shape (BH 112, P = N = 64) at S = 1024 in both
   layouts and at S = 256 (a bucket the engine launches) in the model's:
   y and the final state within 1e-4 x max|want|; the model-layout calls
   at zamba2's shape timed (``cuda_ms`` and the profiler's device time)
   beside the plain version and the bound (bytes against the chunked
   form's products at 3 TF32 products per fp32 product; the recurrence
   on the CUDA cores beside it; no PyTorch call computes this function).
   Then the ``rwkv6_wkv`` kernel likewise: the
   reference's three test cases, S = 1000 and an initial state with a
   ragged S and K (neither S a multiple of the 64-step chunk), the
   model's layout with r, k, v strided column slices and u shared by
   the batch (with and without an initial state), strong (lw = -5 on
   every channel), weak (|lw| near its smallest, 3.4e-4) and mixed
   decay, and rwkv6-7b's prefill shape (BH 64, K 64) at S = 1024 in both
   layouts and at S = 256, within 1e-4 x max|want|; the model-layout
   calls at S = 1024 and 256 timed (``cuda_ms`` and device time) beside
   the bound (bytes against the chunked form's tensor-core products at 3
   TF32 products per fp32 product; the recurrence on the CUDA cores
   beside it); and 300 pad steps (k = 0, lw = 0) at the end of the S =
   1024 shape, whose final state must be bitwise the state before them.
3b. fused_matmul: the kernel against ``matmul1`` on int8 x with fp32 w,
   scaled and unscaled, at fig09's n = 256, 512, 1024 and 2048; on
   tests/test_kernels.py's three shapes in fp32 and bf16, scaled and
   unscaled; on fp16 x; at ragged edges (37x53x29, M = 1, K = 1), with
   int8 x whose K is not a multiple of 16 or odd, bf16 w whose N is not
   a multiple of 8 or odd, and with a bf16 output from fp32 w (fp32 out
   <= 1e-4 x max|want|, bf16 <= 2e-2 x max|want|).  fig11's case (int8
   x, scaled, fp32 out) timed at n = 1024 and 2048 beside the plain
   version (prep + cuBLAS), bare cuBLAS on the prepared x (a yardstick)
   and the bound at the kernel's 2 TF32 products per fp32 product, each
   call also by its device time from the profiler (``device_ms``).  ``matmul``'s
   gradients (forward through the kernel) against autograd through
   ``matmul1``: dw and dscale for int8 x, dx too for fp32 x (<= 1e-4 x
   max|want|).  Then the slice's main path: fig09's and fig11's
   ``main`` at their default sizes, their CSV rows printed; every
   kernel count zeroed just before each and read just after: fig09
   launches no kernel, fig11 launches ``fused_matmul`` once per fused
   call and no other kernel.
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
5a. sharded_serve: the fp32 phase's 12 requests through
   ``Engine(rules=...)`` (``BATCH`` and ``PAGES`` on ``"data"``) on a
   one-rank NCCL ``("data", "pool")`` mesh joined through a
   ``file://`` store in a temporary directory: the rank holds every slot
   and page, and each drain all-gathers its packed tensor over
   ``"data"``.  Gates: tokens equal the fp32 phase's, a chunk free of
   host syncs, paged launches == 24 x micro-steps, 0 leaked pages,
   prefix hits, ``Rules.fallbacks`` printed (none expected).  Then ``core/scheduler``'s ``run_async`` (1
   branch) and ``hybrid_pools`` (4 branches) over ``"pool"`` at dbrx's
   expert-FFN width (d 6144, F 10752, 256 tokens), each within 1e-4 x
   max|want| of ``run_sync``, timed once each.  Its seconds printed.
5b. legacy, once on fp32 and once on int8 pools: the same 12 requests
   through ``Engine(chunked_prefill=False)`` (buckets 8..1024): 32 tokens
   each, 0 leaked pages, prefix hits with CoW, ``flash_attention``
   launches == 24 x full prefills (calls of ``Executor.prefill``),
   paged-attention launches == 24 x decode micro-steps, and the first
   admission round (prefills, CoW, splices, arming) and one decode chunk
   free of host syncs.  Before it, on one prompt per bucket, the last
   prompt token's logits of ``forward_prefill`` (through the flash
   kernel) against the fused path's teacher-forced ``forward_verify``
   (through the paged kernel), <= 1e-3; and three prompts (100, 600 and
   900 tokens, the last two in the 1024 bucket, one logical page wider
   than the ring) prefilled and spliced into fresh int8 pools: every
   prompt page's codes and scales bitwise those of ``quantize_pages`` on
   the prefill's fp32 KV, the other pages untouched.  Greedy agreement
   with the fused fp32 run and with the fused run of the same pool
   dtype, prefill and decode times and one profiled decode chunk are
   printed, not gated.
5c. segments: two 700-token prompts on a legacy engine whose buckets
   stop at 256, so each prefill runs as segments; it must complete with
   0 leaked pages; agreement with the same prompts served in one
   prefill is printed.
5f. speculation, on internlm2 before it is freed: the 12 requests
   through the fused engine with the n-gram drafter (k = 4,
   ``prefill_budget`` 32; a sync-free chunk, paged launches == 24 x
   micro-steps, drafts made), then through two executables with the
   n-gram drafter (k = 4: S = 5 verify rows), the target as its own draft
   (k = 3, its own tensors; acceptance >= 0.95), a disagreeing draft (2
   layers, d 256, the target's vocab, seed 1; k = 3) and that draft
   with half the requests sampled at temperature 0.8; each: 32 tokens,
   0 leaked pages, a sync-free first round, paged launches == 24 x
   micro-steps, flash launches == 24 x full prefills + draft layers x
   draft prefills.  Every greedy run's emitted tokens are
   teacher-forced: each is the argmax of ``prefill_hidden``'s logits
   over prompt + emitted tokens, or within 1e-3 x max|logit| of the
   top.  ``spec_stats()``, tokens equal to the plain fused run's,
   tokens/s and ms per micro-step are printed.
5h. launcher: ``python -m repro_torch.launch.serve`` as a subprocess at
   full width on internlm2-1.8b (``--no-smoke --slots 8 --max-len 1024
   --page-size 16 --num-pages 512 --requests 12 --max-new 32
   --shared-prefix 264 --warmup --slo-class interactive``), fused, then
   with ``--chunked-prefill off --spec-draft ngram --spec-k 4``; it
   loads the kernels the build phase left under ``build/``.  Its summary
   lines are printed and gated: 12 requests of 32 tokens, pool-direct
   decode on fp32 pools, a prefix hit rate > 0, finite TTFT/TPOT
   p50/p99, paged launches == 24 x (micro-steps + the warmup chunk's 8).
5i. reference_engine: the 12 requests through ``ReferenceEngine`` (the
   dense per-slot cache, a prefill per prompt length, a host read per
   token), the fused engine and the two-executable one: 32 tokens each,
   the tokens equal to the reference's (or else every run's tokens
   teacher-forced), the reference's flash launches == 24 x 12 prefills
   and no paged launch, the engines' paged launches == 24 x
   micro-steps, host syncs per step >= 1 on the reference and exactly
   1/8 on the engines; tokens/s and ms per step printed.
5j. fig14: the port's ``fig14_dispatch_overhead.main`` at the
   reference's sizes (reduced internlm2): the dispatch trio (eager
   launches, one CUDA-graph replay, a host read per op) and the serve
   workloads, the record in ``build/BENCH_serve_torch.json``; its own
   asserts, every workload's chunk sync-free, and paged and flash
   launches > 0.  Its emit lines and a summary are printed.
5p. fig14_qp: the record's ``qp_*`` part (``quantized_pool_comparison``,
   run inside 5j: reduced internlm2 trained 80 AdamW steps on a token
   chain, then served on int8 against fp32 pools), gated as the JAX
   package's ``check_serve_regression.py`` gates it: int8 pools, greedy
   agreement >= 0.99, teacher-forced logit error <= 0.25, int8 pool
   bytes <= fp32's at >= 1.8x the slots all live, >= 1 preemption with
   equal outputs and no leaked page, copy-on-write outputs equal with a
   prefix hit, one decode shape, a sync-free chunk, the int8 paged
   kernel launched.
5k. fault_tolerance: the 12 requests, one request cancelled after the
   first drain and one whose deadline has passed, on 160 pages of 16 (a
   700 + 32-token request reserves up to 46, so 8 slots cannot all hold
   one and pool-pressure preemption must fire), through the fused
   engine and the two-executable one, each boundary's host work
   (reaping, admission with preemption) apart from its chunk: the 12
   requests' tokens equal the uncontended fused fp32 run's (two
   executables: equal, or else teacher-forced), pressure preemptions
   >= 1, the expired request TIMED_OUT and never admitted, the cancelled
   one CANCELLED, 0 leaked pages, one chunk under
   ``set_sync_debug_mode("error")``, paged launches == 24 x micro-steps
   (flash == 24 x full prefills on two executables).  The share of
   replayed tokens recovered through the radix index and wall ms per
   micro-step are printed.
5l. chaos: the 12 requests through the fused engine under
   ``ChaosMonkey(0, p_deny_admission=0.15, p_preempt=0.6, p_stall=0.05,
   p_sharing_fault=0.25)``: every request FINISHED with 32 tokens equal
   to the unfaulted run's, 0 leaked pages, one chunk shape, chaos
   preemptions >= 1, a sync-free chunk; ``fault_stats()`` printed.
5m. trace: 5k's fused configuration with ``trace=True``: 5k's gates,
   tokens equal to 5k's untraced run, the export valid under
   ``benchmarks/check_trace``, ``explain`` of a preempted request naming
   its preempt and resume; wall ms per micro-step against 5k's.
5n. slo_mix: 24 requests of ``TrafficGenerator(0, rate=8.0)`` replayed
   on a ``VirtualClock`` under 'fifo' and 'slo': tokens equal per rid,
   0 leaked pages; throttles and per-class TTFT/TPOT p50/p99 and goodput
   printed.
5o. launcher_a11: ``python -m repro_torch.launch.serve --no-smoke
   --traffic poisson:0 --policy slo --chaos 0 --trace OUT.json`` as a
   subprocess: exit 0, every arrival served, its ``faults:``, ``chaos``
   and ``trace:`` lines, a clean chaos drain, paged launches == 24 x
   engine steps, the trace file valid.
5g. gemma2: internlm2 is freed, then gemma2-2b is built at full width
   and depth (26 layers, 4096-window layers alternating with global
   ones, dh 256, softcaps 50/30; ~10.5 GB of fp32 weights) and serves
   at max_len 8192 one 4600-token prompt (64 new tokens) beside 7 of the
   main traffic's: its first-token logits through the fused path's
   32-row slices and its second token's after a two-executable splice
   into a 256-page windowed ring, each against ``forward_prefill``
   (<= 1e-3 x max|want|); on each path, the kernel engine against the
   gather engine (greedy tokens equal; one pass on the wrapped mid-run
   cache <= 1e-3 x max|want|), 0 leaked pages, paged launches == 26 x
   micro-steps, every token teacher-forced; then the long request alone
   with ``SpecConfig(k=4)`` on both paths, teacher-forced.  Pool bytes
   per group are printed.
5d. zamba2: gemma2's params and engines are freed, then zamba2-7b is
   built at full width and depth (81 layers: 68 Mamba2, 13 applications
   of 2 shared attention blocks; ~24 GB of fp32 weights).  One 100-token
   prompt through ``forward_prefill`` in the 1024 bucket padded with 0s
   and with 9s (<= 1e-4 x max|want| on the logits and every Mamba2 state
   leaf: the length masking), and in its own 128 bucket against the
   1024 bucket and against a first-token prefill followed by 99
   ``forward_decode`` steps (<= 1e-3 x max|want|: other shapes, other
   fp32 summation orders).  Then the 12 requests
   through ``Engine(chunked_prefill="auto")``, which must resolve to two
   executables: 32 tokens each, 0 leaked pages, 0 prefix hits,
   ``mamba2_scan`` launches == 68 x full prefills, flash launches == 13
   x full prefills, paged launches == 13 x decode micro-steps, the first
   admission round and its chunk free of host syncs; one decode chunk
   of a second wave profiled.  Then zamba2 is freed.
5e. rwkv6: rwkv6-7b at full width and depth (32 layers of 64 wkv heads
   of 64, d_ff 14336, vocab 65536; ~30.3 GB of fp32 weights).  One
   100-token prompt through ``forward_prefill`` in the 1024 bucket
   padded with 0s and with 9s (<= 1e-4 x max|want| on the logits and
   every state leaf), and in its own 128 bucket against the 1024 bucket
   and against a first-token prefill followed by 99 ``forward_decode``
   steps (<= 1e-2: random weights grow a rounding difference ~1.3x per
   layer over 32 layers); and each layer on the prefill's own input to
   it, its prefill against its recurrent path (<= 1e-4).  Then the
   12 requests through ``Engine(chunked_prefill="auto")``, which must
   resolve to two executables with no pools: 32 tokens each, 0 prefix
   hits, 0 pool pages in ``memory_stats``, ``rwkv6_wkv`` launches == 32
   x full prefills, no paged, flash or mamba2_scan launch, the first
   admission round and its chunk free of host syncs, finite logits of a
   decode step on the final state; one decode chunk of a second wave
   profiled; an empty prompt beside a 3-token one (both 8 tokens, the
   neighbour's equal to its solo run's).  Then rwkv6 is freed.
6. dbrx: dbrx-132b is built at full width with its depth cut 40 -> 4
   (~57 GB of fp32 weights) and serves the same 12 requests from fp32 pools: 0 leaked
   pages, a chunk free of host syncs, ``moe_gmm`` launches == 3 x 4 x
   micro-steps and paged-attention launches == 4 x micro-steps.  One
   chunk is profiled.  On one teacher-forced chunk (8 slots x 32 tokens)
   it prints each layer's ``dropped_fraction``, and holds the first MoE
   layer on those 256 tokens (``moe.apply``, through the kernel) against
   the same layer recomposed here from the port's ``route`` and
   ``_dispatch_indices`` with the plain ``moe_gmm_ref`` (<= 1e-3).  The
   kernel is timed there, at the main path's shapes and counts, on the
   gate/up and the down product, by ``cuda_ms`` and by its device time,
   beside the plain version, ``torch.bmm`` and the bound (3 TF32 products
   per fp32 product on the tensor cores; the fp32-core bound beside it).
7. The last four archs, each built from seed 0 and freed before the
   next, each printing its peak device memory.  whisper-medium at full
   width and depth (24 + 24 layers; ~4 GB of fp32 weights): 8 rows of
   seeded stub frames [8, 1500, 1024] x 0.1 and 16-token prompts through
   ``forward_prefill``, ``prepare_decode_cache(max_len=80)`` and 48
   greedy ``forward_decode`` steps: flash launches exactly 24 (encoder)
   + 24 (decoder) + 24 (cross prefill) + 24 x 48 (cross decode), no
   paged launch, every step's logits within 1e-3 x max|logit| of
   ``forward_dense_logits`` over prompt + generated tokens (its own 72
   launches).  gemma3-12b, every width kept, depth 48 -> 36 (its first
   36 layers, six global; ~37 GB; cut so that the whole run keeps its
   time with flash_offset and sharded_train) at ``max_len`` 4096: a
   1500-token prompt (its 1024-window rings wrap) beside 7 of the main
   traffic's; mistral-large-123b, every width kept, depth 88 -> 2 (~12.7
   GB; cut to 2 for the sharded_serve phase): the main traffic.  Each fused and on two
   executables, each through the paged kernel and the gather path:
   greedy tokens equal between the two, every kernel-path token
   teacher-forced, 0 leaked pages, paged launches == layers x
   micro-steps (0 on the gather path), flash launches == layers x full
   prefills (0 fused); mistral also prefix hits with CoW.  pixtral-12b
   with nothing cut (40 layers, ~49 GB): 8 prompts of 1100-1800 tokens
   through ``Engine(max_len=2048)``, whose ``"auto"`` must pick two
   executables (the engine's gates, no prefix hit), and through
   ``ReferenceEngine`` (flash == 40 x 8 prefills, no paged launch):
   tokens equal, or else both runs teacher-forced; the engine's tokens
   teacher-forced with the zero frontend.
3c. (after fused_matmul's gradients) training's backwards: dq, dk, dv of
   ``flash_attention`` (the kernel's forward, the explicit-product
   backward) against ``torch.autograd.grad`` through
   ``flash_attention_ref`` at internlm2's training shape (B 4, 16:8
   heads, dh 128, S 1024, causal), gemma2's 4096 window with softcap 50
   at S 4608, dh 256, and whisper's non-causal encoder (B 4, 1500
   frames, dh 64); dx, dw of ``moe_gmm`` against autograd through
   ``moe_gmm_ref`` at dbrx's gate/up shape with partial row counts
   (dead rows' dx exactly 0); all within 1e-5 x max|want| (fp32, TF32
   off).  Each backward timed (median of 30, CUDA events, L2 flushed)
   beside autograd through the plain version, the library's backward
   (SDPA's; ``torch.bmm`` for the two expert products) and its bound
   (fp32 CUDA cores).  Then scan_grads: the backward kernels of
   ``mamba2_scan`` (zamba2-7b's training shape, B 4, H 112, S 1024, P = N
   = 64, and S 1000 with h0 and dh_final) and ``rwkv6_wkv`` (B 4, H 64,
   S 1024, K 64, and S 1000 with h0 and dh_final) in the model's layout
   under autograd: every gradient within 1e-4 x max|want| of autograd
   through the plain per-step version, two calls the same bits, one
   forward and one backward launch a call; the training shapes'
   backwards timed (median of 30) beside autograd through the plain
   version (median of 5) and their bound (12 flops per state element and step, fp32 CUDA cores); each
   forward again at S 1024 with no gradient wanted, its device time
   within 15% of phase 3's; ``paged_attention`` under autograd must
   raise and launch nothing.
8. training, last: one ``Trainer`` step (B 4, S 1024, fp32, TF32 off) on
   the card and on the CPU from the same seed-0 weights and batch, for
   internlm2-1.8b at full width cut to 2 layers and for reduced
   dbrx-132b (the MoE backward, the aux loss): loss within 1e-5,
   grad_norm and params, m and v within 1e-4 (x max|CPU| per leaf),
   each kernel's forward and backward launched once per layer (moe_gmm
   three times); the same for zamba2-7b at 6 layers (five Mamba2 and
   one shared-attention block) and rwkv6-7b at 2, at B 2, S 256 so that
   the CPU's step stays under ~20 s, their params, m and v within 2e-3
   (the CPU runs the JAX package's chunked forms, and the models' fp32
   gradients sit up to ~2-4e-4 off float64 on either side), and the same
   step on the card with the scans' plain versions in place of the
   kernels within 1e-5 (loss, grad_norm) and 2e-3 (params, m, v; each
   part's worst leaf recorded).  A
   resume at 2 layers: 6 steps checkpointed every 3, a fresh ``Trainer`` restored at step 3 replays 3..5 to the same final
   loss (1e-5).  The slice's main path: internlm2-1.8b at full width and
   depth, 12 ``Trainer`` steps at B 4, S 1024, fp32: every loss finite,
   the last below the first, grad norms finite and > 0, flash forward
   and backward launches 24 a step each and no other kernel; ms per
   step, tokens/s and peak memory printed, and one more step profiled
   (forward, backward, update: device ms by family, idle share).  The
   same gates for zamba2-7b at full width cut to 12 of 81 layers (1.47 B
   params, both shared-attention groups) and rwkv6-7b cut to 6 of 32
   (1.86 B params), 6 steps each at B 4, S 1024: 10 ``mamba2_scan`` and
   2 ``flash_attention`` forwards and backwards a step, and 6
   ``rwkv6_wkv``.  Then ``python -m repro_torch.launch.train --arch ARCH
   --smoke --steps 4`` as a subprocess for internlm2-1.8b, zamba2-7b and
   rwkv6-7b: exit 0 and its final line.

9. paper, last: the paper's tuning machinery (``repro_torch.core``) and
   its figures.  The port's ``Hardware()`` (the H100 SXM5 80GB's
   data-sheet figures) beside nvidia-smi's name and power limit and the
   card's total memory.  fig04's MoE half at dbrx-132b's full width (one
   MoE layer, d 6144, d_ff 10752, 16 experts, top 4, x [4, 512, 6144]
   fp32, 12.7 GB of expert weights): ``moe.apply`` against
   ``apply_sync_schedule``, both timed, ``moe_gmm`` launched exactly 3
   times per ``apply``, and the output within 1e-4 x max|y| of the sync
   schedule's and of ``apply`` with the plain ``moe_gmm_ref``.  fig01 on
   internlm2-1.8b at full width and depth, tokens [8, 64]: first and
   steady ``forward_train`` calls, 24 ``flash_attention`` launches a
   forward, a finite loss; the same step with the plain
   ``flash_attention_ref`` in the kernel's place, the loss within 1e-5
   (relative) and ``forward_dense_logits``' logits within 1e-3; then
   the figure as a subprocess, whose first step is a true first call
   (this process's is a warm one).  fig13: ``torch.matmul`` (cuBLAS, TF32 off),
   ``numpy.dot`` and the naive product at n = 256, 512, 1024, finite
   GFLOP/s, no kernel of the port.  fig04's cost half, fig06 and fig18
   on ``Hardware()``: a row per cell, the guideline's plan fitting
   wherever the optimum fits, fig18's summary line.
10. roofline, right after phase 8's full-size internlm2 run: its step
   (B 4 x S 1024, fp32, one card) counted by ``analysis/count`` while
   the card runs it and on ``meta`` tensors through ``launch/build``
   with a one-device plan: FLOPs equal, bytes within 0.1% (the ops that
   differ named), flash's recorded calls equal to its launches (24 and
   24 backward calls), the FLOPs at least the cost model's
   ``model_flops + attention_flops`` less the untied input embedding's
   lookup; ``analysis/roofline`` at the data sheet's bf16 rate and at
   the fp32 CUDA-core rate printed beside phase 8's ms a step and peak
   memory.  Then ``python -m repro_torch.launch.dryrun --arch dbrx-132b
   --shape train_4k`` (once a mesh: as is and with ``--multi-pod``) and
   ``python -m repro_torch.launch.train --arch internlm2-1.8b
   --production`` as three concurrent subprocesses: exit 0, their rows
   ``ok`` with ``useful_ratio`` in (0, 1.05].
11. sharded_train, after roofline: the same full-size internlm2 step as
   SPMD ranks, ``Trainer`` built inside ``axis_rules`` of the tuner's
   guideline plan at ``data = model = 1`` on a one-rank NCCL ``("data",
   "model")`` mesh (params ``place``d, ZeRO-1 moments, the vocab-parallel
   loss, each collective on its one-rank group): 3 steps of phase 8's
   schedule on its seed and data, each loss and grad_norm within 1e-5 of
   phase 8's, flash launches 24 + 24 a step, ms a step printed beside
   phase 8's.  Earlier, after flash_grads, flash_offset: the flash
   kernel with ``q_offset`` (context-parallel attention's queries) at
   internlm2's training shape (B 4, 16:8, dh 128, S 1024, causal) split
   into 2 and 4 query shards and gemma2's (dh 256, window 4096, softcap
   50, S 4608) into 2, 4 and 16 (where the window drops keys): each
   shard = its plain version, the shards = the unsharded kernel, their
   backwards = the unsharded backward; each shard timed, the last beside
   its plain version, SDPA and its bound.

The last three lines are the card's name and power limit (again), the
kernel table (paged attention per pool dtype, with its S = 1 rows under
``by_case``, ``moe_gmm``,
``flash_attention`` at dh 128, at zamba2's dh 112, at whisper's
encoder and at gemma3's dh 256 window, ``mamba2_scan``, ``rwkv6_wkv``,
``fused_matmul`` at fig11's n = 1024 with its launches in fig11,
``flash_attention_q_offset`` (its shards' times); each
with ``has_backward``, and ``flash_attention``, ``moe_gmm``,
``mamba2_scan`` and ``rwkv6_wkv`` with their backward's times, bound
and launches on the training path, and their launches in fig01 and
fig04) and
``{"ok": true, "device": ...}``.
Any failed check exits non-zero before them.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate
# and dense TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
DEV = "cuda"
KERNEL_TOL = 1e-4     # fp32, TF32 off: only the summation order differs
PATH_TOL = 1e-3       # 24 layers of that difference, on logits
KV_DTYPES = ("fp32", "int8", "fp8_e4m3")
SHARED_HEAD = 264     # tokens of the prompt head every other request shares
GMM_BF16_TOL = 2e-2   # x max|want|: both round the fp32 sum to bf16
FLASH_BF16_TOL = 2e-2  # x max|want| of each row: both round fp32 to bf16
MOE_LAYER_TOL = 1e-3  # one MoE layer, kernel vs recomposed plain version
DBRX_DEPTH = 4        # of 40 layers: ~57 GB of fp32 weights on an 80 GB card
# moe_gmm cases: name, (G, E, C, D, F), row counts ("pattern": C, C//2,
# 0, 1, ... per expert; None: every row live; a list: one count per
# expert).  The last four are the tensor-core redesign's: counts just past
# the old 64-row tile at full width, counts 0 and 1 beside a full expert,
# C = 300 with every row live (three passes over each F tile), D and F
# not multiples of 4 (4-byte and element copies).
GMM_CASES = [
    ("dbrx_gate_up", (1, 16, 80, 6144, 10752), "pattern"),
    ("dbrx_gate_up_all_rows", (1, 16, 80, 6144, 10752), None),
    ("dbrx_gate_up_groups2", (2, 16, 80, 6144, 10752), "pattern"),
    ("dbrx_down", (1, 16, 80, 10752, 6144), "pattern"),
    ("grok_gate_up", (1, 8, 80, 6144, 32768), "pattern"),
    ("odd_edges", (1, 4, 37, 200, 72), "pattern"),
    ("odd_edges_groups2_all_rows", (2, 4, 37, 200, 72), None),
    ("dbrx_rows_65_72_80", (1, 4, 80, 6144, 10752), [65, 72, 80, 64]),
    ("dbrx_rows_0_1_full", (1, 3, 80, 6144, 10752), [0, 1, 80]),
    ("c300_all_live", (1, 4, 300, 1024, 2048), [300, 300, 300, 300]),
    ("ragged_d203_f77", (2, 4, 37, 203, 77), "pattern"),
]
# flash_attention cases: name, (B, H, Hkv, Sq, Skv, dh), options; "main"
# cases are internlm2-1.8b's prefill at three buckets, and are timed
FLASH_MAIN = dict(B=1, H=16, Hkv=8, dh=128)
FLASH_CASES = [
    ("main_s128", dict(FLASH_MAIN, Sq=128, Skv=128), {}),
    ("main_s512", dict(FLASH_MAIN, Sq=512, Skv=512), {}),
    ("main_s1024", dict(FLASH_MAIN, Sq=1024, Skv=1024), {}),
    ("window48", dict(FLASH_MAIN, Sq=300, Skv=300), {"window": 48}),
    ("softcap50", dict(FLASH_MAIN, Sq=256, Skv=256), {"softcap": 50.0}),
    ("noncausal_sq_ne_skv", dict(FLASH_MAIN, Sq=100, Skv=177),
     {"causal": False}),
    ("gqa_8to1", dict(FLASH_MAIN, Hkv=2, Sq=256, Skv=256), {}),
    ("dh32", dict(B=1, H=8, Hkv=4, dh=32, Sq=200, Skv=200), {}),
    ("dh64", dict(B=1, H=8, Hkv=4, dh=64, Sq=200, Skv=200), {}),
    ("dh256_softcap", dict(B=1, H=8, Hkv=4, dh=256, Sq=200, Skv=200),
     {"softcap": 30.0}),
    ("odd_s37", dict(FLASH_MAIN, Sq=37, Skv=37), {}),
    ("odd_s100_window", dict(FLASH_MAIN, Sq=100, Skv=100), {"window": 48}),
    ("batch2", dict(FLASH_MAIN, B=2, Sq=160, Skv=160), {}),
    # the tensor-core redesign: windows that start mid-tile, one query row,
    # causal Sq < Skv, three batches of ragged tiles issued longest first,
    # dh 112 with GQA and a window
    ("window33", dict(FLASH_MAIN, Sq=300, Skv=300), {"window": 33}),
    ("sq1_noncausal", dict(FLASH_MAIN, Sq=1, Skv=77), {"causal": False}),
    ("causal_sq_lt_skv", dict(FLASH_MAIN, Sq=90, Skv=200), {}),
    ("batch3_s700", dict(B=3, H=4, Hkv=2, dh=128, Sq=700, Skv=700), {}),
    ("dh112_gqa_window", dict(B=1, H=8, Hkv=2, dh=112, Sq=333, Skv=333),
     {"window": 70}),
    # the reduced internlm2 fig14 serves (4:2 heads of dh 16), ragged S
    ("dh16_reduced", dict(B=1, H=4, Hkv=2, dh=16, Sq=77, Skv=77), {}),
    # fig01's forward_train on internlm2-1.8b: tokens [8, 64]
    ("fig01_b8_s64", dict(FLASH_MAIN, B=8, Sq=64, Skv=64), {}),
]
# zamba2-7b's shared attention at full width: H = Hkv = 32, dh = 112,
# window 4096 (wider than any prompt here); timed like the main cases
FLASH_CASES.append(("zamba2_dh112_s1024",
                    dict(B=1, H=32, Hkv=32, dh=112, Sq=1024, Skv=1024),
                    {"window": 4096}))
# the last four archs' calls on their main paths, each timed: whisper's
# encoder (8 rows of 1500 frames, non-causal, dh 64) and its
# cross-attention of a 16-token prompt and of one decode row against the
# 1500 encoder positions; gemma3's local layers (dh 256, window 1024) at
# the 1500-token prompt's own length and in its 2048 bucket;
# mistral-large's prefill (GQA 96:8) in the 1024 bucket; pixtral's in the
# 2048 bucket
WHISPER = dict(B=8, H=16, Hkv=16, dh=64, Skv=1500)
FLASH_CASES += [
    ("whisper_enc", dict(WHISPER, Sq=1500), {"causal": False}),
    ("whisper_cross_prefill", dict(WHISPER, Sq=16), {"causal": False}),
    ("whisper_cross_decode", dict(WHISPER, Sq=1), {"causal": False}),
    ("gemma3_dh256_w1024_s1500",
     dict(B=1, H=16, Hkv=8, dh=256, Sq=1500, Skv=1500), {"window": 1024}),
    ("gemma3_dh256_w1024_s2048",
     dict(B=1, H=16, Hkv=8, dh=256, Sq=2048, Skv=2048), {"window": 1024}),
    ("mistral_g12_s1024",
     dict(B=1, H=96, Hkv=8, dh=128, Sq=1024, Skv=1024), {}),
    ("pixtral_s2048", dict(B=1, H=32, Hkv=8, dh=128, Sq=2048, Skv=2048), {}),
]
FLASH_TIMED = ("main", "zamba2", "whisper", "gemma3", "mistral", "pixtral")
# mamba2_scan cases: name, shape, layout, h0, decay.  "kernel": the Pallas
# layout (x [BH,S,P], b/c [BH,S,N]); "model": the model's (x [B,S,H,P],
# b/c [B,S,N] column slices of one [B,S,2N] tensor, shared by the H
# heads).  The first three are tests/test_kernels.py's cases;
# "zamba2_full" is the main path's call (zamba2-7b prefill in the 1024
# bucket) and "zamba2_s256" the same in the 256 bucket; both are timed
# (MAMBA_TIMED).  "strong": a = -16 and dt up to 1.5.
MAMBA_CASES = [
    ("jax_s64_p32_n16", dict(B=3, H=1, S=64, P=32, N=16), "kernel", False,
     "default"),
    ("jax_s128_p64_n32", dict(B=3, H=1, S=128, P=64, N=32), "kernel", False,
     "default"),
    ("jax_s96_p64_n64", dict(B=3, H=1, S=96, P=64, N=64), "kernel", False,
     "default"),
    ("s1000_not_pow2", dict(B=8, H=1, S=1000, P=64, N=64), "kernel", False,
     "default"),
    ("h0_ragged_p20_n100", dict(B=3, H=1, S=77, P=20, N=100), "kernel",
     True, "default"),
    ("model_shared_bc", dict(B=2, H=16, S=300, P=64, N=64), "model", False,
     "default"),
    ("model_shared_bc_h0", dict(B=2, H=16, S=37, P=64, N=64), "model",
     True, "default"),
    ("strong_decay_h0", dict(B=3, H=1, S=300, P=64, N=64), "kernel", True,
     "strong"),
    ("zamba2_kernel_layout", dict(B=112, H=1, S=1024, P=64, N=64), "kernel",
     False, "default"),
    ("zamba2_s256", dict(B=1, H=112, S=256, P=64, N=64), "model", False,
     "default"),
    ("zamba2_full", dict(B=1, H=112, S=1024, P=64, N=64), "model", False,
     "default"),
]
MAMBA_TIMED = ("zamba2_full", "zamba2_s256")
# rwkv6_wkv cases: name, shape, layout, h0, decay.  "kernel": the Pallas
# layout (r, k, v, lw [BH,S,K], u [BH,K]); "model": the model's (r, k, v
# [B,S,H,K] column slices of one [B,S,3,H,K] tensor, lw [B,S,H,K], u
# [H,K] with a batch stride of 0).  The first three are
# tests/test_kernels.py's cases; "rwkv6_full" is the main path's call
# (rwkv6-7b prefill in the 1024 bucket) and "rwkv6_s256" the same in the
# 256 bucket; both are timed (RWKV_TIMED).  S = 1000 and 77 are not
# multiples of the kernel's 64-step chunk.  Decays: "strong" lw = -5
# (the model's clamp) on every channel, "weak" lw in [-6.8e-4,
# -3.4e-4] (|lw| >= exp(-8) = 3.35e-4 in the model), "mixed" the first
# half of the channels strong and the second weak.
RWKV_CASES = [
    ("jax_s64_k32", dict(B=3, H=1, S=64, K=32), "kernel", False,
     "default"),
    ("jax_s128_k64", dict(B=3, H=1, S=128, K=64), "kernel", False,
     "default"),
    ("jax_s48_k64", dict(B=3, H=1, S=48, K=64), "kernel", False,
     "default"),
    ("s1000_not_chunk_multiple", dict(B=8, H=1, S=1000, K=64), "kernel",
     False, "default"),
    ("h0_ragged_s77_k100", dict(B=3, H=1, S=77, K=100), "kernel", True,
     "default"),
    ("model_strided", dict(B=2, H=16, S=300, K=64), "model", False,
     "default"),
    ("model_strided_h0", dict(B=2, H=16, S=37, K=64), "model", True,
     "default"),
    ("strong_decay_h0", dict(B=3, H=1, S=300, K=64), "kernel", True,
     "strong"),
    ("weak_decay_h0", dict(B=3, H=1, S=1000, K=64), "kernel", True,
     "weak"),
    ("mixed_decay_model", dict(B=2, H=16, S=300, K=64), "model", True,
     "mixed"),
    ("rwkv6_kernel_layout", dict(B=64, H=1, S=1024, K=64), "kernel",
     False, "default"),
    ("rwkv6_s256", dict(B=1, H=64, S=256, K=64), "model", False,
     "default"),
    ("rwkv6_full", dict(B=1, H=64, S=1024, K=64), "model", False,
     "default"),
]
RWKV_TIMED = ("rwkv6_full", "rwkv6_s256")
# fused_matmul cases: name, (M, K, N), x dtype, w dtype, out dtype, scaled.
# fig09/fig11's int8 x at their four sizes; tests/test_kernels.py's
# three shapes in fp32 and bf16; fp16 x; ragged edges; a bf16 output
# from fp32 w.  FMM_TIMED: fig11's size and the largest of fig09's.
FMM_BF16_TOL = 2e-2   # x max|want|: one rounding of the fp32 sum to bf16
FMM_CASES = [
    (f"fig_int8_n{n}_{'scaled' if sc else 'unscaled'}", (n, n, n), "int8",
     "float32", "float32", sc)
    for n in (256, 512, 1024, 2048) for sc in (True, False)]
FMM_CASES += [
    (f"jax_{m}x{k}x{n}_{dt}_{'scaled' if sc else 'unscaled'}", (m, k, n),
     dt, dt, dt, sc)
    for (m, k, n) in ((128, 128, 128), (256, 512, 128), (512, 256, 384))
    for dt in ("float32", "bfloat16") for sc in (True, False)]
FMM_CASES += [
    ("fp16_x_fp32_w", (512, 256, 384), "float16", "float32", "float32",
     True),
    ("ragged_37x53x29", (37, 53, 29), "int8", "float32", "float32", True),
    ("ragged_m1", (1, 1024, 300), "int8", "float32", "float32", True),
    ("ragged_k1", (300, 1, 200), "int8", "float32", "float32", True),
    ("ragged_bf16_x", (37, 53, 29), "bfloat16", "float32", "float32", False),
    ("bf16_out_fp32_w", (1024, 1024, 1024), "int8", "float32", "bfloat16",
     True),
    # the tensor-core redesign's copy paths: int8 x with K not a multiple
    # of 16 (4-byte copies) and odd (element copies), w rows not a
    # multiple of 16 bytes (4-byte) and of 4 bytes (element copies)
    ("int8_k1000", (200, 1000, 130), "int8", "float32", "float32", True),
    ("int8_k1001_n131", (200, 1001, 131), "int8", "float32", "float32",
     True),
    ("bf16_w_n130", (256, 256, 130), "bfloat16", "bfloat16", "bfloat16",
     True),
    ("bf16_w_n77", (64, 96, 77), "int8", "bfloat16", "float32", True),
]
FMM_TIMED = (1024, 2048)
# rwkv6's path checks, x max|want| of each leaf.  Full-depth rwkv6-7b
# with random weights grows a rounding-sized difference ~1.3x per layer:
# this script's rwkv6_paths line on an H100 put the same prompt in the
# 128 and 1024 buckets, which differ only in cuBLAS summation orders,
# 2.8e-6 apart on the first layer's state and 2.3e-3 on the logits after
# 32 layers (the recurrent path: 7.4e-7 and 1.7e-3).  So the
# recurrent path is held to the prefill layer by layer, each layer fed
# the prefill's own input (nothing compounds: RWKV6_LAYER_TOL), and end
# to end, like the other bucket, within RWKV6_PATH_TOL.  The same bucket
# with another pad token only moves with a masking fault.
RWKV6_LAYER_TOL = 1e-4
RWKV6_PATH_TOL = 1e-2
RWKV6_MASK_TOL = 1e-4
# zamba2's path checks, x max|want| of each leaf.  One prompt through
# other shapes (another bucket; step-by-step decode): fp32 products of
# other shapes sum in other orders and 81 layers carry the difference
# (the 128 and 1024 buckets differ by ~1e-4 on a Mamba2 state).  The same
# bucket with another pad token has the same shapes, so only a masking
# fault can move it.
ZAMBA2_PATH_TOL = 1e-3
ZAMBA2_MASK_TOL = 1e-4
# one prompt length per bucket (8..1024) for the prefill-vs-fused check
BUCKET_PROMPT_LENS = (5, 12, 30, 60, 100, 200, 400, 900)
# prompts spliced into int8 pools: 600 and 900 pad to the 1024 bucket,
# wider than the 64-page ring by one logical page
SPLICE_PROMPT_LENS = (100, 600, 900)
# a teacher-forced token is the argmax of its logits, or within this
# share of max|logit| of their top (a near-tie another order may flip)
TF_TOL = 1e-3
GEMMA2_MAX_LEN = 8192   # gemma2's 4096 windows wrap within it
GEMMA2_LONG = 4600      # the long prompt: wider than the window
GEMMA3_MAX_LEN = 4096
GEMMA3_LONG = 1500      # wider than gemma3's 1024 windows
GEMMA3_DEPTH = 36       # of 48 layers (6 global, each after 5 windowed):
                        # cut for flash_offset and sharded_train
MISTRAL_DEPTH = 2       # of 88 layers: ~12.7 GB of fp32 weights; cut from
                        # 4 to pay for the sharded_serve phase
# the scans' plain forwards (a Python loop a step: 36-385 ms a call) are
# timed over 5 calls, not 30: cut with MISTRAL_DEPTH for sharded_serve
SCAN_FWD_PLAIN_ITERS = 5
SCHED_TOL = 1e-4        # x max|want|: run_async / hybrid_pools vs run_sync
SCHED_BRANCHES = 4      # hybrid_pools' branches at dbrx's expert width
SCHED_TOKENS = 256


class SmokeFailure(Exception):
    pass


T0 = time.time()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1),
                      **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def port_env() -> dict:
    """This process's environment with the checkout's ``src/`` first on
    ``PYTHONPATH``: for the port's launchers run as subprocesses."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    return env


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


def device_ms(torch, fn, flush, iters: int = 10):
    """Device time of one call of ``fn``, from ``torch.profiler``: ``iters``
    calls made as ``cuda_ms`` makes them (``flush`` rewritten before
    each), the CUDA kernels of each call (those between two of the flush's
    fills) summed, and the median over the calls.  A call whose kernels
    the trace lost is left out rather than read as 0 (the count of calls
    traced rides along).  The wrapper's host work, which ``cuda_ms``
    holds, is not in it.  (None, 0) when no kernel was traced."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    kernels = sorted((evt.time_range.start, evt.time_range.elapsed_us() / 1e3,
                      "fill" in evt.name.lower()) for evt in prof.events()
                     if evt.device_type == torch.autograd.DeviceType.CUDA)
    calls, current = [], None
    for _start, ms, is_flush in kernels:
        if is_flush:
            current = None
        elif current is None:
            current = [ms]
            calls.append(current)
        else:
            current.append(ms)
    per_call = sorted(sum(call) for call in calls)
    if not per_call:
        return None, 0
    return per_call[len(per_call) // 2], len(per_call)


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
    # gemma2-2b's windowed layers at max_len 8192: 5 of 8 slots past the
    # window, their rings wrapped
    gemma2 = dict(B=8, H=8, Hkv=4, dh=256, P=16, window=4096, softcap=50.0)
    lens_g2 = [8192, 4700, 4129, 6000, 4097, 700, 300, 40]
    fig14 = dict(B=4, H=4, Hkv=2, dh=16, P=8)
    gemma3 = dict(B=8, H=16, Hkv=8, dh=256, P=16, window=1024)
    lens_g3 = [1532, 1100, 1025, 700, 333, 200, 97, 40]
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
        # dbrx-132b's heads: GQA 6:1, S*G = 192 rows in 3 row tiles
        ("dbrx_gqa6", dict(main, H=48, S=32, lens=lens32)),
        # zamba2-7b's shared attention, S = 1 decode: dh 112, window 4096
        ("zamba2_dh112_s1", dict(B=8, H=32, Hkv=32, dh=112, P=16, nb=64,
                                 S=1, lens=lens32, window=4096)),
        # the split-KV redesign: a ring of 11 pages (2 splits, the second
        # 48 positions) that wraps; a split whose pages are all trash; dead
        # slots and a wrapping window on the tile path; S*G = 15 (GEMV) and
        # 16 (tile) on either side of the path boundary; dh 36 (a k step
        # past dh on the tile path, 4-byte copies of 8-bit rows)
        ("nb_not_split_multiple", dict(B=3, H=16, Hkv=8, dh=128, P=16,
                                       nb=11, S=8, lens=[200, 100, 30])),
        ("trash_split", dict(B=2, H=16, Hkv=8, dh=128, P=16, nb=24, S=2,
                             lens=[380, 300], trash_tail=9)),
        ("no_valid_rows_tile", dict(B=4, H=16, Hkv=8, dh=128, P=16, nb=8,
                                    S=8, lens=[0, 2, 60, 128],
                                    dead_slots=(2,))),
        # the same over three splits (a 384-position ring): empty partials
        # and the combine launch, on both paths
        ("no_valid_rows_split_tile", dict(B=4, H=16, Hkv=8, dh=128, P=16,
                                          nb=24, S=8, lens=[0, 2, 300, 380],
                                          dead_slots=(2,))),
        ("no_valid_rows_split_gemv", dict(B=4, H=16, Hkv=8, dh=128, P=16,
                                          nb=24, S=4, lens=[0, 2, 300, 380],
                                          dead_slots=(2,))),
        ("no_valid_rows_split_s1", dict(B=4, H=16, Hkv=8, dh=128, P=16,
                                        nb=24, S=1, lens=[0, 2, 300, 380],
                                        dead_slots=(2,))),
        ("window_wrap_tile", dict(B=4, H=8, Hkv=4, dh=128, P=16, nb=8, S=16,
                                  lens=[300, 129, 64, 20], window=100)),
        ("rows15_gemv", dict(B=3, H=24, Hkv=8, dh=128, P=16, nb=16, S=5,
                             lens=[250, 90, 6])),
        ("rows16_tile", dict(B=3, H=16, Hkv=8, dh=128, P=16, nb=16, S=8,
                             lens=[250, 90, 8])),
        ("dh36_tile", dict(B=2, H=16, Hkv=8, dh=36, P=16, nb=10, S=8,
                           lens=[150, 20])),
        ("dh36_gemv", dict(B=2, H=16, Hkv=8, dh=36, P=16, nb=10, S=1,
                           lens=[150, 20])),
        # speculative verify: internlm2 at k = 4 (S = 5, 10 rows per kv
        # head: the GEMV path); gemma2 (dh 256, G = 2, window 4096,
        # softcap 50) on rings that wrap: S = 1 decode (256 pages), the
        # two-executable verify S = 5 (257: 4 tokens of slack) and the
        # fused chunk's S = 32 (258: 31 of slack)
        ("verify_internlm2_s5", dict(main, S=5, lens=lens32)),
        ("gemma2_s1_wrap", dict(gemma2, S=1, nb=256, lens=lens_g2)),
        ("gemma2_verify_s5_wrap", dict(gemma2, S=5, nb=257, lens=lens_g2)),
        ("gemma2_fused_s32_wrap", dict(gemma2, S=32, nb=258, lens=lens_g2)),
        # fig14's reduced internlm2 (dh 16, 4:2 heads, page 8, 4 slots):
        # S = 1 decode at max_len 64 (8 pages) and 256 (32 pages); the
        # n-gram verify (k = 4: S = 5) and the fused chunk at budget 4
        # (S = 4) on 33-page rings; all on the GEMV path
        ("fig14_dh16_s1", dict(fig14, S=1, nb=8, lens=[64, 40, 17, 3])),
        ("fig14_dh16_s1_ring32", dict(fig14, S=1, nb=32,
                                      lens=[256, 120, 37, 5])),
        ("fig14_dh16_verify_s5", dict(fig14, S=5, nb=33,
                                      lens=[260, 120, 37, 5])),
        ("fig14_dh16_fused_s4", dict(fig14, S=4, nb=33,
                                     lens=[259, 120, 37, 2])),
        # mistral-large: G = 96 / 8 = 12 query heads per kv head; S = 1
        # decode is 12 rows per kv head (the GEMV path), the fused
        # chunk's S = 32 is 384 (six tiles of the tile path)
        ("mistral_g12_s1", dict(main, H=96, S=1, lens=lens32)),
        ("mistral_g12_s32", dict(main, H=96, S=32, lens=lens32)),
        # gemma3's local layers (dh 256, window 1024) at max_len 4096:
        # two-executable decode on a 64-page ring and the fused chunk on
        # a 66-page one (31 tokens of slack), both wrapped
        ("gemma3_s1_wrap", dict(gemma3, S=1, nb=64, lens=lens_g3)),
        ("gemma3_fused_s32_wrap", dict(gemma3, S=32, nb=66, lens=lens_g3)),
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
            if name.startswith("no_valid_rows"):
                # slot 0 (nothing written), slot 2 (all-trash table) and
                # slot 1's query rows that precede its first token
                dead_q = max(0, kw["S"] - kw["lens"][1])
                zero = (bool((got[0] == 0).all())
                        and bool((got[2] == 0).all())
                        and bool((got[1, :dead_q] == 0).all()))
                rec["dead_rows_exactly_zero"] = zero
                check(zero, f"{kv_dtype} {name}: rows with no valid "
                            "position are not 0")
            check(err <= KERNEL_TOL,
                  f"{kv_dtype} {name}: max abs err {err} > {KERNEL_TOL}")
            if name.startswith(("main", "zamba2", "verify", "gemma2",
                                "mistral", "gemma3")):
                nbytes, flops = paged_need(torch, case)
                # S*G >= 16 rows run on the tensor cores (3 TF32 products
                # per fp32 product, 2 on 8-bit pools), fewer on CUDA cores
                sg = kw["S"] * kw["H"] // kw["Hkv"]
                terms = (3 if kv_dtype == "fp32" else 2) if sg >= 16 else 0
                rec.update(
                    ms=cuda_ms(torch,
                               lambda: ops.paged_attention(*args, **opts),
                               flush=flush),
                    plain_ms=cuda_ms(
                        torch,
                        lambda: ops.paged_attention_ref(*args, **opts),
                        flush=flush),
                    library_ms=sdpa_ms(torch, case, flush),
                    path="tile" if sg >= 16 else "gemv",
                    bytes=nbytes, flops=flops,
                    **bounds(nbytes, flops, terms))
                roofline(rec, f"paged {kv_dtype} {name}")
                rows[kv_dtype][name] = rec
            emit("kernel_check", kernel="paged_decode_attention", **rec)
    return worst, rows


def bounds(nbytes: int, flops: int, terms: int) -> dict:
    """The least time the card could take: bytes at the HBM rate against
    the products on the tensor cores (``terms`` TF32 products per fp32
    product, at the TF32 rate) or, with ``terms`` 0, on the fp32 CUDA
    cores; the CUDA-core bound rides along as ``bound_fp32_cores_ms``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = flops / FP32_FLOPS * 1e3
    t_ops = terms * flops / TF32_FLOPS * 1e3 if terms else t_fp32
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_cores_ms": max(t_bytes, t_fp32),
            "tensor_terms": terms}


def roofline(rec: dict, what: str) -> None:
    """The share of the bound this run reached; above 1 the bound is
    wrong, and the run fails."""
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    check(rec["roofline_share"] <= 1.0,
          f"{what}: {rec['ms']} ms beats its {rec['bound_ms']} ms bound")


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
# Phase 3, moe_gmm: the grouped expert matmul against its plain version
# ---------------------------------------------------------------------------

def gmm_pattern_counts(torch, G, E, C):
    """Row counts C, C//2, 0, 1, C, ... per expert (the reference's
    ``tests/test_kernels.py`` pattern), shifted by one expert per group."""
    pat = [C, C // 2, 0, 1]
    return torch.tensor([[pat[(e + g) % 4] for e in range(E)]
                         for g in range(G)], dtype=torch.int32, device=DEV)


def phase_gmm_kernels(torch, gmm):
    """Every ``GMM_CASES`` case in fp32 and bf16 at the model's scale
    (x ~ N(0, 1), w ~ N(0, 1/D)), with the rows the kernel computes for
    its counts.  Returns the worst fp32 max abs error and the worst bf16
    error relative to max|want|."""
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_rows_computed
    gen = torch.Generator(device=DEV).manual_seed(4321)
    worst = {"fp32": 0.0, "bf16": 0.0}
    for name, (G, E, C, D, F), counts_kind in GMM_CASES:
        x32 = torch.randn(G, E, C, D, generator=gen, device=DEV)
        w32 = torch.randn(E, D, F, generator=gen, device=DEV).mul_(D ** -0.5)
        if counts_kind == "pattern":
            counts = gmm_pattern_counts(torch, G, E, C)
        elif counts_kind is None:
            counts = None
        else:
            counts = torch.tensor([counts_kind] * G, dtype=torch.int32,
                                  device=DEV)
        for dt_name, dt in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            x, w = x32.to(dt), w32.to(dt)
            if G == 1:             # the ungrouped [E,C,D] form of the op
                x = x[0]
            c = counts if counts is None or G > 1 else counts[0]
            got = gmm.moe_gmm(x, w, c)
            want = gmm.moe_gmm_ref(x, w, c)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dt,
                  f"moe_gmm {name} {dt_name}: {tuple(got.shape)} "
                  f"{got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"moe_gmm {name} {dt_name}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            rec = {"case": name, "dtype": dt_name, "shape": [G, E, C, D, F],
                   "row_counts": counts_kind, "max_abs_err": err,
                   "max_abs_want": scale,
                   "rows_computed": moe_gmm_rows_computed(
                       [C] * (G * E) if counts is None
                       else counts.flatten().tolist(), C)}
            if counts is not None:
                g4 = got.reshape(G, E, C, F)
                pad = (torch.arange(C, device=DEV)[None, None, :]
                       >= counts[..., None])
                rec["padding_rows_exactly_zero"] = not bool(g4[pad].any())
                check(rec["padding_rows_exactly_zero"],
                      f"moe_gmm {name} {dt_name}: rows past a count are "
                      "not 0")
            if dt_name == "fp32":
                rec["tol"] = KERNEL_TOL
                worst["fp32"] = max(worst["fp32"], err)
                check(err <= KERNEL_TOL, f"moe_gmm {name} fp32: max abs "
                                         f"err {err} > {KERNEL_TOL}")
            else:
                rel = err / max(scale, 1e-30)
                rec.update(tol_relative=GMM_BF16_TOL, relative_err=rel)
                worst["bf16"] = max(worst["bf16"], rel)
                check(rel <= GMM_BF16_TOL, f"moe_gmm {name} bf16: error "
                                           f"{rel} x max|want|")
            emit("kernel_check", kernel="moe_gmm", **rec)
            del x, w, got, want
        del x32, w32
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# Phase 3, flash_attention: prefill attention against its plain version
# ---------------------------------------------------------------------------

def flash_need(B, H, Hkv, Sq, Skv, dh, causal=True, window=None, q_offset=0,
               **_kw):
    """Bytes and flops this call needs: q, k, v read once and the output
    written once (fp32); 4*dh flops per (head, live score), the live
    scores being the unmasked (row, key) pairs, query i at key position
    q_offset + i."""
    rows = list(range(q_offset, q_offset + Sq))
    live = 0
    for i in rows:
        lo, hi = 0, Skv
        if causal:
            hi = min(i + 1, Skv)
        if window is not None:
            lo = max(lo, i - window + 1)
        live += max(0, hi - lo)
    nbytes = 4 * (2 * B * H * Sq * dh + 2 * B * Hkv * Skv * dh)
    return nbytes, 4 * B * H * live * dh, live


def flash_sdpa_ms(torch, q, k, v, flush, causal=True, window=None,
                  **_kw) -> float:
    """Yardstick only (the port never calls it): PyTorch's
    ``scaled_dot_product_attention`` on the same fp32 inputs, kv heads
    repeated to H outside the timed call: ``is_causal`` for a causal
    call, no mask for a non-causal one, and a window's band as a boolean
    mask built outside the timed call."""
    import torch.nn.functional as F
    g = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(g, dim=1).contiguous()
    vr = v.repeat_interleave(g, dim=1).contiguous()
    if window is not None:
        rows = torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        band = cols > rows - window
        if causal:
            band &= cols <= rows
        return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=band), flush=flush)
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=causal), flush=flush)


def phase_flash_kernels(torch, fa):
    """Every ``FLASH_CASES`` case in fp32 and bf16.  Returns the worst
    fp32 max abs error, the worst bf16 error relative to max|want| and
    the timed main-shape records."""
    gen = torch.Generator(device=DEV).manual_seed(2468)
    worst = {"fp32": 0.0, "bf16": 0.0}
    timed = {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    for name, shape, opts in FLASH_CASES:
        B, H, Hkv, Sq, Skv, dh = (shape[k] for k in
                                  ("B", "H", "Hkv", "Sq", "Skv", "dh"))
        q32 = torch.randn(B, H, Sq, dh, generator=gen, device=DEV)
        k32 = torch.randn(B, Hkv, Skv, dh, generator=gen, device=DEV)
        v32 = torch.randn(B, Hkv, Skv, dh, generator=gen, device=DEV)
        for dt_name, dt in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got = fa.flash_attention(q, k, v, **opts)
            want = fa.flash_attention_ref(q, k, v, **opts)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dt,
                  f"flash {name} {dt_name}: {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"flash {name} {dt_name}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            rec = {"case": name, "dtype": dt_name, "shape": shape,
                   "options": opts, "max_abs_err": err,
                   "max_abs_want": scale}
            if dt_name == "fp32":
                rec["tol"] = KERNEL_TOL
                worst["fp32"] = max(worst["fp32"], err)
                check(err <= KERNEL_TOL, f"flash {name} fp32: max abs err "
                                         f"{err} > {KERNEL_TOL}")
                if name.startswith(FLASH_TIMED):
                    nbytes, flops, live = flash_need(**shape, **opts)
                    rec.update(
                        ms=cuda_ms(torch, lambda: fa.flash_attention(
                            q, k, v, **opts), flush=flush),
                        plain_ms=cuda_ms(torch, lambda: fa.flash_attention_ref(
                            q, k, v, **opts), flush=flush),
                        library_ms=flash_sdpa_ms(torch, q, k, v, flush,
                                                 **opts),
                        bytes=nbytes, flops=flops, live_scores=live,
                        **bounds(nbytes, flops, 3))   # fp32: 3xTF32
                    roofline(rec, f"flash {name}")
                    timed[name] = rec
            else:
                # per query row, against that row's own max|want|: late
                # causal rows are smaller than the first ones
                d = (got.float() - want.float()).abs().amax(-1)
                rel = float((d / want.float().abs().amax(-1)
                             .clamp_min(1e-30)).max())
                rec.update(tol_relative=FLASH_BF16_TOL, relative_err=rel)
                worst["bf16"] = max(worst["bf16"], rel)
                check(rel <= FLASH_BF16_TOL, f"flash {name} bf16: error "
                                             f"{rel} x max|want|")
            emit("kernel_check", kernel="flash_attention", **rec)
        del q32, k32, v32, q, k, v, got, want
    torch.cuda.empty_cache()
    return worst, timed


# ---------------------------------------------------------------------------
# Phase 3, mamba2_scan: the Mamba2 prefill scan against its plain version
# ---------------------------------------------------------------------------

def mamba_inputs(torch, gen, B, H, S, P, N, layout, h0, decay="default"):
    """tests/test_kernels.py's distributions (dt = |N(0,1)| 0.4 + 0.01,
    b and c N(0, 0.25), a < -0.05; the model layout's a from a_log =
    log U(1, 16)); ``decay="strong"``: a = -16 (a_log = log 16) and dt
    uniform in [0.01, 1.5).  Returns the kernel call and the same inputs
    in the plain version's layout (b/c broadcast to every head there)."""
    dev = DEV
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa: E731
    if layout == "kernel":
        x, b, c = rn(B, S, P), rn(B, S, N) * 0.5, rn(B, S, N) * 0.5
        if decay == "strong":
            dt = 0.01 + 1.49 * torch.rand(B, S, generator=gen, device=dev)
            a = torch.full((B,), -16.0, device=dev)
        else:
            dt = rn(B, S).abs() * 0.4 + 0.01
            a = -rn(B).abs() - 0.05
        hh = rn(B, N, P) if h0 else None
        return (x, dt, b, c, a, hh), (x, dt, b, c, a, hh)
    x, bc = rn(B, S, H, P), rn(B, S, 2 * N) * 0.5
    if decay == "strong":
        dt = 0.01 + 1.49 * torch.rand(B, S, H, generator=gen, device=dev)
        a_log = torch.full((H,), math.log(16.0), device=dev)
    else:
        dt = rn(B, S, H).abs() * 0.4 + 0.01
        a_log = torch.log(1.0 + 15.0 * torch.rand(H, generator=gen,
                                                  device=dev))
    hh = rn(B, H, N, P) if h0 else None
    bb = bc[..., :N][:, None].expand(B, H, S, N).reshape(B * H, S, N)
    cc = bc[..., N:][:, None].expand(B, H, S, N).reshape(B * H, S, N)
    plain = (x.transpose(1, 2).reshape(B * H, S, P),
             dt.transpose(1, 2).reshape(B * H, S), bb, cc,
             (-torch.exp(a_log))[None].expand(B, H).reshape(B * H),
             None if hh is None else hh.reshape(B * H, N, P))
    return (x, dt, bc[..., :N], bc[..., N:], a_log, hh), plain


def mamba_need(B, H, S, P, N, layout, h0, chunk):
    """Bytes and flops of one call.  Bytes: x and dt read, y and the final
    state written, b/c read once ([B,S,N] each in the model layout,
    [BH,S,N] in the kernel's), h0 read when given, fp32.  Flops of the
    chunked form the kernel runs (chunks of ``chunk`` rows, the last
    ragged; q(q + 1) / 2 causal pairs in a chunk of q rows): C B^T on
    the causal pairs, once per b/c stream (per batch row in the model
    layout), and per head the masked scores times X (causal pairs x P),
    (exp(cum) C) h_prev and the decayed B^T X (2 q N P each), 2 flops a
    multiply-add.  And the recurrence's 4 * BH * S * N * P (a
    multiply-add per state element and step for the update, one for y),
    for the CUDA-core bound."""
    bh = B * H
    bc_streams = B if layout == "model" else bh
    nbytes = 4 * (2 * bh * S * P + bh * S + 2 * bc_streams * S * N
                  + bh * N * P * (2 if h0 else 1))
    pairs = rows = 0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        pairs += q * (q + 1) // 2
        rows += q
    chunk_flops = 2 * pairs * N * bc_streams \
        + bh * (2 * pairs * P + 4 * rows * N * P)
    return nbytes, chunk_flops, 4 * bh * S * N * P


def phase_mamba_kernels(torch, mops):
    """Every ``MAMBA_CASES`` case: the kernel against its plain version
    on y and the final state, each within ``KERNEL_TOL`` x its max|want|.
    Returns the worst relative error and the timed records by case."""
    from repro_torch.kernels.mamba2_scan.ref import CHUNK_ROWS
    gen = torch.Generator(device=DEV).manual_seed(1357)
    worst = 0.0
    timed = {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    for name, shape, layout, h0, decay in MAMBA_CASES:
        call, plain = mamba_inputs(torch, gen, **shape, layout=layout, h0=h0,
                                   decay=decay)
        op = mops.scan_model_layout if layout == "model" else mops.mamba2_scan
        before = mops.launches
        y, hf = op(*call)
        yw, hw = mops.mamba2_scan_ref(*plain)
        torch.cuda.synchronize()
        check(mops.launches == before + 1, f"mamba2 {name}: no launch")
        B, H, S, P, N = (shape[k] for k in ("B", "H", "S", "P", "N"))
        if layout == "model":
            y = y.transpose(1, 2).reshape(B * H, S, P)
            hf = hf.reshape(B * H, N, P)
        check(bool(torch.isfinite(y).all() and torch.isfinite(hf).all()),
              f"mamba2 {name}: non-finite output")
        rec = {"case": name, "shape": shape, "layout": layout, "h0": h0,
               "decay": decay, "tol_relative": KERNEL_TOL}
        for key, got, want in (("y", y, yw), ("state", hf, hw)):
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            rel = err / max(scale, 1e-30)
            rec.update({f"{key}_max_abs_err": err,
                        f"{key}_max_abs_want": scale,
                        f"{key}_relative_err": rel})
            worst = max(worst, rel)
            check(rel <= KERNEL_TOL, f"mamba2 {name} {key}: error {rel} x "
                                     "max|want|")
        if name in MAMBA_TIMED:
            nbytes, flops, rec_flops = mamba_need(**shape, layout=layout,
                                                  h0=h0, chunk=CHUNK_ROWS)
            rec.update(bytes=nbytes, flops=flops, recurrence_flops=rec_flops,
                       **bounds(nbytes, flops, 3))     # 3xTF32
            rec["bound_fp32_cores_ms"] = max(
                nbytes / HBM_BYTES_PER_S, rec_flops / FP32_FLOPS) * 1e3
            rec["ms"] = cuda_ms(torch, lambda: op(*call), flush=flush)
            rec["device_ms"], rec["calls_traced"] = device_ms(
                torch, lambda: op(*call), flush)
            rec["plain_ms"] = cuda_ms(
                torch, lambda: mops.mamba2_scan_ref(*plain), flush=flush,
                iters=SCAN_FWD_PLAIN_ITERS)
            rec["library_ms"] = None
            roofline(rec, f"mamba2 {name}")
            timed[name] = rec
        emit("kernel_check", kernel="mamba2_scan", **rec)
        del call, plain, y, hf, yw, hw
    torch.cuda.empty_cache()
    return worst, timed


# ---------------------------------------------------------------------------
# Phase 3, rwkv6_wkv: the rwkv6 prefill recurrence against its plain version
# ---------------------------------------------------------------------------

def rwkv_inputs(torch, gen, B, H, S, K, layout, h0, decay="default"):
    """tests/test_kernels.py's distributions (r, k N(0, 0.25), v N(0, 1),
    lw = clip(-2|N(0, 1)|, -5, 0), u N(0, 0.09)); ``decay`` "strong": lw
    = -5; "weak": lw uniform in [-6.8e-4, -3.4e-4]; "mixed": the first
    half of the channels strong, the second weak.  Returns the kernel
    call and the same inputs in the plain version's layout."""
    dev = DEV
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa: E731

    def log_decay(*shape):
        lw = torch.clamp(-rn(*shape).abs() * 2, -5.0, 0.0)
        weak = -3.4e-4 * (1.0 + torch.rand(*shape, generator=gen,
                                           device=dev))
        if decay == "strong":
            return torch.full_like(lw, -5.0)
        if decay == "weak":
            return weak
        if decay == "mixed":
            return torch.cat([torch.full_like(lw[..., :K // 2], -5.0),
                              weak[..., K // 2:]], dim=-1)
        return lw

    if layout == "kernel":
        r, k, v = rn(B, S, K) * 0.5, rn(B, S, K) * 0.5, rn(B, S, K)
        lw = log_decay(B, S, K)
        u = rn(B, K) * 0.3
        hh = rn(B, K, K) if h0 else None
        return (r, k, v, lw, u, hh), (r, k, v, lw, u, hh)
    rkv = rn(B, S, 3, H, K)
    rkv[:, :, :2] *= 0.5
    r, k, v = rkv[:, :, 0], rkv[:, :, 1], rkv[:, :, 2]
    lw = log_decay(B, S, H, K)
    u = rn(H, K) * 0.3
    hh = rn(B, H, K, K) if h0 else None

    def flat(z):
        return z.transpose(1, 2).reshape(B * H, S, K)
    plain = (flat(r), flat(k), flat(v), flat(lw),
             u[None].expand(B, H, K).reshape(B * H, K),
             None if hh is None else hh.reshape(B * H, K, K))
    return (r, k, v, lw, u, hh), plain


def rwkv_need(B, H, S, K, layout, h0, chunk, sub):
    """Bytes and flops of one call.  Bytes: r, k, v, lw and u read, y and
    the final state written, h0 read when given, fp32.  Flops of the
    tensor-core products of the chunked form the kernel runs (chunks of
    ``chunk`` rows, the last ragged, in sub-blocks of ``sub`` rows; 2
    flops a multiply-add): A left of the diagonal (each sub-block's rows
    against the keys before it) and in each diagonal sub-block's
    lower-left quadrant (its second half of rows against its first half
    of keys), the causal part of A V (q(q + 1) / 2 pairs in a chunk of q
    rows), r h_prev and the update (q K^2 each).  And the recurrence's 4 *
    BH * S * K^2 (a multiply-add per state element and step for the
    update and one for y; the bonus folds into y's), for the CUDA-core
    bound."""
    bh = B * H
    u_rows = H if layout == "model" else bh
    nbytes = 4 * (5 * bh * S * K + u_rows * K
                  + bh * K * K * (2 if h0 else 1))
    macs = 0
    half = sub // 2
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        for b0 in range(0, q, sub):
            rows = min(sub, q - b0)
            macs += rows * b0 * K                          # left of it
            macs += max(0, rows - half) * min(half, rows) * K  # quadrant
        macs += q * (q + 1) // 2 * K + 2 * q * K * K
    return nbytes, 2 * bh * macs, 4 * bh * S * K * K


def phase_rwkv6_kernels(torch, wops):
    """Every ``RWKV_CASES`` case: the kernel against its plain version on
    y and the final state, each within ``KERNEL_TOL`` x its max|want|;
    then pad steps (k = 0, lw = 0, as the model masks bucket padding)
    at the full shape: the final state bitwise the state before them.
    Returns the worst relative error and the timed records by case."""
    from repro_torch.kernels.rwkv6_wkv.ref import CHUNK_ROWS, SUB_ROWS
    gen = torch.Generator(device=DEV).manual_seed(2468)
    worst = 0.0
    timed = {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    for name, shape, layout, h0, decay in RWKV_CASES:
        call, plain = rwkv_inputs(torch, gen, **shape, layout=layout, h0=h0,
                                  decay=decay)
        op = wops.wkv_model_layout if layout == "model" else wops.rwkv6_wkv
        before = wops.launches
        y, hf = op(*call)
        yw, hw = wops.rwkv6_wkv_ref(*plain)
        torch.cuda.synchronize()
        check(wops.launches == before + 1, f"rwkv6 {name}: no launch")
        B, H, S, K = (shape[k] for k in ("B", "H", "S", "K"))
        if layout == "model":
            y = y.transpose(1, 2).reshape(B * H, S, K)
            hf = hf.reshape(B * H, K, K)
        check(bool(torch.isfinite(y).all() and torch.isfinite(hf).all()),
              f"rwkv6 {name}: non-finite output")
        rec = {"case": name, "shape": shape, "layout": layout, "h0": h0,
               "decay": decay, "tol_relative": KERNEL_TOL}
        for key, got, want in (("y", y, yw), ("state", hf, hw)):
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            rel = err / max(scale, 1e-30)
            rec.update({f"{key}_max_abs_err": err,
                        f"{key}_max_abs_want": scale,
                        f"{key}_relative_err": rel})
            worst = max(worst, rel)
            check(rel <= KERNEL_TOL, f"rwkv6 {name} {key}: error {rel} x "
                                     "max|want|")
        if name in RWKV_TIMED:
            nbytes, flops, rec_flops = rwkv_need(
                **shape, layout=layout, h0=h0, chunk=CHUNK_ROWS,
                sub=SUB_ROWS)
            rec.update(bytes=nbytes, flops=flops, recurrence_flops=rec_flops,
                       **bounds(nbytes, flops, 3))     # 3xTF32
            rec["bound_fp32_cores_ms"] = max(
                nbytes / HBM_BYTES_PER_S, rec_flops / FP32_FLOPS) * 1e3
            rec["ms"] = cuda_ms(torch, lambda: op(*call), flush=flush)
            rec["device_ms"], rec["calls_traced"] = device_ms(
                torch, lambda: op(*call), flush)
            rec["plain_ms"] = cuda_ms(
                torch, lambda: wops.rwkv6_wkv_ref(*plain), flush=flush,
                iters=SCAN_FWD_PLAIN_ITERS)
            rec["library_ms"] = None
            roofline(rec, f"rwkv6 {name}")
            timed[name] = rec
        emit("kernel_check", kernel="rwkv6_wkv", **rec)
        del call, plain, y, hf, yw, hw
    # pad steps: the last 300 of 1024 steps masked as the model masks them
    call, _plain = rwkv_inputs(torch, gen, B=1, H=64, S=1024, K=64,
                               layout="model", h0=False)
    r, k, v, lw, u, _ = call
    k, lw = k.clone(), lw.clone()
    k[:, 724:] = 0.0
    lw[:, 724:] = 0.0
    _y, h_all = wops.wkv_model_layout(r, k, v, lw, u)
    _y, h_cut = wops.wkv_model_layout(r[:, :724], k[:, :724], v[:, :724],
                                      lw[:, :724], u)
    torch.cuda.synchronize()
    same = bool(torch.equal(h_all, h_cut))
    emit("kernel_check", kernel="rwkv6_wkv", case="pad_steps_keep_state",
         real_steps=724, pad_steps=300, state_bitwise_equal=same)
    check(same, "rwkv6: pad steps moved the state")
    torch.cuda.empty_cache()
    return worst, timed


# ---------------------------------------------------------------------------
# Phase 3, fused_matmul: the §5 operator against its plain version
# ---------------------------------------------------------------------------

def fmm_inputs(torch, gen, M, K, N, xd, wd, scaled):
    """fig09's distributions: int8 x in [-127, 127), float x and w
    N(0, 1) in their dtype, row scales |N(0, 1)|."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
    if xd == "int8":
        x = torch.randint(-127, 127, (M, K), generator=gen, device=DEV,
                          dtype=torch.int8)
    else:
        x = torch.randn(M, K, generator=gen, device=DEV).to(dt[xd])
    w = torch.randn(K, N, generator=gen, device=DEV).to(dt[wd])
    sc = (torch.randn(M, 1, generator=gen, device=DEV).abs() if scaled
          else None)
    return x, w, sc


def phase_fused_matmul_kernels(torch, fops, fig11):
    """Every ``FMM_CASES`` case: the kernel against ``matmul1`` on the
    same tensors, fp32 out within ``KERNEL_TOL`` x max|want|, bf16 out
    within ``FMM_BF16_TOL``; fig11's int8 scaled case at ``FMM_TIMED``
    timed beside the plain version, bare cuBLAS on the prepared x (the
    library yardstick, never called by the port) and the bound: fig11's
    ``fused_bytes`` (int8 x, the scales, fp32 w and out, each once) and
    2n^3 flops at the kernel's 2 TF32 products per fp32 product (x is
    exact in TF32), each call's device time from the profiler beside its
    ``cuda_ms``.  Returns
    the worst relative errors and the timed records by n."""
    from repro_torch.kernels.tf32 import products
    gen = torch.Generator(device=DEV).manual_seed(97531)
    worst = {"fp32": 0.0, "bf16": 0.0}
    timed = {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    out_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for name, (M, K, N), xd, wd, od, scaled in FMM_CASES:
        x, w, sc = fmm_inputs(torch, gen, M, K, N, xd, wd, scaled)
        before = fops.launches
        got = fops.fused_matmul(x, w, sc, out_dtype=out_dt[od])
        want = fops.matmul1(x, w, sc, out_dtype=out_dt[od])
        torch.cuda.synchronize()
        check(fops.launches == before + 1, f"fused_matmul {name}: no launch")
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"fused_matmul {name}: {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()),
              f"fused_matmul {name}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        rel = err / max(scale, 1e-30)
        key = "bf16" if od == "bfloat16" else "fp32"
        tol = FMM_BF16_TOL if key == "bf16" else KERNEL_TOL
        worst[key] = max(worst[key], rel)
        rec = {"case": name, "mkn": [M, K, N], "x": xd, "w": wd, "out": od,
               "scaled": scaled, "max_abs_err": err, "max_abs_want": scale,
               "relative_err": rel, "tol_relative": tol}
        check(rel <= tol, f"fused_matmul {name}: error {rel} x max|want|")
        if M == K == N and M in FMM_TIMED and xd == "int8" and scaled \
                and od == "float32":
            xf = fops.prep(x, sc)
            calls = {
                "": lambda: fops.fused_matmul(x, w, sc,
                                              out_dtype=torch.float32),
                "plain_": lambda: fops.matmul1(x, w, sc,
                                               out_dtype=torch.float32),
                "library_": lambda: torch.matmul(xf, w)}
            for key, fn in calls.items():
                rec[key + "ms"] = cuda_ms(torch, fn, flush=flush)
                rec[key + "device_ms"], rec[key + "calls_traced"] = \
                    device_ms(torch, fn, flush=flush)
            nbytes, flops = fig11.fused_bytes(M), 2 * M * N * K
            rec.update(bytes=nbytes, flops=flops,
                       **bounds(nbytes, flops, products(x.dtype, w.dtype)))
            roofline(rec, f"fused_matmul n = {M}")
            timed[M] = rec
            del xf
        emit("kernel_check", kernel="fused_matmul", **rec)
        del x, w, sc, got, want
    torch.cuda.empty_cache()
    return worst, timed


def phase_fused_matmul_grads(torch, fops):
    """``matmul``'s gradients on the card (forward through the kernel)
    against autograd through ``matmul1``: dw and dscale for int8 x, dx
    too for fp32 x, each within ``KERNEL_TOL`` x max|want|."""
    gen = torch.Generator(device=DEV).manual_seed(8642)
    worst = 0.0
    for name, (M, K, N), xd in (("int8_fig11", (1024, 1024, 1024), "int8"),
                                ("fp32_x", (512, 256, 384), "float32")):
        x, w, sc = fmm_inputs(torch, gen, M, K, N, xd, "float32", True)
        g = torch.randn(M, N, generator=gen, device=DEV)
        grads = {}
        for side in ("kernel", "plain"):
            xs = x.clone().requires_grad_(xd != "int8")
            ws = w.clone().requires_grad_(True)
            ss = sc.clone().requires_grad_(True)
            before = fops.launches
            out = (fops.matmul(xs, ws, ss) if side == "kernel"
                   else fops.matmul1(xs, ws, ss))
            (out * g).sum().backward()
            torch.cuda.synchronize()
            check(fops.launches == before + (side == "kernel"),
                  f"fused_matmul grads {name} {side}: launches")
            grads[side] = {"dw": ws.grad, "dscale": ss.grad}
            if xd != "int8":
                grads[side]["dx"] = xs.grad
        rec = {"case": name, "mkn": [M, K, N], "x": xd,
               "tol_relative": KERNEL_TOL}
        for key, want in grads["plain"].items():
            got = grads["kernel"][key]
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            rec[f"{key}_relative_err"] = rel
            worst = max(worst, rel)
            check(rel <= KERNEL_TOL, f"fused_matmul grads {name} {key}: "
                                     f"error {rel} x max|want|")
        emit("kernel_grads", kernel="fused_matmul", **rec)
    return worst


def zero_launches(kernel_ops) -> None:
    """Zero each kernel module's launch count (and the paged one's counts
    by pool dtype)."""
    for mod in kernel_ops:
        mod.launches = 0
        if hasattr(mod, "bwd_launches"):
            mod.bwd_launches = 0
        for k in getattr(mod, "launches_by_dtype", {}):
            mod.launches_by_dtype[k] = 0


def other_launches(kernel_ops, fops) -> int:
    return sum(mod.launches for mod in kernel_ops if mod is not fops)


def phase_figs(torch, fops, kernel_ops, fig09, fig11):
    """The slice's main path: fig09 and fig11's ``main`` on the card at
    their default sizes (their CSV rows print as they go).  fig09 runs
    no hand-written kernel; every fused call of fig11 launches
    ``fused_matmul`` once, and no other kernel runs.  Every kernel's
    count is zeroed just before each and read just after."""
    t0 = time.time()
    zero_launches(kernel_ops)
    res09 = fig09.main(["--device", "cuda"])
    launches09 = fops.launches
    check(launches09 == 0, f"fig09 launched fused_matmul {launches09} times")
    check(other_launches(kernel_ops, fops) == 0,
          "fig09 launched another kernel")
    check(all(r["op_us"] > 0 and r["bare_us"] > 0 for r in res09.values()),
          "fig09: a non-positive time")
    emit("fig09", sizes=sorted(res09), fused_matmul_launches=launches09,
         results=res09, seconds=time.time() - t0)
    t0 = time.time()
    zero_launches(kernel_ops)
    res11 = fig11.main(["--device", "cuda"])
    launches11 = fops.launches
    check(other_launches(kernel_ops, fops) == 0,
          "fig11 launched another kernel")
    check(res11["fused_calls"] > 0 and launches11 == res11["fused_calls"],
          f"fig11: {launches11} launches for {res11['fused_calls']} fused "
          "calls")
    check(res11["fused_us"] > 0 and res11["unfused_us"] > 0,
          "fig11: a non-positive time")
    emit("fig11", fused_matmul_launches=launches11,
         seconds=time.time() - t0, **res11)
    return launches09, launches11, res11


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


def phase_engine(torch, ops, gmm, rt, cfg, params, kv_dtype):
    """Serve the 12 requests from ``kv_dtype`` pools.  Every kernel's
    launch counts are zeroed just before and read just after the run; an
    MoE model must launch ``moe_gmm`` 3 times per MoE layer and
    micro-step, a dense one never."""
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
    gmm.launches = 0
    served = serve_fused(torch, eng, reqs)
    wall, sync_checked = served["wall_s"], served["sync_free_chunk"]
    launches = ops.launches_by_dtype[kv_dtype]
    all_launches = ops.launches
    gmm_launches = gmm.launches
    micro = eng.steps - steps0
    moe_layers = sum(b.ffn == "moe" for b in cfg.blocks)
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    stats = eng.memory_stats()
    pstats = eng.prefix_stats()
    emit("engine", arch=cfg.name, layers=cfg.num_layers, kv_dtype=kv_dtype,
         requests=len(reqs), micro_steps=micro,
         chunks=eng.chunks, wall_s=wall, generated_tokens=gen_tokens,
         prompt_tokens=prompt_tokens,
         prefill_tokens_computed=prompt_tokens
         - pstats["prefill_tokens_skipped"],
         generated_tokens_per_s=gen_tokens / wall,
         ms_per_micro_step=wall / micro * 1e3, kernel_launches=launches,
         kernel_launches_all_dtypes=all_launches,
         moe_gmm_launches=gmm_launches, host_syncs=eng.host_syncs,
         sync_free_chunk=sync_checked,
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
    check(gmm_launches == 3 * moe_layers * micro,
          f"{cfg.name}: moe_gmm launches {gmm_launches} != 3 x "
          f"{moe_layers} x {micro}")
    check(eng.leaked_pages() == 0, f"{kv_dtype}: leaked pages")
    check(pstats["prefix_hits"] > 0, f"{kv_dtype}: no prefix hits")
    check(pstats["cow_copies"] > 0, f"{kv_dtype}: no copy-on-write ran")
    tokens = {r.rid: list(r.out_tokens) for r in reqs}
    return eng, launches, gmm_launches, tokens


def greedy_agreement(ref: dict, got: dict) -> float:
    """Share of positions where two runs of the same requests emitted the
    same token."""
    same = total = 0
    for rid, toks in ref.items():
        total += len(toks)
        same += sum(a == b for a, b in zip(toks, got[rid]))
    return same / total


def teacher_forced_engine(rt, cfg, params, kv_dtype):
    """A fresh engine whose 8 slots each own a whole ring of pages, so
    ``forward_verify`` can be fed 32 tokens per slot with no scheduler."""
    from repro_torch.serve import cache as cache_mod
    eng = make_engine(rt, cfg, params, kv_dtype)
    key = eng.spec.groups[0].key
    nb = eng.spec.groups[0].ring_blocks
    for slot in range(8):
        cache_mod.install_slot_rows(
            eng.spec, eng.cache, slot, 0,
            {key: list(range(slot * nb, (slot + 1) * nb))})
    return eng


def teacher_forced_logit_diff(torch, rt, cfg, params, kv_dtype,
                              chunks: int = 4) -> float:
    """Max |logit| difference between ``kv_dtype`` pools and fp32 pools on
    the same random tokens, fed 32 per slot per step to all 8 slots of
    two fresh engines (teacher forcing: both see the same tokens)."""
    engs = [teacher_forced_engine(rt, cfg, params, d)
            for d in ("fp32", kv_dtype)]
    gen = torch.Generator(device=DEV).manual_seed(5)
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
    the paged-attention, moe_gmm, flash-attention, mamba2_scan and
    rwkv6_wkv kernels, library matrix products, everything else, and the
    device's idle share of the
    chunk's wall time (profiler on, so the wall time includes its
    overhead)."""
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
    fam = {"paged_attention": 0.0, "moe_gmm": 0.0, "flash_attention": 0.0,
           "mamba2_scan": 0.0, "rwkv6_wkv": 0.0, "matmul": 0.0,
           "other": 0.0}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        us = evt.time_range.elapsed_us()
        name = evt.name.lower()
        if "paged_attention" in name:
            fam["paged_attention"] += us / 1e3
        elif "moe_gmm" in name:
            fam["moe_gmm"] += us / 1e3
        elif "flash_attention" in name:
            fam["flash_attention"] += us / 1e3
        elif "mamba2_scan" in name:
            fam["mamba2_scan"] += us / 1e3
        elif "rwkv6_wkv" in name:
            fam["rwkv6_wkv"] += us / 1e3
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


# ---------------------------------------------------------------------------
# Phase 5a: the engine under rules= on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

def expert_ffn(torch, p, x):
    """One dbrx expert's FFN: silu(x wg) * (x wu), then wd."""
    return (torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def phase_schedules(torch, rt, mesh) -> dict:
    """``run_sync`` / ``run_async`` / ``hybrid_pools`` of
    ``core/scheduler`` over the mesh's one-rank ``"pool"`` axis at dbrx's
    expert-FFN width: ``run_async`` takes one branch (the pool size),
    ``hybrid_pools`` four in turn; each against ``run_sync`` of the same
    branches, timed once (CUDA events)."""
    from repro_torch.core import scheduler
    dbrx = rt["get_config"]("dbrx-132b")
    gen = torch.Generator(device=DEV).manual_seed(3)
    D, F = dbrx.d_model, dbrx.d_ff

    def w(*shape):
        return torch.randn(shape, generator=gen, device=DEV) / math.sqrt(
            shape[-2])

    stacked = {"wg": w(SCHED_BRANCHES, D, F), "wu": w(SCHED_BRANCHES, D, F),
               "wd": w(SCHED_BRANCHES, F, D)}
    x = torch.randn((SCHED_TOKENS, D), generator=gen, device=DEV)
    fn = lambda p, v: expert_ffn(torch, p, v)      # noqa: E731
    first = {k: v[:1] for k, v in stacked.items()}
    out = {}
    for name, call, ref_params in (
            ("run_async", lambda: scheduler.run_async(
                fn, first, x, mesh=mesh, pool_axis="pool"), first),
            ("hybrid_pools", lambda: scheduler.hybrid_pools(
                fn, stacked, x, mesh=mesh, pool_axis="pool"), stacked)):
        want = scheduler.run_sync(fn, ref_params, x)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        got = call()
        end.record()
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        out[name] = {"branches": ref_params["wg"].shape[0],
                     "rel_err": err, "ms": start.elapsed_time(end)}
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        check(err <= SCHED_TOL, f"{name} vs run_sync: {err} > {SCHED_TOL}")
    del stacked, first, x
    return out


def phase_sharded_serve(torch, ops, rt, cfg, params, fused_tokens) -> dict:
    """The 12 requests through ``Engine(rules=...)`` on a one-rank NCCL
    mesh (``("data", "pool")``, sizes 1 x 1): tokens equal to the fused
    fp32 phase's (``fused_tokens``), a sync-free chunk, paged launches
    == layers x micro-steps; then the branch schedules over ``"pool"``.
    The process group is destroyed before it returns."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh
    store = tempfile.mkdtemp()
    mesh_lib.join_process_group("nccl", rank=0, world_size=1,
                                init_method=f"file://{store}/store")
    try:
        mesh = mesh_lib.device_mesh((1, 1), ("data", "pool"))
        rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"},
                         mesh=mesh)
        eng = rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                           device=DEV, rules=rules)
        check(eng.paged_kernel, "sharded: paged_kernel='auto' did not pick "
              "the kernel")
        check(eng._dp_group is not None and eng.shards == 1,
              "sharded: the slots are not placed on the data axis")
        eng.warmup()
        reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7,
                             rid0=0)
        steps0 = eng.steps
        ops.launches = 0
        for k in ops.launches_by_dtype:
            ops.launches_by_dtype[k] = 0
        served = serve_fused(torch, eng, reqs)
        launches, micro = ops.launches, eng.steps - steps0
        tokens = {r.rid: list(r.out_tokens) for r in reqs}
        pstats = eng.prefix_stats()
        mem = eng.memory_stats()
        emit("sharded_serve", mesh=mesh_lib.describe(mesh),
             placements={"len": repr(eng.spec.shardings(rules)["len"])},
             fallbacks=rules.fallbacks, micro_steps=micro,
             chunks=eng.chunks, host_syncs=eng.host_syncs,
             wall_s=served["wall_s"],
             ms_per_micro_step=served["wall_s"] / micro * 1e3,
             kernel_launches=launches,
             sync_free_chunk=served["sync_free_chunk"],
             tokens_equal=same_tokens(fused_tokens, tokens),
             tokens_total=sum(len(v) for v in fused_tokens.values()),
             prefix_stats=pstats, rank_share=mem["rank"],
             leaked_pages=eng.leaked_pages())
        check(tokens == fused_tokens,
              "sharded: tokens differ from the fused fp32 phase's")
        check(served["sync_free_chunk"], "sharded: no chunk ran under sync "
              "debug mode")
        check(launches == cfg.num_layers * micro,
              f"sharded: paged launches {launches} != {cfg.num_layers} x "
              f"{micro}")
        check(eng.leaked_pages() == 0, "sharded: leaked pages")
        check(pstats["prefix_hits"] > 0, "sharded: no prefix hits")
        check(eng.host_syncs == eng.chunks, "sharded: more than one host "
              "sync a chunk")
        del eng
        torch.cuda.empty_cache()
        schedules = phase_schedules(torch, rt, mesh)
        emit("schedules", **schedules)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "micro_steps": micro,
            "schedules": schedules}


# ---------------------------------------------------------------------------
# Phases 5b-5c: the two-executable engine at full width
# ---------------------------------------------------------------------------

def make_legacy_engine(rt, cfg, params, kv_dtype, **kw):
    return rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                        kv_dtype=kv_dtype, chunked_prefill=False,
                        device=DEV, **kw)


def count_prefills(eng, name: str = "prefill") -> dict:
    """Count the engine's full prefills: calls of ``Executor.prefill``
    (suffix prefills and segments after the first are other calls), or
    of another executor method (``draft_prefill``)."""
    inner = getattr(eng.executor, name)
    box = {"n": 0}

    def counted(*args, **kw):
        box["n"] += 1
        return inner(*args, **kw)

    setattr(eng.executor, name, counted)
    return box


def phase_prefill_vs_fused(torch, rt, cfg, params):
    """On one prompt per bucket (8..1024): the last prompt token's logits
    of ``forward_prefill`` (bucket-padded, through the flash kernel)
    against the fused path's, teacher-forced through ``forward_verify``
    in right-aligned 32-row slices over paged pools (through the paged
    kernel).  Gate: max abs difference <= 1e-3."""
    import numpy as np
    from repro_torch.serve.cache import CacheSpec
    S = 32
    spec = CacheSpec.from_config(cfg, 1, 1024, page_size=16,
                                 spec_tokens=S - 1)
    group = spec.groups[0]
    rows = {group.key: list(range(group.ring_blocks))}
    rng = np.random.default_rng(13)
    col = torch.arange(S, device=DEV)[None, :]
    worst = 0.0
    for L in BUCKET_PROMPT_LENS:
        prompt = rng.integers(1, cfg.vocab_size, L)
        bucket = max(8, 1 << (L - 1).bit_length())
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :L] = prompt
        want, _ = rt["forward_prefill"](
            params, cfg, {"tokens": torch.tensor(padded, device=DEV)},
            length=torch.tensor([L], dtype=torch.int32, device=DEV))
        cache = spec.init_paged_cache(torch.device(DEV))
        rt["install_slot_rows"](spec, cache, 0, 0, rows)
        done = 0
        while done < L:
            n = min(S, L - done)
            toks = np.zeros((1, S), np.int32)
            toks[0, S - n:] = prompt[done:done + n]
            logits, cache = rt["forward_verify"](
                params, cfg, torch.tensor(toks, device=DEV), cache,
                write_mask=col >= S - n, paged_kernel=True,
                spec_slack=spec.spec_tokens,
                n_rows=torch.tensor([n], dtype=torch.int32, device=DEV))
            cache = dict(cache, len=cache["len"] + n)
            done += n
        got = logits[0, -1]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(want).all()),
              f"prefill logits at L={L} not finite")
        err = float((got - want[0]).abs().max())
        worst = max(worst, err)
        emit("prefill_vs_fused", prompt_len=L, bucket=bucket,
             logits_max_abs_diff=err, tol=PATH_TOL,
             same_argmax=bool(got.argmax() == want[0].argmax()))
        check(err <= PATH_TOL, f"prefill vs fused logits at L={L}: {err}")
    return worst


def phase_quantized_splice(torch, rt, cfg, params):
    """The int8 legacy admission at full width: ``forward_prefill`` (through
    the flash kernel) of one prompt per length in ``SPLICE_PROMPT_LENS``,
    then ``admit_cache`` into fresh int8 pools through a reversed page
    row.  Gate, every layer, K and V: each prompt page's codes and scales
    are bitwise those of ``quantize_pages`` on the prefill's fp32 KV
    (zero past the prompt), and the slot's other pages stay untouched.
    900 and 600 tokens pad to the 1024 bucket, whose 65 logical pages
    outnumber the 64-page ring."""
    import numpy as np
    spec = rt["CacheSpec"].from_config(cfg, 1, 1024, page_size=16,
                                       kv_dtype="int8")
    group = spec.groups[0]
    P, nb = spec.page_size, group.ring_blocks
    row = np.arange(nb - 1, -1, -1, dtype=np.int32)
    rng = np.random.default_rng(19)
    for L in SPLICE_PROMPT_LENS:
        bucket = max(8, 1 << (L - 1).bit_length())
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :L] = rng.integers(1, cfg.vocab_size, L)
        _, one = rt["forward_prefill"](
            params, cfg, {"tokens": torch.tensor(padded, device=DEV)},
            length=torch.tensor([L], dtype=torch.int32, device=DEV))
        cache = spec.init_paged_cache(torch.device(DEV))
        rt["admit_cache"](spec, cache, one, 0, 0, L, {group.key: row})
        npg = -(-L // P)
        live = torch.as_tensor(row[:npg].astype(np.int64), device=DEV)
        rest = torch.as_tensor(row[npg:].astype(np.int64), device=DEV)
        bad = []
        for i, (big, small) in enumerate(zip(cache["layers"],
                                             one["layers"])):
            for pk, sk, name in (("pk", "ks", "k"), ("pv", "vs", "v")):
                x = small[name][0].transpose(0, 1)[:L].float()
                x = torch.cat([x, x.new_zeros((npg * P - L,) + x.shape[1:])])
                q, sc = rt["quantize_pages"](
                    x.reshape((npg, P) + x.shape[1:]), torch.int8)
                ok = (torch.equal(big[pk][live], q)
                      and torch.equal(big[sk][live], sc)
                      and not bool(big[pk][rest].any())
                      and bool((big[sk][rest] == 1e-30).all()))
                if not ok:
                    bad.append(f"{name}{i}")
        emit("quantized_splice", kv_dtype="int8", prompt_len=L,
             bucket=bucket, logical_pages=(bucket - 1) // P + 2,
             ring_blocks=nb, prompt_pages=npg, layers_wrong=bad)
        check(not bad, f"int8 splice at L={L}: pages differ from "
                       f"quantize_pages in {bad[:6]}")
        del one, cache


def serve_legacy(torch, eng, reqs, sync_check: bool) -> dict:
    """Serve ``reqs`` round by round.  With ``sync_check`` the first
    admission round (prefills, CoW copies, splices, arming) and its
    decode chunk run under ``set_sync_debug_mode("error")``.  Returns
    the wall, admission and decode seconds (the sync-checked round
    apart) and the decode micro-steps timed."""
    for r in reqs:
        check(eng.submit(r) is None, f"rid {r.rid} rejected")
    t = {"wall_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
         "first_round_s": 0.0, "decode_micro_steps_timed": 0}
    t0 = time.time()
    first = sync_check
    while eng.queue or eng._live():
        ta = time.time()
        if first:
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._admit()
                check(eng._live(), "the first round admitted nothing")
                toks = eng.step_chunk()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eng._drain(toks)
            t["first_round_s"] = time.time() - ta
            first = False
            continue
        eng._admit()
        check(eng._live(), "admission wedged with no live slot")
        torch.cuda.synchronize()
        tb = time.time()
        eng._drain(eng.step_chunk())
        t["prefill_s"] += tb - ta
        t["decode_s"] += time.time() - tb
        t["decode_micro_steps_timed"] += eng.sync_interval
    torch.cuda.synchronize()
    t["wall_s"] = time.time() - t0
    return t


def phase_legacy(torch, ops, fa, rt, cfg, params, kv_dtype, fused_tokens):
    """Serve the 12 requests through the two-executable engine from
    ``kv_dtype`` pools (``fused_tokens``: the fused engine's tokens by
    pool dtype, for agreement).  Counts are zeroed just before the run
    and read just after.  Returns the engine (for the segment phase), the
    flash launches and the full prefills."""
    eng = make_legacy_engine(rt, cfg, params, kv_dtype)
    check(eng.paged_kernel and not eng.chunked_prefill,
          "the legacy engine does not read pools through the kernel")
    check(eng.buckets == [8 << i for i in range(8)],
          f"buckets {eng.buckets}")
    t0 = time.time()
    eng.warmup()
    torch.cuda.synchronize()
    emit("warmup", path="legacy", kv_dtype=kv_dtype,
         buckets=eng.buckets, seconds=time.time() - t0)
    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    steps0 = eng.steps
    prefills = count_prefills(eng)
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    for k in ops.launches_by_dtype:
        ops.launches_by_dtype[k] = 0
    fa.launches = 0
    times = serve_legacy(torch, eng, reqs, sync_check=True)
    paged = ops.launches_by_dtype[kv_dtype]
    paged_all = ops.launches
    flash = fa.launches
    n_prefill = prefills["n"]
    micro = eng.steps - steps0
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    pstats = eng.prefix_stats()
    tokens = {r.rid: list(r.out_tokens) for r in reqs}
    emit("legacy_engine", arch=cfg.name, kv_dtype=kv_dtype,
         requests=len(reqs), decode_micro_steps=micro, chunks=eng.chunks,
         full_prefills=n_prefill, flash_attention_launches=flash,
         paged_attention_launches=paged,
         paged_attention_launches_all_dtypes=paged_all,
         generated_tokens=gen_tokens,
         generated_tokens_per_s=gen_tokens / times["wall_s"],
         ms_per_decode_micro_step=(times["decode_s"]
                                   / max(times["decode_micro_steps_timed"],
                                         1) * 1e3),
         sync_free_admission_and_chunk=True, host_syncs=eng.host_syncs,
         greedy_agreement_with_fused_fp32=greedy_agreement(
             fused_tokens["fp32"], tokens),
         greedy_agreement_with_fused_same_dtype=greedy_agreement(
             fused_tokens[kv_dtype], tokens),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         prefix_stats=pstats, leaked_pages=eng.leaked_pages(), **times)
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"legacy {kv_dtype} rid {r.rid}: {len(r.out_tokens)} tokens, "
              f"done={r.done}")
    check(n_prefill > 0 and flash == cfg.num_layers * n_prefill,
          f"legacy {kv_dtype}: flash launches {flash} != "
          f"{cfg.num_layers} x {n_prefill} full prefills")
    check(paged == cfg.num_layers * micro and paged_all == paged,
          f"legacy {kv_dtype}: paged launches {paged} (all dtypes "
          f"{paged_all}) != {cfg.num_layers} x {micro}")
    check(eng.leaked_pages() == 0, f"legacy {kv_dtype}: leaked pages")
    check(pstats["prefix_hits"] > 0, f"legacy {kv_dtype}: no prefix hits")
    check(pstats["cow_copies"] > 0,
          f"legacy {kv_dtype}: no copy-on-write ran")
    # a second wave, one of its decode chunks profiled
    for r in make_requests(rt["Request"], cfg.vocab_size, 8, seed=11,
                           rid0=100):
        eng.submit(r)
    eng.step()
    eng.step()
    try:
        prof = profile_chunk(torch, eng)
    except (RuntimeError, AttributeError) as e:   # an optional reading
        prof = {"measured": False, "reason": repr(e)}
    emit("profile", path="legacy", kv_dtype=kv_dtype, **prof)
    eng.run(max_steps=10 ** 6)
    check(eng.leaked_pages() == 0,
          f"legacy {kv_dtype}: leaked pages after the second wave")
    return eng, flash, n_prefill


def phase_segments(torch, rt, cfg, params, single):
    """Two 700-token prompts on a legacy engine whose buckets stop at
    256: each prefill runs as a 256-token full prefill, a 256-token
    segment and a 188-token suffix.  Gate: both complete with 0 leaked
    pages.  Agreement with the same prompts served by ``single`` (one
    1024-bucket prefill each) is printed."""
    import numpy as np
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, cfg.vocab_size, 700).tolist()
               for _ in range(2)]

    def run(eng, rid0):
        reqs = [rt["Request"](rid=rid0 + i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
        for r in reqs:
            check(eng.submit(r) is None, f"rid {r.rid} rejected")
        eng.run(max_steps=10 ** 6)
        return {r.rid - rid0: list(r.out_tokens) for r in reqs}, reqs

    want, _ = run(single, 200)
    eng = make_legacy_engine(rt, cfg, params, "fp32",
                             buckets=[8 << i for i in range(6)])
    prefills = count_prefills(eng)
    t0 = time.time()
    got, reqs = run(eng, 300)
    torch.cuda.synchronize()
    emit("segments", prompt_lens=[700, 700], buckets=eng.buckets,
         full_prefills=prefills["n"], wall_s=time.time() - t0,
         greedy_agreement_with_single_prefill=greedy_agreement(want, got),
         leaked_pages=eng.leaked_pages())
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"segments rid {r.rid}: {len(r.out_tokens)} tokens")
    check(eng.buckets[-1] == 256, f"segments grew buckets {eng.buckets}")
    check(eng.leaked_pages() == 0, "segments: leaked pages")


# ---------------------------------------------------------------------------
# Phase 5f: speculative decoding at full width (internlm2-1.8b)
# ---------------------------------------------------------------------------

def teacher_forced_check(torch, rt, cfg, params, reqs, what: str) -> dict:
    """Each emitted token against ``prefill_hidden`` over its request's
    prompt and emitted tokens (bucket-padded, through the flash kernel;
    a patch-frontend arch with the engines' zero stub embeddings):
    it must be the argmax of the logits before it, or lie within
    ``TF_TOL`` x max|logit| of their top (a near-tie that another
    summation order may flip).  Returns the counts; fails on any other
    token."""
    import numpy as np
    exact = total = 0
    worst = 0.0
    bad = []
    for r in reqs:
        seq = list(r.prompt) + list(r.out_tokens)
        plen, n = len(r.prompt), len(r.out_tokens)
        bucket = max(8, 1 << (len(seq) - 1).bit_length())
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(seq)] = seq
        batch = {"tokens": torch.tensor(padded, device=DEV)}
        if cfg.frontend:      # the engines' stub: zero patch embeddings
            batch["frontend"] = torch.zeros(
                (1, cfg.frontend_len, cfg.d_model), device=DEV)
        h, _ = rt["prefill_hidden"](
            params, cfg, batch,
            length=torch.tensor([len(seq)], dtype=torch.int32, device=DEV))
        rows = h[0, plen - 1:plen - 1 + n]     # the rows before each token
        logits = rt["logits"](params["embed"], cfg, rows)
        toks = torch.tensor(r.out_tokens, dtype=torch.long, device=DEV)
        top = logits.max(dim=-1).values
        gap = ((top - logits.gather(1, toks[:, None])[:, 0])
               / logits.abs().max(dim=-1).values)
        is_exact = logits.argmax(dim=-1) == toks
        gap = torch.where(is_exact, torch.zeros_like(gap), gap)
        check(bool(torch.isfinite(logits).all()),
              f"{what}: non-finite teacher-forced logits")
        exact += int(is_exact.sum())
        total += n
        g = float(gap.max())
        worst = max(worst, g)
        if g > TF_TOL:
            bad.append(r.rid)
    rec = {"what": what, "tokens": total, "exact": exact,
           "near_ties": total - exact, "worst_relative_gap": worst,
           "tol": TF_TOL}
    emit("teacher_forced", **rec)
    check(not bad, f"{what}: tokens of rids {bad} are not the "
                   "teacher-forced argmax (nor a near-tie)")
    return rec


def serve_fused(torch, eng, reqs) -> dict:
    """Serve ``reqs`` through a fused engine; one chunk after the first
    two runs under ``set_sync_debug_mode("error")``.  Returns the wall
    seconds and whether the sync check ran."""
    for r in reqs:
        check(eng.submit(r) is None, f"rid {r.rid} rejected")
    sync_checked = False
    t0 = time.time()
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
    return {"wall_s": time.time() - t0, "sync_free_chunk": sync_checked}


def same_tokens(ref: dict, got: dict) -> int:
    """Positions where two runs of the same requests emitted one token."""
    return sum(a == b for rid, toks in ref.items()
               for a, b in zip(toks, got[rid]))


def phase_spec_fused_ngram(torch, ops, rt, cfg, params, fused_tokens):
    """The 12 requests through the fused engine with the n-gram drafter
    (k = 4, ``prefill_budget`` 32: 32 rows per micro-step, the last 5 a
    decoding slot's verify rows).  Gates: 32 tokens each, a sync-free
    chunk, 0 leaked pages, paged launches == 24 x micro-steps, drafts
    made, every emitted token teacher-forced.  Returns the paged
    launches."""
    eng = rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                       prefill_budget=32,
                       spec=rt["SpecConfig"](draft="ngram", k=4), device=DEV)
    check(eng.chunked_prefill and eng.paged_kernel
          and eng.executor.chunk_rows == 32,
          "spec fused: not the fused kernel path at 32 rows")
    eng.warmup()
    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    steps0 = eng.steps
    zero_launches([ops])
    torch.cuda.reset_peak_memory_stats()
    t = serve_fused(torch, eng, reqs)
    paged = ops.launches_by_dtype["fp32"]
    micro = eng.steps - steps0
    st = eng.spec_stats()
    tokens = {r.rid: list(r.out_tokens) for r in reqs}
    gen_tokens = sum(len(v) for v in tokens.values())
    emit("spec_fused_ngram", arch=cfg.name, requests=len(reqs),
         micro_steps=micro, chunks=eng.chunks, spec_stats=st,
         tokens_equal_to_plain_fused=same_tokens(fused_tokens["fp32"],
                                                 tokens),
         generated_tokens=gen_tokens,
         generated_tokens_per_s=gen_tokens / t["wall_s"],
         ms_per_micro_step=t["wall_s"] / micro * 1e3,
         paged_attention_launches=paged,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         prefix_stats=eng.prefix_stats(), leaked_pages=eng.leaked_pages(),
         **t)
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"spec fused rid {r.rid}: {len(r.out_tokens)} tokens")
    check(t["sync_free_chunk"], "spec fused: no chunk ran under sync "
                                "debug mode")
    check(paged == cfg.num_layers * micro and ops.launches == paged,
          f"spec fused: paged launches {paged} != {cfg.num_layers} x "
          f"{micro}")
    check(eng.leaked_pages() == 0, "spec fused: leaked pages")
    check(st["drafted_tokens"] > 0, "spec fused: nothing drafted")
    teacher_forced_check(torch, rt, cfg, params, reqs, "spec_fused_ngram")
    del eng
    torch.cuda.empty_cache()
    return paged


def spec_legacy_run(torch, ops, fa, rt, cfg, params, spec, what: str,
                    temps=None) -> dict:
    """The 12 requests through ``Engine(chunked_prefill=False, spec=spec)``
    (the first admission round and its chunk sync-free).  ``temps``: a
    temperature per request (sampled rows) or None (greedy, then every
    emitted token teacher-forced).  Gates: 32 tokens each, 0 leaked
    pages, paged launches == 24 x micro-steps, flash launches == 24 x
    full prefills + draft layers x draft prefills."""
    eng = make_legacy_engine(rt, cfg, params, "fp32", spec=spec)
    check(not eng.chunked_prefill and eng.paged_kernel,
          f"{what}: not two executables on the kernel path")
    eng.warmup()
    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    for r, temp in zip(reqs, temps or []):
        r.temperature = temp
    steps0 = eng.steps
    prefills = count_prefills(eng)
    drafts = count_prefills(eng, "draft_prefill")
    zero_launches([ops, fa])
    torch.cuda.reset_peak_memory_stats()
    times = serve_legacy(torch, eng, reqs, sync_check=True)
    paged, flash = ops.launches_by_dtype["fp32"], fa.launches
    micro = eng.steps - steps0
    st = eng.spec_stats()
    draft_layers = (eng.drafter.cfg.num_layers
                    if eng.drafter.kind == "model" else 0)
    draft_bytes = sum(t.numel() * t.element_size()
                      for lc in eng.cache.get("draft", [])
                      for t in lc.values())
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    rec = {"what": what, "arch": cfg.name, "drafter": eng.drafter.kind,
           "spec_k": eng.spec_config.k, "requests": len(reqs),
           "sampled_requests": sum(1 for t in (temps or []) if t),
           "decode_micro_steps": micro, "chunks": eng.chunks,
           "spec_stats": st, "full_prefills": prefills["n"],
           "draft_prefills": drafts["n"], "flash_attention_launches": flash,
           "paged_attention_launches": paged,
           "draft_cache_bytes": draft_bytes,
           "generated_tokens": gen_tokens,
           "generated_tokens_per_s": gen_tokens / times["wall_s"],
           "ms_per_micro_step": (times["decode_s"]
                                 / max(times["decode_micro_steps_timed"], 1)
                                 * 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "leaked_pages": eng.leaked_pages(), **times}
    emit("spec_legacy", **rec)
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"{what} rid {r.rid}: {len(r.out_tokens)} tokens")
    check(eng.leaked_pages() == 0, f"{what}: leaked pages")
    check(paged == cfg.num_layers * micro and ops.launches == paged,
          f"{what}: paged launches {paged} != {cfg.num_layers} x {micro}")
    check(prefills["n"] > 0 and flash == cfg.num_layers * prefills["n"]
          + draft_layers * drafts["n"],
          f"{what}: flash launches {flash} != {cfg.num_layers} x "
          f"{prefills['n']} + {draft_layers} x {drafts['n']}")
    if temps is None:
        rec["teacher_forced"] = teacher_forced_check(torch, rt, cfg, params,
                                                     reqs, what)
    rec["tokens"] = {r.rid: list(r.out_tokens) for r in reqs}
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_spec_legacy(torch, ops, fa, rt, cfg, params, fused_tokens):
    """Speculation on two executables: the n-gram drafter at k = 4 (S = 5
    verify rows, 10 per kv head: the GEMV path), then the model drafter
    at k = 3 on the target itself (its own tensors; acceptance >= 0.95:
    only near-ties between the dense draft path and the kernel path may
    reject), on a disagreeing draft (2 layers, d 256, the target's vocab,
    random weights from seed 1), and that draft once more with half the
    requests sampled at temperature 0.8.  Returns the n-gram run's paged
    launches (the S = 5 row's)."""
    Spec = rt["SpecConfig"]
    ngram = spec_legacy_run(torch, ops, fa, rt, cfg, params,
                            Spec(draft="ngram", k=4), "spec_legacy_ngram")
    selfspec = spec_legacy_run(
        torch, ops, fa, rt, cfg, params,
        Spec(draft="self", k=3, draft_cfg=cfg, draft_params=params),
        "spec_legacy_model_self")
    acc = selfspec["spec_stats"]["acceptance_rate"]
    check(acc >= 0.95, f"self-speculation acceptance {acc} < 0.95")
    dcfg = rt["reduced"](cfg, layers=2, d_model=256, heads=4, d_ff=1024,
                         vocab=cfg.vocab_size)
    dparams = rt["init_params"](rt["model_defs"](dcfg), 1, device=DEV)
    spec = Spec(draft="small", k=3, draft_cfg=dcfg, draft_params=dparams)
    small = spec_legacy_run(torch, ops, fa, rt, cfg, params, spec,
                            "spec_legacy_model_disagreeing")
    spec_legacy_run(torch, ops, fa, rt, cfg, params, spec,
                    "spec_legacy_model_sampled",
                    temps=[0.8 if i % 2 else 0.0 for i in range(12)])
    emit("spec_legacy_agreement",
         tokens_equal_to_plain_fused={
             rec["what"]: same_tokens(fused_tokens["fp32"], rec["tokens"])
             for rec in (ngram, selfspec, small)},
         tokens_total=sum(len(v) for v in fused_tokens["fp32"].values()))
    del dparams
    torch.cuda.empty_cache()
    return ngram["paged_attention_launches"]


# ---------------------------------------------------------------------------
# Phases 5h-5j: the launcher, ReferenceEngine and fig14 on internlm2
# ---------------------------------------------------------------------------

LAUNCHER_FLAGS = ["--no-smoke", "--slots", "8", "--max-len", "1024",
                  "--page-size", "16", "--num-pages", "512", "--requests",
                  "12", "--max-new", "32", "--shared-prefix", "264",
                  "--warmup", "--slo-class", "interactive"]
LAUNCHER_RUNS = {
    "fused": [],
    "legacy_ngram_k4": ["--chunked-prefill", "off", "--spec-draft",
                        "ngram", "--spec-k", "4"],
}
LAUNCHER_TIMEOUT_S = 300


def parse_launcher(out: str, what: str, layers: int,
                   sync_interval: int = 8) -> dict:
    """The launcher's summary lines, gated: 12 requests of 32 tokens,
    pool-direct decode on fp32 pools, a prefix hit rate > 0, finite
    positive TTFT/TPOT percentiles, and the paged kernel launched once
    per layer and micro-step (warmup's chunk included)."""
    import re
    lines = out.splitlines()

    def line(prefix: str) -> str:
        got = [ln for ln in lines if ln.startswith(prefix)]
        check(len(got) == 1, f"launcher {what}: {len(got)} lines start "
                             f"with {prefix!r}")
        return got[0]

    reqs = {}
    for ln in lines:
        m = re.match(r"req (\d+): \[(.*)\]$", ln)
        if m:
            reqs[int(m.group(1))] = [int(t) for t in m.group(2).split(",")]
    check(sorted(reqs) == list(range(12))
          and all(len(v) == 32 for v in reqs.values()),
          f"launcher {what}: requests {sorted(reqs)}, tokens "
          f"{sorted({len(v) for v in reqs.values()})}")
    totals = [ln for ln in lines if re.match(r"\d+ requests, ", ln)]
    check(len(totals) == 1, f"launcher {what}: no totals line")
    m = re.match(r"(\d+) requests, (\d+) tokens in ([0-9.]+)s \(([0-9.]+) "
                 r"tok/s, (\d+) engine steps, (\d+) host syncs, (\d+) "
                 r"prefill shapes / (\d+) suffix shapes / (\d+) decode "
                 r"shapes / (\d+) admit shapes\)", totals[0])
    check(m is not None, f"launcher {what}: totals line {totals[0]!r}")
    (n_req, toks, secs, tps, steps, syncs, prefill_shapes, suffix_shapes,
     decode_shapes, admit_shapes) = m.groups()
    check(int(n_req) == 12 and int(toks) == 384,
          f"launcher {what}: {n_req} requests, {toks} tokens")
    paged = line("paged KV:")
    check("decode_attention=pool-direct" in paged
          and "kv_dtype=fp32" in paged,
          f"launcher {what}: not the kernel path on fp32 pools: {paged}")
    prefix = line("prefix sharing:")
    hit_rate = float(re.search(r"hit_rate=([0-9.]+)", prefix).group(1))
    check(hit_rate > 0, f"launcher {what}: no prefix hits: {prefix}")
    slo = line("slo[interactive]:")
    m = re.search(r"ttft_p50/p99=(\S+)/(\S+)s tpot_p50/p99=(\S+)/(\S+)s$",
                  slo)
    check(m is not None, f"launcher {what}: {slo!r}")
    lat = {}
    for key, val in zip(("ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                         "tpot_p99_s"), m.groups()):
        try:
            lat[key] = float(val)
        except ValueError:
            raise SmokeFailure(f"launcher {what}: {key} is {val}")
        check(math.isfinite(lat[key]) and lat[key] > 0,
              f"launcher {what}: {key} = {val}")
    check(lat["ttft_p50_s"] <= lat["ttft_p99_s"]
          and lat["tpot_p50_s"] <= lat["tpot_p99_s"],
          f"launcher {what}: percentiles out of order: {lat}")
    launches = {k: int(v) for k, v in (
        kv.split("=") for kv in line("kernel launches:").split(": ", 1)[1]
        .split())}
    want = layers * (int(steps) + sync_interval)
    check(launches["paged_attention"] == want,
          f"launcher {what}: paged launches {launches['paged_attention']} "
          f"!= {layers} x ({steps} micro-steps + {sync_interval} warmup)")
    return {"tokens_per_s": float(tps), "seconds": float(secs),
            "micro_steps": int(steps), "host_syncs": int(syncs),
            "shapes": {"prefill": int(prefill_shapes),
                       "suffix": int(suffix_shapes),
                       "decode": int(decode_shapes),
                       "admit": int(admit_shapes)},
            "prefix_hit_rate": hit_rate, **lat,
            "kernel_launches": launches,
            "tokens": reqs}


def phase_launcher(torch, rt, cfg, params) -> dict:
    """``python -m repro_torch.launch.serve`` as a subprocess at full
    width on internlm2-1.8b (``--no-smoke``), fused, then two
    executables with the n-gram drafter.  It finds the kernels the build
    phase left under ``build/`` (or builds them).  Each run's summary
    lines are printed and gated (``parse_launcher``), and every token it
    served is teacher-forced on ``params`` (the launcher's weights: both
    draw them from seed 0 on the card) over the prompts its workload
    sent."""
    from repro_torch.launch.serve import parse_args, prompts
    env = port_env()
    torch.cuda.empty_cache()
    res = {}
    for what, extra in LAUNCHER_RUNS.items():
        argv = LAUNCHER_FLAGS + extra
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve", *argv],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=LAUNCHER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"launcher {what}: no exit within "
                               f"{LAUNCHER_TIMEOUT_S} s")
        seconds = time.time() - t0
        summary = [ln for ln in proc.stdout.splitlines()
                   if not ln.startswith("req ")]
        emit("launcher_output", run=what, argv=argv, rc=proc.returncode,
             seconds=seconds, lines=summary,
             stderr_tail=proc.stderr.splitlines()[-20:])
        check(proc.returncode == 0,
              f"launcher {what}: exit code {proc.returncode}")
        rec = parse_launcher(proc.stdout, what, cfg.num_layers)
        tokens = rec.pop("tokens")
        emit("launcher", run=what, process_seconds=seconds, **rec)
        served = []
        for rid, prompt in enumerate(prompts(parse_args(argv))):
            r = rt["Request"](rid=rid, prompt=prompt, max_new_tokens=32)
            r.out_tokens = tokens[rid]
            served.append(r)
        rec["teacher_forced"] = teacher_forced_check(
            torch, rt, cfg, params, served, f"launcher_{what}")
        res[what] = dict(rec, tokens=tokens)
    return res


def phase_reference_engine(torch, ops, fa, rt, cfg, params) -> dict:
    """The 12 requests through ``ReferenceEngine`` (8 slots, ``max_len``
    1024, the dense cache), the fused ``Engine`` (fp32 pools) and the
    two-executable one.  Gates: 32 tokens each; the tokens equal across
    the three, or else every token of each run teacher-forced; the
    reference's flash launches == layers x 12 exact-length prefills and
    no paged launch; the engines' paged launches == layers x
    micro-steps; host syncs per step >= 1 on the reference and exactly
    1 / sync_interval on both engines.  Returns the flash launches of
    the reference's run."""
    def requests():
        return make_requests(rt["Request"], cfg.vocab_size, 12, seed=7,
                             rid0=0)

    ref = rt["ReferenceEngine"](cfg, params, slots=8, max_len=1024,
                                device=DEV)
    ref_reqs = requests()
    for r in ref_reqs:
        ref.submit(r)
    zero_launches([ops, fa])
    torch.cuda.synchronize()
    t0 = time.time()
    done = ref.run(max_steps=100_000)
    torch.cuda.synchronize()
    ref_wall = time.time() - t0
    ref_flash, ref_paged = fa.launches, ops.launches
    check(len(done) == 12 and all(len(r.out_tokens) == 32 for r in done),
          "reference: not 12 requests of 32 tokens")
    check(ref_flash == cfg.num_layers * 12 and ref_paged == 0,
          f"reference: flash launches {ref_flash} != {cfg.num_layers} x 12 "
          f"or paged launches {ref_paged} != 0")
    ref_syncs = ref.host_syncs / ref.steps
    check(ref_syncs >= 1.0, f"reference: {ref_syncs} host syncs per step")
    runs = {"reference": ref_reqs}
    gen = 12 * 32
    rec = {"reference": {
        "wall_s": ref_wall, "steps": ref.steps, "host_syncs": ref.host_syncs,
        "host_syncs_per_step": ref_syncs,
        "generated_tokens_per_s": gen / ref_wall,
        "ms_per_step": ref_wall / ref.steps * 1e3,
        "prefill_shapes": ref.prefill_compiles,
        "decode_shapes": ref.decode_compiles,
        "flash_attention_launches": ref_flash}}

    for what in ("fused", "legacy"):
        eng = rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                           chunked_prefill=what == "fused", device=DEV)
        check(eng.paged_kernel, f"{what}: not the kernel path")
        eng.warmup()
        reqs = requests()
        steps0, syncs0 = eng.steps, eng.host_syncs
        zero_launches([ops, fa])
        torch.cuda.synchronize()
        if what == "fused":
            t = serve_fused(torch, eng, reqs)
            sync_checked = t["sync_free_chunk"]
        else:
            t = serve_legacy(torch, eng, reqs, sync_check=True)
            sync_checked = True
        micro = eng.steps - steps0
        syncs = (eng.host_syncs - syncs0) / micro
        for r in reqs:
            check(r.done and len(r.out_tokens) == 32,
                  f"{what}: rid {r.rid}: {len(r.out_tokens)} tokens")
        check(sync_checked, f"{what}: no chunk ran under sync debug mode")
        check(ops.launches == cfg.num_layers * micro,
              f"{what}: paged launches {ops.launches} != "
              f"{cfg.num_layers} x {micro}")
        check(syncs == 1.0 / eng.sync_interval,
              f"{what}: {syncs} host syncs per step, not "
              f"1/{eng.sync_interval}")
        check(eng.leaked_pages() == 0, f"{what}: leaked pages")
        rec[what] = {"wall_s": t["wall_s"], "micro_steps": micro,
                     "host_syncs_per_step": syncs,
                     "generated_tokens_per_s": gen / t["wall_s"],
                     "ms_per_micro_step": t["wall_s"] / micro * 1e3,
                     "paged_attention_launches": ops.launches,
                     "flash_attention_launches": fa.launches,
                     "shapes": {"prefill": eng.prefill_compiles,
                                "suffix": eng.suffix_prefill_compiles,
                                "decode": eng.decode_compiles,
                                "admit": eng.admit_compiles}}
        runs[what] = reqs
        del eng
        torch.cuda.empty_cache()
    tokens = {what: {r.rid: list(r.out_tokens) for r in reqs}
              for what, reqs in runs.items()}
    equal = {what: same_tokens(tokens["reference"], toks)
             for what, toks in tokens.items() if what != "reference"}
    emit("reference_engine", arch=cfg.name, tokens_equal_to_reference=equal,
         tokens_total=gen, **rec)
    if any(n != gen for n in equal.values()):
        # near-ties with random weights: each run must be teacher-forced
        for what, reqs in runs.items():
            teacher_forced_check(torch, rt, cfg, params, reqs,
                                 f"reference_engine_{what}")
    del ref
    torch.cuda.empty_cache()
    return ref_flash


def phase_fig14(torch, ops, fa, fig14) -> dict:
    """The port's fig14 at the reference's sizes (reduced internlm2, 4
    slots, 12 requests of 16 new tokens): the dispatch trio, then the
    serve workloads, the record written under ``build/``.  Its own
    asserts gate sync-free chunks, host syncs per step and clean
    teardown; here, every workload's chunk must have run sync-free, the
    tokens of its engines and of the dense reference must be equal in
    every workload, and both attention kernels must have launched."""
    out = ROOT / "build" / "BENCH_serve_torch.json"
    zero_launches([ops, fa])
    # the quantized-pool workload's own seconds and launches, for
    # phase_fig14_qp: main calls it through the module
    qp_run = fig14.quantized_pool_comparison
    qp = {}

    def timed_qp(**kw):
        before = (ops.launches, ops.launches_by_dtype["int8"], fa.launches)
        t_qp = time.time()
        got = qp_run(**kw)
        qp.update(seconds=time.time() - t_qp,
                  paged_attention_launches=ops.launches - before[0],
                  paged_attention_int8_launches=(
                      ops.launches_by_dtype["int8"] - before[1]),
                  flash_attention_launches=fa.launches - before[2])
        return got
    fig14.quantized_pool_comparison = timed_qp
    t0 = time.time()
    try:
        rec = fig14.main(["--out", str(out)])
    finally:
        fig14.quantized_pool_comparison = qp_run
    seconds = time.time() - t0
    sync_free = {k: rec[k] for k in rec if k.endswith("sync_free")}
    match = {k: rec[k] for k in rec if "outputs_match" in k}
    keys = ("per_dispatch_us", "per_op_fused_us", "per_op_eager_us",
            "speedup", "ref_tokens_per_s", "new_tokens_per_s",
            "ref_steps_per_s", "new_steps_per_s", "ref_host_syncs_per_step",
            "new_host_syncs_per_step", "ref_prefill_compiles",
            "new_prefill_compiles", "new_decode_compiles",
            "new_admit_compiles", "prefix_hit_rate",
            "paged_kernel_speedup", "spec_acceptance_rate",
            "spec_decode_speedup", "cp_decode_latency_p99_ratio",
            "cp_fused_chunk_token_p99_ms", "cp_legacy_chunk_token_p99_ms",
            "cp_fused_ttft_p50_s", "cp_fused_ttft_p99_s",
            "cp_legacy_ttft_p50_s", "cp_legacy_ttft_p99_s")
    emit("fig14", seconds=seconds, record=str(out.relative_to(ROOT)),
         outputs_match=match, sync_free=sync_free,
         paged_attention_launches=ops.launches,
         flash_attention_launches=fa.launches,
         **{k: rec[k] for k in keys})
    check(all(sync_free.values()), f"fig14: a chunk synchronized: "
                                   f"{sync_free}")
    check(all(match.values()), f"fig14: engines' tokens differ: {match}")
    check(ops.launches > 0 and fa.launches > 0,
          f"fig14: paged {ops.launches}, flash {fa.launches} launches")
    return {"paged": ops.launches, "flash": fa.launches, "record": rec,
            "qp": qp}


QP_GREEDY_MIN = 0.99       # benchmarks/check_serve_regression.py's gates
QP_LOGIT_ERR_MAX = 0.25
QP_SLOT_RATIO_MIN = 1.8


def phase_fig14_qp(fig14_run: dict) -> dict:
    """fig14's ``quantized_pool_comparison`` on the card (run inside
    phase 5j's ``main``: the reduced internlm2 trained on the token chain
    with the port's ``forward_train`` and AdamW, then served on int8
    against fp32 pools), gated as the JAX package's
    ``benchmarks/check_serve_regression.py`` gates it: int8 pools, greedy
    agreement >= 0.99 and the teacher-forced logit error <= 0.25, the
    int8 pool's bytes <= the fp32 pool's with >= 1.8x the slots all live
    at once, >= 1 preemption with equal outputs and no leaked page,
    copy-on-write outputs equal with a prefix hit, one decode shape and
    a sync-free decode chunk; the int8 paged kernel launched."""
    rec = {k: v for k, v in fig14_run["record"].items()
           if k.startswith("qp_")}
    qp = fig14_run["qp"]
    emit("fig14_qp", **qp, **rec)
    check(rec["qp_kv_dtype"] == "int8",
          f"fig14 qp: pools {rec['qp_kv_dtype']}")
    check(rec["qp_greedy_match"] >= QP_GREEDY_MIN,
          f"fig14 qp: greedy match {rec['qp_greedy_match']}")
    check(rec["qp_max_logit_err"] <= QP_LOGIT_ERR_MAX,
          f"fig14 qp: logit error {rec['qp_max_logit_err']}")
    check(rec["qp_quant_pool_bytes"] <= rec["qp_fp32_pool_bytes"],
          f"fig14 qp: int8 pool {rec['qp_quant_pool_bytes']} B > fp32 "
          f"{rec['qp_fp32_pool_bytes']} B")
    check(rec["qp_equal_bytes_slot_ratio"] >= QP_SLOT_RATIO_MIN
          and rec["qp_equal_bytes_peak_live_slots"]
          == rec["qp_equal_bytes_slots"],
          f"fig14 qp: slot ratio {rec['qp_equal_bytes_slot_ratio']}, peak "
          f"{rec['qp_equal_bytes_peak_live_slots']} of "
          f"{rec['qp_equal_bytes_slots']}")
    check(rec["qp_preemptions"] >= 1 and rec["qp_preempt_outputs_match"]
          and rec["qp_preempt_leaked_pages"] == 0,
          f"fig14 qp: preemptions {rec['qp_preemptions']}, match "
          f"{rec['qp_preempt_outputs_match']}, leaked "
          f"{rec['qp_preempt_leaked_pages']}")
    check(rec["qp_cow_outputs_match"] and rec["qp_prefix_hits"] >= 1,
          f"fig14 qp: CoW match {rec['qp_cow_outputs_match']}, hits "
          f"{rec['qp_prefix_hits']}")
    check(rec["qp_decode_sync_free"] and rec["qp_decode_compiles"] == 1,
          f"fig14 qp: sync-free {rec['qp_decode_sync_free']}, decode "
          f"shapes {rec['qp_decode_compiles']}")
    check(qp.get("paged_attention_int8_launches", 0) > 0,
          f"fig14 qp: the int8 paged kernel never launched: {qp}")
    return {**qp, **rec}


# ---------------------------------------------------------------------------
# Phases 5k-5o: robustness, SLO policy and lifecycle tracing at full width
# ---------------------------------------------------------------------------

FT_NUM_PAGES = 160   # a 700 + 32-token request reserves up to 46 pages of 16
# the smoke preset's rates, the storm rate raised to 0.6: at its 10% a
# short drain can see no storm at all
FT_CHAOS = dict(p_deny_admission=0.15, p_preempt=0.6, p_stall=0.05,
                p_sharing_fault=0.25)
SLO_MIX_REQUESTS = 24
LAUNCHER_A11_FLAGS = ["--no-smoke", "--traffic", "poisson:0", "--policy",
                      "slo", "--chaos", "0"]


def timed_phase(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, then one line with the phase's seconds (warmups
    and checks included)."""
    t0 = time.time()
    out = fn(*args, **kw)
    emit("phase_seconds", name=name, seconds=time.time() - t0)
    return out


def a11_engine(rt, cfg, params, fused: bool = True, **kw):
    return rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                        chunked_prefill=fused, device=DEV, **kw)


def ft_traffic(rt, cfg):
    """The 12 requests, one request to cancel after the first drain
    (submitted first, so that it runs) and one whose deadline has
    already passed (submitted last): the order of submission."""
    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    cancelled = rt["Request"](rid=12, prompt=list(reqs[1].prompt[:60]),
                              max_new_tokens=32)
    expired = rt["Request"](rid=13, prompt=list(reqs[0].prompt[:40]),
                            max_new_tokens=32, deadline=0.0)
    return reqs, cancelled, expired


def serve_boundaries(torch, eng, order, cancel=None) -> dict:
    """Submit ``order``, then serve boundary by boundary: the host's
    boundary work (``Engine._boundary``: reaping, chaos, admission with
    preemption, the SLO budget upload), then the chunk and its drain.
    The chunk after the second drain runs under
    ``set_sync_debug_mode("error")``, the boundary work before it
    outside.  ``cancel`` is cancelled after the first drain."""
    for r in order:
        check(eng.submit(r) is None, f"rid {r.rid} rejected")
    steps0 = eng.steps
    sync_checked = False
    torch.cuda.synchronize()
    t0 = time.time()
    while eng.queue or eng._live():
        if not eng._boundary():
            continue
        checked = not sync_checked and eng.chunks >= 2
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            toks = eng.step_chunk()
        finally:
            if checked:
                torch.cuda.set_sync_debug_mode(0)
        sync_checked = sync_checked or checked
        eng._drain(toks)
        if cancel is not None and eng.chunks == 1:
            cancel.cancel()
    torch.cuda.synchronize()
    wall = time.time() - t0
    micro = eng.steps - steps0
    return {"wall_s": wall, "micro_steps": micro,
            "ms_per_micro_step": wall / max(micro, 1) * 1e3,
            "sync_free_chunk": sync_checked}


def phase_fault_tolerance(torch, ops, fa, rt, cfg, params, fused_tokens,
                          trace: bool = False) -> dict:
    """The 12 requests, a cancelled and an expired one on ``num_pages``
    160 (8 slots cannot all hold a 46-page reservation: pressure
    preemption must fire), through the fused engine and the
    two-executable one (``trace``: the fused one only, traced).  Gates:
    the 12 requests' tokens equal the uncontended fused run's
    (``fused_tokens``; two executables: equal, or else teacher-forced),
    pressure preemptions >= 1, the expired request TIMED_OUT without
    ever holding a slot, the cancelled one CANCELLED, 0 leaked pages, a
    sync-free chunk, paged launches == layers x micro-steps (and flash
    launches == layers x full prefills on two executables)."""
    res = {}
    for what in (("fused",) if trace else ("fused", "legacy")):
        eng = a11_engine(rt, cfg, params, fused=what == "fused",
                         num_pages=FT_NUM_PAGES, trace=trace)
        check(eng.paged_kernel, f"fault_tolerance {what}: not the kernel")
        eng.warmup()
        reqs, cancelled, expired = ft_traffic(rt, cfg)
        prefills = count_prefills(eng)
        zero_launches([ops, fa])
        t = serve_boundaries(torch, eng, [cancelled] + reqs + [expired],
                             cancel=cancelled)
        paged, flash = ops.launches, fa.launches
        fs = eng.fault_stats()
        tokens = {r.rid: list(r.out_tokens) for r in reqs}
        equal = same_tokens(fused_tokens, tokens)
        admitted = {entry[1] for entry in eng.scheduler.admission_log}
        rec = dict(t, path=what, traced=trace, num_pages=FT_NUM_PAGES,
                   tokens_equal_to_uncontended=equal, tokens_total=12 * 32,
                   fault_stats=fs,
                   resume_recovered_share=fs["recovered_prefill_fraction"],
                   preempted_requests=sorted(r.rid for r in reqs
                                             if r.preemptions > 0),
                   cancelled_tokens=len(cancelled.out_tokens),
                   statuses={"cancelled": cancelled.status,
                             "expired": expired.status},
                   peak_pages_in_use=eng.scheduler.peak_pages_in_use,
                   paged_attention_launches=paged,
                   flash_attention_launches=flash,
                   full_prefills=prefills["n"],
                   leaked_pages=eng.leaked_pages())
        if trace:
            obj = eng.export_trace()
            failures = rt["validate_trace"](obj)
            victim = next((r for r in reqs if r.preemptions > 0), None)
            text = eng.explain(victim.rid) if victim is not None else ""
            rec.update(trace_events=len(eng.tracer),
                       trace_dropped=eng.tracer.dropped,
                       trace_export_events=len(obj["traceEvents"]),
                       schema_failures=failures[:5],
                       explained_rid=None if victim is None else victim.rid,
                       explain_head=text.splitlines()[:12])
        emit("fault_tolerance" if not trace else "trace", **rec)
        for r in reqs:
            check(r.status == "FINISHED" and len(r.out_tokens) == 32,
                  f"ft {what}: rid {r.rid} {r.status} with "
                  f"{len(r.out_tokens)} tokens")
        if what == "fused":
            check(equal == 12 * 32, f"ft {what}: {equal} of 384 tokens "
                                    "equal the uncontended run's")
        elif equal != 12 * 32:
            teacher_forced_check(torch, rt, cfg, params, reqs,
                                 "fault_tolerance_legacy")
        check(fs["pressure_preemptions"] >= 1,
              f"ft {what}: no pressure preemption on {FT_NUM_PAGES} pages")
        check(expired.status == "TIMED_OUT" and not expired.out_tokens
              and expired.rid not in admitted,
              f"ft {what}: expired request {expired.status}, admitted="
              f"{expired.rid in admitted}")
        check(cancelled.status == "CANCELLED",
              f"ft {what}: cancelled request ended {cancelled.status}")
        check(eng.leaked_pages() == 0, f"ft {what}: leaked pages")
        check(t["sync_free_chunk"], f"ft {what}: no chunk sync-checked")
        check(paged == cfg.num_layers * t["micro_steps"],
              f"ft {what}: paged launches {paged} != {cfg.num_layers} x "
              f"{t['micro_steps']}")
        if what == "legacy":
            check(prefills["n"] > 0
                  and flash == cfg.num_layers * prefills["n"],
                  f"ft legacy: flash launches {flash} != "
                  f"{cfg.num_layers} x {prefills['n']} full prefills")
        if trace:
            check(not failures, f"trace: export fails the schema: "
                                f"{failures[:3]}")
            check(victim is not None, "trace: no preempted request")
            check(" preempt " in text and " resume " in text,
                  f"trace: explain({victim.rid}) names no preempt and "
                  "resume")
        res[what] = dict(rec, tokens={r.rid: list(r.out_tokens)
                                      for r in [cancelled] + reqs})
        del eng
        torch.cuda.empty_cache()
    return res


def phase_trace(torch, ops, fa, rt, cfg, params, fused_tokens,
                untraced) -> dict:
    """The fault_tolerance phase's fused configuration with
    ``trace=True`` (so preemptions are traced): that phase's gates, and
    its tokens (the cancelled request's too) equal the untraced run's,
    the export valid under ``benchmarks/check_trace``, ``explain`` of a
    preempted request naming its preempt and resume.  Wall ms per
    micro-step, traced against untraced, is printed."""
    rec = phase_fault_tolerance(torch, ops, fa, rt, cfg, params,
                                fused_tokens, trace=True)["fused"]
    same = rec["tokens"] == untraced["tokens"]
    emit("trace_vs_untraced", tokens_equal=same,
         ms_per_micro_step_traced=rec["ms_per_micro_step"],
         ms_per_micro_step_untraced=untraced["ms_per_micro_step"],
         micro_steps_traced=rec["micro_steps"],
         micro_steps_untraced=untraced["micro_steps"],
         trace_events=rec["trace_events"])
    check(same, "trace: tokens differ from the untraced run's")
    return rec


def phase_chaos(torch, ops, rt, cfg, params, fused_tokens) -> dict:
    """The 12 requests through the fused engine under
    ``ChaosMonkey(0, **FT_CHAOS)``: admission denials, preemption
    storms, stalls ended by the watchdog, sharing faults.  Gates: every
    request FINISHED with 32 tokens equal to the unfaulted fused run's,
    0 leaked pages, one chunk shape, chaos preemptions >= 1, a
    sync-free chunk, paged launches == layers x micro-steps."""
    chaos = rt["ChaosMonkey"](0, **FT_CHAOS)
    eng = a11_engine(rt, cfg, params, chaos=chaos)
    eng.warmup()
    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    zero_launches([ops])
    t = serve_boundaries(torch, eng, reqs)
    fs = eng.fault_stats()
    tokens = {r.rid: list(r.out_tokens) for r in reqs}
    equal = same_tokens(fused_tokens, tokens)
    emit("chaos", **t, fault_stats=fs, tokens_equal_to_unfaulted=equal,
         tokens_total=12 * 32, decode_shapes=eng.decode_compiles,
         paged_attention_launches=ops.launches,
         leaked_pages=eng.leaked_pages())
    for r in reqs:
        check(r.status == "FINISHED" and len(r.out_tokens) == 32,
              f"chaos: rid {r.rid} {r.status} with {len(r.out_tokens)} "
              "tokens")
    check(equal == 12 * 32, f"chaos: {equal} of 384 tokens equal the "
                            "unfaulted run's")
    check(eng.leaked_pages() == 0, "chaos: leaked pages")
    check(eng.decode_compiles == 1, "chaos: more than one chunk shape")
    check(fs["chaos_preemptions"] >= 1, "chaos: no storm preemption")
    check(t["sync_free_chunk"], "chaos: no chunk sync-checked")
    check(ops.launches == cfg.num_layers * t["micro_steps"],
          f"chaos: paged launches {ops.launches} != {cfg.num_layers} x "
          f"{t['micro_steps']}")
    del eng
    torch.cuda.empty_cache()
    return dict(t, fault_stats=fs, paged=ops.launches)


def phase_slo_mix(torch, ops, rt, cfg, params) -> dict:
    """24 requests of ``TrafficGenerator(0, rate=8.0)`` (the reference's
    class mix and profiles: prompts of 2-24 tokens, 4-24 new tokens)
    replayed on a ``VirtualClock`` (0.05 per chunk) under 'fifo' and
    'slo' on the fused engine.  Gates: every request finished, greedy
    tokens equal per rid between the policies (batch prompts of 9-24
    tokens against a throttled budget of 8: where the reference's
    completion rule goes wrong), 0 leaked pages, paged launches == layers
    x micro-steps.  Reported: throttles, per-class TTFT/TPOT p50/p99 and
    goodput (virtual units), wall ms per micro-step."""
    traffic = rt["traffic"]
    trace = traffic.TrafficGenerator(0, rate=8.0, process="poisson") \
        .generate(SLO_MIX_REQUESTS)
    out = {}
    for policy in ("fifo", "slo"):
        clk = traffic.VirtualClock(dt=0.05)
        eng = a11_engine(rt, cfg, params, policy=policy, clock=clk)
        eng.warmup()
        zero_launches([ops])
        steps0 = eng.steps
        torch.cuda.synchronize()
        t0 = time.time()
        results = traffic.replay(eng, trace, clock=clk)
        torch.cuda.synchronize()
        wall = time.time() - t0
        micro = eng.steps - steps0
        ls = eng.latency_stats()
        done = {r.rid: list(r.out_tokens) for r in eng.finished}
        out[policy] = {
            "wall_s": wall, "micro_steps": micro,
            "ms_per_micro_step": wall / micro * 1e3,
            "budget_throttles": ls["budget_throttles"],
            "goodput": ls["goodput"],
            "classes": {name: {k: c[k] for k in (
                "count", "finished", "goodput", "ttft_p50", "ttft_p99",
                "tpot_p50", "tpot_p99")}
                for name, c in ls["classes"].items()},
            "preemptions": eng.fault_stats()["preemptions"],
            "paged_attention_launches": ops.launches,
            "tokens": done}
        check(all(v is None for v in results.values())
              and sorted(done) == list(range(SLO_MIX_REQUESTS)),
              f"slo_mix {policy}: finished {sorted(done)}")
        check(eng.leaked_pages() == 0, f"slo_mix {policy}: leaked pages")
        check(ops.launches == cfg.num_layers * micro,
              f"slo_mix {policy}: paged launches {ops.launches} != "
              f"{cfg.num_layers} x {micro}")
        del eng
        torch.cuda.empty_cache()
    equal = same_tokens(out["fifo"]["tokens"], out["slo"]["tokens"])
    total = sum(map(len, out["fifo"]["tokens"].values()))
    emit("slo_mix", requests=SLO_MIX_REQUESTS, rate=8.0, clock_dt=0.05,
         classes=sorted({tr.slo_class for tr in trace}),
         tokens_equal_across_policies=equal, tokens_total=total,
         **{policy: {k: v for k, v in rec.items() if k != "tokens"}
            for policy, rec in out.items()})
    check(equal == total, f"slo_mix: {equal} of {total} tokens equal "
                          "across the policies")
    return out


def phase_launcher_a11(torch, cfg) -> dict:
    """``python -m repro_torch.launch.serve --no-smoke --traffic
    poisson:0 --policy slo --chaos 0 --trace OUT.json`` as a subprocess
    at full width.  Gates: exit code 0, every traffic request served, the
    ``faults:``, ``chaos`` and ``trace:`` lines present, the chaos drain
    clean, paged launches == layers x engine steps, and the trace file
    valid under ``benchmarks/check_trace``."""
    import re
    from repro_torch.benchmarks.check_trace import validate
    out = ROOT / "build" / "launcher_a11_trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():
        out.unlink()
    argv = LAUNCHER_A11_FLAGS + ["--trace", str(out)]
    env = port_env()
    torch.cuda.empty_cache()
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=LAUNCHER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"launcher_a11: no exit within "
                           f"{LAUNCHER_TIMEOUT_S} s")
    seconds = time.time() - t0
    lines = proc.stdout.splitlines()
    summary = [ln for ln in lines if not ln.startswith("req ")]
    emit("launcher_a11_output", argv=argv, rc=proc.returncode,
         seconds=seconds, lines=summary[:40],
         stderr_tail=proc.stderr.splitlines()[-20:])
    check(proc.returncode == 0, f"launcher_a11: exit code "
                                f"{proc.returncode}")

    def line(prefix: str) -> str:
        got = [ln for ln in lines if ln.startswith(prefix)]
        check(len(got) == 1, f"launcher_a11: {len(got)} lines start with "
                             f"{prefix!r}")
        return got[0]

    traffic_line = line("traffic[poisson:0]:")
    m = re.match(r"traffic\[poisson:0\]: (\d+) arrivals", traffic_line)
    arrivals = int(m.group(1)) if m else -1
    totals = [ln for ln in lines if re.match(r"\d+ requests, ", ln)]
    check(len(totals) == 1, "launcher_a11: no totals line")
    m = re.match(r"(\d+) requests, (\d+) tokens in [0-9.]+s \(([0-9.]+) "
                 r"tok/s, (\d+) engine steps", totals[0])
    check(m is not None, f"launcher_a11: totals line {totals[0]!r}")
    n_req, n_tok, tps, steps = (int(m.group(1)), int(m.group(2)),
                                float(m.group(3)), int(m.group(4)))
    faults = line("faults:")
    chaos_line = line("chaos[seed=0]:")
    check("chaos: clean drain" in proc.stdout,
          "launcher_a11: no clean chaos drain")
    trace_line = line("trace:")
    launches = {k: int(v) for k, v in (
        kv.split("=") for kv in line("kernel launches:").split(": ", 1)[1]
        .split())}
    check(n_req == arrivals > 0, f"launcher_a11: {n_req} of {arrivals} "
                                 "arrivals served")
    check(launches["paged_attention"] == cfg.num_layers * steps,
          f"launcher_a11: paged launches {launches['paged_attention']} "
          f"!= {cfg.num_layers} x {steps} steps")
    check(out.exists(), "launcher_a11: no trace file written")
    failures = validate(json.loads(out.read_text()))
    rec = {"process_seconds": seconds, "requests": n_req, "tokens": n_tok,
           "tokens_per_s": tps, "engine_steps": steps,
           "faults": faults, "chaos": chaos_line, "trace": trace_line,
           "slo": [ln for ln in lines if ln.startswith("slo")],
           "kernel_launches": launches,
           "trace_schema_failures": failures[:5]}
    emit("launcher_a11", **rec)
    check(not failures, f"launcher_a11: trace fails the schema: "
                        f"{failures[:3]}")
    return rec


# ---------------------------------------------------------------------------
# Phase 5g: gemma2-2b at full width and depth, a window ring that wraps
# ---------------------------------------------------------------------------

def gemma2_long_logits(torch, rt, cfg, params, prompt) -> None:
    """The long prompt (4600 tokens > the 4096 window) on both paths,
    against ``forward_prefill`` over it in the 8192 bucket: (fused) its
    first-token logits, teacher-forced through ``forward_verify`` in
    right-aligned 32-row slices over fresh pools (the windowed ring of
    258 pages wraps after 4128 tokens), and (two executables) the
    second token's, from ``forward_decode`` of the first token after the
    prompt's prefill was spliced into a 256-page windowed ring (its
    4600 tokens wrap inside the one splice) against ``forward_prefill``
    over prompt + first token.  Gate: max abs difference <= 1e-3 x
    max|want|, both through the kernels."""
    import numpy as np
    L = len(prompt)

    def prefill(seq):
        bucket = 1 << (len(seq) - 1).bit_length()
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(seq)] = seq
        return rt["forward_prefill"](
            params, cfg, {"tokens": torch.tensor(padded, device=DEV)},
            length=torch.tensor([len(seq)], dtype=torch.int32, device=DEV))

    def gate(what, got, want, extra):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        emit("gemma2_long_logits", path=what, prompt_len=L,
             logits_max_abs_diff=err, max_abs_want=scale,
             tol=PATH_TOL * scale,
             same_argmax=bool(got.argmax() == want.argmax()), **extra)
        check(bool(torch.isfinite(got).all()), f"gemma2 {what}: non-finite")
        check(err <= PATH_TOL * scale,
              f"gemma2 {what}: long-prompt logits differ by {err} "
              f"(max|want| {scale})")

    want, one = prefill(prompt)
    S = 32
    spec = rt["CacheSpec"].from_config(cfg, 1, GEMMA2_MAX_LEN, page_size=16,
                                       spec_tokens=S - 1)
    rows = {g.key: list(range(g.ring_blocks)) for g in spec.groups}
    cache = spec.init_paged_cache(torch.device(DEV))
    rt["install_slot_rows"](spec, cache, 0, 0, rows)
    col = torch.arange(S, device=DEV)[None, :]
    done = 0
    while done < L:
        n = min(S, L - done)
        toks = np.zeros((1, S), np.int32)
        toks[0, S - n:] = prompt[done:done + n]
        logits, cache = rt["forward_verify"](
            params, cfg, torch.tensor(toks, device=DEV), cache,
            write_mask=col >= S - n, paged_kernel=True,
            spec_slack=spec.spec_tokens,
            n_rows=torch.tensor([n], dtype=torch.int32, device=DEV))
        cache = dict(cache, len=cache["len"] + n)
        done += n
    gate("fused", logits[0, -1], want[0],
         {"ring_blocks": {g.key: g.ring_blocks for g in spec.groups}})
    del cache
    first = int(want[0].argmax())
    spec = rt["CacheSpec"].from_config(cfg, 1, GEMMA2_MAX_LEN, page_size=16)
    rows = {g.key: list(range(g.ring_blocks)) for g in spec.groups}
    cache = spec.init_paged_cache(torch.device(DEV))
    rt["admit_cache"](spec, cache, one, 0, 0, L, rows)
    del one
    got, cache = rt["forward_decode"](
        params, cfg, torch.tensor([[first]], dtype=torch.int32, device=DEV),
        cache, paged_kernel=True)
    want2, _ = prefill(list(prompt) + [first])
    gate("legacy", got[0], want2[0],
         {"ring_blocks": {g.key: g.ring_blocks for g in spec.groups}})
    del cache
    torch.cuda.empty_cache()


def gemma2_requests(rt, cfg, long_prompt):
    """The long request (64 new tokens) and 7 of the main traffic's."""
    reqs = [rt["Request"](rid=0, prompt=list(long_prompt),
                          max_new_tokens=64)]
    return reqs + make_requests(rt["Request"], cfg.vocab_size, 7, seed=7,
                                rid0=1)


def gemma2_paths_check(torch, rt, cfg, eng) -> dict:
    """One full-width pass on the engine's mid-run cache (the long slot's
    window ring wrapped), through the kernel and through the gather
    path, each on its own copy of the cache: the fused engine's next
    micro-step rows (``forward_verify``), or the two-executable engine's
    next decode step (``forward_decode``).  Gate: <= 1e-3 x max|want|
    (want: the gather path) on the live rows."""
    out = {}
    ex = eng.executor
    if eng.chunked_prefill:
        toks, wm, n, _pre, _comp = ex.micro_inputs(eng.cache, eng.state)
    for kernel in (True, False):
        cache = dict(eng.cache, len=eng.cache["len"].clone(),
                     layers=[{k: v.clone() for k, v in c.items()}
                             for c in eng.cache["layers"]])
        if eng.chunked_prefill:
            logits, _ = rt["forward_verify"](
                eng.params, cfg, toks, cache, write_mask=wm,
                paged_kernel=kernel, spec_slack=eng.spec.spec_tokens,
                n_rows=n)
            real = wm
        else:
            logits, _ = rt["forward_decode"](
                eng.params, cfg, eng.state["tokens"][:, None], cache,
                write_mask=eng.state["active"], paged_kernel=kernel)
            real = eng.state["active"]
        out[kernel] = logits[real]
        del cache
        torch.cuda.empty_cache()
    scale = float(out[False].abs().max())
    err = float((out[True] - out[False]).abs().max())
    rec = {"rows_compared": int(out[True].shape[0]),
           "logits_max_abs_diff": err, "max_abs_want": scale,
           "tol": PATH_TOL * scale,
           "long_slot_len": int(eng.cache["len"][0])}
    check(bool(torch.isfinite(out[True]).all()), "gemma2: non-finite logits")
    check(err <= PATH_TOL * scale,
          f"gemma2 {'fused' if eng.chunked_prefill else 'legacy'}: kernel "
          f"vs gather logits differ by {err} (max|want| {scale})")
    return rec


def gemma2_serve(torch, ops, rt, cfg, params, long_prompt, *, fused: bool,
                 kernel: bool, spec=None, only_long: bool = False) -> dict:
    """Serve the gemma2 requests on one engine (``max_len`` 8192, page 16,
    fp32 pools).  The kernel engine without speculation is checked
    against the gather path once the long slot's window ring has wrapped
    (``gemma2_paths_check``).  Gates: every request's budget emitted, 0
    leaked pages, on the kernel path paged launches == 26 x
    micro-steps."""
    eng = rt["Engine"](cfg, params, slots=8, max_len=GEMMA2_MAX_LEN,
                       page_size=16, chunked_prefill=fused,
                       paged_kernel=kernel, spec=spec, device=DEV)
    check(eng.chunked_prefill == fused and eng.paged_kernel == kernel,
          "gemma2: engine mode")
    reqs = gemma2_requests(rt, cfg, long_prompt)[:1 if only_long else None]
    steps0 = eng.steps
    zero_launches([ops])
    paths = None
    for r in reqs:
        check(eng.submit(r) is None, f"gemma2 rid {r.rid} rejected")
    t0 = time.time()
    wrap_at = max(b.window for b in cfg.blocks if b.window) + 128
    while eng.queue or eng._live():
        if (kernel and spec is None and paths is None
                and eng._slot_req[0] is reqs[0]
                and (not fused or eng._slot_seen_len[0] >= wrap_at)):
            # the check's own launches are not the engine's: restore
            saved = ops.launches, dict(ops.launches_by_dtype)
            paths = gemma2_paths_check(torch, rt, cfg, eng)
            ops.launches = saved[0]
            ops.launches_by_dtype.update(saved[1])
        eng.step()
    torch.cuda.synchronize()
    wall = time.time() - t0
    micro = eng.steps - steps0
    paged = ops.launches_by_dtype["fp32"]
    stats = eng.memory_stats()
    groups = {g.key: {"ring_blocks": g.ring_blocks,
                      "num_pages": g.num_pages,
                      "pool_bytes": g.num_pages * eng.spec.group_page_bytes(g),
                      "windowed": g.windowed} for g in eng.spec.groups}
    gen = sum(len(r.out_tokens) for r in reqs)
    rec = {"arch": cfg.name, "path": "fused" if fused else "legacy",
           "paged_kernel": kernel, "spec": eng.spec_stats(),
           "requests": len(reqs), "long_prompt_len": len(long_prompt),
           "micro_steps": micro, "chunks": eng.chunks,
           "paged_attention_launches": paged, "pool_groups": groups,
           "pool_bytes": stats["paged_kv_bytes"], "wall_s": wall,
           "generated_tokens": gen, "generated_tokens_per_s": gen / wall,
           "ms_per_micro_step": wall / micro * 1e3,
           "kernel_vs_gather": paths, "leaked_pages": eng.leaked_pages()}
    emit("gemma2_engine", **rec)
    for r in reqs:
        check(r.done and len(r.out_tokens) == r.max_new_tokens,
              f"gemma2 rid {r.rid}: {len(r.out_tokens)} tokens")
    check(eng.leaked_pages() == 0, "gemma2: leaked pages")
    if kernel:
        check(paged == cfg.num_layers * micro and ops.launches == paged,
              f"gemma2: paged launches {paged} != {cfg.num_layers} x "
              f"{micro}")
    else:
        check(ops.launches == 0, "gemma2: the gather path launched the "
                                 "paged kernel")
    if kernel and spec is None:
        check(paths is not None, "gemma2: the kernel/gather check never ran")
    rec["reqs"] = reqs
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_gemma2(torch, ops, fa, rt):
    """Full-width, full-depth gemma2-2b (26 layers alternating a 4096
    window with global attention, dh 256, softcaps 50/30, tied and
    scaled embeddings; ~10.5 GB of fp32 weights from seed 0) at
    ``max_len`` 8192: the long-prompt logits check, then on each path
    (fused, two executables) the 8 requests through the kernel and
    through the gather path (greedy tokens equal), every emitted token
    of the kernel run teacher-forced, then the long request alone with
    ``SpecConfig(k=4)`` on both paths, teacher-forced.  Returns the
    paged launches by verify shape."""
    import numpy as np
    cfg = rt["get_config"]("gemma2-2b")
    t0 = time.time()
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV)
    torch.cuda.synchronize()
    emit("params", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         head_dim=cfg.resolved_head_dim,
         windows=sorted({b.window or 0 for b in cfg.blocks}),
         params=sum(p.numel() for p in params.parameters()),
         param_bytes=sum(p.numel() * p.element_size()
                         for p in params.parameters()),
         seconds=time.time() - t0)
    long_prompt = np.random.default_rng(23).integers(
        1, cfg.vocab_size, GEMMA2_LONG).tolist()
    gemma2_long_logits(torch, rt, cfg, params, long_prompt)
    launches = {}
    for fused in (True, False):
        path = "fused" if fused else "legacy"
        runs = {kernel: gemma2_serve(torch, ops, rt, cfg, params,
                                     long_prompt, fused=fused, kernel=kernel)
                for kernel in (True, False)}
        got = {r.rid: list(r.out_tokens) for r in runs[True]["reqs"]}
        want = {r.rid: list(r.out_tokens) for r in runs[False]["reqs"]}
        emit("gemma2_kernel_vs_gather", path=path,
             tokens=sum(len(v) for v in want.values()),
             tokens_equal=same_tokens(want, got))
        check(got == want, f"gemma2 {path}: kernel and gather tokens differ")
        teacher_forced_check(torch, rt, cfg, params, runs[True]["reqs"],
                             f"gemma2_{path}")
        launches[f"gemma2_{path}"] = runs[True]["paged_attention_launches"]
        spec = gemma2_serve(torch, ops, rt, cfg, params, long_prompt,
                            fused=fused, kernel=True,
                            spec=rt["SpecConfig"](k=4), only_long=True)
        teacher_forced_check(torch, rt, cfg, params, spec["reqs"],
                             f"gemma2_{path}_spec")
        launches[f"gemma2_{path}_spec"] = spec["paged_attention_launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5d: zamba2-7b, Mamba2 + shared attention at full width and depth
# ---------------------------------------------------------------------------

def zamba2_recurrent_check(torch, rt, cfg, params):
    """One prompt of 100 tokens four ways: ``forward_prefill`` in its own
    bucket (128), in the 1024 bucket padded with 0s and padded with 9s
    (the flash and mamba2_scan kernels), and the recurrent path: a
    prefill of its first token, then ``forward_decode`` through the rest
    (the paged kernel and the O(1) state update).  Gates on the
    last-token logits and every Mamba2 state leaf: the two pad tokens
    <= ``ZAMBA2_MASK_TOL`` x max|want| (the ``length`` masking); the 1024
    bucket and the recurrent path against the 128 bucket <=
    ``ZAMBA2_PATH_TOL`` x max|want|."""
    import numpy as np
    L = 100
    rng = np.random.default_rng(23)
    prompt = rng.integers(1, cfg.vocab_size, L).astype(np.int32)
    length = torch.tensor([L], dtype=torch.int32, device=DEV)

    def prefill(bucket, pad):
        padded = np.full((1, bucket), pad, np.int32)
        padded[0, :L] = prompt
        lg, cache = rt["forward_prefill"](
            params, cfg, {"tokens": torch.tensor(padded, device=DEV)},
            length=length)
        return leaves(lg, cache["layers"])

    def leaves(lg, layers):
        out = {"logits": lg.reshape(-1)}
        for i, c in enumerate(layers):
            if c is not None and "ssm" in c:
                out[f"ssm{i}"], out[f"conv{i}"] = c["ssm"], c["conv"]
        return out

    want = prefill(128, 0)
    runs = {"pad9": prefill(1024, 9)}
    base = prefill(1024, 0)
    spec = rt["CacheSpec"].from_config(cfg, 1, 1024, page_size=16)
    cache = spec.init_paged_cache(torch.device(DEV))
    rows = {g.key: list(range(g.ring_blocks)) for g in spec.groups}
    toks = torch.tensor(prompt, device=DEV)
    _, one = rt["forward_prefill"](params, cfg, {"tokens": toks[None, :1]})
    rt["admit_cache"](spec, cache, one, 0, 0, 1, rows)
    t0 = time.time()
    for t in range(1, L):
        logits, cache = rt["forward_decode"](params, cfg, toks[None, t:t + 1],
                                             cache, paged_kernel=True)
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    runs["bucket1024"] = base
    runs["recurrent"] = leaves(logits, cache["layers"])
    rec = {}
    for name, got in runs.items():
        ref = base if name == "pad9" else want
        check(all(bool(torch.isfinite(got[k]).all()) for k in got),
              f"zamba2 {name}: non-finite values")
        rel = {k: float((got[k] - w).abs().max())
               / max(float(w.abs().max()), 1e-30) for k, w in ref.items()}
        worst = max(rel, key=rel.get)
        rec[name] = {"relative_err": rel[worst], "leaf": worst,
                     "logits_relative_err": rel["logits"]}
    emit("zamba2_paths", prompt_len=L, decode_steps=L - 1,
         decode_s=decode_s, state_leaves=len(want) - 1,
         mask_tol=ZAMBA2_MASK_TOL, path_tol=ZAMBA2_PATH_TOL,
         same_argmax=bool(runs["recurrent"]["logits"].argmax()
                          == want["logits"].argmax()), **rec)
    for name, tol in (("pad9", ZAMBA2_MASK_TOL),
                      ("bucket1024", ZAMBA2_PATH_TOL),
                      ("recurrent", ZAMBA2_PATH_TOL)):
        check(rec[name]["relative_err"] <= tol,
              f"zamba2 {name}: {rec[name]['relative_err']} x max|want| "
              f"({rec[name]['leaf']}) > {tol}")


def phase_zamba2(torch, ops, fa, mops, rt):
    """Full-width, full-depth zamba2-7b (81 layers, fp32, random weights
    from seed 0): the prefill-vs-recurrent check, then the 12 requests
    through ``Engine(chunked_prefill="auto")``, which must resolve to two
    executables.  Counts are zeroed just before the run and read just
    after.  Returns the launch counts for the kernel line."""
    cfg = rt["get_config"]("zamba2-7b")
    n_mamba = sum(b.mixer == "mamba2" for b in cfg.blocks)
    n_attn = sum(b.mixer == "shared_attn" for b in cfg.blocks)
    t0 = time.time()
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV)
    torch.cuda.synchronize()
    emit("params", arch=cfg.name, layers=cfg.num_layers,
         mamba2_layers=n_mamba, shared_attention_layers=n_attn,
         d_model=cfg.d_model,
         params=sum(p.numel() for p in params.parameters()),
         param_bytes=sum(p.numel() * p.element_size()
                         for p in params.parameters()),
         seconds=time.time() - t0)
    zamba2_recurrent_check(torch, rt, cfg, params)

    eng = rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                       num_pages=512, chunked_prefill="auto", device=DEV)
    check(not eng.chunked_prefill and eng.paged_kernel,
          "zamba2: chunked_prefill='auto' did not resolve to two "
          "executables reading pools through the kernel")
    check(not eng.spec.prefix_sharing_capable,
          "zamba2: prefix sharing must be off for STATE archs")
    t0 = time.time()
    eng.warmup()
    torch.cuda.synchronize()
    emit("warmup", arch=cfg.name, path="legacy", buckets=eng.buckets,
         seconds=time.time() - t0)
    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    steps0 = eng.steps
    prefills = count_prefills(eng)
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    for k in ops.launches_by_dtype:
        ops.launches_by_dtype[k] = 0
    fa.launches = 0
    mops.launches = 0
    times = serve_legacy(torch, eng, reqs, sync_check=True)
    paged, flash, scans = ops.launches, fa.launches, mops.launches
    n_prefill = prefills["n"]
    micro = eng.steps - steps0
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    pstats = eng.prefix_stats()
    stats = eng.memory_stats()
    emit("zamba2_engine", arch=cfg.name, kv_dtype="fp32",
         requests=len(reqs), decode_micro_steps=micro, chunks=eng.chunks,
         full_prefills=n_prefill, mamba2_scan_launches=scans,
         flash_attention_launches=flash, paged_attention_launches=paged,
         generated_tokens=gen_tokens,
         generated_tokens_per_s=gen_tokens / times["wall_s"],
         ms_per_decode_micro_step=(times["decode_s"]
                                   / max(times["decode_micro_steps_timed"],
                                         1) * 1e3),
         sync_free_admission_and_chunk=True, host_syncs=eng.host_syncs,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         pool_bytes=stats["paged_kv_bytes"], memory_stats=stats,
         prefix_stats=pstats, leaked_pages=eng.leaked_pages(), **times)
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"zamba2 rid {r.rid}: {len(r.out_tokens)} tokens, "
              f"done={r.done}")
    check(pstats["prefix_hits"] == 0, "zamba2: prefix hits with sharing off")
    check(n_prefill > 0 and scans == n_mamba * n_prefill,
          f"zamba2: mamba2_scan launches {scans} != {n_mamba} x "
          f"{n_prefill} full prefills")
    check(flash == n_attn * n_prefill,
          f"zamba2: flash launches {flash} != {n_attn} x {n_prefill}")
    check(paged == n_attn * micro and ops.launches_by_dtype["fp32"] == paged,
          f"zamba2: paged launches {paged} != {n_attn} x {micro}")
    check(eng.leaked_pages() == 0, "zamba2: leaked pages")
    # a second wave, one of its decode chunks profiled
    for r in make_requests(rt["Request"], cfg.vocab_size, 8, seed=11,
                           rid0=100):
        eng.submit(r)
    eng.step()
    eng.step()
    try:
        prof = profile_chunk(torch, eng)
    except (RuntimeError, AttributeError) as e:   # an optional reading
        prof = {"measured": False, "reason": repr(e)}
    emit("profile", arch=cfg.name, path="legacy", kv_dtype="fp32", **prof)
    eng.run(max_steps=10 ** 6)
    check(eng.leaked_pages() == 0,
          "zamba2: leaked pages after the second wave")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"scans": scans, "flash": flash, "paged": paged,
            "prefills": n_prefill}


# ---------------------------------------------------------------------------
# Phase 5e: rwkv6-7b, attention-free, at full width and depth
# ---------------------------------------------------------------------------

def rwkv6_layer_check(torch, cfg, params, prompt) -> dict:
    """Each rwkv6 layer on the prefill's own input to it: its full
    prefill (one ``rwkv6_wkv`` launch over the prompt) against its
    recurrent path (a one-token prefill, then one decode step per
    token), on the layer's output rows and its state leaves, each within
    ``RWKV6_LAYER_TOL`` x max|want|.  Returns the worst error per layer."""
    from repro_torch.models import layers, transformer
    L = len(prompt)
    toks = torch.tensor(prompt[None], device=DEV)
    pos = torch.arange(L, device=DEV)[None]
    h = layers.embed(params["embed"], cfg, toks)
    worst = []
    for i, block in enumerate(cfg.blocks):
        def run(x, mode, cache, lp=params["layers"][i], block=block):
            return transformer._apply_block(
                lp, None, x, x, cfg, block, mode=mode, positions=pos,
                cache=cache, cache_len=None, paged_kernel=False)[:2]
        out, want = run(h, "prefill", None)
        rows, state = run(h[:, :1], "prefill", None)
        rows = [rows]
        for t in range(1, L):
            y, state = run(h[:, t:t + 1], "decode", state)
            rows.append(y)
        pairs = [("out", torch.cat(rows, 1), out)] + [
            (k, state[k], want[k]) for k in want]
        rel = {k: float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
               for k, g, w in pairs}
        key = max(rel, key=rel.get)
        worst.append((rel[key], key))
        check(all(bool(torch.isfinite(g).all()) for _k, g, _w in pairs),
              f"rwkv6 layer {i}: non-finite values")
        h = out
    return worst


def rwkv6_recurrent_check(torch, rt, cfg, params):
    """One prompt of 100 tokens through ``forward_prefill`` in its own
    bucket (128), in the 1024 bucket padded with 0s and padded with 9s
    (the rwkv6_wkv kernel), and through the recurrent path: a prefill of
    its first token, then ``forward_decode`` through the rest (the O(1)
    update).  Gates on the last-token logits and every layer's state
    leaves: the two pad tokens <= ``RWKV6_MASK_TOL`` x max|want| (the
    ``length`` masking); the recurrent path and the 1024 bucket against
    the 128 bucket <= ``RWKV6_PATH_TOL`` x max|want|; and, layer by
    layer on the prefill's own inputs, the recurrent path against the
    prefill <= ``RWKV6_LAYER_TOL`` (``rwkv6_layer_check``).  Returns the
    decode seconds."""
    import numpy as np
    L = 100
    rng = np.random.default_rng(29)
    prompt = rng.integers(1, cfg.vocab_size, L).astype(np.int32)
    length = torch.tensor([L], dtype=torch.int32, device=DEV)

    def leaves(lg, layers):
        out = {"logits": lg.reshape(-1)}
        for i, c in enumerate(layers):
            for key in ("wkv", "tshift", "cshift"):
                out[f"{key}{i}"] = c[key]
        return out

    def prefill(bucket, pad):
        padded = np.full((1, bucket), pad, np.int32)
        padded[0, :L] = prompt
        lg, cache = rt["forward_prefill"](
            params, cfg, {"tokens": torch.tensor(padded, device=DEV)},
            length=length)
        return leaves(lg, cache["layers"])

    want = prefill(128, 0)
    base = prefill(1024, 0)
    runs = {"pad9": prefill(1024, 9), "bucket1024": base}
    spec = rt["CacheSpec"].from_config(cfg, 1, 1024, page_size=16)
    cache = spec.init_paged_cache(torch.device(DEV))
    toks = torch.tensor(prompt, device=DEV)
    _, one = rt["forward_prefill"](params, cfg, {"tokens": toks[None, :1]})
    rt["admit_cache"](spec, cache, one, 0, 0, 1, {})
    torch.cuda.synchronize()
    t0 = time.time()
    for t in range(1, L):
        logits, cache = rt["forward_decode"](params, cfg, toks[None, t:t + 1],
                                             cache)
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    runs["recurrent"] = leaves(logits, cache["layers"])
    rec = {}
    for name, got in runs.items():
        ref = base if name == "pad9" else want
        check(all(bool(torch.isfinite(got[k]).all()) for k in got),
              f"rwkv6 {name}: non-finite values")
        rel = {k: float((got[k] - w).abs().max())
               / max(float(w.abs().max()), 1e-30) for k, w in ref.items()}
        worst = max(rel, key=rel.get)
        rec[name] = {"relative_err": rel[worst], "leaf": worst,
                     "logits_relative_err": rel["logits"],
                     "wkv_relative_err_by_layer": [
                         rel[f"wkv{i}"] for i in range(cfg.num_layers)]}
    by_layer = rwkv6_layer_check(torch, cfg, params, prompt)
    layer_worst = max(by_layer)
    emit("rwkv6_paths", prompt_len=L, decode_steps=L - 1,
         decode_s=decode_s, ms_per_batch1_decode_step=decode_s / (L - 1)
         * 1e3, state_leaves=len(want) - 1, mask_tol=RWKV6_MASK_TOL,
         path_tol=RWKV6_PATH_TOL, layer_tol=RWKV6_LAYER_TOL,
         pad_bucket_bitwise=all(bool(torch.equal(runs["pad9"][k], base[k]))
                                for k in base),
         same_argmax=bool(runs["recurrent"]["logits"].argmax()
                          == want["logits"].argmax()),
         layer_by_layer={"relative_err": layer_worst[0],
                         "leaf": layer_worst[1],
                         "layer": by_layer.index(layer_worst),
                         "relative_err_by_layer": [e for e, _k in by_layer]},
         **rec)
    for name, tol in (("pad9", RWKV6_MASK_TOL),
                      ("bucket1024", RWKV6_PATH_TOL),
                      ("recurrent", RWKV6_PATH_TOL)):
        check(rec[name]["relative_err"] <= tol,
              f"rwkv6 {name}: {rec[name]['relative_err']} x max|want| "
              f"({rec[name]['leaf']}) > {tol}")
    check(layer_worst[0] <= RWKV6_LAYER_TOL,
          f"rwkv6 layer {by_layer.index(layer_worst)}: recurrent vs "
          f"prefill {layer_worst[0]} x max|want| ({layer_worst[1]}) > "
          f"{RWKV6_LAYER_TOL}")
    return decode_s


def phase_rwkv6(torch, ops, fa, mops, wops, rt):
    """Full-width, full-depth rwkv6-7b (32 layers, fp32, random weights
    from seed 0): the prefill-vs-recurrent check, then the 12 requests
    through ``Engine(chunked_prefill="auto")``, which must resolve to two
    executables with no pools.  Counts are zeroed just before the run and
    read just after.  Returns the launch counts for the kernel line."""
    cfg = rt["get_config"]("rwkv6-7b")
    n_layers = sum(b.mixer == "rwkv6" for b in cfg.blocks)
    t0 = time.time()
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV)
    torch.cuda.synchronize()
    emit("params", arch=cfg.name, layers=cfg.num_layers,
         rwkv6_layers=n_layers, d_model=cfg.d_model,
         wkv_heads=cfg.d_model // cfg.rwkv.head_dim,
         params=sum(p.numel() for p in params.parameters()),
         param_bytes=sum(p.numel() * p.element_size()
                         for p in params.parameters()),
         seconds=time.time() - t0)
    rwkv6_recurrent_check(torch, rt, cfg, params)

    eng = rt["Engine"](cfg, params, slots=8, max_len=1024, page_size=16,
                       chunked_prefill="auto", device=DEV)
    check(not eng.chunked_prefill and not eng.paged_kernel,
          "rwkv6: chunked_prefill='auto' did not resolve to two "
          "executables with no pools to read")
    check(not eng.spec.has_paged and not eng.spec.prefix_sharing_capable,
          "rwkv6: the cache must hold no pools and share no prefixes")
    t0 = time.time()
    eng.warmup()
    torch.cuda.synchronize()
    emit("warmup", arch=cfg.name, path="legacy", buckets=eng.buckets,
         seconds=time.time() - t0)
    reqs = make_requests(rt["Request"], cfg.vocab_size, 12, seed=7, rid0=0)
    steps0 = eng.steps
    prefills = count_prefills(eng)
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    for k in ops.launches_by_dtype:
        ops.launches_by_dtype[k] = 0
    fa.launches = 0
    mops.launches = 0
    wops.launches = 0
    times = serve_legacy(torch, eng, reqs, sync_check=True)
    wkvs, paged, flash, scans = (wops.launches, ops.launches, fa.launches,
                                 mops.launches)
    n_prefill = prefills["n"]
    micro = eng.steps - steps0
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    pstats = eng.prefix_stats()
    stats = eng.memory_stats()
    emit("rwkv6_engine", arch=cfg.name, requests=len(reqs),
         decode_micro_steps=micro, chunks=eng.chunks,
         full_prefills=n_prefill, rwkv6_wkv_launches=wkvs,
         paged_attention_launches=paged, flash_attention_launches=flash,
         mamba2_scan_launches=scans, generated_tokens=gen_tokens,
         generated_tokens_per_s=gen_tokens / times["wall_s"],
         ms_per_decode_micro_step=(times["decode_s"]
                                   / max(times["decode_micro_steps_timed"],
                                         1) * 1e3),
         sync_free_admission_and_chunk=True, host_syncs=eng.host_syncs,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         state_bytes=sum(t.numel() * t.element_size()
                         for c in eng.cache["layers"] for t in c.values()),
         memory_stats=stats, prefix_stats=pstats,
         leaked_pages=eng.leaked_pages(), **times)
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"rwkv6 rid {r.rid}: {len(r.out_tokens)} tokens, "
              f"done={r.done}")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"rwkv6 rid {r.rid}: a token outside the vocabulary")
    check(pstats["prefix_hits"] == 0, "rwkv6: prefix hits with no pools")
    check(stats["num_pages"] == 0 and stats["pages_in_use"] == 0
          and stats["peak_pages_in_use"] == 0,
          f"rwkv6: pool pages in memory_stats: {stats['num_pages']} / "
          f"{stats['peak_pages_in_use']}")
    check(n_prefill > 0 and wkvs == n_layers * n_prefill,
          f"rwkv6: rwkv6_wkv launches {wkvs} != {n_layers} x "
          f"{n_prefill} full prefills")
    check(paged == 0 and flash == 0 and scans == 0,
          f"rwkv6: other kernels launched (paged {paged}, flash {flash}, "
          f"mamba2_scan {scans})")
    # the logits of one decode step on the engine's final state (a copy)
    cache = dict(eng.cache, len=eng.cache["len"].clone(),
                 layers=[{k: v.clone() for k, v in c.items()}
                         for c in eng.cache["layers"]])
    logits, _ = rt["forward_decode"](params, cfg, eng.state["tokens"][:, None],
                                     cache)
    check(bool(torch.isfinite(logits).all()), "rwkv6: non-finite logits")
    del cache, logits
    # a second wave, one of its decode chunks profiled
    wave = make_requests(rt["Request"], cfg.vocab_size, 8, seed=11,
                         rid0=100)
    for r in wave:
        eng.submit(r)
    eng.step()
    eng.step()
    try:
        prof = profile_chunk(torch, eng)
    except (RuntimeError, AttributeError) as e:   # an optional reading
        prof = {"measured": False, "reason": repr(e)}
    emit("profile", arch=cfg.name, path="legacy", kv_dtype="none", **prof)
    eng.run(max_steps=10 ** 6)
    check(all(r.done and len(r.out_tokens) == 32 for r in wave),
          "rwkv6: the second wave did not finish")
    empty = rwkv6_empty_prompt(rt, eng)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"wkvs": wkvs, "prefills": n_prefill, "empty_prompt": empty}


def rwkv6_empty_prompt(rt, eng) -> dict:
    """An empty prompt beside a 3-token one on the two-executable engine
    (admitted with a fresh state and len 0, as the reference admits it):
    both generate 8 tokens, and the neighbour's equal its solo run's."""
    R = rt["Request"]
    pair = [R(rid=300, prompt=[], max_new_tokens=8),
            R(rid=301, prompt=[4, 5, 6], max_new_tokens=8)]
    for r in pair:
        check(eng.submit(r) is None, f"rwkv6: rid {r.rid} rejected")
    eng.run(max_steps=10 ** 6)
    solo = R(rid=302, prompt=[4, 5, 6], max_new_tokens=8)
    check(eng.submit(solo) is None, "rwkv6: the solo request rejected")
    eng.run(max_steps=10 ** 6)
    rec = {"empty": list(pair[0].out_tokens),
           "neighbour": list(pair[1].out_tokens),
           "solo": list(solo.out_tokens)}
    emit("rwkv6_empty_prompt", **rec)
    check(all(r.done and len(r.out_tokens) == 8 for r in pair + [solo]),
          f"rwkv6 empty prompt: {rec}")
    check(rec["neighbour"] == rec["solo"],
          f"rwkv6 empty prompt: the neighbour's tokens moved: {rec}")
    return rec


# ---------------------------------------------------------------------------
# Phase 6: dbrx-132b, MoE at full width
# ---------------------------------------------------------------------------

def cut_depth(cfg, layers: int):
    """The first ``layers`` of a uniform stack: every width kept."""
    from repro_torch.configs.base import validate
    return validate(dataclasses.replace(cfg, num_layers=layers,
                                        blocks=cfg.blocks[:layers]))


def moe_recomposed(torch, moe, ref, p, x, cfg):
    """One MoE layer written out here from the port's ``route`` and
    ``_dispatch_indices`` with the plain ``moe_gmm_ref`` (boolean indexing
    and host syncs are fine outside the engine's path).  Returns y, the
    dispatched buffer [E,cap,d], the live rows per expert [E] and the
    hidden activations [E,cap,F] that enter the down product."""
    import torch.nn.functional as F
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    T = x2d.shape[0]
    check(moe._num_groups(T) == 1, f"{T} tokens make more than one group")
    cap = moe._capacity(T, m)
    top_p, top_e, _ = moe.route(p, x2d, m)
    slot, keep = moe._dispatch_indices(top_e, e, cap)
    kept = keep.reshape(-1)
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros(e * cap, d, dtype=x.dtype, device=x.device)
    buf[slot.reshape(-1)[kept]] = x2d[token[kept]]
    counts = torch.bincount(top_e.reshape(-1)[kept], minlength=e).to(
        torch.int32)
    buf = buf.view(e, cap, d)
    hidden = (F.silu(ref(buf, p["w_gate"], counts))
              * ref(buf, p["w_up"], counts))
    out = ref(hidden, p["w_down"], counts).reshape(e * cap, d)
    wts = (top_p * keep).reshape(-1, 1)
    y = (out[slot.reshape(-1)] * wts).reshape(T, k, d).sum(dim=1)
    return y.reshape(x.shape), buf, counts, hidden


def gmm_timing(torch, gmm, x, w, counts, flush, product: str) -> dict:
    """The kernel, its plain version and ``torch.bmm`` (fp32, TF32 off: a
    yardstick the port never calls) on one expert product of the main
    path, each with its device time from the profiler, and the bound:
    bytes of x, of the live experts' w and of the output over the memory
    rate against 2 * sum(counts) * D * F flops at the kernel's TF32
    products per fp32 product (3 for fp32) over the TF32 rate.  The rows
    the kernel computes ride along beside the live ones."""
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_rows_computed
    from repro_torch.kernels.tf32 import products
    E, C, D = x.shape
    F = w.shape[2]
    x4, c2 = x[None], counts[None]
    got = gmm.moe_gmm(x4, w, c2)
    want = gmm.moe_gmm_ref(x4, w, c2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= KERNEL_TOL, f"moe_gmm at the main shape: max abs err {err}")
    live = int((counts > 0).sum())
    nbytes = (x.numel() + live * D * F + E * C * F) * x.element_size()
    flops = 2 * int(counts.sum()) * D * F
    rec = {"shape": [E, C, D, F], "row_counts": counts.tolist(),
           "live_rows": int(counts.sum()),
           "rows_computed": moe_gmm_rows_computed(counts.tolist(), C),
           "max_abs_err": err, "bytes": nbytes, "flops": flops,
           **bounds(nbytes, flops, products(x.dtype, w.dtype))}
    calls = {"": lambda: gmm.moe_gmm(x4, w, c2),
             "plain_": lambda: gmm.moe_gmm_ref(x4, w, c2),
             "library_": lambda: torch.bmm(x, w)}
    for key, fn in calls.items():
        rec[key + "ms"] = cuda_ms(torch, fn, flush=flush)
        rec[key + "device_ms"], rec[key + "calls_traced"] = device_ms(
            torch, fn, flush=flush)
    roofline(rec, f"moe_gmm {product}")
    return rec


def phase_moe_chunk(torch, gmm, rt, cfg, params):
    """One teacher-forced chunk (8 slots x 32 tokens) through the model,
    reading each MoE layer's aux on the way; then the first MoE layer on
    that chunk's 256 tokens, through the kernel against the recomposed
    plain version, and the kernel timed on its expert products."""
    from repro_torch.models import moe
    eng = teacher_forced_engine(rt, cfg, params, "fp32")
    gen = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(1, cfg.vocab_size, (8, 32), generator=gen,
                         device=DEV, dtype=torch.int32)
    seen = []
    apply = moe.apply

    def spy(p, x, c, act="silu"):
        y, aux = apply(p, x, c, act)
        seen.append((p, x, aux))
        return y, aux

    moe.apply = spy
    try:
        logits, _ = rt["forward_verify"](params, cfg, toks, eng.cache,
                                         paged_kernel=True,
                                         spec_slack=eng.spec.spec_tokens)
    finally:
        moe.apply = apply
    del eng
    check(tuple(logits.shape) == (8, 32, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"teacher-forced logits {tuple(logits.shape)} not finite")
    check(len(seen) == len(cfg.blocks), f"{len(seen)} MoE layers ran")
    dropped = [float(aux["dropped_fraction"]) for _p, _x, aux in seen]
    emit("moe_chunk", arch=cfg.name, tokens=8 * 32,
         capacity=moe._capacity(8 * 32, cfg.moe),
         dropped_fraction_by_layer=dropped,
         load_balance_loss_by_layer=[float(a["load_balance_loss"])
                                     for _p, _x, a in seen])

    p, x, _aux = seen[0]
    y, _ = moe.apply(p, x, cfg)
    want, buf, counts, hidden = moe_recomposed(torch, moe, gmm.moe_gmm_ref,
                                               p, x, cfg)
    torch.cuda.synchronize()
    err = float((y - want).abs().max())
    emit("moe_layer", arch=cfg.name, tokens=x.shape[0] * x.shape[1],
         row_counts=counts.tolist(), max_abs_err=err, tol=MOE_LAYER_TOL,
         max_abs_y=float(want.abs().max()))
    check(bool(torch.isfinite(y).all()), "non-finite MoE layer output")
    check(err <= MOE_LAYER_TOL, f"MoE layer kernel vs plain: {err}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    timed = {"gate_up": gmm_timing(torch, gmm, buf, p["w_gate"], counts,
                                   flush, "gate_up"),
             "down": gmm_timing(torch, gmm, hidden, p["w_down"], counts,
                                flush, "down")}
    for name, rec in timed.items():
        emit("kernel_time", kernel="moe_gmm", product=name, **rec)
    return timed


def phase_dbrx(torch, ops, gmm, rt, cfg):
    """Serve the 12 requests on ``cfg`` (dbrx, depth cut) from fp32 pools,
    profile one chunk of a second wave, then the teacher-forced chunk."""
    t0 = time.time()
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV)
    torch.cuda.synchronize()
    emit("params", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         experts=cfg.moe.num_experts, top_k=cfg.moe.top_k, d_ff=cfg.d_ff,
         params=sum(p.numel() for p in params.parameters()),
         param_bytes=sum(p.numel() * p.element_size()
                         for p in params.parameters()),
         seconds=time.time() - t0)
    eng, launches, gmm_launches, _tokens = phase_engine(
        torch, ops, gmm, rt, cfg, params, "fp32")
    for r in make_requests(rt["Request"], cfg.vocab_size, 8, seed=11,
                           rid0=100):
        eng.submit(r)
    eng.step()
    eng.step()
    try:
        prof = profile_chunk(torch, eng)
    except (RuntimeError, AttributeError) as e:   # an optional reading
        prof = {"measured": False, "reason": repr(e)}
    emit("profile", arch=cfg.name, kv_dtype=eng.kv_dtype, **prof)
    eng.run(max_steps=10 ** 6)
    check(eng.leaked_pages() == 0,
          f"{cfg.name}: leaked pages after the second wave")
    del eng
    timed = phase_moe_chunk(torch, gmm, rt, cfg, params)
    return launches, gmm_launches, timed


# ---------------------------------------------------------------------------
# Phase 7: the last four archs (whisper-medium, gemma3-12b,
# mistral-large-123b, pixtral-12b)
# ---------------------------------------------------------------------------

def new_params(torch, rt, cfg, **extra):
    """Seed-0 weights on the card for ``cfg``; emits their size."""
    t0 = time.time()
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV)
    torch.cuda.synchronize()
    emit("params", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=[cfg.num_heads, cfg.num_kv_heads],
         head_dim=cfg.resolved_head_dim,
         params=sum(p.numel() for p in params.parameters()),
         param_bytes=sum(p.numel() * p.element_size()
                         for p in params.parameters()),
         seconds=time.time() - t0, **extra)
    return params


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_whisper(torch, ops, fa, rt) -> dict:
    """whisper-medium at full width and depth (24 encoder + 24 decoder
    layers, d 1024, 16 heads of 64): 8 rows of seeded stub frames [8,
    1500, 1024] x 0.1 and 16-token prompts through ``forward_prefill``
    (the encoder's non-causal flash over the frames, each decoder
    layer's cross-attention KV), ``prepare_decode_cache(max_len=80)`` and
    48 greedy ``forward_decode`` steps, each cross-attending through the
    flash kernel (Sq = 1 against 1500).  Gates: flash launches exactly
    24 (encoder) + 24 (decoder prefill) + 24 (cross prefill) + 24 x 48
    (cross decode) and no paged launch; every step's logits against
    ``forward_dense_logits`` over prompt + generated tokens (its own 72
    launches), within ``TF_TOL`` x max|logit| of that position."""
    cfg = rt["get_config"]("whisper-medium")
    B, plen, steps, max_len = 8, 16, 48, 80
    torch.cuda.reset_peak_memory_stats()
    params = new_params(torch, rt, cfg, enc_layers=cfg.enc_layers,
                        frames=cfg.frontend_len)
    gen = torch.Generator(device=DEV).manual_seed(31)
    frames = torch.randn(B, cfg.frontend_len, cfg.d_model, generator=gen,
                         device=DEV).mul_(0.1)
    prompts = torch.randint(1, cfg.vocab_size, (B, plen), generator=gen,
                            device=DEV, dtype=torch.int32)
    zero_launches([ops, fa])
    t0 = time.time()
    logits, cache = rt["forward_prefill"](
        params, cfg, {"tokens": prompts, "frames": frames})
    cache = rt["prepare_decode_cache"](cfg, cache, max_len)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    prefill_flash = fa.launches
    outs, toks = [logits], [logits.argmax(-1).to(torch.int32)]
    t0 = time.time()
    for _ in range(steps):
        logits, cache = rt["forward_decode"](params, cfg, toks[-1][:, None],
                                             cache)
        outs.append(logits)
        toks.append(logits.argmax(-1).to(torch.int32))
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    flash, paged = fa.launches, ops.launches
    L = cfg.num_layers
    want_flash = cfg.enc_layers + L + L + L * steps
    seq = torch.cat([prompts, torch.stack(toks[:steps], dim=1)], dim=1)
    fa.launches = 0
    dense = rt["forward_dense_logits"](params, cfg,
                                       {"tokens": seq, "frames": frames})
    torch.cuda.synchronize()
    dense_flash = fa.launches
    worst = 0.0
    for j, got in enumerate(outs):
        want = dense[:, plen - 1 + j]
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
    rec = {"arch": cfg.name, "rows": B, "prompt_len": plen,
           "decode_steps": steps, "max_len": max_len,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "ms_per_decode_step": decode_s / steps * 1e3,
           "flash_attention_launches": flash,
           "flash_attention_launches_prefill": prefill_flash,
           "flash_attention_launches_expected": want_flash,
           "flash_attention_launches_dense": dense_flash,
           "paged_attention_launches": paged,
           "worst_relative_logit_diff": worst, "tol": TF_TOL,
           "dense_argmax_equal": bool(
               (dense[:, plen - 1:].argmax(-1)
                == torch.stack(toks, dim=1)).all()),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit("whisper", **rec)
    check(bool(torch.isfinite(dense).all())
          and all(bool(torch.isfinite(o).all()) for o in outs),
          "whisper: non-finite logits")
    check(flash == want_flash, f"whisper: flash launches {flash} != "
                               f"{want_flash}")
    check(dense_flash == cfg.enc_layers + 2 * L,
          f"whisper: the dense pass launched flash {dense_flash} times")
    check(paged == 0, "whisper: the paged kernel ran")
    check(worst <= TF_TOL, f"whisper: decode logits differ from the dense "
                           f"pass by {worst} x max|logit|")
    del params, cache, dense, outs, frames
    free(torch)
    return rec


def serve_arch(torch, ops, fa, rt, cfg, params, reqs, *, max_len: int,
               fused: bool, kernel: bool, what: str) -> dict:
    """Serve ``reqs`` on one engine (8 slots, page 16, fp32 pools) with
    every count zeroed just before and read just after.  Gates: every
    request's budget emitted, 0 leaked pages; paged launches == layers x
    micro-steps on the kernel path and 0 on the gather path; flash
    launches == layers x full prefills on two executables, 0 fused."""
    eng = rt["Engine"](cfg, params, slots=8, max_len=max_len, page_size=16,
                       chunked_prefill=fused, paged_kernel=kernel,
                       device=DEV)
    check(eng.chunked_prefill == fused and eng.paged_kernel == kernel,
          f"{what}: engine mode")
    path = ("fused" if fused else "legacy") + (
        "_kernel" if kernel else "_gather")
    prefills = count_prefills(eng)
    steps0 = eng.steps
    zero_launches([ops, fa])
    torch.cuda.reset_peak_memory_stats()
    for r in reqs:
        check(eng.submit(r) is None, f"{what} rid {r.rid} rejected")
    t0 = time.time()
    while eng.queue or eng._live():
        eng.step()
    torch.cuda.synchronize()
    wall = time.time() - t0
    micro = eng.steps - steps0
    paged, flash, n_prefill = ops.launches, fa.launches, prefills["n"]
    L = cfg.num_layers
    gen = sum(len(r.out_tokens) for r in reqs)
    stats = eng.memory_stats()
    rec = {"arch": cfg.name, "path": path, "requests": len(reqs),
           "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "micro_steps": micro, "chunks": eng.chunks,
           "full_prefills": n_prefill, "paged_attention_launches": paged,
           "flash_attention_launches": flash, "wall_s": wall,
           "generated_tokens": gen, "generated_tokens_per_s": gen / wall,
           "ms_per_micro_step": wall / micro * 1e3,
           "pool_bytes": stats["paged_kv_bytes"],
           "pool_groups": {g.key: {"ring_blocks": g.ring_blocks,
                                   "num_pages": g.num_pages,
                                   "windowed": g.windowed}
                           for g in eng.spec.groups},
           "prefix_stats": eng.prefix_stats(),
           "leaked_pages": eng.leaked_pages(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(f"{what}_engine", **rec)
    for r in reqs:
        check(r.done and len(r.out_tokens) == r.max_new_tokens,
              f"{what} {path} rid {r.rid}: {len(r.out_tokens)} tokens")
    check(eng.leaked_pages() == 0, f"{what} {path}: leaked pages")
    want_paged = L * micro if kernel else 0
    check(paged == want_paged and ops.launches_by_dtype["fp32"] == paged,
          f"{what} {path}: paged launches {paged} != {want_paged}")
    want_flash = 0 if fused else L * n_prefill
    check((fused or n_prefill > 0) and flash == want_flash,
          f"{what} {path}: flash launches {flash} != {L} x {n_prefill}")
    rec["tokens"] = {r.rid: list(r.out_tokens) for r in reqs}
    rec["reqs"] = reqs
    del eng
    free(torch)
    return rec


def serve_four_ways(torch, ops, fa, rt, cfg, params, make_reqs, *,
                    max_len: int, what: str) -> dict:
    """Fused and two executables, each through the paged kernel and the
    gather path: greedy tokens equal between the two reads of each mode,
    the kernel runs' tokens teacher-forced.  Returns the kernel runs by
    mode."""
    runs = {}
    for fused in (True, False):
        mode = "fused" if fused else "legacy"
        got, want = (serve_arch(torch, ops, fa, rt, cfg, params, make_reqs(),
                                max_len=max_len, fused=fused, kernel=kernel,
                                what=what)
                     for kernel in (True, False))
        emit(f"{what}_kernel_vs_gather", path=mode,
             tokens=sum(len(v) for v in want["tokens"].values()),
             tokens_equal=same_tokens(want["tokens"], got["tokens"]))
        check(got["tokens"] == want["tokens"],
              f"{what} {mode}: kernel and gather tokens differ")
        teacher_forced_check(torch, rt, cfg, params, got["reqs"],
                             f"{what}_{mode}")
        runs[mode] = got
    return runs


def phase_gemma3(torch, ops, fa, rt) -> dict:
    """gemma3-12b at every width, its depth cut 48 -> ``GEMMA3_DEPTH``
    (its first 36 layers: five 1024-window layers for every global one,
    dh 256, vocab 262144; ~37 GB of fp32 weights) at ``max_len`` 4096:
    one 1500-token prompt, whose 1024-window rings wrap, beside 7 of the
    main traffic's requests, each 32 new tokens, served four ways
    (``serve_four_ways``)."""
    import numpy as np
    full = rt["get_config"]("gemma3-12b")
    cfg = cut_depth(full, GEMMA3_DEPTH)
    emit("depth_cut", arch=full.name, layers_full=full.num_layers,
         layers=cfg.num_layers,
         kept=f"the first {cfg.num_layers} of {full.num_layers} layers "
              "(the 5:1 window pattern whole); every width kept")
    torch.cuda.reset_peak_memory_stats()
    params = new_params(torch, rt, cfg,
                        windows=sorted({b.window or 0 for b in cfg.blocks}))
    long_prompt = np.random.default_rng(29).integers(
        1, cfg.vocab_size, GEMMA3_LONG).tolist()

    def make_reqs():
        return [rt["Request"](rid=0, prompt=list(long_prompt),
                              max_new_tokens=32)] + make_requests(
            rt["Request"], cfg.vocab_size, 7, seed=7, rid0=1)

    runs = serve_four_ways(torch, ops, fa, rt, cfg, params, make_reqs,
                           max_len=GEMMA3_MAX_LEN, what="gemma3")
    emit("gemma3_peak", peak_memory_bytes=torch.cuda.max_memory_allocated())
    del params
    free(torch)
    return runs


def phase_mistral(torch, ops, fa, rt, depth: int) -> dict:
    """mistral-large-123b with every width kept and its depth cut 88 ->
    ``depth`` (~5.5 GB of fp32 weights a layer): the 12 requests of the
    main traffic served four ways (``serve_four_ways``), with prefix
    hits and copy-on-write on every run; the paged kernel's first G = 12
    (96 query heads on 8 kv heads)."""
    full = rt["get_config"]("mistral-large-123b")
    cfg = cut_depth(full, depth)
    emit("depth_cut", arch=full.name, layers_full=full.num_layers,
         layers=cfg.num_layers,
         kept=f"the first {cfg.num_layers} of {full.num_layers} uniform "
              "attention + dense FFN blocks; every width kept")
    torch.cuda.reset_peak_memory_stats()
    params = new_params(torch, rt, cfg)
    runs = serve_four_ways(
        torch, ops, fa, rt, cfg, params,
        lambda: make_requests(rt["Request"], cfg.vocab_size, 12, seed=7,
                              rid0=0),
        max_len=1024, what="mistral")
    for mode, run in runs.items():
        check(run["prefix_stats"]["prefix_hits"] > 0
              and run["prefix_stats"]["cow_copies"] > 0,
              f"mistral {mode}: no prefix hit with copy-on-write")
    emit("mistral_peak", peak_memory_bytes=torch.cuda.max_memory_allocated())
    del params
    free(torch)
    return runs


def pixtral_requests(rt, cfg):
    """8 greedy requests of 1100-1800 prompt tokens, 32 new tokens each;
    every other one shares a 264-token head (the frontend covers it, and
    prefix sharing is off for a frontend arch)."""
    import numpy as np
    rng = np.random.default_rng(37)
    head = rng.integers(1, cfg.vocab_size, SHARED_HEAD).tolist()
    reqs = []
    for i in range(8):
        plen = int(rng.integers(1100, 1801))
        lead = head if i % 2 == 0 else []
        reqs.append(rt["Request"](
            rid=i, prompt=lead + rng.integers(
                1, cfg.vocab_size, plen - len(lead)).tolist(),
            max_new_tokens=32))
    return reqs


def phase_pixtral(torch, ops, fa, rt) -> dict:
    """pixtral-12b with nothing cut (40 layers, d 5120, vocab 131072;
    ~49 GB of fp32 weights): the 8 requests through ``Engine(slots=8,
    max_len=2048, page_size=16)``, whose ``"auto"`` must pick two
    executables (every prefill in the 2048 bucket with the zero
    frontend in its first 1024 positions), and through the port's
    ``ReferenceEngine`` (an exact-length prefill each).  Gates: the
    engine's (``serve_arch``) and no prefix hit; the reference's flash
    launches == 40 x 8 prefills, no paged launch; tokens equal between
    the two engines, or else both runs' tokens teacher-forced; the
    engine's tokens teacher-forced."""
    cfg = rt["get_config"]("pixtral-12b")
    torch.cuda.reset_peak_memory_stats()
    params = new_params(torch, rt, cfg, frontend_len=cfg.frontend_len)
    eng = rt["Engine"](cfg, params, slots=8, max_len=2048, page_size=16,
                       device=DEV)
    check(not eng.chunked_prefill and eng.paged_kernel,
          "pixtral: 'auto' did not pick two executables on the kernel")
    del eng
    run = serve_arch(torch, ops, fa, rt, cfg, params,
                     pixtral_requests(rt, cfg), max_len=2048, fused=False,
                     kernel=True, what="pixtral")
    check(run["prefix_stats"]["prefix_hits"] == 0,
          "pixtral: a prefix hit on a frontend arch")
    ref = rt["ReferenceEngine"](cfg, params, slots=8, max_len=2048,
                                device=DEV)
    reqs = pixtral_requests(rt, cfg)
    zero_launches([ops, fa])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for r in reqs:
        ref.submit(r)
    ref.run(max_steps=10 ** 6)
    torch.cuda.synchronize()
    wall = time.time() - t0
    ref_tokens = {r.rid: list(r.out_tokens) for r in reqs}
    L = cfg.num_layers
    same = same_tokens(ref_tokens, run["tokens"])
    rec = {"arch": cfg.name, "requests": len(reqs), "wall_s": wall,
           "steps": ref.steps, "flash_attention_launches": fa.launches,
           "paged_attention_launches": ops.launches,
           "tokens": sum(len(v) for v in ref_tokens.values()),
           "tokens_equal_to_engine": same,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit("pixtral_reference_engine", **rec)
    check(fa.launches == L * len(reqs) and ops.launches == 0,
          f"pixtral reference: flash {fa.launches}, paged {ops.launches}")
    for r in reqs:
        check(r.done and len(r.out_tokens) == 32,
              f"pixtral reference rid {r.rid}: {len(r.out_tokens)} tokens")
    del ref
    free(torch)
    teacher_forced_check(torch, rt, cfg, params, run["reqs"],
                         "pixtral_engine")
    if ref_tokens != run["tokens"]:
        teacher_forced_check(torch, rt, cfg, params, reqs,
                             "pixtral_reference")
    del params
    free(torch)
    return {"engine": run, "reference": rec}


# ---------------------------------------------------------------------------
# Phase 8: training — the backwards of flash_attention and moe_gmm, the
# scans' backward kernels and paged attention's refusal, one Trainer step
# on the card against the CPU (internlm2, reduced dbrx, zamba2, rwkv6),
# internlm2-1.8b at full width and depth, zamba2-7b and rwkv6-7b at full
# width, a checkpoint resume and the train launcher
# ---------------------------------------------------------------------------

TRAIN_GRAD_TOL = 1e-5   # x max|want|: kernel-forward grads vs autograd
                        # through the plain version, fp32, TF32 off
TRAIN_LOSS_RTOL = 1e-5  # card vs CPU, and a resumed run vs an unbroken one
TRAIN_STATE_TOL = 1e-4  # card vs CPU: grad_norm (rtol); m, v and params
                        # per leaf, max|diff| <= this x max|CPU|
TRAIN_B, TRAIN_S = 4, 1024
TRAIN_STEPS = 12
TRAIN_PARITY_LAYERS = 2
TRAIN_LAUNCHER_TIMEOUT_S = 300
TRAIN_LAUNCHER_ARCHS = ("internlm2-1.8b", "zamba2-7b", "rwkv6-7b")
# the scans' archs: full width, cut in depth to fit 16 bytes a parameter
# of training state beside the activations (zamba2 1.47 B params at 12 of
# 81 layers, both shared-attention groups in; rwkv6 1.86 B at 6 of 32)
ZAMBA2_TRAIN_DEPTH = 12
RWKV6_TRAIN_DEPTH = 6
TRAIN_SCAN_STEPS = 6
# card against CPU, one step: zamba2 at 6 layers (one shared block in)
# and rwkv6 at 2, B 2 x S 256 so that the CPU's step stays under ~20 s
SCAN_PARITY = (("zamba2-7b", 6), ("rwkv6-7b", 2))
SCAN_PARITY_B, SCAN_PARITY_S = 2, 256
# the scans' archs hold m, v and params at 2e-3 against the CPU: the
# CPU runs the JAX package's chunked forms (zamba2's a_log gradient ~2e-4
# x max|g| off float64 under its strong decays, where the kernels'
# per-step backward is within 1e-5: tests/test_torch_scan_grads.py), and
# rwkv6's fp32 gradients sit 2-4e-4 off float64 in both packages
# (tests/test_torch_train.py), on each side of the comparison.  The same
# step on the card with the scans' plain versions (plain_scans) gives
# the kernels' own share, held to the same bound
SCAN_STATE_TOL = 2e-3
# flash_attention's backward: name, shape, options (the training calls of
# internlm2, gemma2's windowed, softcapped dh 256 layers past the window,
# whisper's non-causal encoder)
FLASH_BWD_CASES = [
    ("internlm2_train", dict(B=4, H=16, Hkv=8, Sq=1024, Skv=1024, dh=128),
     {}),
    ("gemma2_w4096_cap50", dict(B=1, H=8, Hkv=4, Sq=4608, Skv=4608,
                                dh=256),
     dict(window=4096, softcap=50.0)),
    ("whisper_enc", dict(B=4, H=16, Hkv=16, Sq=1500, Skv=1500, dh=64),
     dict(causal=False)),
]
GMM_BWD_SHAPE = dict(E=16, C=80, D=6144, F=10752)   # dbrx's gate/up
# the query offset of context-parallel attention: the training shapes
# split into 2 and 4 query shards, each against the keys it attends to
# (gemma2 also in 16: only a shard under 512 queries leaves keys out)
FLASH_OFFSET_CASES = [
    ("internlm2_train", dict(B=4, H=16, Hkv=8, S=1024, dh=128), {}, (2, 4)),
    ("gemma2_w4096_cap50", dict(B=1, H=8, Hkv=4, S=4608, dh=256),
     dict(window=4096, softcap=50.0), (2, 4, 16)),
]
SHARDED_TRAIN_STEPS = 3


def rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def grad_ms(torch, out, inputs, grad, flush, iters: int = 30) -> float:
    """Median ms of one backward of ``out`` (its graph kept)."""
    return cuda_ms(torch, lambda: torch.autograd.grad(
        out, inputs, grad, retain_graph=True), iters=iters, flush=flush)


def phase_flash_grads(torch, fa) -> dict:
    """dq, dk, dv of ``flash_attention`` (the kernel's forward, the
    explicit-product backward) against ``torch.autograd.grad`` through
    ``flash_attention_ref`` on the same inputs, at ``FLASH_BWD_CASES``;
    each backward timed beside autograd through the plain version, SDPA's
    backward at the same shape (a yardstick: kv heads repeated outside the
    timed call, a window's band as a mask, no softcap) and its bound
    (10 dh flops per live (head, score): the scores recomputed, dP, dV,
    dQ, dK, on the fp32 CUDA cores, as the backward runs them)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(97531)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    out = {}
    for name, shape, opts in FLASH_BWD_CASES:
        B, H, Hkv, Sq, Skv, dh = (shape[k] for k in
                                  ("B", "H", "Hkv", "Sq", "Skv", "dh"))
        q = torch.randn(B, H, Sq, dh, generator=gen, device=DEV)
        k = torch.randn(B, Hkv, Skv, dh, generator=gen, device=DEV)
        v = torch.randn(B, Hkv, Skv, dh, generator=gen, device=DEV)
        do = torch.randn(B, H, Sq, dh, generator=gen, device=DEV)
        qk = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention(*qk, **opts)
        got = torch.autograd.grad(o, qk, do)
        qr = [t.clone().requires_grad_() for t in (q, k, v)]
        o_ref = fa.flash_attention_ref(*qr, **opts)
        want = torch.autograd.grad(o_ref, qr, do, retain_graph=True)
        torch.cuda.synchronize()
        errs = {nm: rel_err(torch, g, w)
                for nm, g, w in zip(("dq", "dk", "dv"), got, want)}
        for nm, g in zip(("dq", "dk", "dv"), got):
            check(bool(torch.isfinite(g).all()),
                  f"flash backward {name}: non-finite {nm}")
        check(max(errs.values()) <= TRAIN_GRAD_TOL,
              f"flash backward {name}: {errs} x max|want| > "
              f"{TRAIN_GRAD_TOL}")
        del got, want
        o = o.detach()
        _, _, live = flash_need(**shape, **opts)
        nbytes = 4 * (3 * B * H * Sq * dh + 2 * B * Hkv * Skv * dh
                      + B * H * Sq * dh + 2 * B * Hkv * Skv * dh)
        flops = 10 * B * H * live * dh
        rec = {"case": name, "shape": shape, "options": opts,
               "tol_relative": TRAIN_GRAD_TOL, "relative_err": errs,
               "ms": cuda_ms(torch, lambda: fa.flash_attention_bwd(
                   q, k, v, o, do, **opts), flush=flush),
               "plain_ms": grad_ms(torch, o_ref, qr, do, flush),
               "bytes": nbytes, "flops": flops, "live_scores": live,
               **bounds(nbytes, flops, 0)}
        del o_ref, qr
        g = H // Hkv
        qs = q.clone().requires_grad_()
        ks = k.repeat_interleave(g, dim=1).contiguous().requires_grad_()
        vs = v.repeat_interleave(g, dim=1).contiguous().requires_grad_()
        if opts.get("window") is not None:
            rows = torch.arange(Sq, device=DEV)[:, None]
            cols = torch.arange(Skv, device=DEV)[None, :]
            band = (cols > rows - opts["window"]) & (cols <= rows)
            o_lib = F.scaled_dot_product_attention(qs, ks, vs,
                                                   attn_mask=band)
        else:
            o_lib = F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=opts.get("causal", True))
        rec["library_ms"] = grad_ms(torch, o_lib, (qs, ks, vs), do, flush)
        rec["library"] = ("scaled_dot_product_attention backward"
                          + (" (no softcap)" if opts.get("softcap")
                             else ""))
        roofline(rec, f"flash backward {name}")
        emit("kernel_grad_check", kernel="flash_attention", **rec)
        out[name] = rec
        del q, k, v, do, o, o_lib, qs, ks, vs, qk
        free(torch)
    return out


def phase_flash_offset(torch, fa, cp_kv_slice) -> dict:
    """``flash_attention`` with ``q_offset`` at ``FLASH_OFFSET_CASES``:
    each shape split into 2 and 4 query shards as
    ``models/attention.cp_attention`` splits it (each shard's queries at
    their offset against the keys ``cp_kv_slice`` keeps), gemma2's also
    into 16, where its 4096 window drops keys from the slice.  Each shard's kernel output = its plain version
    (``KERNEL_TOL``); the shards' outputs concatenated = the unsharded
    kernel's (``KERNEL_TOL``), and their backwards (dq concatenated, dk
    and dv summed into the keys each shard got) = the unsharded
    backward's (``TRAIN_GRAD_TOL`` x max|want|).  Every shard call is
    timed beside the unsharded call (offset 0); the last shard (the
    largest offset) also beside its plain version, SDPA with the
    offset's mask and its bound.  These launches compare the kernel
    with its plain version and count on no path."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(8642)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    out = {}
    worst = 0.0
    for name, shape, opts, splits in FLASH_OFFSET_CASES:
        B, H, Hkv, S, dh = (shape[k] for k in ("B", "H", "Hkv", "S", "dh"))
        q = torch.randn(B, H, S, dh, generator=gen, device=DEV)
        k = torch.randn(B, Hkv, S, dh, generator=gen, device=DEV)
        v = torch.randn(B, Hkv, S, dh, generator=gen, device=DEV)
        do = torch.randn(B, H, S, dh, generator=gen, device=DEV)
        want = fa.flash_attention(q, k, v, **opts)
        want_g = fa.flash_attention_bwd(q, k, v, want, do, **opts)
        rec = {"case": name, "shape": shape, "options": opts,
               "ms_unsharded": cuda_ms(torch, lambda: fa.flash_attention(
                   q, k, v, **opts), flush=flush)}
        for n in splits:
            s_loc = S // n
            got = torch.empty_like(want)
            got_g = [torch.zeros_like(t) for t in (q, k, v)]
            ms, errs = [], []
            for i in range(n):
                start, klen = cp_kv_slice(i * s_loc, s_loc, S, True,
                                          opts.get("window"))
                off = i * s_loc - start
                rows = slice(i * s_loc, (i + 1) * s_loc)
                qs = q[:, :, rows].contiguous()
                ks = k[:, :, start:start + klen].contiguous()
                vs = v[:, :, start:start + klen].contiguous()
                o = fa.flash_attention(qs, ks, vs, q_offset=off, **opts)
                plain = fa.flash_attention_ref(qs, ks, vs, q_offset=off,
                                               **opts)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(o).all()),
                      f"flash offset {name} {n}/{i}: non-finite output")
                errs.append(float((o - plain).abs().max()))
                got[:, :, rows] = o
                dq, dk, dv = fa.flash_attention_bwd(
                    qs, ks, vs, o, do[:, :, rows].contiguous(),
                    q_offset=off, **opts)
                got_g[0][:, :, rows] = dq
                got_g[1][:, :, start:start + klen] += dk
                got_g[2][:, :, start:start + klen] += dv
                ms.append(cuda_ms(torch, lambda: fa.flash_attention(
                    qs, ks, vs, q_offset=off, **opts), flush=flush))
                del plain
            nbytes, flops, live = flash_need(
                B, H, Hkv, s_loc, klen, dh, window=opts.get("window"),
                q_offset=off)
            band = (torch.arange(klen, device=DEV)[None, :]
                    <= off + torch.arange(s_loc, device=DEV)[:, None])
            if opts.get("window") is not None:
                band &= (torch.arange(klen, device=DEV)[None, :]
                         > off + torch.arange(s_loc, device=DEV)[:, None]
                         - opts["window"])
            g = H // Hkv
            kr = ks.repeat_interleave(g, dim=1).contiguous()
            vr = vs.repeat_interleave(g, dim=1).contiguous()
            last = {"q_offset": off, "Sq": s_loc, "Skv": klen,
                    "ms": ms[-1], "plain_ms": cuda_ms(
                        torch, lambda: fa.flash_attention_ref(
                            qs, ks, vs, q_offset=off, **opts), flush=flush),
                    "library_ms": cuda_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qs, kr, vr, attn_mask=band), flush=flush),
                    "library": "scaled_dot_product_attention, the offset's "
                               "band as a mask" + (" (no softcap)" if
                                                   opts.get("softcap")
                                                   else ""),
                    "bytes": nbytes, "flops": flops, "live_scores": live,
                    **bounds(nbytes, flops, 3)}
            roofline(last, f"flash offset {name} {n} shards")
            err_sharded = float((got - want).abs().max())
            gerr = {nm: rel_err(torch, a, b) for nm, a, b in
                    zip(("dq", "dk", "dv"), got_g, want_g)}
            rec[f"shards_{n}"] = {
                "ms_each": ms, "ms_sum": sum(ms), "last": last,
                "max_abs_err_vs_plain": max(errs),
                "max_abs_err_vs_unsharded": err_sharded,
                "grad_rel_err_vs_unsharded": gerr}
            worst = max(worst, max(errs), err_sharded)
            check(max(errs) <= KERNEL_TOL, f"flash offset {name} {n} "
                  f"shards: {max(errs)} from plain > {KERNEL_TOL}")
            check(err_sharded <= KERNEL_TOL, f"flash offset {name} {n} "
                  f"shards: {err_sharded} from unsharded > {KERNEL_TOL}")
            check(max(gerr.values()) <= TRAIN_GRAD_TOL,
                  f"flash offset {name} {n} shards: backward {gerr} x "
                  f"max|want| > {TRAIN_GRAD_TOL}")
            del got, got_g, qs, ks, vs, kr, vr, band, o
        rec["tol"] = KERNEL_TOL
        rec["grad_tol_relative"] = TRAIN_GRAD_TOL
        emit("kernel_check", kernel="flash_attention_q_offset", **rec)
        out[name] = rec
        del q, k, v, do, want, want_g
        free(torch)
    out["max_abs_err"] = worst
    return out


def phase_gmm_grads(torch, gmm) -> dict:
    """dx, dw of ``moe_gmm`` (the kernel's forward, the explicit-product
    backward) against autograd through ``moe_gmm_ref`` at dbrx's gate/up
    shape with the pattern's partial row counts; dead rows' dx exactly 0.
    Timed beside autograd through the plain version, the two ``torch.bmm``
    products (a yardstick, every row) and the bound (4 D F flops per live
    row: dx and dw; fp32 CUDA cores)."""
    gen = torch.Generator(device=DEV).manual_seed(8642)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    E, C, D, Fd = (GMM_BWD_SHAPE[k] for k in ("E", "C", "D", "F"))
    x = torch.randn(E, C, D, generator=gen, device=DEV)
    w = torch.randn(E, D, Fd, generator=gen, device=DEV).mul_(D ** -0.5)
    dy = torch.randn(E, C, Fd, generator=gen, device=DEV)
    counts = gmm_pattern_counts(torch, 1, E, C)[0]
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(gmm.moe_gmm(xg, wg, counts), (xg, wg), dy)
    del xg, wg
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    o_ref = gmm.moe_gmm_ref(xr, wr, counts)
    want = torch.autograd.grad(o_ref, (xr, wr), dy, retain_graph=True)
    torch.cuda.synchronize()
    errs = {"dx": rel_err(torch, got[0], want[0]),
            "dw": rel_err(torch, got[1], want[1])}
    dead = (torch.arange(C, device=DEV)[None, :] >= counts[:, None])
    dead_zero = not bool(got[0][dead].any())
    check(dead_zero, "moe_gmm backward: dead rows got a nonzero dx")
    check(max(errs.values()) <= TRAIN_GRAD_TOL,
          f"moe_gmm backward: {errs} x max|want| > {TRAIN_GRAD_TOL}")
    del got, want
    live = int(counts.sum())
    nbytes = 4 * (2 * E * C * D + 2 * E * D * Fd + E * C * Fd) + 4 * E
    flops = 4 * live * D * Fd
    wt = w.transpose(1, 2)
    xt = x.transpose(1, 2)
    rec = {"case": "dbrx_gate_up", "shape": [E, C, D, Fd],
           "live_rows": live, "tol_relative": TRAIN_GRAD_TOL,
           "relative_err": errs, "dead_rows_dx_exactly_zero": dead_zero,
           "ms": cuda_ms(torch, lambda: gmm.moe_gmm_bwd(x, w, counts, dy),
                         flush=flush),
           "plain_ms": grad_ms(torch, o_ref, (xr, wr), dy, flush),
           "library_ms": cuda_ms(torch, lambda: (torch.bmm(dy, wt),
                                                 torch.bmm(xt, dy)),
                                 flush=flush),
           "library": "torch.bmm x 2 (dy w^T, x^T dy), every row",
           "bytes": nbytes, "flops": flops, **bounds(nbytes, flops, 0)}
    roofline(rec, "moe_gmm backward")
    emit("kernel_grad_check", kernel="moe_gmm", **rec)
    del x, w, dy, xr, wr, o_ref, wt, xt
    free(torch)
    return rec


# the scans' backwards: kernel, name, shape (the model's layout), h0 and
# dh_final given, decay (``mamba_inputs``: "strong" is a = -16 with dt up
# to 1.5; ``rwkv_inputs``: "mixed" is half the channels at lw = -5, half
# at |lw| ~ 3.4e-4).  The training shapes (zamba2-7b and rwkv6-7b at B 4,
# S 1024) are timed; S = 1000 is not a multiple of the chunks.
ZAMBA2_TRAIN = dict(B=4, H=112, S=1024, P=64, N=64)
RWKV6_TRAIN = dict(B=4, H=64, S=1024, K=64)
SCAN_BWD_CASES = [
    ("mamba2_scan", "zamba2_train", ZAMBA2_TRAIN, False, "default"),
    ("mamba2_scan", "zamba2_s1000_h0", dict(B=4, H=112, S=1000, P=64,
                                            N=64), True, "default"),
    ("mamba2_scan", "zamba2_train_strong", ZAMBA2_TRAIN, False, "strong"),
    ("rwkv6_wkv", "rwkv6_train", RWKV6_TRAIN, False, "default"),
    ("rwkv6_wkv", "rwkv6_s1000_h0", dict(B=4, H=64, S=1000, K=64), True,
     "default"),
    ("rwkv6_wkv", "rwkv6_train_mixed", RWKV6_TRAIN, False, "mixed"),
]
SCAN_BWD_TIMED = ("zamba2_train", "rwkv6_train")
# each backward kernel against its own algebra in plain PyTorch
# (``mamba2_scan_chunked_bwd_ref``, ``rwkv6_wkv_chunked_bwd_ref``) at
# these cases
SCAN_BWD_VS_CHUNKED = ("zamba2_s1000_h0", "rwkv6_s1000_h0")
SCAN_FWD_NOISE = 0.15   # the no-grad forward's device time against phase 3's
SCAN_PLAIN_ITERS = 5    # autograd through the plain versions: ~0.6-0.8 s a
                        # call, so the median of 5
SCAN_GRAD_NAMES = {"mamba2_scan": ("dx", "ddt", "db", "dc", "da_log", "dh0"),
                   "rwkv6_wkv": ("dr", "dk", "dv", "dlw", "du", "dh0")}


def mamba_plain_model(mops, x, dt, b, c, a_log, h0):
    """The model layout through the plain per-step version, as the CPU
    branch of ``scan_model_layout`` runs it (b/c broadcast to every head,
    a to every batch row), so autograd sums db, dc over the heads and da
    over the batch."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    y, hf = mops.mamba2_scan_ref(
        x.transpose(1, 2).reshape(B * H, S, P),
        dt.transpose(1, 2).reshape(B * H, S),
        b[:, None].expand(B, H, S, N).reshape(B * H, S, N),
        c[:, None].expand(B, H, S, N).reshape(B * H, S, N),
        (-a_log.exp())[None].expand(B, H).reshape(B * H),
        None if h0 is None else h0.reshape(B * H, N, P))
    return y.reshape(B, H, S, P).transpose(1, 2), hf.reshape(B, H, N, P)


def wkv_plain_model(wops, r, k, v, lw, u, h0):
    """The model layout through the plain per-step version (u broadcast to
    every batch row, so autograd sums du over the batch)."""
    B, S, H, K = r.shape

    def flat(z):
        return z.transpose(1, 2).reshape(B * H, S, K)
    y, hf = wops.rwkv6_wkv_ref(
        flat(r), flat(k), flat(v), flat(lw),
        u[None].expand(B, H, K).reshape(B * H, K),
        None if h0 is None else h0.reshape(B * H, K, K))
    return y.reshape(B, H, S, K).transpose(1, 2), hf.reshape(B, H, K, K)


def scan_bwd_need(kernel: str, B, H, S, h0, P=None, N=None, K=None):
    """Bytes and flops of one backward call.  Bytes: its inputs read once
    (the forward's operands, dy, and dh_final and h0 when given) and its
    gradients written once, fp32.  Flops of the per-step recurrence: 12
    per state element and step on the fp32 CUDA cores (the state
    recomputed, g_t's update and the four sums over it: one multiply-add
    each).  And the products of the chunked backward that each kernel runs
    (chunks of ``CHUNK_ROWS``, the last ragged; q(q + 1) / 2 causal pairs
    in a chunk of q rows), 2 flops a multiply-add.  mamba2_scan: C B^T on
    the causal pairs once per b/c stream (a batch row), and per head dM =
    dY X^T, M^T dY, dSc B and dSc^T C on the causal pairs (x P, P, N, N)
    and U, Z, B G, dY h^T and X G^T (q N P each).  rwkv6_wkv, per head: A,
    dA = dY V^T and A^T dY on the causal pairs and dR's and dK's pivot
    products on the pairs below the diagonal (x K each), and R~^T dY, K~ G,
    dY h^T and V G^T (q K^2 each)."""
    bh = B * H

    def pairs(rows: int, strict: bool) -> int:
        total = 0
        for t0 in range(0, S, rows):
            q = min(rows, S - t0)
            total += q * (q - 1) // 2 if strict else q * (q + 1) // 2
        return total
    if kernel == "mamba2_scan":
        from repro_torch.kernels.mamba2_scan.ref import CHUNK_ROWS
        state = N * P
        per_call = 2 * bh * S * P + bh * S + 2 * B * S * N + H
        nbytes = 4 * (2 * per_call - bh * S * P
                      + (3 if h0 else 0) * bh * state)
        causal = pairs(CHUNK_ROWS, False)
        chunk_flops = 2 * causal * N * B \
            + bh * (2 * causal * (2 * P + 2 * N) + 10 * S * N * P)
    else:
        from repro_torch.kernels.rwkv6_wkv.ref import CHUNK_ROWS
        state = K * K
        nbytes = 4 * (9 * bh * S * K + 2 * H * K
                      + (3 if h0 else 0) * bh * state)
        chunk_flops = 2 * bh * K * (3 * pairs(CHUNK_ROWS, False)
                                    + 2 * pairs(CHUNK_ROWS, True)
                                    + 4 * S * K)
    return nbytes, 12 * bh * S * state, chunk_flops


def mamba_vs_chunked_ref(torch, mops, call, dy, dhf, got) -> dict:
    """The kernel's gradients ``got`` (model layout) against
    ``mamba2_scan_chunked_bwd_ref`` on the same inputs broadcast to the
    kernel's layout, summed as the kernel sums them: relative errors by
    gradient."""
    from repro_torch.kernels.mamba2_scan.ref import (
        mamba2_scan_chunked_bwd_ref)
    x, dt, b, c, a_log, h0 = call
    B, S, H, P = x.shape
    N = b.shape[-1]
    a = -torch.exp(a_log)
    with torch.no_grad():
        dx, ddt, db, dc, da, dh0 = mamba2_scan_chunked_bwd_ref(
            x.transpose(1, 2).reshape(B * H, S, P),
            dt.transpose(1, 2).reshape(B * H, S),
            b[:, None].expand(B, H, S, N).reshape(B * H, S, N),
            c[:, None].expand(B, H, S, N).reshape(B * H, S, N),
            a[None].expand(B, H).reshape(B * H),
            None if h0 is None else h0.reshape(B * H, N, P),
            dy.transpose(1, 2).reshape(B * H, S, P),
            None if dhf is None else dhf.reshape(B * H, N, P))
        want = [dx.reshape(B, H, S, P).transpose(1, 2),
                ddt.reshape(B, H, S).transpose(1, 2),
                db.reshape(B, H, S, N).sum(1), dc.reshape(B, H, S, N).sum(1),
                da.reshape(B, H).sum(0) * a]
        if h0 is not None:
            want.append(dh0.reshape(B, H, N, P))
        torch.cuda.synchronize()
        out = {nm: rel_err(torch, g, w) for nm, g, w in
               zip(SCAN_GRAD_NAMES["mamba2_scan"], got, want)}
    del dx, ddt, db, dc, da, dh0, want
    free(torch)
    return out


def wkv_vs_chunked_ref(torch, call, dy, dhf, got) -> dict:
    """The rwkv6 kernel's gradients ``got`` (model layout) against
    ``rwkv6_wkv_chunked_bwd_ref`` on the same inputs in the kernel's
    layout, du summed over the batch rows as the kernel sums it: relative
    errors by gradient."""
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_chunked_bwd_ref
    r, k, v, lw, u, h0 = call
    B, S, H, K = r.shape

    def flat(z):
        return z.transpose(1, 2).reshape(B * H, S, K)

    def back(z):
        return z.reshape(B, H, S, K).transpose(1, 2)
    with torch.no_grad():
        dr, dk, dv, dlw, du, dh0 = rwkv6_wkv_chunked_bwd_ref(
            flat(r), flat(k), flat(v), flat(lw),
            u[None].expand(B, H, K).reshape(B * H, K),
            None if h0 is None else h0.reshape(B * H, K, K), flat(dy),
            None if dhf is None else dhf.reshape(B * H, K, K))
        want = [back(dr), back(dk), back(dv), back(dlw),
                du.reshape(B, H, K).sum(0)]
        if h0 is not None:
            want.append(dh0.reshape(B, H, K, K))
        torch.cuda.synchronize()
        out = {nm: rel_err(torch, g, w) for nm, g, w in
               zip(SCAN_GRAD_NAMES["rwkv6_wkv"], got, want)}
    del dr, dk, dv, dlw, du, dh0, want
    free(torch)
    return out


def phase_scan_grads(torch, mops, wops, ops, mamba_timed, rwkv_timed
                     ) -> dict:
    """The two scans' backward kernels under autograd at ``SCAN_BWD_CASES``
    in the model's layout: every gradient against ``torch.autograd.grad``
    through the plain per-step version on the same inputs, within
    ``KERNEL_TOL`` x its max|want|; two calls the same bits; one forward
    and one backward launch a call; at ``SCAN_BWD_VS_CHUNKED`` each
    kernel also against its algebra in plain PyTorch
    (``mamba2_scan_chunked_bwd_ref``, ``rwkv6_wkv_chunked_bwd_ref``)
    within ``KERNEL_TOL``.  The training shapes' backwards timed (``ms``,
    ``device_ms``) beside autograd through the plain version and the
    bound (``scan_bwd_need``: the chunked form's products in 3xTF32, with
    the per-step CUDA-core bound beside it); no library call computes a
    scan.  Then each forward kernel again at S 1024 with no gradient
    wanted: its device time within ``SCAN_FWD_NOISE`` of phase 3's.  And
    ``paged_attention``, which never trains, still refuses under autograd
    and launches nothing there."""
    gen = torch.Generator(device=DEV).manual_seed(4321)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    out = {}
    for kernel, name, shape, h0, decay in SCAN_BWD_CASES:
        mod = mops if kernel == "mamba2_scan" else wops
        if kernel == "mamba2_scan":
            call, _ = mamba_inputs(torch, gen, **shape, layout="model",
                                   h0=h0, decay=decay)
            call = tuple(None if t is None else t.contiguous() for t in call)
            op = mops.scan_model_layout
            plain = lambda *t: mamba_plain_model(mops, *t)  # noqa: E731
        else:
            call, _ = rwkv_inputs(torch, gen, **shape, layout="model",
                                  h0=h0, decay=decay)
            op = wops.wkv_model_layout
            plain = lambda *t: wkv_plain_model(wops, *t)  # noqa: E731
        names = [nm for nm, t in zip(SCAN_GRAD_NAMES[kernel], call)
                 if t is not None]
        with torch.no_grad():
            y0, hf0 = op(*call)
        dy = torch.randn(y0.shape, generator=gen, device=DEV)
        dhf = torch.randn(hf0.shape, generator=gen, device=DEV) \
            if h0 else None
        del y0, hf0

        def graph(fn):
            ins = [t.clone().requires_grad_() for t in call if t is not None]
            it = iter(ins)
            y, hf = fn(*[next(it) if t is not None else None for t in call])
            outs, cots = ([y, hf], [dy, dhf]) if h0 else ([y], [dy])
            return ins, outs, cots
        before = (mod.launches, mod.bwd_launches)
        ins, outs, cots = graph(op)
        got = torch.autograd.grad(outs, ins, cots, retain_graph=True)
        launched = [mod.launches - before[0], mod.bwd_launches - before[1]]
        again = torch.autograd.grad(outs, ins, cots, retain_graph=True)
        p_ins, p_outs, _ = graph(plain)
        want = torch.autograd.grad(p_outs, p_ins, cots, retain_graph=True)
        torch.cuda.synchronize()
        errs = {nm: rel_err(torch, g, w) for nm, g, w in
                zip(names, got, want)}
        same = all(bool(torch.equal(g, g2)) for g, g2 in zip(got, again))
        for nm, g in zip(names, got):
            check(bool(torch.isfinite(g).all()),
                  f"{kernel} backward {name}: non-finite {nm}")
        rec = {"kernel": kernel, "case": name, "shape": shape, "h0": h0,
               "dh_final": h0, "decay": decay, "layout": "model",
               "tol_relative": KERNEL_TOL, "relative_err": errs,
               "two_calls_bitwise_equal": same,
               "launches_one_call": launched}
        if name in SCAN_BWD_VS_CHUNKED:
            rec["relative_err_vs_chunked_ref"] = (
                mamba_vs_chunked_ref(torch, mops, call, dy, dhf, got)
                if kernel == "mamba2_scan"
                else wkv_vs_chunked_ref(torch, call, dy, dhf, got))
            check(max(rec["relative_err_vs_chunked_ref"].values())
                  <= KERNEL_TOL,
                  f"{kernel} backward {name} vs the chunked plain backward:"
                  f" {rec['relative_err_vs_chunked_ref']} x max|want| > "
                  f"{KERNEL_TOL}")
        check(max(errs.values()) <= KERNEL_TOL,
              f"{kernel} backward {name}: {errs} x max|want| > "
              f"{KERNEL_TOL}")
        check(same, f"{kernel} backward {name}: two calls differ")
        check(launched == [1, 1], f"{kernel} backward {name}: launches "
                                  f"{launched} != [1, 1]")
        del got, again, want
        if name in SCAN_BWD_TIMED:
            nbytes, flops, chunk_flops = scan_bwd_need(kernel, **shape,
                                                       h0=h0)
            # 3xTF32 products; the per-step CUDA-core bound beside
            rec.update(bytes=nbytes, flops=chunk_flops, per_step_flops=flops,
                       **bounds(nbytes, chunk_flops, 3))
            rec["bound_per_step_ms"] = max(
                nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            rec["ms"] = grad_ms(torch, outs, ins, cots, flush)
            rec["device_ms"], rec["calls_traced"] = device_ms(
                torch, lambda: torch.autograd.grad(outs, ins, cots,
                                                   retain_graph=True),
                flush)
            rec["plain_ms"] = grad_ms(torch, p_outs, p_ins, cots, flush,
                                      iters=SCAN_PLAIN_ITERS)
            rec["plain_iters"] = SCAN_PLAIN_ITERS
            rec["library_ms"] = None
            rec["library"] = "none: no PyTorch call computes a scan"
            roofline(rec, f"{kernel} backward {name}")
        emit("kernel_grad_check", **rec)
        out[name] = rec
        del ins, outs, p_ins, p_outs, cots, call, dy, dhf
        free(torch)
    # the forward kernels with no gradient wanted, at phase 3's timed shape
    fwd = {}
    for kernel, mod, case, timed in (
            ("mamba2_scan", mops, "zamba2_full", mamba_timed),
            ("rwkv6_wkv", wops, "rwkv6_full", rwkv_timed)):
        if kernel == "mamba2_scan":
            call, _ = mamba_inputs(torch, gen, B=1, H=112, S=1024, P=64,
                                   N=64, layout="model", h0=False)
            op = mops.scan_model_layout
        else:
            call, _ = rwkv_inputs(torch, gen, B=1, H=64, S=1024, K=64,
                                  layout="model", h0=False)
            op = wops.wkv_model_layout
        with torch.no_grad():
            ms = cuda_ms(torch, lambda: op(*call), flush=flush)
            dms, traced = device_ms(torch, lambda: op(*call), flush)
        ref = timed[case]["device_ms"]
        rec = {"kernel": kernel, "case": case, "ms": ms, "device_ms": dms,
               "calls_traced": traced, "phase3_ms": timed[case]["ms"],
               "phase3_device_ms": ref, "noise_bound": SCAN_FWD_NOISE}
        emit("scan_forward_no_grad", **rec)
        if dms is not None and ref is not None:
            check(abs(dms / ref - 1.0) <= SCAN_FWD_NOISE,
                  f"{kernel} forward without grad: {dms} ms device vs "
                  f"{ref} ms in phase 3")
        fwd[kernel] = rec
        del call
    # paged_attention never trains: it refuses under autograd
    q = torch.randn(2, 1, 4, 16, generator=gen, device=DEV)
    pool = torch.randn(9, 4, 2, 16, generator=gen, device=DEV)
    table = torch.arange(1, 9, dtype=torch.int32, device=DEV).view(2, 4)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=DEV)
    before = ops.launches
    by_dtype = dict(ops.launches_by_dtype)
    try:
        ops.paged_attention(q.clone().requires_grad_(), pool, pool, table,
                            lens)
        refused = False
    except RuntimeError as e:
        refused = "has no backward" in str(e)
    with torch.no_grad():      # serving: no grad, the kernel launches
        ops.paged_attention(q.clone().requires_grad_(), pool, pool, table,
                            lens)
    torch.cuda.synchronize()
    launched = ops.launches - before
    emit("train_refusal", kernel="paged_attention", refused=refused,
         launches_under_autograd=launched - 1)
    check(refused, "paged_attention under autograd did not refuse")
    check(launched == 1, f"paged_attention launches around the refusal: "
                         f"{launched}")
    ops.launches = before
    ops.launches_by_dtype.update(by_dtype)
    free(torch)
    return {"grads": out, "forward_no_grad": fwd}


def state_rel_errs(torch, rt, got_state, want_state,
                   worst_leaf: Optional[dict] = None) -> dict:
    """Per part (params, m, v): the worst over leaves of max|diff| /
    max|want|, ``got`` on the card and ``want`` on the CPU (or the card).
    ``worst_leaf``, when given, takes each part's worst leaf's name."""
    names = {id(p): n for n, p in got_state["params"].named_parameters()}
    order = [names.get(id(p), "?")
             for p in rt["tree_leaves"](got_state["params"])]
    out = {}
    for part, g, w in (
            ("params", got_state["params"], want_state["params"]),
            ("m", got_state["opt"]["m"], want_state["opt"]["m"]),
            ("v", got_state["opt"]["v"], want_state["opt"]["v"])):
        worst, at = 0.0, None
        for i, (a, b) in enumerate(zip(rt["tree_leaves"](g),
                                       rt["tree_leaves"](w))):
            err = rel_err(torch, a.detach(), b.detach().to(DEV))
            if err > worst or at is None:
                worst, at = err, order[i]
        out[part] = worst
        if worst_leaf is not None:
            worst_leaf[part] = at
    return out


@contextlib.contextmanager
def plain_scans(mops, wops):
    """The scans' model-layout entry points on CUDA tensors swapped for
    their plain per-step versions under autograd (the CPU adapters'
    broadcast, on the card), so one training step can run with and
    without the scan kernels on the same device."""
    saved = (mops.scan_model_layout, wops.wkv_model_layout)

    def mamba(xh, dt, b_in, c_in, a_log, h0=None):
        return mamba_plain_model(mops, xh, dt, b_in, c_in, a_log, h0)

    def wkv(rh, kh, vh, lwh, uh, h0=None):
        return wkv_plain_model(wops, rh, kh, vh, lwh, uh, h0)
    mops.scan_model_layout, wops.wkv_model_layout = mamba, wkv
    try:
        yield
    finally:
        mops.scan_model_layout, wops.wkv_model_layout = saved


def train_parity(torch, kernel_ops: dict, rt, cfg, what: str,
                 fwd_per_step: dict, *, batch: int = TRAIN_B,
                 seq: int = TRAIN_S, state_tol: float = TRAIN_STATE_TOL,
                 plain_swap=None) -> dict:
    """One ``Trainer`` step (``batch`` x ``seq``, fp32, TF32 off) on the
    card (the kernels) and on the CPU (the plain versions) from the same
    seed-0 weights and batch.  Gates: loss at ``TRAIN_LOSS_RTOL``,
    grad_norm at ``TRAIN_STATE_TOL``, and params, m and v after the update
    within ``state_tol``; each kernel of ``kernel_ops`` (name -> ops
    module) launched forward and backward ``fwd_per_step[name]`` times
    (0 when absent) on the card.  With ``plain_swap`` (a context manager
    that swaps kernels for their plain versions on the card) the same
    step runs once more on the card inside it: the kernels' own share of
    the difference from the CPU, recorded per part with its worst leaf;
    the two card steps' loss and grad_norm must agree at
    ``TRAIN_LOSS_RTOL`` and their params, m and v within ``state_tol``
    (a leaf whose gradient is a long sum that cancels, rwkv6's
    ``bonus_u``, differs by ~1.5e-4 x its max between two fp32 orders)."""
    import copy
    tc = rt["TrainerConfig"](steps=1, batch=batch, seq_len=seq,
                             log_every=1)
    cpu_params = rt["init_params"](rt["model_defs"](cfg), 0, device="cpu",
                                   trainable=True)
    card_params = copy.deepcopy(cpu_params).to(DEV)
    zero_launches(kernel_ops.values())
    t0 = time.time()
    card = rt["Trainer"](cfg, tc, device=DEV, params=card_params)
    card.run()
    card_s = time.time() - t0
    launched = {name: [op.launches, op.bwd_launches]
                for name, op in kernel_ops.items()}
    gr = card.metrics_history[0]
    plain = None
    if plain_swap is not None:
        # the same step on the card with the scans' plain versions: the
        # kernels' own share of any difference from the CPU
        with plain_swap():
            other = rt["Trainer"](cfg, tc, device=DEV,
                                  params=copy.deepcopy(cpu_params).to(DEV))
            other.run()
        pr = other.metrics_history[0]
        plain = {"loss": pr["loss"], "grad_norm": pr["grad_norm"],
                 "loss_rel_err": abs(gr["loss"] - pr["loss"])
                 / abs(pr["loss"]),
                 "grad_norm_rel_err": abs(gr["grad_norm"] - pr["grad_norm"])
                 / abs(pr["grad_norm"]), "worst_leaf": {}}
        plain["state_rel_err"] = state_rel_errs(
            torch, rt, card.state, other.state, plain["worst_leaf"])
        del other
        free(torch)
    t0 = time.time()
    host = rt["Trainer"](cfg, tc, device="cpu", params=cpu_params)
    host.run()
    cpu_s = time.time() - t0
    hr = host.metrics_history[0]
    worst = {}
    errs = state_rel_errs(torch, rt, card.state, host.state, worst)
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "batch": [batch, seq], "loss_card": gr["loss"],
           "loss_cpu": hr["loss"], "grad_norm_card": gr["grad_norm"],
           "grad_norm_cpu": hr["grad_norm"],
           "loss_rel_err": abs(gr["loss"] - hr["loss"]) / abs(hr["loss"]),
           "grad_norm_rel_err": abs(gr["grad_norm"] - hr["grad_norm"])
           / abs(hr["grad_norm"]), "state_rel_err": errs,
           "worst_leaf": worst, "card_vs_card_plain_scans": plain,
           "launches": launched, "card_seconds": card_s,
           "cpu_seconds": cpu_s,
           "tol": {"loss_rtol": TRAIN_LOSS_RTOL,
                   "grad_norm_rtol": TRAIN_STATE_TOL,
                   "state_rtol": state_tol,
                   "card_plain_rtol": [TRAIN_LOSS_RTOL, TRAIN_LOSS_RTOL,
                                       state_tol]}}
    emit("train_parity", what=what, **rec)
    if plain is not None:
        check(plain["loss_rel_err"] <= TRAIN_LOSS_RTOL
              and plain["grad_norm_rel_err"] <= TRAIN_LOSS_RTOL
              and max(plain["state_rel_err"].values()) <= state_tol,
              f"train parity {what}: the scan kernels against their plain "
              f"versions on the card: {plain}")
    check(rec["loss_rel_err"] <= TRAIN_LOSS_RTOL,
          f"train parity {what}: loss {gr['loss']} vs {hr['loss']}")
    check(rec["grad_norm_rel_err"] <= TRAIN_STATE_TOL,
          f"train parity {what}: grad_norm {gr['grad_norm']} vs "
          f"{hr['grad_norm']}")
    check(max(errs.values()) <= state_tol,
          f"train parity {what}: state {errs}")
    for name in kernel_ops:
        n = fwd_per_step.get(name, 0)
        check(launched[name] == [n, n],
              f"train parity {what}: {name} launches {launched[name]} != "
              f"[{n}, {n}]")
    del card, host, cpu_params, card_params
    free(torch)
    return rec


def scan_launches_per_step(cfg) -> dict:
    """Each scan kernel's forward (and backward) launches a training step
    of ``cfg`` (zamba2: one ``mamba2_scan`` a Mamba2 block and one
    ``flash_attention`` a shared-attention block; rwkv6: one
    ``rwkv6_wkv`` a layer)."""
    kinds = [b.mixer for b in cfg.blocks]
    return {"mamba2_scan": kinds.count("mamba2"),
            "flash_attention": kinds.count("shared_attn"),
            "rwkv6_wkv": kinds.count("rwkv6")}


def phase_scan_parity(torch, train_ops: dict, rt) -> dict:
    """``train_parity`` for the scans' archs at ``SCAN_PARITY``'s depths
    (B ``SCAN_PARITY_B``, S ``SCAN_PARITY_S``), with the card step also
    run with the scans' plain versions (``plain_scans``)."""
    out = {}
    for arch, depth in SCAN_PARITY:
        cfg = cut_depth(rt["get_config"](arch), depth)
        what = arch.split("-")[0]
        out[what] = timed_phase(
            f"train_parity_{what}", train_parity, torch, train_ops, rt,
            cfg, what, scan_launches_per_step(cfg), batch=SCAN_PARITY_B,
            seq=SCAN_PARITY_S, state_tol=SCAN_STATE_TOL,
            plain_swap=lambda: plain_scans(train_ops["mamba2_scan"],
                                           train_ops["rwkv6_wkv"]))
    return out


TRAIN_PARTS = ("train_forward", "train_backward", "train_update")


def profile_train_step(torch, rt, tr) -> dict:
    """One more step of ``tr`` under ``torch.profiler``, its three parts
    (``forward_train``, ``backward``, the AdamW update) each ended by a
    synchronize inside its own ``record_function`` range: per part the
    host wall ms, the device ms by kernel family (the flash kernel, the
    scan kernels, library matrix products, everything else) and the idle
    share."""
    from torch.profiler import ProfilerActivity, profile, record_function
    params = tr.state["params"]
    batch = rt["to_device"](tr.data.batch_at(0), torch.device(DEV))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(TRAIN_PARTS[0]):
            loss, _ = rt["forward_train"](params, tr.cfg, batch)
            torch.cuda.synchronize()
        with record_function(TRAIN_PARTS[1]):
            loss.backward()
            torch.cuda.synchronize()
        with record_function(TRAIN_PARTS[2]):
            rt["adamw"].update(None, tr.state["opt"], params, tr.ocfg,
                               tr.ocfg.lr)
            torch.cuda.synchronize()
    for p in params.parameters():
        p.grad = None
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    # each range's host-side event; its device-side annotation (a CUDA
    # event of the same name spanning the range) is not a kernel
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in events
              if e.name in TRAIN_PARTS and e.device_type != cuda}
    out = {}
    for part in TRAIN_PARTS:
        lo, hi = ranges[part]
        fam = {"flash_attention": 0.0, "scan": 0.0, "matmul": 0.0,
               "other": 0.0}
        n = 0
        for e in events:
            if e.device_type != cuda or e.name in TRAIN_PARTS \
                    or not lo <= e.time_range.start < hi:
                continue
            n += 1
            name = e.name.lower()
            key = ("flash_attention" if "flash_attention" in name else
                   "scan" if ("mamba2_scan" in name or "rwkv6_wkv" in name)
                   else "matmul" if ("gemm" in name or "gemv" in name
                                or "cutlass" in name) else "other")
            fam[key] += e.time_range.elapsed_us() / 1e3
        wall = (hi - lo) / 1e3
        busy = sum(fam.values())
        out[part] = {"wall_ms": wall, "device_busy_ms": busy,
                     "device_ms_by_family": fam, "device_kernels": n,
                     "idle_share": max(0.0, 1.0 - busy / wall)
                     if wall else None}
    return out


def train_full(torch, ops, kernel_ops: dict, rt, card, cfg, steps: int,
               per_step: dict) -> dict:
    """``Trainer`` on ``cfg`` for ``steps`` steps at B ``TRAIN_B``, S
    ``TRAIN_S``, fp32, from seed-0 weights.  Counts zeroed just before
    ``run`` and read just after.  Gates: every loss finite, the last below
    the first, grad_norm finite and > 0, each kernel of ``kernel_ops``
    launched forward and backward ``per_step[name]`` times a step (0 when
    absent), and no paged attention.  Records ms a step (the median after
    the first), tokens/s, peak memory and the per-part profile of one
    more step."""
    t0 = time.time()
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV,
                               trainable=True)
    tc = rt["TrainerConfig"](steps=steps, batch=TRAIN_B, seq_len=TRAIN_S,
                             log_every=1)
    tr = rt["Trainer"](cfg, tc, device=DEV, params=params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit("params", arch=cfg.name, layers=cfg.num_layers, trainable=True,
         params=n_params, param_bytes=4 * n_params,
         state_bytes=16 * n_params, seconds=time.time() - t0)
    torch.cuda.reset_peak_memory_stats()
    zero_launches([ops, *kernel_ops.values()])
    t0 = time.time()
    res = tr.run()
    wall = time.time() - t0
    launched = {name: [op.launches, op.bwd_launches]
                for name, op in kernel_ops.items()}
    launched["paged_attention"] = ops.launches
    hist = res["history"]
    losses = [r["loss"] for r in hist]
    norms = [r["grad_norm"] for r in hist]
    step_ms = sorted(r["step_time_s"] * 1e3 for r in hist[1:])
    med = step_ms[len(step_ms) // 2]
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "steps": len(hist),
           "params": n_params, "batch": [TRAIN_B, TRAIN_S],
           "losses": losses, "grad_norms": norms,
           "lrs": [r["lr"] for r in hist],
           "step_ms": [r["step_time_s"] * 1e3 for r in hist],
           "ms_per_step_median_after_first": med,
           "tokens_per_s": TRAIN_B * TRAIN_S / (med / 1e3),
           "wall_s": wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launched, "launches_per_step_want": per_step,
           "stragglers": len(res["stragglers"]), "card": card}
    emit("train_full", **rec)
    check(len(hist) == steps, f"train {cfg.name}: {len(hist)} logged steps")
    check(all(math.isfinite(x) for x in losses),
          f"train {cfg.name}: losses {losses}")
    check(losses[-1] < losses[0],
          f"train {cfg.name}: the loss did not fall: {losses}")
    check(all(math.isfinite(x) and x > 0 for x in norms),
          f"train {cfg.name}: grad norms {norms}")
    for name in kernel_ops:
        n = per_step.get(name, 0) * steps
        check(launched[name] == [n, n],
              f"train {cfg.name}: {name} launches {launched[name]} != "
              f"[{n}, {n}]")
    check(ops.launches == 0,
          f"train {cfg.name}: paged attention launched {ops.launches}")
    try:
        rec["profile"] = profile_train_step(torch, rt, tr)
    except (RuntimeError, KeyError) as e:    # an optional reading
        rec["profile"] = {"measured": False, "reason": repr(e)}
    emit("profile", arch=cfg.name, path="train_step", **rec["profile"])
    del tr, params, res
    free(torch)
    return rec


def phase_train_full(torch, ops, kernel_ops: dict, rt, card) -> dict:
    """The slice's first main path at full size: internlm2-1.8b at full
    width and all 24 layers, ``TRAIN_STEPS`` steps (params, grads, m and
    v ~30 GB; activations ~20 GB; the logits [4096, 92544] ~1.5 GB a
    copy): flash forward and backward 24 a step each, no other kernel."""
    cfg = rt["get_config"]("internlm2-1.8b")
    return train_full(torch, ops, kernel_ops, rt, card, cfg, TRAIN_STEPS,
                      {"flash_attention": cfg.num_layers})


def phase_sharded_train(torch, fa, rt, card, train: dict) -> dict:
    """The sharded step on a one-rank NCCL mesh: internlm2-1.8b uncut
    under the tuner's guideline plan at ``data = model = 1`` (its rules
    from ``core/tuner.make_rules`` on a ``("data", "model")``
    ``DeviceMesh``), a ``Trainer`` built inside ``axis_rules`` (the
    params placed, ZeRO-1 moments), ``SHARDED_TRAIN_STEPS`` steps of the
    schedule ``train_full`` ran, on its seed and data.  Gates: each
    step's loss and grad_norm within ``TRAIN_LOSS_RTOL`` of
    ``train_full``'s, flash forward and backward launched once a layer a
    step (counts zeroed just before ``run``), every param and moment
    placed.  Records ms a step beside ``train_full``'s.  The process
    group is destroyed before it returns."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tuner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh
    store = tempfile.mkdtemp()
    mesh_lib.join_process_group("nccl", rank=0, world_size=1,
                                init_method=f"file://{store}/store")
    try:
        cfg = rt["get_config"]("internlm2-1.8b")
        mesh = mesh_lib.device_mesh((1, 1), ("data", "model"))
        plan = tuner.guideline_plan(cfg, ShapeConfig(
            "phase8_train", "train", TRAIN_S, TRAIN_B), model_axis=1,
            data_axis=1)
        rules = tuner.make_rules(plan, mesh)
        params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV,
                                   trainable=True)
        tc = rt["TrainerConfig"](steps=TRAIN_STEPS, batch=TRAIN_B,
                                 seq_len=TRAIN_S, log_every=1)
        with sh.axis_rules(rules):
            tr = rt["Trainer"](cfg, tc, device=DEV, params=params)
        del params
        free(torch)
        leaves = rt["tree_leaves"](tr.state["params"])
        moments = rt["tree_leaves"](tr.state["opt"]["m"])
        check(all(sh.placement(x) is not None for x in leaves + moments),
              "sharded_train: a param or moment is not placed")
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.bwd_launches = 0
        t0 = time.time()
        res = tr.run(steps=SHARDED_TRAIN_STEPS)
        wall = time.time() - t0
        launched = [fa.launches, fa.bwd_launches]
        hist = res["history"]
        n = len(hist)
        losses = [r["loss"] for r in hist]
        norms = [r["grad_norm"] for r in hist]
        want_l, want_n = train["losses"][:n], train["grad_norms"][:n]
        rel = {"loss": max(abs(a - b) / abs(b) for a, b in
                           zip(losses, want_l)),
               "grad_norm": max(abs(a - b) / abs(b) for a, b in
                                zip(norms, want_n))}
        step_ms = sorted(r["step_time_s"] * 1e3 for r in hist[1:])
        rec = {"arch": cfg.name, "layers": cfg.num_layers, "steps": n,
               "batch": [TRAIN_B, TRAIN_S], "mesh": mesh_lib.describe(mesh),
               "plan": {k: getattr(plan, k) for k in (
                   "name", "data", "pools", "intra", "fsdp", "seq_shard",
                   "cp")},
               "rules_fallbacks": rules.fallbacks,
               "losses": losses, "grad_norms": norms,
               "train_full_losses": want_l, "train_full_grad_norms": want_n,
               "rel_err_vs_train_full": rel, "tol_relative": TRAIN_LOSS_RTOL,
               "step_ms": [r["step_time_s"] * 1e3 for r in hist],
               "ms_per_step_median_after_first": step_ms[len(step_ms) // 2],
               "train_full_ms_per_step_median_after_first":
                   train["ms_per_step_median_after_first"],
               "wall_s": wall,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "launches": {"flash_attention": launched}, "card": card}
        emit("sharded_train", **rec)
        check(n == SHARDED_TRAIN_STEPS, f"sharded_train: {n} logged steps")
        check(max(rel.values()) <= TRAIN_LOSS_RTOL,
              f"sharded_train: {rel} from train_full > {TRAIN_LOSS_RTOL}")
        want = cfg.num_layers * n
        check(launched == [want, want],
              f"sharded_train: flash launches {launched} != [{want}, "
              f"{want}]")
        del tr, res, leaves, moments
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    free(torch)
    return rec


def phase_train_scans(torch, ops, kernel_ops: dict, rt, card) -> dict:
    """zamba2-7b and rwkv6-7b at full width, cut in depth to fit fp32
    params, grads, m and v (16 bytes a parameter) beside their
    activations on the card: ``TRAIN_SCAN_STEPS`` steps each.  zamba2 at
    ``ZAMBA2_TRAIN_DEPTH`` layers keeps both shared-attention groups (its
    layers 5 and 11): 10 ``mamba2_scan`` and 2 ``flash_attention`` each
    way a step; rwkv6 at ``RWKV6_TRAIN_DEPTH``: 6 ``rwkv6_wkv`` each way
    a step; no other kernel."""
    out = {}
    for arch, depth in (("zamba2-7b", ZAMBA2_TRAIN_DEPTH),
                        ("rwkv6-7b", RWKV6_TRAIN_DEPTH)):
        full = rt["get_config"](arch)
        cfg = cut_depth(full, depth)
        kinds = [b.mixer for b in cfg.blocks]
        emit("depth_cut", arch=full.name, layers_full=full.num_layers,
             layers=cfg.num_layers,
             kept=f"the first {cfg.num_layers} of {full.num_layers} "
                  f"blocks ({dict((k, kinds.count(k)) for k in kinds)}); "
                  "every width kept; training state 16 bytes a parameter")
        out[arch] = timed_phase(f"train_full_{arch}", train_full, torch,
                                ops, kernel_ops, rt, card, cfg,
                                TRAIN_SCAN_STEPS,
                                scan_launches_per_step(cfg))
    return out


def phase_train_resume(torch, rt, cfg) -> dict:
    """``TRAIN_PARITY_LAYERS`` layers at full width: 6 steps with
    ``ckpt_every=3`` into a temporary directory, then a fresh ``Trainer``
    restores step 3 and replays 3..5; the final loss must be the unbroken
    run's at ``TRAIN_LOSS_RTOL`` (the embedding's backward sums with
    atomics on the card, so not bitwise)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tc = rt["TrainerConfig"](steps=6, batch=TRAIN_B, seq_len=TRAIN_S,
                                 ckpt_dir=d, ckpt_every=3, log_every=1)
        t0 = time.time()
        t1 = rt["Trainer"](cfg, tc, device=DEV)
        t1.run()
        full_s = time.time() - t0
        loss_full = t1.metrics_history[-1]["loss"]
        latest = rt["ckpt"].latest_step(d)
        del t1
        free(torch)
        t0 = time.time()
        t3 = rt["Trainer"](cfg, dataclasses.replace(tc, ckpt_dir=None),
                           device=DEV)
        _, step = rt["ckpt"].restore(d, t3.state, step=3)
        restored_step = int(t3.state["step"])
        t3.run()
        resumed_s = time.time() - t0
    replay = t3.metrics_history
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "latest_step": latest,
           "restored_step": restored_step,
           "replayed_steps": [r["step"] for r in replay],
           "loss_full": loss_full, "loss_resumed": replay[-1]["loss"],
           "rel_err": abs(replay[-1]["loss"] - loss_full) / abs(loss_full),
           "tol_rtol": TRAIN_LOSS_RTOL, "full_run_s": full_s,
           "resumed_run_s": resumed_s}
    emit("train_resume", **rec)
    check(latest == 6 and step == 3 and restored_step == 3,
          f"resume: latest {latest}, restored {step}/{restored_step}")
    check(rec["replayed_steps"] == [3, 4, 5],
          f"resume: replayed {rec['replayed_steps']}")
    check(rec["rel_err"] <= TRAIN_LOSS_RTOL,
          f"resume: loss {replay[-1]['loss']} vs {loss_full}")
    del t3
    free(torch)
    return rec


def train_launcher_run(env, arch: str) -> dict:
    """One ``launch.train --smoke`` subprocess: its lines and seconds."""
    argv = ["--arch", arch, "--smoke", "--steps", "4"]
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=TRAIN_LAUNCHER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"train launcher {arch}: no exit within "
                           f"{TRAIN_LAUNCHER_TIMEOUT_S} s")
    return {"argv": argv, "rc": proc.returncode,
            "lines": proc.stdout.strip().splitlines(),
            "seconds": time.time() - t0,
            "stderr_tail": proc.stderr.splitlines()[-20:]}


def phase_train_launcher(torch) -> dict:
    """``python -m repro_torch.launch.train --arch ARCH --smoke --steps 4``
    as a subprocess on the card for internlm2-1.8b, zamba2-7b and
    rwkv6-7b (the scans' backward kernels under the launcher), the three
    at once (each mostly its start-up): exit 0, its step lines and its
    final line, each."""
    env = port_env()
    with ThreadPoolExecutor(len(TRAIN_LAUNCHER_ARCHS)) as pool:
        futures = {arch: pool.submit(train_launcher_run, env, arch)
                   for arch in TRAIN_LAUNCHER_ARCHS}
        out = {arch: f.result() for arch, f in futures.items()}
    for arch, rec in out.items():
        lines = rec["lines"]
        emit("train_launcher", **rec)
        check(rec["rc"] == 0, f"train launcher {arch}: exit {rec['rc']}")
        check(bool(lines) and re.match(
            r"^final loss: \d+\.\d{4}  stragglers flagged: \d+$",
            lines[-1]), f"train launcher {arch}: last line {lines[-1:]!r}")
        check(sum(bool(re.match(r"^step +\d+ loss ", ln)) for ln in lines)
              == 2, f"train launcher {arch}: step lines {lines}")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the paper's tuning machinery and its figures
# ---------------------------------------------------------------------------

PAPER_MOE_TOL = 1e-4   # x max|y|: fig04's kernel path vs sync and plain
PAPER_LOSS_TOL = 1e-5  # relative: fig01's loss, kernel vs plain attention
FIG01_TIMEOUT_S = 120


def paper_moe_paths(torch, gmm, cfg, params, x) -> dict:
    """fig04's MoE layer on its own tensors three ways: ``moe.apply``
    through the kernel, ``apply_sync_schedule`` (a plain product per
    expert) and ``moe.apply`` with the plain ``moe_gmm_ref`` in the
    kernel's place.  Comparison launches: made after the counts are
    read."""
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
    from repro_torch.models import moe
    kernel = gmm.moe_gmm
    with torch.no_grad():
        y, aux = moe.apply(params, x, cfg)
        y_sync, _ = moe.apply_sync_schedule(params, x, cfg)
        gmm.moe_gmm = moe_gmm_ref
        try:
            y_plain, _ = moe.apply(params, x, cfg)
        finally:
            gmm.moe_gmm = kernel
    scale = float(y_plain.abs().max())
    return {"max_abs_y": scale,
            "vs_sync": float((y - y_sync).abs().max()) / scale,
            "vs_plain": float((y - y_plain).abs().max()) / scale,
            "dropped_fraction": float(aux["dropped_fraction"]),
            "finite": bool(torch.isfinite(y).all())}


def paper_flash_paths(torch, fa, cfg, params, batch) -> dict:
    """fig01's step on its own weights and tokens with ``flash_attention``
    and with the plain ``flash_attention_ref`` in its place: the
    ``forward_train`` loss and ``forward_dense_logits``' logits, each
    from the same dense pass.  Comparison launches: made after the counts
    are read."""
    from repro_torch.models import forward_dense_logits, forward_train
    kernel = fa.flash_attention
    with torch.no_grad():
        loss = float(forward_train(params, cfg, batch)[0])
        logits = forward_dense_logits(params, cfg, batch)
        fa.flash_attention = fa.flash_attention_ref
        try:
            plain_loss = float(forward_train(params, cfg, batch)[0])
            plain_logits = forward_dense_logits(params, cfg, batch)
        finally:
            fa.flash_attention = kernel
    return {"loss": loss, "plain_loss": plain_loss,
            "loss_rel_err": abs(loss - plain_loss) / abs(plain_loss),
            "max_logit_diff": float((logits - plain_logits).abs().max()),
            "max_abs_logit": float(plain_logits.abs().max()),
            "finite": bool(torch.isfinite(logits).all())}


def fig01_fresh() -> dict:
    """``python -m repro_torch.benchmarks.fig01_breakdown`` in a process
    of its own, so that its first step is a true first call (the kernel
    library's load, cuBLAS's set-up, the allocator's growth): exit 0 and
    its two rows, in seconds."""
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.benchmarks.fig01_breakdown",
             "--device", "cuda"], cwd=ROOT, env=port_env(),
            capture_output=True, text=True, timeout=FIG01_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"fig01: no exit within {FIG01_TIMEOUT_S} s")
    rows = {}
    for ln in proc.stdout.splitlines():
        name, _, rest = ln.partition(",")
        if name in ("fig01.first_step", "fig01.steady_step"):
            us, _, derived = rest.partition(",")
            rows[name] = {"s": float(us) * 1e-6, "derived": derived}
    rec = {"rc": proc.returncode, "rows": rows,
           "seconds": time.time() - t0,
           "stderr_tail": proc.stderr.splitlines()[-20:]}
    emit("paper_fig01_fresh_process", **rec)
    check(proc.returncode == 0, f"fig01 in its own process: exit "
                                f"{proc.returncode}")
    check(len(rows) == 2 and all(r["s"] > 0 for r in rows.values()),
          f"fig01 in its own process: rows {rows}")
    return rec


def phase_paper(torch, kernel_ops, gmm, fa, card) -> dict:
    """The paper's tuning machinery on the card: the port's ``Hardware()``
    beside what the card reports; fig04's MoE half at dbrx-132b's full
    width (``moe_gmm`` launched 3 times per ``apply``, the output against
    the sync schedule and the plain ``moe_gmm`` within 1e-4 x max|y|);
    fig01 on internlm2-1.8b at full width and depth (24 ``flash_attention``
    launches a forward, a finite loss, the loss and logits against the
    plain ``flash_attention_ref``'s; the figure again in a process of its
    own for a true first step); fig13's three GEMMs (no kernel of
    the port); fig04's cost half, fig06 and fig18 on ``Hardware()`` (a
    row per cell; the guideline's plan fits wherever the optimum's
    does).  Every kernel count is zeroed just before each figure and read
    just after."""
    from repro_torch.benchmarks import fig01_breakdown as fig01
    from repro_torch.benchmarks import fig04_scheduling as fig04
    from repro_torch.benchmarks import fig06_heatmap as fig06
    from repro_torch.benchmarks import fig13_library as fig13
    from repro_torch.benchmarks import fig18_guideline_eval as fig18
    from repro_torch.configs import ARCH_IDS
    from repro_torch.core import cost_model
    t0 = time.time()
    hw = cost_model.Hardware()
    emit("paper_hardware", port_hardware=dataclasses.asdict(hw),
         nvidia_smi=card,
         total_memory=torch.cuda.get_device_properties(0).total_memory,
         source="data-sheet figures of the H100 SXM5 80GB, not measured")

    cfg, params, x = fig04.moe_layer_inputs(DEV)
    torch.cuda.synchronize()
    zero_launches(kernel_ops)
    moe_rec = fig04.moe_layer_comparison(cfg, params, x)
    gmm_launches = gmm.launches
    others = other_launches(kernel_ops, gmm)
    paths = paper_moe_paths(torch, gmm, cfg, params, x)
    del params, x
    free(torch)
    emit("paper_fig04_moe", gmm_launches=gmm_launches, **moe_rec, **paths)
    check(cfg.d_model == 6144 and cfg.d_ff == 10752
          and cfg.moe.num_experts == 16 and cfg.moe.top_k == 4,
          "fig04: not dbrx-132b's MoE layer at full width")
    check(gmm_launches == 3 * moe_rec["calls"],
          f"fig04: {gmm_launches} moe_gmm launches for {moe_rec['calls']} "
          "calls of moe.apply (3 each)")
    check(others == 0, "fig04 launched another kernel")
    check(paths["finite"], "fig04: a non-finite output")
    check(paths["vs_sync"] <= PAPER_MOE_TOL
          and paths["vs_plain"] <= PAPER_MOE_TOL,
          f"fig04: kernel path off by {paths['vs_sync']:.3g} (sync) and "
          f"{paths['vs_plain']:.3g} (plain) x max|y|")

    dev = torch.device(DEV)
    cfg01, params01, batch01 = fig01.step_inputs(dev)
    torch.cuda.synchronize()
    zero_launches(kernel_ops)
    rec01 = fig01.breakdown(cfg01, params01, batch01, dev)
    flash01 = fa.launches
    others = other_launches(kernel_ops, fa)
    paths01 = paper_flash_paths(torch, fa, cfg01, params01, batch01)
    del params01, batch01
    free(torch)
    # this process has loaded the kernels and grown the allocator: its
    # first step is a warm one
    emit("paper_fig01", flash_attention_launches=flash01, process="warm",
         **rec01, paths=paths01)
    check(rec01["arch"] == "internlm2-1.8b" and rec01["layers"] == 24,
          f"fig01: {rec01['arch']} at {rec01['layers']} layers")
    check(flash01 == rec01["layers"] * rec01["forwards"],
          f"fig01: {flash01} flash launches for {rec01['forwards']} "
          f"forwards of {rec01['layers']} attention layers")
    check(others == 0, "fig01 launched another kernel")
    check(rec01["loss_finite"], f"fig01: loss {rec01['loss']}")
    check(rec01["first_step_s"] > 0 and rec01["steady_step_s"] > 0,
          "fig01: a non-positive time")
    check(paths01["finite"], "fig01: non-finite logits")
    check(paths01["loss_rel_err"] <= PAPER_LOSS_TOL
          and paths01["max_logit_diff"] <= PATH_TOL,
          f"fig01: kernel vs plain attention: loss off by "
          f"{paths01['loss_rel_err']:.3g} (relative), logits by "
          f"{paths01['max_logit_diff']:.3g}")
    fresh01 = fig01_fresh()

    zero_launches(kernel_ops)
    rows13 = fig13.main(["--device", "cuda"])
    check(other_launches(kernel_ops, None) == 0,
          "fig13 launched a kernel of the port")
    check(len(rows13) == 8 and all(
        math.isfinite(r["gflops"]) and r["gflops"] > 0 for r in rows13),
        f"fig13: rows {rows13}")
    emit("paper_fig13", rows=rows13)

    prod = fig04.prod_estimates()
    rows06 = fig06.main([])
    res18 = fig18.main([])
    check(len(prod) == len(ARCH_IDS), f"fig04 cost half: {len(prod)} rows")
    check(len(rows06) == 12, f"fig06: {len(rows06)} rows")
    check(len(res18["rows"]) == len(fig18.FIG18_SHAPES) * len(ARCH_IDS),
          f"fig18: {len(res18['rows'])} rows")
    unfit = [r["name"] for r in res18["rows"]
             if r["global_optimum"]["fits"] and not r["guideline"]["fits"]]
    check(not unfit, f"fig18: the guideline's plan does not fit in {unfit}")
    emit("paper_analytic", fig04_prod=prod, fig06=rows06,
         fig18_summary=res18["summary"],
         fig18_guideline_pools={r["name"]: r["guideline"]["pools"]
                                for r in res18["rows"]})
    return {"fig04": moe_rec, "fig04_paths": paths,
            "gmm_launches": gmm_launches, "fig01": rec01,
            "fig01_paths": paths01, "fig01_fresh": fresh01,
            "flash_launches": flash01, "seconds": time.time() - t0}


# ---------------------------------------------------------------------------
# Phase 10: the dry-run's counter and roofline against a step the card runs
# ---------------------------------------------------------------------------

ROOFLINE_BYTES_RTOL = 1e-3     # card count vs meta count
ROOFLINE_LAUNCHER_TIMEOUT_S = 300
ROOFLINE_KERNELS = (("flash_attention", "launches"),
                    ("flash_attention_bwd", "bwd_launches"))


def roofline_lower_bound(cfg, shape, cost_model) -> dict:
    """``cost_model.model_flops + attention_flops``, and the same less
    the input embedding's 6 V d flops a token: an untied table is a
    lookup (a gather, no products), yet 6 N D counts its parameters."""
    tokens = shape.global_batch * shape.seq_len
    full = cost_model.model_flops(cfg, shape) + \
        cost_model.attention_flops(cfg, shape)
    lookup = 0 if cfg.tie_embeddings else \
        6.0 * cfg.vocab_size * cfg.d_model * tokens
    return {"model_plus_attention_flops": full,
            "input_embedding_lookup_flops": lookup,
            "lower_bound_flops": full - lookup}


def dryrun_subprocess(argv, what: str) -> dict:
    """One launcher of the dry-run as a subprocess: exit 0, its lines."""
    t0 = time.time()
    try:
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                              env=port_env(), capture_output=True,
                              text=True,
                              timeout=ROOFLINE_LAUNCHER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{what}: no exit within "
                           f"{ROOFLINE_LAUNCHER_TIMEOUT_S} s")
    rec = {"argv": argv, "rc": proc.returncode,
           "lines": [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("[")],
           "seconds": time.time() - t0,
           "stderr_tail": proc.stderr.splitlines()[-20:]}
    emit("roofline_launcher", what=what, **rec)
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}")
    return rec


def phase_roofline(torch, fa, rt, card, train: dict) -> dict:
    """The dry-run's counter held against a step the card runs: phase 8's
    step (internlm2-1.8b uncut, B ``TRAIN_B`` x S ``TRAIN_S``, fp32, one
    device) counted once while the card runs it and once on ``meta``
    through ``launch/build`` with a one-device plan.  Gates: FLOPs equal,
    bytes within ``ROOFLINE_BYTES_RTOL`` (the ops that differ named),
    each kernel's recorded calls equal to its launches over the step,
    the FLOPs at least the cost model's (less the input embedding's
    lookup).  The roofline at the data sheet's bf16 rate and at the fp32
    CUDA-core rate the step runs at, beside phase 8's measured ms a step
    and peak memory.  Then ``launch.dryrun --arch dbrx-132b --shape
    train_4k --both-meshes`` and ``launch.train --arch internlm2-1.8b
    --production`` as subprocesses: exit 0, their rows ``ok`` with
    ``useful_ratio`` in (0, 1.05]."""
    from repro_torch.analysis import roofline as roof
    from repro_torch.analysis.count import StepCounter
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import cost_model
    from repro_torch.launch import build as buildlib
    from repro_torch.launch import dryrun
    t0 = time.time()
    cfg = rt["get_config"]("internlm2-1.8b")
    shape = ShapeConfig("phase8_train", "train", TRAIN_S, TRAIN_B)
    params = rt["init_params"](rt["model_defs"](cfg), 0, device=DEV,
                               trainable=True)
    tc = rt["TrainerConfig"](steps=2, batch=TRAIN_B, seq_len=TRAIN_S)
    tr = rt["Trainer"](cfg, tc, device=DEV, params=params)
    batch = rt["to_device"](tr.data.batch_at(0), torch.device(DEV))
    tr.train_step(batch)                 # warm: the kernels loaded
    torch.cuda.synchronize()
    before = {name: getattr(fa, attr) for name, attr in ROOFLINE_KERNELS}
    t1 = time.time()
    with StepCounter() as card_count:
        tr.train_step(batch)
        torch.cuda.synchronize()
    card_s = time.time() - t1
    launched = {name: getattr(fa, attr) - before[name]
                for name, attr in ROOFLINE_KERNELS}
    args_bytes = sum({x.untyped_storage()._cdata:
                      x.untyped_storage().nbytes()
                      for x in rt["tree_leaves"](
                          [tr.state["params"], tr.state["opt"],
                           tr.state["step"], batch])}.values())
    card_mem = card_count.memory_stats(argument_bytes=args_bytes)
    del tr, params, batch
    free(torch)

    t1 = time.time()
    plan, mesh = buildlib.one_device()
    built = buildlib.build(cfg, shape, plan=plan, mesh=mesh,
                           param_dtype=torch.float32)
    meta_count, meta_mem = built.count()
    meta_s = time.time() - t1

    card_ops, meta_ops = card_count.ops(), meta_count.ops()
    differ = {op: {"card": card_ops.get(op), "meta": meta_ops.get(op)}
              for op in sorted(set(card_ops) | set(meta_ops))
              if card_ops.get(op) != meta_ops.get(op)}
    bytes_rel = abs(card_count.bytes - meta_count.bytes) / meta_count.bytes
    bound = roofline_lower_bound(cfg, shape, cost_model)
    fp32 = dataclasses.replace(cost_model.H100, name="h100-fp32-cuda-cores",
                               peak_flops=FP32_FLOPS)
    measured_s = train["ms_per_step_median_after_first"] / 1e3
    rows = {}
    for hw in (cost_model.H100, fp32):
        r = roof.analyze(cfg, shape, arch=cfg.name, mesh_name="one-card",
                         setting="one_device", chips=1,
                         cost=meta_count.cost(), collectives=[],
                         memory_stats=meta_mem, hw=hw).row()
        r["measured_step_s"] = measured_s
        r["measured_over_estimate"] = measured_s / r["step_s"]
        rows[hw.name] = r
    rec = {"arch": cfg.name, "batch": [TRAIN_B, TRAIN_S], "card": card,
           "card_flops": card_count.flops, "meta_flops": meta_count.flops,
           "card_bytes": card_count.bytes, "meta_bytes": meta_count.bytes,
           "bytes_rel_diff": bytes_rel, "ops_that_differ": differ,
           "card_families": card_count.families(),
           "meta_families": meta_count.families(),
           "launches": launched, **bound,
           "counted_over_model_plus_attention":
               meta_count.flops / bound["model_plus_attention_flops"],
           "counted_over_lower_bound":
               meta_count.flops / bound["lower_bound_flops"],
           "card_memory": card_mem, "meta_memory": meta_mem,
           "meta_argument_plus_temp_bytes":
               meta_mem["argument_size_in_bytes"]
               + meta_mem["temp_size_in_bytes"],
           "card_argument_plus_temp_bytes":
               card_mem["argument_size_in_bytes"]
               + card_mem["temp_size_in_bytes"],
           "measured_ms_per_step": train["ms_per_step_median_after_first"],
           "measured_peak_memory_bytes": train["peak_memory_bytes"],
           "roofline": rows, "count_card_s": card_s, "count_meta_s": meta_s}
    emit("roofline", **rec)
    check(card_count.flops == meta_count.flops,
          f"roofline: card FLOPs {card_count.flops} != meta "
          f"{meta_count.flops}; ops that differ {differ}")
    check(bytes_rel <= ROOFLINE_BYTES_RTOL,
          f"roofline: bytes card {card_count.bytes} meta "
          f"{meta_count.bytes} ({bytes_rel:.2e}); ops that differ {differ}")
    for name, n in launched.items():
        for what, fam in (("card", card_count.families()),
                          ("meta", meta_count.families())):
            got = fam.get(name, {}).get("calls", 0)
            check(got == n, f"roofline: {what} count {name} {got} calls, "
                            f"{n} launched")
    check(launched["flash_attention"] == cfg.num_layers,
          f"roofline: flash launches {launched}")
    check(meta_count.flops >= bound["lower_bound_flops"],
          f"roofline: counted {meta_count.flops} FLOPs under the cost "
          f"model's {bound['lower_bound_flops']}")

    # the launchers, as a user runs them, all at once (host-bound): the
    # dry-run's two meshes as two processes
    dry = ["repro_torch.launch.dryrun", "--arch", "dbrx-132b", "--shape",
           "train_4k"]
    launchers = {
        "dryrun_dbrx": (dry, "launch.dryrun dbrx-132b"),
        "dryrun_dbrx_multi_pod": (dry + ["--multi-pod"],
                                  "launch.dryrun dbrx-132b --multi-pod"),
        "production_internlm2": (["repro_torch.launch.train", "--arch",
                                  "internlm2-1.8b", "--production"],
                                 "launch.train --production internlm2-1.8b")}
    with ThreadPoolExecutor(len(launchers)) as pool:
        futures = {name: pool.submit(dryrun_subprocess, *job)
                   for name, job in launchers.items()}
        runs = {name: f.result() for name, f in futures.items()}
    launcher_rows = {}
    for name in ("dbrx-132b__train_4k__single__guideline",
                 "dbrx-132b__train_4k__multi__guideline",
                 "internlm2-1.8b__train_4k__single__guideline"):
        row = json.loads((dryrun.RESULTS / f"{name}.json").read_text())
        launcher_rows[name] = {k: row[k] for k in (
            "ok", "useful_ratio", "dominant", "roofline_frac", "step_s",
            "flops_per_device", "memory_per_device_bytes", "count_s")}
        check(row["ok"] and 0 < row["useful_ratio"] <= 1.05,
              f"roofline: {name} row {launcher_rows[name]}")
    emit("roofline_launcher_rows", rows=launcher_rows,
         seconds=time.time() - t0)
    rec.update(launchers=runs, launcher_rows=launcher_rows,
               seconds=time.time() - t0)
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config, reduced
        from repro_torch.device import resolve_device
        from repro_torch.benchmarks import fig09_operator_scaling as fig09
        from repro_torch.benchmarks import fig11_fused_prep as fig11
        from repro_torch.benchmarks import fig14_dispatch_overhead as fig14
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.fused_matmul import ops as fops
        from repro_torch.kernels.mamba2_scan import ops as mops
        from repro_torch.kernels.moe_gmm import ops as gmm
        from repro_torch.kernels.paged_attention import ops
        from repro_torch.kernels.rwkv6_wkv import ops as wops
        from repro_torch.models import (forward_decode, forward_dense_logits,
                                        forward_prefill, forward_verify,
                                        model_defs, prepare_decode_cache)
        from repro_torch.models.attention import (cp_kv_slice,
                                                  quantize_pages)
        from repro_torch.models.layers import logits
        from repro_torch.models.transformer import prefill_hidden
        from repro_torch.models.module import init_params
        from repro_torch.benchmarks.check_trace import validate
        from repro_torch.serve import traffic
        from repro_torch.serve.cache import (CacheSpec, admit_cache,
                                             install_slot_rows, kv_pool_dtype)
        from repro_torch.serve.chaos import ChaosMonkey
        from repro_torch.serve.engine import Engine, Request
        from repro_torch.serve.reference import ReferenceEngine
        from repro_torch.serve.spec import SpecConfig
        from repro_torch.models.module import tree_leaves
        from repro_torch.data.pipeline import to_device
        from repro_torch.models import forward_train
        from repro_torch.optim import adamw
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train.trainer import Trainer, TrainerConfig
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    rt = dict(get_config=get_config, init_params=init_params,
              model_defs=model_defs, Engine=Engine, Request=Request,
              forward_verify=forward_verify, forward_prefill=forward_prefill,
              forward_decode=forward_decode,
              install_slot_rows=install_slot_rows, admit_cache=admit_cache,
              CacheSpec=CacheSpec, quantize_pages=quantize_pages,
              SpecConfig=SpecConfig, prefill_hidden=prefill_hidden,
              logits=logits, reduced=reduced,
              ReferenceEngine=ReferenceEngine, ChaosMonkey=ChaosMonkey,
              traffic=traffic, validate_trace=validate,
              forward_dense_logits=forward_dense_logits,
              prepare_decode_cache=prepare_decode_cache,
              Trainer=Trainer, TrainerConfig=TrainerConfig,
              tree_leaves=tree_leaves, ckpt=ckpt, to_device=to_device,
              forward_train=forward_train, adamw=adamw)
    try:
        resolve_device("cuda")        # TF32 off
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        emit("device", name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda,
             tf32=[torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32])

        t0 = time.time()
        sources = [ops.SOURCE, gmm.SOURCE, fa.SOURCE, mops.SOURCE,
                   wops.SOURCE, fops.SOURCE]
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
        gmm_worst = phase_gmm_kernels(torch, gmm)
        flash_worst, flash_timed = phase_flash_kernels(torch, fa)
        mamba_worst, mamba_timed = phase_mamba_kernels(torch, mops)
        rwkv_worst, rwkv_timed = phase_rwkv6_kernels(torch, wops)
        fmm_worst, fmm_timed = phase_fused_matmul_kernels(torch, fops, fig11)
        fmm_grad_worst = phase_fused_matmul_grads(torch, fops)
        # the backwards of the training path (the scans' backward kernels
        # among them), and paged attention's refusal under autograd
        flash_grads = timed_phase("flash_grads", phase_flash_grads, torch,
                                  fa)
        flash_offset = timed_phase("flash_offset", phase_flash_offset,
                                   torch, fa, cp_kv_slice)
        gmm_grads = timed_phase("gmm_grads", phase_gmm_grads, torch, gmm)
        scan_grads = timed_phase("scan_grads", phase_scan_grads, torch, mops,
                                 wops, ops, mamba_timed, rwkv_timed)
        _, fig11_launches, fig11_res = phase_figs(
            torch, fops, (ops, gmm, fa, mops, wops, fops), fig09, fig11)
        cfg, params = init_model(torch, rt)
        launches, tokens = {}, {}
        for kv_dtype in KV_DTYPES:
            eng, launches[kv_dtype], _, tokens[kv_dtype] = phase_engine(
                torch, ops, gmm, rt, cfg, params, kv_dtype)
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
        # the same traffic through Engine(rules=...) on a one-rank mesh
        sharded = timed_phase("sharded_serve", phase_sharded_serve, torch,
                              ops, rt, cfg, params, tokens["fp32"])
        # the two-executable path on the same model, before it is freed
        phase_prefill_vs_fused(torch, rt, cfg, params)
        phase_quantized_splice(torch, rt, cfg, params)
        legacy = {}
        for kv_dtype in ("fp32", "int8"):
            eng, flash_launches, n_prefill = phase_legacy(
                torch, ops, fa, rt, cfg, params, kv_dtype, tokens)
            legacy[kv_dtype] = (flash_launches, n_prefill)
            if kv_dtype == "fp32":
                phase_segments(torch, rt, cfg, params, eng)
            del eng
            torch.cuda.empty_cache()
        # speculative decoding on the same model, both paths
        verify_launches = {
            "spec_fused_ngram": phase_spec_fused_ngram(
                torch, ops, rt, cfg, params, tokens),
            "spec_legacy_ngram": phase_spec_legacy(
                torch, ops, fa, rt, cfg, params, tokens)}
        # the launcher, the dense reference engine and fig14
        launcher = phase_launcher(torch, rt, cfg, params)
        ref_flash = phase_reference_engine(torch, ops, fa, rt, cfg, params)
        fig14_launches = phase_fig14(torch, ops, fa, fig14)
        fig14_qp = phase_fig14_qp(fig14_launches)
        # robustness, SLO policy and tracing on the same model
        t_a11 = time.time()
        ft = timed_phase("fault_tolerance", phase_fault_tolerance, torch,
                         ops, fa, rt, cfg, params, tokens["fp32"])
        chaos_run = timed_phase("chaos", phase_chaos, torch, ops, rt, cfg,
                                params, tokens["fp32"])
        traced = timed_phase("trace", phase_trace, torch, ops, fa, rt, cfg,
                             params, tokens["fp32"], ft["fused"])
        slo_mix = timed_phase("slo_mix", phase_slo_mix, torch, ops, rt,
                              cfg, params)
        launcher_a11 = timed_phase("launcher_a11", phase_launcher_a11,
                                   torch, cfg)
        emit("a11_phases_done", seconds=time.time() - t_a11)
        # gemma2's ~10.5 GB, zamba2's ~24 GB, rwkv6's ~30 GB and dbrx's
        # ~57 GB of weights fit only one at a time, and only once
        # internlm2's are gone
        del params
        gc.collect()
        torch.cuda.empty_cache()
        verify_launches.update(phase_gemma2(torch, ops, fa, rt))
        zamba2 = phase_zamba2(torch, ops, fa, mops, rt)
        rwkv6 = phase_rwkv6(torch, ops, fa, mops, wops, rt)
        full = get_config("dbrx-132b")
        dbrx = cut_depth(full, DBRX_DEPTH)
        emit("depth_cut", arch=full.name, layers_full=full.num_layers,
             layers=dbrx.num_layers,
             kept=f"the first {dbrx.num_layers} of {full.num_layers} "
                  "uniform attention + MoE blocks; every width kept")
        dbrx_launches, gmm_launches, gmm_rows = phase_dbrx(
            torch, ops, gmm, rt, dbrx)
        free(torch)
        # the last four archs, one at a time: each frees its weights
        whisper = timed_phase("whisper", phase_whisper, torch, ops, fa, rt)
        gemma3 = timed_phase("gemma3", phase_gemma3, torch, ops, fa, rt)
        mistral = timed_phase("mistral", phase_mistral, torch, ops, fa, rt,
                              MISTRAL_DEPTH)
        pixtral = timed_phase("pixtral", phase_pixtral, torch, ops, fa, rt)
        # training: card against CPU at 2 layers (and reduced dbrx: the
        # MoE backward and the aux loss; zamba2 and rwkv6: the scans'
        # backward kernels), a resume, the full models, the launcher
        t_train = time.time()
        train_ops = {"flash_attention": fa, "moe_gmm": gmm,
                     "mamba2_scan": mops, "rwkv6_wkv": wops}
        il2 = cut_depth(get_config("internlm2-1.8b"), TRAIN_PARITY_LAYERS)
        parity = {
            "internlm2": timed_phase(
                "train_parity_internlm2", train_parity, torch, train_ops, rt,
                il2, "internlm2", {"flash_attention": TRAIN_PARITY_LAYERS}),
            "dbrx_reduced": timed_phase(
                "train_parity_dbrx", train_parity, torch, train_ops, rt,
                reduced(get_config("dbrx-132b")), "dbrx_reduced",
                {"flash_attention": 2, "moe_gmm": 6})}
        parity.update(phase_scan_parity(torch, train_ops, rt))
        resume = timed_phase("train_resume", phase_train_resume, torch, rt,
                             il2)
        train = timed_phase("train_full", phase_train_full, torch, ops,
                            train_ops, rt, card)
        # the dry-run's counter and roofline on phase 8's step
        timed_phase("roofline", phase_roofline, torch, fa, rt, card, train)
        # the same step under the guideline plan's rules on a one-rank
        # NCCL mesh, on train_full's seed and data
        sharded_train = timed_phase("sharded_train", phase_sharded_train,
                                    torch, fa, rt, card, train)
        train_scans = phase_train_scans(torch, ops, train_ops, rt, card)
        train_launcher = timed_phase("train_launcher", phase_train_launcher,
                                     torch)
        emit("train_phases_done", seconds=time.time() - t_train,
             resumed_loss_rel_err=resume["rel_err"],
             launcher_final={arch: run["lines"][-1]
                             for arch, run in train_launcher.items()})
        # the paper's tuning machinery and its figures
        free(torch)
        paper = timed_phase("paper", phase_paper, torch,
                            (ops, gmm, fa, mops, wops, fops), gmm, fa, card)
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
            "bound_fp32_cores_ms": main32["bound_fp32_cores_ms"],
            "max_err": worst[kv_dtype], "kernel_ms": main32["ms"],
            "shape": f"B=8 S=32 H=16 Hkv=8 dh=128 P=16 nb=64 {kv_dtype}",
            # the fused chunk (S = 32, tile path) and both S = 1 decode
            # shapes (GEMV path), each beside SDPA and its bounds
            "by_case": {name: {key: rec[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_fp32_cores_ms", "roofline_share", "path")}
                for name, rec in rows[kv_dtype].items()}})
    # the verify shapes' launches on their engine paths (fp32 pools)
    for name, run in (("verify_internlm2_s5", "spec_legacy_ngram"),
                      ("gemma2_s1_wrap", "gemma2_legacy"),
                      ("gemma2_verify_s5_wrap", "gemma2_legacy_spec"),
                      ("gemma2_fused_s32_wrap", "gemma2_fused")):
        entries[0]["by_case"][name]["launches"] = verify_launches[run]
        entries[0]["by_case"][name]["launched_by"] = run
    entries[0]["launches_spec_fused_ngram"] = verify_launches[
        "spec_fused_ngram"]
    entries[0]["launches_gemma2_fused_spec"] = verify_launches[
        "gemma2_fused_spec"]
    entries[0]["launches_dbrx"] = dbrx_launches
    entries[0]["launches_sharded_serve"] = sharded["launches"]
    entries[0]["launches_fig14"] = fig14_launches["paged"]
    entries[1]["launches_fig14_qp"] = fig14_qp["paged_attention_int8_launches"]
    entries[0]["launches_launcher"] = {
        what: run["kernel_launches"]["paged_attention"]
        for what, run in launcher.items()}
    entries[0]["launches_zamba2"] = zamba2["paged"]
    # the last four archs' paged launches (whisper's decoder reads a dense
    # cache: none), and their shapes' launches under ``by_case``
    entries[0]["launches_a13"] = {
        **{f"gemma3_{mode}": run["paged_attention_launches"]
           for mode, run in gemma3.items()},
        **{f"mistral_{mode}": run["paged_attention_launches"]
           for mode, run in mistral.items()},
        "pixtral_legacy": pixtral["engine"]["paged_attention_launches"]}
    for name, run in (("mistral_g12_s1", mistral["legacy"]),
                      ("mistral_g12_s32", mistral["fused"]),
                      ("gemma3_s1_wrap", gemma3["legacy"]),
                      ("gemma3_fused_s32_wrap", gemma3["fused"])):
        entries[0]["by_case"][name]["launches"] = run[
            "paged_attention_launches"]
        entries[0]["by_case"][name]["launched_by"] = (
            f"{run['arch']} {run['path']}")
    entries[0]["launches_a11"] = {
        "fault_tolerance_fused": ft["fused"]["paged_attention_launches"],
        "fault_tolerance_legacy": ft["legacy"]["paged_attention_launches"],
        "chaos": chaos_run["paged"],
        "trace": traced["paged_attention_launches"],
        "slo_mix_fifo": slo_mix["fifo"]["paged_attention_launches"],
        "slo_mix_slo": slo_mix["slo"]["paged_attention_launches"],
        "launcher_a11": launcher_a11["kernel_launches"]["paged_attention"]}
    main_gmm = gmm_rows["gate_up"]
    timing_keys = ("ms", "device_ms", "plain_ms", "plain_device_ms",
                   "library_ms", "library_device_ms", "bound_ms", "bound_by",
                   "bound_fp32_cores_ms", "tensor_terms", "roofline_share")
    entries.append({
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:49",
        "launches": gmm_launches,
        "max_abs_err": max(gmm_worst["fp32"], main_gmm["max_abs_err"],
                           gmm_rows["down"]["max_abs_err"]),
        **{key: main_gmm[key] for key in timing_keys},
        "bf16_relative_err": gmm_worst["bf16"],
        "live_rows": main_gmm["live_rows"],
        "rows_computed": main_gmm["rows_computed"],
        "down": {key: gmm_rows["down"][key] for key in timing_keys},
        "launches_fig04": paper["gmm_launches"],
        "fig04_calls": paper["fig04"]["calls"],
        "shape": "dbrx gate/up: E=16 C=80 D=6144 F=10752 fp32, "
                 f"sum(counts)={main_gmm['live_rows']}"})
    main_fa = flash_timed["main_s1024"]
    entries.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
        "launches": legacy["fp32"][0],
        "max_abs_err": flash_worst["fp32"],
        "ms": main_fa["ms"], "plain_ms": main_fa["plain_ms"],
        "bound_ms": main_fa["bound_ms"], "bound_by": main_fa["bound_by"],
        "bound_fp32_cores_ms": main_fa["bound_fp32_cores_ms"],
        "library_ms": main_fa["library_ms"],
        "bf16_relative_err": flash_worst["bf16"],
        "full_prefills": legacy["fp32"][1],
        "launches_int8": legacy["int8"][0],
        "launches_fault_tolerance_legacy":
            ft["legacy"]["flash_attention_launches"],
        "launches_reference_engine": ref_flash,
        "launches_fig14": fig14_launches["flash"],
        "launches_launcher": {
            what: run["kernel_launches"]["flash_attention"]
            for what, run in launcher.items()},
        "launches_mistral": mistral["legacy"]["flash_attention_launches"],
        "launches_pixtral": pixtral["engine"]["flash_attention_launches"],
        "launches_pixtral_reference":
            pixtral["reference"]["flash_attention_launches"],
        "launches_fig01": paper["flash_launches"],
        "fig01_forwards": paper["fig01"]["forwards"],
        "ms_by_seq": {name: rec["ms"] for name, rec in flash_timed.items()},
        "library_ms_by_seq": {name: rec["library_ms"]
                              for name, rec in flash_timed.items()},
        "shape": "B=1 H=16 Hkv=8 dh=128 causal fp32 S=1024"})
    # whisper's non-causal calls (encoder, cross-attention) and gemma3's
    # dh 256 window 1024 prefill, each an entry with its own launches
    flash_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "bound_fp32_cores_ms", "roofline_share", "max_abs_err")
    for name, case, launches, extra in (
            ("flash_attention_whisper", "whisper_enc",
             whisper["flash_attention_launches"],
             {"launches_dense": whisper["flash_attention_launches_dense"],
              "shape": "whisper-medium encoder: B=8 H=Hkv=16 dh=64 "
                       "non-causal fp32 Sq=Skv=1500"}),
            ("flash_attention_dh256_window", "gemma3_dh256_w1024_s2048",
             gemma3["legacy"]["flash_attention_launches"],
             {"full_prefills": gemma3["legacy"]["full_prefills"],
              "shape": "gemma3-12b prefill: B=1 H=16 Hkv=8 dh=256 causal "
                       "window=1024 fp32 S=2048"})):
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
            "launches": launches,
            **{key: flash_timed[case][key] for key in flash_keys},
            "by_case": {n: {key: flash_timed[n][key] for key in flash_keys}
                        for n in flash_timed
                        if n.startswith(case.split("_")[0])},
            **extra})
    z_fa = flash_timed["zamba2_dh112_s1024"]
    entries.append({
        "name": "flash_attention_dh112", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
        "launches": zamba2["flash"], "max_abs_err": z_fa["max_abs_err"],
        "ms": z_fa["ms"], "plain_ms": z_fa["plain_ms"],
        "bound_ms": z_fa["bound_ms"], "bound_by": z_fa["bound_by"],
        "bound_fp32_cores_ms": z_fa["bound_fp32_cores_ms"],
        "library_ms": z_fa["library_ms"],
        "full_prefills": zamba2["prefills"],
        "shape": "zamba2-7b: B=1 H=Hkv=32 dh=112 causal window=4096 fp32 "
                 "S=1024"})
    mamba_main = mamba_timed["zamba2_full"]
    scan_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                  "bound_fp32_cores_ms", "tensor_terms", "roofline_share")
    entries.append({
        "name": "mamba2_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2_scan/csrc/mamba2_scan.cu",
        "replaces": "src/repro/kernels/mamba2_scan/kernel.py:77",
        "launches": zamba2["scans"],
        "max_abs_err": mamba_main["y_max_abs_err"],
        "max_relative_err_all_cases": mamba_worst,
        **{key: mamba_main[key] for key in scan_keys},
        "library_ms": None,
        "by_case": {name: {key: rec[key] for key in scan_keys}
                    for name, rec in mamba_timed.items()},
        "full_prefills": zamba2["prefills"],
        "shape": "zamba2-7b prefill, model layout: B=1 H=112 S=1024 P=64 "
                 "N=64 fp32, b/c shared by the heads"})
    rwkv_main = rwkv_timed["rwkv6_full"]
    entries.append({
        "name": "rwkv6_wkv", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:72",
        "launches": rwkv6["wkvs"],
        "max_abs_err": rwkv_main["y_max_abs_err"],
        "max_relative_err_all_cases": rwkv_worst,
        **{key: rwkv_main[key] for key in scan_keys},
        "library_ms": None,
        "by_case": {name: {key: rec[key] for key in scan_keys}
                    for name, rec in rwkv_timed.items()},
        "full_prefills": rwkv6["prefills"],
        "shape": "rwkv6-7b prefill, model layout: B=1 H=64 S=1024 K=64 "
                 "fp32, u shared by the batch"})
    fmm = fmm_timed[1024]
    entries.append({
        "name": "fused_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_matmul/csrc/fused_matmul.cu",
        "replaces": "src/repro/kernels/fused_matmul/kernel.py:58",
        "launches": fig11_launches, "max_abs_err": fmm["max_abs_err"],
        "max_relative_err_all_cases": fmm_worst["fp32"],
        "bf16_relative_err": fmm_worst["bf16"],
        "grad_relative_err": fmm_grad_worst,
        **{key: fmm[key] for key in timing_keys},
        "by_n": {n: {key: rec[key] for key in timing_keys}
                 for n, rec in fmm_timed.items()},
        "fig11_speedup": fig11_res["speedup"],
        "shape": "fig11: int8 x [1024,1024] scaled, f32 w [1024,1024], "
                 "f32 out"})
    # which kernels' ops have a backward, and the two that the training
    # path differentiates: their backwards' times, bounds and launches
    bwd_keys = ("ms", "plain_ms", "library_ms", "library", "bound_ms",
                "bound_by", "roofline_share", "relative_err")
    for e in entries:
        e["has_backward"] = not e["name"].startswith(
            "paged_decode_attention")
    by_name = {e["name"]: e for e in entries}
    # the scans' backward kernels: their times at the training shapes,
    # and their launches in the full-width training runs
    for name, case, arch, fn, shape in (
            ("mamba2_scan", "zamba2_train", "zamba2-7b", "mamba2_scan_bwd",
             "zamba2-7b training, model layout: B=4 H=112 S=1024 P=64 "
             "N=64 fp32, b/c shared by the heads"),
            ("rwkv6_wkv", "rwkv6_train", "rwkv6-7b", "rwkv6_wkv_bwd",
             "rwkv6-7b training, model layout: B=4 H=64 S=1024 K=64 fp32, "
             "u shared by the batch")):
        run = train_scans[arch]
        fl, bl = run["launches"][name]
        grads = scan_grads["grads"]
        by_name[name].update(
            launches_train=fl,
            launches_train_per_step=fl // run["steps"],
            forward_no_grad={k: scan_grads["forward_no_grad"][name][k]
                             for k in ("ms", "device_ms")},
            backward={
                "function": fn, "route": "cuda",
                "source": by_name[name]["source"],
                "launches_train": bl,
                "launches_train_per_step": bl // run["steps"],
                **{k: grads[case][k] for k in bwd_keys + ("device_ms",)},
                **{k: grads[case][k] for k in ("bound_per_step_ms",
                                                "per_step_flops", "flops")
                   if k in grads[case]},
                "shape": shape,
                "by_case": {n: {"relative_err": r["relative_err"],
                                "two_calls_bitwise_equal":
                                    r["two_calls_bitwise_equal"]}
                            for n, r in grads.items()
                            if r["kernel"] == name}})
    fl_train = train["launches"]["flash_attention"]
    by_name["flash_attention"].update(
        launches_train=fl_train[0],
        launches_train_per_step=fl_train[0] // TRAIN_STEPS,
        backward={
            "function": "flash_attention_bwd",
            "source": "src/repro_torch/kernels/flash_attention/ops.py",
            "route": "explicit products (fp32 einsum, TF32 off); not a "
                     "kernel of its own",
            "launches_train": fl_train[1],
            "launches_train_per_step": fl_train[1] // TRAIN_STEPS,
            **{k: flash_grads["internlm2_train"][k] for k in bwd_keys},
            "shape": "internlm2-1.8b training: B=4 H=16 Hkv=8 dh=128 "
                     "causal fp32 S=1024",
            "by_case": {n: {k: r[k] for k in bwd_keys}
                        for n, r in flash_grads.items()}})
    by_name["flash_attention"]["launches_sharded_train"] = \
        sharded_train["launches"]["flash_attention"]
    # the query offset (context-parallel attention): its calls at 2, 4
    # (and gemma2's 16) shards; one card holds one sequence shard, so the
    # sharded step's launches are the offset-0 form
    off_last = flash_offset["internlm2_train"]["shards_4"]["last"]
    entries.append({
        "name": "flash_attention_q_offset", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
        "launches": sharded_train["launches"]["flash_attention"][0],
        "launches_q_offset_positive": 0,
        "max_abs_err": flash_offset["max_abs_err"],
        **{key: off_last[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_fp32_cores_ms", "roofline_share", "q_offset")},
        "by_case": {name: {key: (val if key == "ms_unsharded" else {
            k: val[k] for k in ("ms_each", "ms_sum", "max_abs_err_vs_plain",
                                "max_abs_err_vs_unsharded",
                                "grad_rel_err_vs_unsharded")})
            for key, val in rec.items()
            if key == "ms_unsharded" or key.startswith("shards_")}
            for name, rec in flash_offset.items() if name != "max_abs_err"},
        "shape": "internlm2-1.8b training, the last of 4 query shards: "
                 "B=4 H=16 Hkv=8 dh=128 causal fp32 Sq=256 Skv=1024 "
                 "q_offset=768"})
    gmm_par = parity["dbrx_reduced"]["launches"]["moe_gmm"]
    by_name["moe_gmm"].update(
        launches_train_dbrx_reduced=gmm_par[0],
        backward={
            "function": "moe_gmm_bwd",
            "source": "src/repro_torch/kernels/moe_gmm/ops.py",
            "route": "explicit products (fp32 einsum, TF32 off); not a "
                     "kernel of its own",
            "launches_train_dbrx_reduced": gmm_par[1],
            **{k: gmm_grads[k] for k in bwd_keys},
            "shape": "dbrx gate/up: E=16 C=80 D=6144 F=10752 fp32, "
                     f"live rows {gmm_grads['live_rows']}"})
    print(card, flush=True)      # again, beside the results it qualifies
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
