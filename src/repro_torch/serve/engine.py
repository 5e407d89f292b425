"""Serving runtime of the port over block-paged KV pools in fp32, int8
or fp8_e4m3 (counterpart of ``repro/serve/engine.py``), in the
reference's two modes.

Three layers, as in the reference:

* **Scheduler** (``serve/scheduler``) — host-side policy: FIFO or SLO
  queue order, slot admission, per-group page reservation, refcounted
  prefix sharing over a radix index.
* **Executor** (below) — the device layer.  A chunk is ``sync_interval``
  micro-steps, sampled and booked on the device with no host
  synchronization inside it (the reference's ``lax.scan`` becomes a
  Python loop of eager launches):

  - *fused chunked prefill* (``chunked_prefill=True``): each micro-step
    feeds a right-aligned ``[slots, S]`` token matrix
    (``S = prefill_budget``) to the model: a mid-prefill slot
    contributes its next ``min(plen - len, pbudget)`` prompt tokens
    (``pbudget``: its per-slot budget, ``S`` unless the SLO policy
    throttles it), a decoding slot its pending token, and pad rows are
    write-masked so their KV lands on the trash page;
  - *two executables* (``chunked_prefill=False``): admission runs a
    batch-1 prefill of the prompt padded to a power-of-two bucket
    (``models/transformer.forward_prefill``, whose attention is
    ``kernels/flash_attention`` on the card), samples the first token
    on the device and splices the prompt's KV into the slot's pages
    (``serve/cache.admit_cache``).  A radix prefix hit prefills only the
    suffix against the shared pages, and a prompt longer than the
    largest bucket runs as bucket-sized segments.  Each micro-step of
    the chunk is one S = 1 decode step.

  With ``spec=`` (``serve/spec``) each decode micro-step becomes a
  speculative round: a drafter proposes ``K`` tokens per slot (n-gram
  lookup in the slot's history, or a small model on its own dense draft
  cache), one multi-row pass verifies the ``K + 1`` rows (two
  executables: ``S = K + 1``; fused: the last ``K + 1`` columns of the
  ``[slots, max(prefill_budget, K + 1)]`` matrix), and on-device
  rejection sampling commits a variable number of tokens: greedy output
  is token-identical to plain decoding.
* **Driver** (``Engine``) — glues them: at each chunk boundary it reaps
  cancelled and expired requests, applies chaos faults, admits (with
  pool-pressure preemption), sets the SLO prefill budgets, launches one
  chunk and drains it in one batched device-to-host copy (prefill-
  sampled first tokens included), with the stall watchdog.

Decode attention reads the pools pool-direct through the Hopper
paged-attention kernel (``paged_kernel="auto"`` on a CUDA device) or
gathers each slot's ring (``paged_kernel=False``).  Robustness, SLO
policy and tracing are the reference's: preemption (a victim's pages
preserved in the radix index, its request requeued and resumed with its
emitted tokens replayed as prompt), deadlines, TTLs and cancellation,
queue limits with the ``reject``, ``block``, ``evict-lru-prefix`` and
``shed-lowest-class`` policies, the ``slo`` admission order and its
prefill-budget throttle, seeded fault injection (``serve/chaos``), the
lifecycle tracer (``serve/trace``) and the metric registry
(``serve/metrics``).  All of it runs on the host at chunk boundaries:
the chunk stays free of host synchronization.  A cross-attention arch
(whisper) raises ``NotImplementedError``, as in the reference.  A
patch-frontend
arch (pixtral) serves on two executables, as in the reference: each
prefill takes zero frontend embeddings in its first ``frontend_len``
positions, and prefix sharing stays off.  A prompt whose bucket is
shorter than the frontend is refused at ``submit`` (the reference fails
inside its prefill).

One deliberate departure from the reference: a fused slot completes its
prefill when this micro-step's ``n`` rows reach the end of its prompt
(``rem <= n``).  The reference tests ``rem <= S``, so under the SLO
throttle (``n = pbudget < rem <= S``) it commits a "first token" sampled
from a mid-prompt row; the port does not.  Without a throttle the two
rules coincide.

Telemetry, as the reference's: ``memory_stats``, ``prefix_stats``,
``spec_stats``, ``fault_stats``, ``latency_stats`` (TTFT/TPOT
percentiles and goodput from the drain's host stamps; the pure
functions above ``Executor``), ``observe`` (stable dotted names),
``export_trace``, ``explain`` and the shape counters
``prefill_compiles``, ``suffix_prefill_compiles``, ``decode_compiles``
and ``admit_compiles``.

Data-parallel serving (``rules=``: a ``parallel/sharding.Rules`` whose
mesh is a ``DeviceMesh`` and whose table maps ``BATCH`` and ``PAGES`` to
one mesh axis).  The reference shards the cache with GSPMD; the port's
kernels take plain local tensors, so it runs SPMD ranks instead.  Every
rank builds the same ``Engine`` (replicated weights) and receives the
same ``submit`` calls in the same order; the host scheduler runs on
every rank, replicated and deterministic.  A rank at coordinate ``r`` of
``n`` along the axis holds the device state of slots ``r * slots/n ..``
only (tables, ``len``, sampling state) and, per pool group, pages ``r *
num_pages/n ..`` plus a trash page of its own (``CacheSpec.rank_spec``);
a slot leases pages of its own rank only (``serve/scheduler``), so every
paged-attention launch reads local pages.  Admissions, prefills,
splices and copies of a slot run on its rank; the chunk runs on each
rank's ``[slots/n, S]`` rows; the drain all-gathers the packed tensor
over the axis (``all_gather_into_tensor``) before its one
device-to-host copy, so every rank's scheduler sees every slot.  A
``BATCH`` rule that does not divide ``slots`` falls back (logged in
``Rules.fallbacks``, as the reference's) and every rank then serves
every slot.  MoE archs, recurrent archs and speculation raise under
``rules=`` (ROADMAP A19, A20).  So do, across more than one rank, the
decisions that read the clock: each rank reads its own, so they could
part (``policy="slo"``, ``shed_policy="shed-lowest-class"``, a request's
``ttl`` or ``deadline``; ROADMAP A22).
"""

from __future__ import annotations

import json
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, host_to_device, resolve_device
from repro_torch.models import layers
from repro_torch.models.module import init_params
from repro_torch.models.transformer import (forward_decode, forward_prefill,
                                            forward_verify, model_defs,
                                            verify_hidden)
from repro_torch.serve import cache as cache_mod
from repro_torch.serve import metrics as metrics_mod
from repro_torch.serve import sampling
from repro_torch.serve import trace as trace_mod
from repro_torch.parallel import sharding as sh
from repro_torch.serve.cache import STATE, CacheSpec
from repro_torch.serve.chaos import ChaosMonkey, GarbageDrafter
from repro_torch.serve.scheduler import (PagePoolExhausted, Request,
                                         RequestRejected, RequestStatus,
                                         Scheduler)
from repro_torch.serve.spec import (ModelDrafter, NGramDrafter, SpecConfig,
                                    check_spec_capable,
                                    spec_unsupported_reason)


# ---------------------------------------------------------------------------
# Latency telemetry: percentile / goodput math over host-stamped requests
# (the reference's functions, line for line).  Pure functions of Request
# timestamp fields, so tests/test_torch_latency_stats.py grades them by
# hand.
# ---------------------------------------------------------------------------

def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the ``ceil(q/100 * n)``-th smallest
    value.  None on an empty sample."""
    if not values:
        return None
    vals = sorted(values)
    n = len(vals)
    rank = max(1, math.ceil(q * n / 100.0))
    return vals[min(rank, n) - 1]


def request_ttft(req: Request) -> Optional[float]:
    """Submit -> first token, from the original submit time.  None until
    a first token is drained."""
    if req.first_token_time is None or req.submit_time is None:
        return None
    return req.first_token_time - req.submit_time


def request_tpot(req: Request) -> Optional[float]:
    """Mean per-token delta after the first token (TPOT).  Tokens drained
    in one chunk share a stamp, so this is the chunk-boundary average.
    None below 2 tokens."""
    if len(req.token_times) < 2:
        return None
    span = req.token_times[-1] - req.token_times[0]
    return span / (len(req.token_times) - 1)


def request_slo_met(req: Request) -> bool:
    """Only FINISHED requests can meet their SLO; a measured latency over
    target, or a target with no measurement, is a miss, and an absent
    target (best-effort) always passes."""
    if req.status != RequestStatus.FINISHED:
        return False
    for target, got in ((req.resolved_ttft_target, request_ttft(req)),
                        (req.resolved_tpot_target, request_tpot(req))):
        if target is None:
            continue
        if got is None or got > target:
            return False
    return True


def compute_latency_stats(requests: List[Request]) -> Dict[str, Any]:
    """TTFT/TPOT p50/p99 per SLO class + goodput over ``requests``.
    Percentiles cover every request with the measurement; goodput is the
    fraction of terminal requests that FINISHED meeting their targets.
    Classes with no samples report None percentiles and goodput 0.0."""
    by_class: Dict[str, List[Request]] = {}
    for req in requests:
        by_class.setdefault(req.slo_class, []).append(req)

    def _summary(reqs: List[Request]) -> Dict[str, Any]:
        ttfts = [t for t in (request_ttft(r) for r in reqs)
                 if t is not None]
        tpots = [t for t in (request_tpot(r) for r in reqs)
                 if t is not None]
        terminal = [r for r in reqs
                    if r.status in RequestStatus.TERMINAL]
        met = sum(request_slo_met(r) for r in terminal)
        return {
            "count": len(reqs),
            "terminal": len(terminal),
            "finished": sum(r.status == RequestStatus.FINISHED
                            for r in reqs),
            "slo_met": met,
            "goodput": met / len(terminal) if terminal else 0.0,
            "ttft_p50": percentile(ttfts, 50),
            "ttft_p99": percentile(ttfts, 99),
            "tpot_p50": percentile(tpots, 50),
            "tpot_p99": percentile(tpots, 99),
        }

    stats: Dict[str, Any] = {
        "classes": {cls: _summary(reqs)
                    for cls, reqs in sorted(by_class.items())},
        "overall": _summary(list(requests)),
    }
    stats["goodput"] = stats["overall"]["goodput"]
    return stats


class Executor:
    """Device layer of both modes: the chunk, admission, prefill (two
    executables only), copy-on-write and slot eviction.  Cache and slot
    state are dicts of device tensors, updated in place where the
    reference donated them.  ``chunked``: the fused mode, whose chunk
    feeds ``prefill_budget`` rows per slot; else two executables, whose
    chunk decodes one row per slot."""

    def __init__(self, cfg: ModelConfig, spec: CacheSpec, *, top_k: int,
                 sync_interval: int, paged_kernel: bool, chunked: bool,
                 prefill_budget: int, device: torch.device,
                 drafter=None, draft_params=None):
        self.cfg = cfg
        self.spec = spec
        self.top_k = int(top_k)
        self.sync_interval = int(sync_interval)
        self.paged_kernel = bool(paged_kernel)
        self.chunked = bool(chunked)
        self.device = device
        # speculation: ``drafter`` proposes ``drafter.k`` tokens per slot
        # and each micro-step verifies k1 = k + 1 rows per decoding slot
        self.drafter = drafter
        self.draft_params = draft_params
        self.k1 = drafter.k + 1 if drafter is not None else 1
        # fused: prefill slices and verify rows share one [slots, S] matrix
        self.chunk_rows = max(int(prefill_budget), self.k1)
        # a patch-frontend arch's prefill takes the reference's stub: zero
        # embeddings in the first frontend_len positions
        self.frontend = None
        if cfg.frontend:
            self.frontend = torch.zeros((1, cfg.frontend_len, cfg.d_model),
                                        dtype=torch.float32, device=device)

    # ------------------------------------------------------ fused chunk
    def micro_inputs(self, cache: Dict, state: Dict,
                     drafts: Optional[torch.Tensor] = None):
        """One fused micro-step's right-aligned token matrix and masks:
        ``(toks [B,S], write_mask [B,S], n_rows [B], prefilling [B],
        completing [B])``.  A mid-prefill slot's rows are its next
        ``n = min(plen - len, pbudget)`` prompt tokens (``pbudget``
        clamped into ``[1, S]``: a value, never a shape); a decoding
        slot's are its pending token, followed by its ``drafts`` [B,K]
        under speculation, in the last ``k1`` columns.  A slot completes
        its prefill when its ``n`` rows reach the prompt's end
        (``rem <= n``; the reference's ``rem <= S`` commits a mid-prompt
        row's sample under the SLO throttle)."""
        S, k1 = self.chunk_rows, self.k1
        col = torch.arange(S, device=self.device, dtype=torch.int32)[None, :]
        len_ = cache["len"]
        active = state["active"]
        rem = state["plen"] - len_
        prefilling = active & (rem > 0)
        budget = torch.clamp(state["pbudget"], 1, S)
        n = torch.where(prefilling, torch.minimum(rem, budget), k1)
        completing = prefilling & (rem <= n)
        gidx = len_[:, None] + col - (S - n)[:, None]
        pcap = state["prompt"].shape[1]
        ptoks = torch.gather(state["prompt"], 1,
                             torch.clamp(gidx, 0, pcap - 1).long())
        wm = active[:, None] & (col >= (S - n)[:, None])
        dec = [torch.zeros((S - k1,), dtype=torch.int32,
                           device=self.device).expand(len_.shape[0], -1),
               state["tokens"][:, None]]
        if drafts is not None:
            dec.append(drafts)
        toks = torch.where(prefilling[:, None], ptoks, torch.cat(dec, dim=1))
        return toks, wm, n, prefilling, completing

    def chunk(self, params, cache: Dict, state: Dict,
              gen: torch.Generator):
        """``sync_interval`` micro-steps: forward (KV written through the
        page tables) + sample + bookkeeping, all on the device.  Returns
        the token history (-1 where a slot committed nothing), the cache
        and the state.  The history is [T, slots], or under speculation
        [T*(K+1), slots] (each round's up to K+1 committed tokens in
        order), so each slot's new tokens are its column's non-negative
        entries."""
        if self.drafter is not None:
            step = (self._fused_spec_step if self.chunked
                    else self._spec_decode_step)
        else:
            step = self._fused_step if self.chunked else self._decode_step
        emitted: List[torch.Tensor] = []
        for _ in range(self.sync_interval):
            em, cache, state = step(params, cache, state, gen)
            emitted.append(em)
        toks = torch.stack(emitted)
        if toks.dim() == 3:      # [T, slots, K+1] -> time-major rows
            toks = toks.transpose(1, 2).reshape(-1, toks.shape[1])
        return toks, cache, state

    def _decode_step(self, params, cache: Dict, state: Dict,
                     gen: torch.Generator):
        """S = 1 decode; ``active`` as write mask: a finished slot's
        dead-tail steps must not write into pages now shared with other
        slots or the radix index."""
        logits, cache = forward_decode(
            params, self.cfg, state["tokens"][:, None], cache,
            write_mask=state["active"], paged_kernel=self.paged_kernel)
        nxt = sampling.sample(logits, gen, temperature=state["temp"],
                              top_k=self.top_k)
        state, em = sampling.decode_update(state, nxt)
        return em, cache, state

    def _fused_step(self, params, cache: Dict, state: Dict,
                    gen: torch.Generator):
        """One fused micro-step: prompt slices and decode rows together."""
        len_, active = cache["len"], state["active"]
        toks, wm, n, prefilling, completing = self.micro_inputs(
            cache, state)
        h, cache = verify_hidden(
            params, self.cfg, toks, cache, write_mask=wm,
            paged_kernel=self.paged_kernel,
            spec_slack=self.spec.spec_tokens, n_rows=n)
        logits = layers.logits(params["embed"], self.cfg, h[:, -1])
        nxt = sampling.sample(logits, gen, temperature=state["temp"],
                              top_k=self.top_k)
        # commit for decoding slots and for slots whose prefill just
        # completed (their first token); mid-prefill slots commit
        # nothing
        commit = active & (~prefilling | completing)
        state, em = sampling.decode_update(state, nxt, commit=commit)
        cache = dict(cache, len=len_ + torch.where(
            prefilling, n, active.to(torch.int32)))
        return em, cache, state

    def _spec_decode_step(self, params, cache: Dict, state: Dict,
                          gen: torch.Generator):
        """Two executables, one speculative round: draft ``K``, verify the
        current token and the drafts (``S = K + 1`` rows, ``active`` as
        write mask), accept, and advance ``len`` by the committed count
        (rejected drafts roll back by not being counted)."""
        drafts, qprobs = self.drafter.propose(self.draft_params, cache,
                                              state, gen, self.top_k)
        toks = torch.cat([state["tokens"][:, None], drafts], dim=1)
        logits, cache = forward_verify(
            params, self.cfg, toks, cache, write_mask=state["active"],
            paged_kernel=self.paged_kernel, spec_slack=self.spec.spec_tokens)
        cand, n_acc = sampling.spec_accept(logits, drafts, qprobs,
                                           state["temp"], self.top_k, gen)
        state, em, n_emit = sampling.spec_update(state, cand, n_acc)
        cache = dict(cache, len=cache["len"] + n_emit)
        return em, cache, state

    def _fused_spec_step(self, params, cache: Dict, state: Dict,
                         gen: torch.Generator):
        """One fused speculative micro-step: prompt slices of mid-prefill
        slots beside the verify rows of decoding slots.  A slot whose
        prefill completes commits exactly its first token (drafting
        starts the next micro-step); a mid-prefill slot's draft rows are
        not fed and its accept verdict is discarded.  Only the last
        ``K + 1`` rows go through the LM head."""
        S, k1 = self.chunk_rows, self.k1
        len_, active = cache["len"], state["active"]
        drafts, qprobs = self.drafter.propose(self.draft_params, cache,
                                              state, gen, self.top_k)
        toks, wm, n, prefilling, completing = self.micro_inputs(
            cache, state, drafts)
        decoding = active & ~prefilling
        h, cache = verify_hidden(
            params, self.cfg, toks, cache, write_mask=wm,
            paged_kernel=self.paged_kernel,
            spec_slack=self.spec.spec_tokens, n_rows=n)
        logits = layers.logits(params["embed"], self.cfg, h[:, S - k1:])
        cand, n_acc = sampling.spec_accept(logits, drafts, qprobs,
                                           state["temp"], self.top_k, gen)
        first = sampling.sample(logits[:, -1], gen, temperature=state["temp"],
                                top_k=self.top_k)
        state, _ = sampling.decode_update(state, first, commit=completing)
        state, em, n_emit = sampling.spec_update(state, cand, n_acc,
                                                 commit=decoding)
        idx = torch.arange(k1, device=self.device)[None, :]
        em = torch.where(completing[:, None] & (idx == 0), first[:, None], em)
        cache = dict(cache, len=len_ + torch.where(prefilling, n, n_emit))
        return em, cache, state

    # --------------------------------------------- two-executable prefill
    def prefill(self, params, tokens: torch.Tensor, length: torch.Tensor,
                temp: torch.Tensor, gen: torch.Generator):
        """Bucketed batch-1 prefill and on-device first-token sampling:
        tokens [1, bucket], length [1] int32, temp [1] -> (first token [1]
        int32, cache of per-layer ``{"k","v"}`` [1,Hkv,bucket,dh], or the
        state of a Mamba2 or rwkv6 layer).  Its attention is one
        ``flash_attention`` launch per attention layer, its Mamba2 scan
        one ``mamba2_scan`` launch per Mamba2 layer, its wkv one
        ``rwkv6_wkv`` launch per rwkv6 layer.  A patch-frontend arch's
        first ``frontend_len`` positions take the zero stub."""
        batch = {"tokens": tokens}
        if self.frontend is not None:
            batch["frontend"] = self.frontend
        logits, one = forward_prefill(params, self.cfg, batch, length=length)
        tok = sampling.sample(logits, gen, temperature=temp,
                              top_k=self.top_k)
        return tok, one

    def prefill_suffix(self, params, tokens: torch.Tensor,
                       length: torch.Tensor, off: int,
                       ctx_row: torch.Tensor, cache: Dict,
                       temp: torch.Tensor, gen: torch.Generator):
        """Suffix prefill: ``tokens`` [1, bucket] hold the prompt's tail
        at positions ``off + i``; the first ``off`` tokens are attended
        through the pool pages named in ``ctx_row`` (the slot's own table
        row: shared pages, a CoW copy, or the pages earlier segments of
        an overlong prompt spliced) without being recomputed."""
        pools = [c if (c is not None and "pk" in c) else None
                 for c in cache["layers"]]
        ctx = {"off": off, "row": ctx_row, "layers": pools}
        logits, one = forward_prefill(params, self.cfg, {"tokens": tokens},
                                      length=length, ctx=ctx)
        tok = sampling.sample(logits, gen, temperature=temp,
                              top_k=self.top_k)
        return tok, one

    def draft_prefill(self, tokens: torch.Tensor,
                      length: torch.Tensor) -> List[Dict]:
        """The model drafter's prefill of the whole prompt (same bucket):
        per-layer dense KV ``{"k","v": [1,Hkv,bucket,dh]}``; its logits
        are dropped, the first proposal comes from a draft decode step."""
        _, one = forward_prefill(self.draft_params, self.drafter.cfg,
                                 {"tokens": tokens}, length=length)
        return one["layers"]

    # --------------------------------------------------------- admission
    def admit_prefilled(self, cache: Dict, state: Dict, en: Dict) -> None:
        """Two-executable admission of one slot, in place: splice its
        prefill's KV into its pages, install its table rows, set ``len``
        to the prompt length and arm it with its prefill-sampled first
        token, which ``out_len0`` already counts."""
        slot = en["slot"]
        cache_mod.admit_cache(self.spec, cache, en["one_cache"], slot,
                              en["start"], en["plen"], en["rows"])
        if en.get("draft") is not None:
            # the draft prefill into the slot's row of the dense draft
            # cache, positions 0..; its pad tail is overwritten by later
            # draft decode writes before any read
            for big, small in zip(cache["draft"], en["draft"]):
                for key in ("k", "v"):
                    n = min(small[key].shape[2], big[key].shape[2])
                    big[key][slot:slot + 1, :, :n].copy_(small[key][:, :, :n])
        at = slice(slot, slot + 1)   # fill_: no blocking copy
        state["tokens"][at].copy_(en["tok"])
        state["out_len"][at].fill_(en["out_len0"])
        state["max_new"][at].fill_(en["max_new"])
        state["eos"][at].fill_(en["eos"])
        state["temp"][at].fill_(en["temp"])
        # a max_new = 1 request is done with its first token
        state["active"][at].fill_(en["out_len0"] < en["max_new"])
        if "hist" in state:
            # the n-gram corpus: the prompt, then the prefill-sampled
            # token (in the spill column when the prompt fills the row)
            hist = state["hist"]
            cap = hist.shape[1] - 1
            row = np.zeros((1, cap + 1), np.int32)
            head = en["prompt"][:cap]
            row[0, :len(head)] = head
            hist[at].copy_(host_to_device(row, self.device))
            pos = min(en["plen"], cap)
            hist[at, pos:pos + 1].copy_(en["tok"][:, None])
            state["hist_len"][at].fill_(en["plen"] + 1)

    def admit(self, cache: Dict, state: Dict, entries: List[Dict]) -> None:
        """Fused admission, in place: install each slot's page-table rows,
        rewind its ``len`` to the prefill cursor, stage its prompt and arm
        it; no KV is written (the chunk prefills)."""
        if not entries:
            return
        dev = self.device
        for en in entries:
            cache_mod.install_slot_rows(self.spec, cache, en["slot"],
                                        en["start"], en["rows"])
        idx = host_to_device([en["slot"] for en in entries], dev,
                             torch.int64)

        def put(name, values, dtype=torch.int32):
            state[name][idx] = host_to_device(np.asarray(values), dev, dtype)

        put("tokens", [0] * len(entries))
        put("out_len", [en["out_len0"] for en in entries])
        put("max_new", [en["max_new"] for en in entries])
        put("eos", [en["eos"] for en in entries])
        put("temp", [en["temp"] for en in entries], torch.float32)
        put("active", [en["out_len0"] < en["max_new"] for en in entries],
            torch.bool)
        put("plen", [en["plen"] for en in entries])
        put("prompt", np.stack([en["prompt"] for en in entries]))
        if "hist" in state:
            # the n-gram corpus starts as the prompt; the chunk appends
            cap1 = state["hist"].shape[1]
            rows = np.zeros((len(entries), cap1), np.int32)
            for i, en in enumerate(entries):
                m = min(en["plen"], cap1)
                rows[i, :m] = en["prompt"][:m]
            put("hist", rows)
            put("hist_len", [en["plen"] for en in entries])

    def copy_page(self, cache: Dict, src: int, dst: int,
                  group_key: str) -> None:
        cache_mod.copy_shared_page(self.spec, cache, group_key, src, dst)

    def free_slot(self, cache: Dict, slot: int) -> None:
        cache_mod.free_slot_cache(self.spec, cache, slot)

    def deactivate(self, state: Dict, slot: int) -> None:
        """Clear a slot's active flag in place (preemption or reaping at
        a chunk boundary): its dead-tail micro-steps neither sample nor,
        with its table rows trashed by ``free_slot``, write KV anywhere
        that matters.  ``fill_``: no host synchronization."""
        state["active"][slot:slot + 1].fill_(False)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _unsupported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet (ROADMAP {item})")


class Engine:
    """Host driver of the port's serving engine.

    ``chunked_prefill``: ``True`` streams prompts through the fused
    chunk, ``prefill_budget`` tokens per slot per micro-step; ``False``
    prefills each admission in a batch-1 bucket (``buckets``, default
    powers of two from ``min_bucket`` up to ``max_len``) and decodes
    one token per slot per micro-step; ``"auto"`` is fused exactly where
    the reference picks it (attention-only stacks).  zamba2 (Mamba2 +
    shared attention) and rwkv6 (no attention, no pools) run on two
    executables: their state admits by a copy into the slot's row, they
    share no prefixes, and a prompt longer than the largest bucket takes
    a larger bucket (no segments).

    ``device`` (default: the card; raises without one) holds params,
    pools and slot state.  ``paged_kernel``: ``True`` reads the pools
    through ``kernels/paged_attention`` (the Hopper kernel on CUDA
    tensors, its plain version on the CPU), ``False`` gathers each slot's
    ring, ``"auto"`` is the kernel exactly when the device is CUDA; an
    arch with no paged layer reads no pools (``paged_kernel`` False).
    ``max_len`` is the logical per-slot token cap; ``num_pages`` the
    full-attention pool budget (default ``slots`` x widest ring, under
    which no pool pressure can arise).

    ``kv_dtype`` is the pool precision: ``"auto"`` (fp32), ``"fp32"``,
    ``"int8"`` or ``"fp8_e4m3"`` (8-bit pages with per-page, per-kv-head
    fp32 scales).  One departure from the reference, which falls back to
    fp32 pools when it cannot store a dtype: the port never does.  An
    8-bit dtype is served in 8 bits, through the quantized kernel on the
    card, or the launch raises.

    ``spec`` turns on speculative decoding for attention-only archs:
    ``"ngram"``, a draft config name (``reduced(get_config(name))``), or
    a ``SpecConfig``.  A model drafter forces two executables (its dense
    draft cache is filled by a draft prefill) and, without
    ``draft_params``, draws its weights from a generator seeded
    ``seed + 17`` on the engine's device.  Windowed rings carry the
    verify rows' slack (``CacheSpec(spec_tokens=...)``).

    Robustness and SLO policy, as the reference's (all of it on the host
    at chunk boundaries).  ``preemption``: under page-pool pressure with
    a slot free, evict a victim (lowest SLO class, fewest tokens
    decoded, most radix-recoverable pages, lowest slot), preserve its
    written pages in the radix index and requeue it; it resumes with its
    emitted tokens replayed as prompt.  ``clock`` (default
    ``time.monotonic``) stamps submits, tokens and deadlines; a
    ``serve/traffic.VirtualClock`` makes them replayable.
    ``queue_limit`` bounds the queue and ``shed_policy`` handles a
    submit to a full one: ``"reject"``, ``"block"`` (serve until there
    is room), ``"evict-lru-prefix"`` (reclaim unreferenced radix pages
    and admit first) or ``"shed-lowest-class"`` (drop the lowest-class
    queued request for a more urgent one).  ``policy="slo"`` orders the
    queue by class then TTFT slack, picks victims by class, and
    throttles non-interactive slots' prompt slices to ``max(1, S // 4)``
    while an interactive request waits past its TTFT target.
    ``stall_patience``: drains without progress before the watchdog
    preempts a slot (0: off; 4 under a chaos schedule with stalls).
    ``chaos``: a ``serve/chaos.ChaosMonkey``.  ``trace``: ``True``, a
    ring capacity or a ``serve/trace.Tracer`` records lifecycle events
    (``export_trace``, ``explain``)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 sync_interval: int = 8, min_bucket: int = 8,
                 buckets: Optional[List[int]] = None, page_size: int = 8,
                 num_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 paged_kernel: Any = "auto",
                 chunked_prefill: Any = "auto",
                 prefill_budget: int = 32,
                 kv_dtype: str = "auto",
                 device: DeviceLike = None,
                 spec: Any = None, rules: Any = None,
                 preemption: bool = True,
                 queue_limit: Optional[int] = None,
                 shed_policy: str = "reject",
                 policy: str = "fifo",
                 clock: Optional[Callable[[], float]] = None,
                 stall_patience: int = 0,
                 chaos: Optional[ChaosMonkey] = None,
                 trace: Any = None):
        if cfg.cross_attention:
            raise NotImplementedError(
                "Engine serves decoder-only archs; whisper runs through "
                "forward_prefill, prepare_decode_cache and forward_decode")
        if rules is not None and not isinstance(rules, sh.Rules):
            raise TypeError(f"rules must be a parallel.sharding.Rules, got "
                            f"{rules!r}")
        if rules is not None and any(b.ffn == "moe" for b in cfg.blocks):
            # a rank's dispatch would drop other tokens than the
            # reference's global dispatch at a binding capacity
            raise _unsupported("an MoE arch under rules=", "A19")
        if shed_policy not in ("reject", "block", "evict-lru-prefix",
                               "shed-lowest-class"):
            raise ValueError(f"shed_policy must be 'reject', 'block', "
                             f"'evict-lru-prefix' or 'shed-lowest-class', "
                             f"got {shed_policy!r}")
        if trace in (None, False):
            tracer = None
        elif isinstance(trace, trace_mod.Tracer):
            tracer = trace
        elif trace is True:
            tracer = trace_mod.Tracer()
        elif isinstance(trace, int):
            tracer = trace_mod.Tracer(capacity=trace)
        else:
            raise TypeError(f"trace must be None/bool/int/Tracer, "
                            f"got {trace!r}")
        requested = "fp32" if kv_dtype == "auto" else kv_dtype
        if requested not in cache_mod.KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be 'auto' or one of {cache_mod.KV_DTYPES}, "
                f"got {kv_dtype!r}")
        if spec in (None, False, "off"):
            spec_cfg = None
        elif isinstance(spec, SpecConfig):
            spec_cfg = spec
        elif isinstance(spec, str):
            spec_cfg = SpecConfig(draft=spec)
        else:
            raise TypeError(f"spec must be None, 'ngram', a draft config "
                            f"name, or a SpecConfig; got {spec!r}")
        if spec_cfg is not None:
            check_spec_capable(cfg)
            if spec_cfg.k < 1:
                raise ValueError(f"spec.k must be >= 1, got {spec_cfg.k}")
        model_draft = spec_cfg is not None and spec_cfg.draft != "ngram"
        reason = spec_unsupported_reason(cfg)
        # fused exactly where the reference picks it: attention-only
        # stacks, and no model drafter (its draft cache needs a prefill)
        if chunked_prefill == "auto":
            chunked_prefill = reason is None and not model_draft
        elif chunked_prefill and (reason is not None or model_draft):
            raise ValueError(
                f"{cfg.name}: chunked_prefill needs paged KV for every "
                "mixer (attention-only stack) and no model drafter; "
                f"reason: {reason or 'model drafter'}")
        if prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")
        if rules is not None and spec_cfg is not None:
            raise _unsupported("speculative decoding under rules=", "A20")
        self.device = resolve_device(device)
        pdev = next(params.parameters()).device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        if temperature > 0.0:
            self.default_temp = float(temperature)
        else:
            self.default_temp = 0.0 if greedy else 1.0
        self.top_k = int(top_k)
        self.sync_interval = int(sync_interval)
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_budget = (int(prefill_budget) if self.chunked_prefill
                               else 0)
        if buckets is None:
            b, buckets = min_bucket, []
            while b < _next_pow2(max_len):
                buckets.append(b)
                b *= 2
            buckets.append(b)
        self.buckets = sorted(set(int(b) for b in buckets))
        self.requested_kv_dtype = requested
        self.kv_dtype = requested
        self.spec_config = spec_cfg
        k = spec_cfg.k if spec_cfg is not None else 0
        self.drafter = None
        self.draft_params = None
        if spec_cfg is not None and not model_draft:
            self.drafter = NGramDrafter(k, spec_cfg.ngram)
        elif spec_cfg is not None:
            dcfg = spec_cfg.draft_cfg
            if dcfg is None:
                dcfg = reduced(get_config(spec_cfg.draft))
            self.drafter = ModelDrafter(dcfg, k, cache_tokens=max_len + k + 1)
            self.draft_params = spec_cfg.draft_params
            if self.draft_params is None:
                self.draft_params = init_params(model_defs(dcfg), seed + 17,
                                                device=self.device)
        if chaos is not None and chaos.garbage_drafter \
                and self.drafter is not None:
            # fault isolation: rejection sampling keeps the output
            # token-identical however bad the drafts are
            self.drafter = GarbageDrafter(self.drafter)
        # the history buffer is the n-gram drafter's lookup corpus; a
        # model drafter never reads it
        self._hist_cap = (max_len + k + 2
                          if spec_cfg is not None and not model_draft else 0)
        # windowed rings need ring >= window + S - 1 so the widest
        # micro-step (a fused prefill slice of ``prefill_budget`` rows or
        # K + 1 verify rows) may write-wrap legitimately (capped in
        # CacheSpec)
        cache_slack = max(k, self.prefill_budget - 1)
        self.spec = CacheSpec.from_config(
            cfg, slots, max_len, page_size=page_size, num_pages=num_pages,
            spec_tokens=cache_slack, kv_dtype=self.kv_dtype)
        # data-parallel placement: this rank's shard of the slots and pages
        self.rules = rules
        self.shards, self.shard, self._dp_group = 1, 0, None
        # this rank's first slot and, per pool group, its first page id
        self._slot_lo, self._page_lo = 0, {g.key: 0 for g in self.spec.groups}
        if rules is not None:
            self._place(rules)
        if self.shards > 1:
            # every rank must take the same host decisions, and these
            # read the rank's own clock
            if policy == "slo":
                raise _unsupported("policy='slo' across ranks", "A22")
            if shed_policy == "shed-lowest-class":
                raise _unsupported(
                    "shed_policy='shed-lowest-class' across ranks", "A22")
        self.local_spec = self.spec.rank_spec(self.shards)
        self._lslots = self.local_spec.slots
        if paged_kernel == "auto":
            paged_kernel = self.device.type == "cuda"
        # an arch with no paged layer (rwkv6) has no pools to read
        self.paged_kernel = bool(paged_kernel) and self.spec.has_paged
        # fused prompts enter the radix index once their pages are written
        # (a later drain); a two-executable admission writes them at once.
        # policy: "fifo" (arrival order) or "slo" (class, then TTFT slack)
        self.policy = policy
        self.scheduler = Scheduler(self.spec, prefix_sharing=prefix_sharing,
                                   defer_radix_insert=self.chunked_prefill,
                                   policy=policy, shards=self.shards)
        self.executor = Executor(cfg, self.local_spec, top_k=self.top_k,
                                 sync_interval=self.sync_interval,
                                 paged_kernel=self.paged_kernel,
                                 chunked=self.chunked_prefill,
                                 prefill_budget=self.prefill_budget,
                                 device=self.device, drafter=self.drafter,
                                 draft_params=self.draft_params)
        self._slot_req: List[Optional[Request]] = [None] * slots
        # two executables: whether a slot's prefill-sampled first token
        # waits in ``_first_tok`` (its rank's row, on the device) for the
        # drain to fetch it with the chunk's history
        self._slot_first: List[bool] = [False] * slots
        self._first_tok = torch.full((self._lslots,), -1, dtype=torch.int32,
                                     device=self.device)
        # drains in a row without progress (the stall watchdog's count)
        self._slot_stale: List[int] = [0] * slots
        # host-visible prefill cursor (trails the device's cache["len"] by
        # one drain) and the admission-time prompt length it counts toward
        self._slot_seen_len: List[int] = [0] * slots
        self._slot_plen: List[int] = [0] * slots
        self.cache = self.local_spec.init_paged_cache(self.device)
        if self.drafter is not None and self.drafter.kind == "model":
            self.cache["draft"] = self.drafter.init_cache(slots, self.device)
        S = self.executor.chunk_rows
        self.state = sampling.make_slot_state(
            self._lslots, self.device,
            max_len if self.chunked_prefill else 0,
            hist_cap=self._hist_cap, spec=spec_cfg is not None,
            prefill_budget=S if self.chunked_prefill else 0)
        # host mirror of state["pbudget"]: the SLO boundary policy uploads
        # a new vector only when the wanted one changes
        self._budget_vec: Optional[List[int]] = (
            [S] * slots if self.chunked_prefill else None)
        self.budget_throttles = 0
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed + self.shard)
        self._clock = clock if clock is not None else time.monotonic
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.steps = 0          # micro-steps run
        self.host_syncs = 0
        # chunk sequence number: one per drain, stamped on every drained
        # token (Request.token_chunks), every admission (the admission
        # log's 5th element) and every trace event at the boundary
        self.chunks = 0
        self.peak_live_slots = 0
        # the distinct prefill shape signatures run, keyed as the
        # reference keys its jit caches (see ``prefill_compiles``)
        self._shapes: Dict[str, set] = {"prefill": set(), "suffix": set()}
        self._warmed = False

        # ---- robustness: preemption / deadlines / admission control
        self.preemption = bool(preemption)
        self.queue_limit = queue_limit
        self.shed_policy = shed_policy
        self.tracer = tracer
        self.chaos = chaos
        self.scheduler.chaos = chaos
        if chaos is not None and self.tracer is not None:
            chaos.on_event = self._chaos_event
        if chaos is not None and chaos.p_stall > 0 and stall_patience <= 0:
            stall_patience = 4   # a stall must end in watchdog recovery
        self.stall_patience = int(stall_patience)
        self.fault_counters: Dict[str, int] = {
            "preemptions": 0, "pressure_preemptions": 0,
            "chaos_preemptions": 0, "watchdog_preemptions": 0,
            "resumes": 0, "timed_out": 0, "cancelled": 0,
            "rejected": 0, "rejected_infeasible": 0,
            "rejected_queue_full": 0, "rejected_shed_lower_class": 0,
        }
        # every preemption, in order: the victim's class and the classes
        # of the other preemptable slots live at that instant
        self.preemption_log: List[Dict[str, Any]] = []

    # ------------------------------------------------------------ placement
    def _place(self, rules: sh.Rules) -> None:
        """Read this rank's shard off the cache's placements
        (``CacheSpec.shardings``): the mesh axis ``len``'s slot dim shards
        on, its size and this rank's coordinate, and the data group the
        drain gathers over.  Every pool must shard on that axis too;
        when the slot dim falls back to replicated, every pool is
        replicated with it (logged)."""
        from torch.distributed.tensor import Shard

        if any(ls.kind == STATE for ls in self.spec.layers):
            raise _unsupported("a recurrent arch under rules=", "A20")
        if not sh.is_device_mesh(rules.mesh):
            raise ValueError("rules= needs a DeviceMesh "
                             "(launch/mesh.device_mesh); a descriptor "
                             "places nothing")
        placed = self.spec.shardings(rules)
        names = list(rules.mesh.mesh_dim_names)

        def axes(placement) -> List[str]:
            return [names[i] for i, p in enumerate(placement)
                    if isinstance(p, Shard)]

        batch = axes(placed["len"])
        pools = {(g, k): axes(leaf[k]) for g, leaf in enumerate(
            placed["layers"]) for k in leaf}
        if not batch:
            if any(pools.values()):
                rules.fallbacks.append(
                    f"{sh.PAGES}: the slots are replicated, so is every "
                    "pool")
            return
        for (layer, key), got in pools.items():
            if got != batch:
                raise ValueError(
                    f"layer {layer} {key}: a pool shards on {got}, the "
                    f"slots on {batch}; a rank's kernels read only its "
                    f"own pages (Rules.fallbacks: {rules.fallbacks})")
        axis = batch[0]
        self.shards = rules.mesh_size(axis)
        self.shard = rules.coordinate(axis)
        self._dp_group = rules.mesh.get_group(axis)
        self._slot_lo = rules.local_range((axis,), (self.spec.slots,))[0]
        self._page_lo = {g.key: rules.local_range((axis,), (g.num_pages,))[0]
                         for g in self.spec.groups}

    def _local_slot(self, slot: int) -> Optional[int]:
        """``slot``'s row on this rank, or None when another rank's."""
        ls = slot - self._slot_lo
        return ls if 0 <= ls < self._lslots else None

    def _local_rows(self, rows: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """Page-table rows in this rank's page ids: its pages from 0, the
        trash page its own."""
        if self.shards == 1:
            return rows
        out = {}
        for g, lg in zip(self.spec.groups, self.local_spec.groups):
            row = np.asarray(rows[g.key])
            out[g.key] = np.where(row == g.trash_page, lg.trash_page,
                                  row - self._page_lo[g.key]).astype(np.int32)
        return out

    # ------------------------------------------------------ shape counters
    @property
    def prefill_compiles(self) -> int:
        """Distinct full-prefill shapes run: (bucket, largest bucket).
        Eager torch compiles nothing; these counters count what the
        reference's ``jit`` caches hold on the same traffic (the
        executables it compiles) and the CUDA graphs one capture per
        shape would need.  0 in the fused mode, which has no prefill."""
        return len(self._shapes["prefill"])

    @property
    def suffix_prefill_compiles(self) -> int:
        """Distinct suffix-prefill shapes: (suffix bucket, context pages
        rounded up to a power of two and capped at the ring, largest
        bucket)."""
        return len(self._shapes["suffix"])

    @property
    def admit_compiles(self) -> int:
        """Distinct admission-splice shapes: one once a request was
        admitted (the fused mode has one splice shape; on two executables
        the reference pads every prefill's KV to the largest bucket)."""
        return int(self.scheduler.admissions_total > 0)

    @property
    def decode_compiles(self) -> int:
        """Distinct chunk shapes: one once a chunk ran (warmup's
        included)."""
        return int(self._warmed or self.steps > 0)

    # ---------------------------------------------------------- telemetry
    @property
    def queue(self) -> List[Request]:
        return self.scheduler.queue

    def memory_stats(self) -> Dict[str, Any]:
        """Paged-cache memory telemetry (per-group page occupancy and
        pool bytes per live token at the current instant), over every
        rank; under ``rules=`` also ``"rank"``, this rank's share."""
        live = sum(len(r.out_tokens) + len(r.prompt)
                   for r in self._slot_req if r is not None)
        stats = self.spec.memory_stats(
            self.scheduler.pages_in_use_by_group, live)
        stats["peak_pages_in_use"] = self.scheduler.peak_pages_in_use
        stats["live_slots"] = sum(r is not None for r in self._slot_req)
        stats["peak_live_slots"] = self.peak_live_slots
        if self.rules is not None:
            mine = self.scheduler.pages_in_use_in(self.shard)
            stats["rank"] = {
                "shard": self.shard, "shards": self.shards,
                "slots": self._lslots,
                "live_slots": sum(self._local_slot(s) is not None
                                  for s, r in enumerate(self._slot_req)
                                  if r is not None),
                "num_pages": self.local_spec.total_pages(),
                "pages_in_use": sum(mine.values()),
                "pages_in_use_by_group": mine,
                "paged_kv_bytes": self.local_spec.paged_kv_bytes()}
        return stats

    def prefix_stats(self) -> Dict[str, Any]:
        return self.scheduler.prefix_stats()

    def spec_stats(self) -> Dict[str, Any]:
        """Speculative-decoding telemetry: acceptance rate (accepted over
        drafted tokens) and committed tokens per verify step, from the
        device counters ``sampling.spec_update`` keeps.  Reading them is
        one device-to-host copy: call it between runs."""
        if self.spec_config is None:
            return {"spec": False}
        steps, drafted, accepted, emitted = torch.stack(
            [self.state[c] for c in ("spec_steps", "spec_drafted",
                                     "spec_accepted", "spec_emitted")]
        ).tolist()
        return {
            "spec": True,
            "drafter": self.drafter.kind,
            "spec_k": self.spec_config.k,
            "spec_steps": steps,
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "acceptance_rate": accepted / drafted if drafted else 0.0,
            "emitted_tokens": emitted,
            "tokens_per_step": emitted / steps if steps else 0.0,
        }

    def latency_stats(self) -> Dict[str, Any]:
        """TTFT/TPOT p50/p99 per SLO class + goodput (seconds), from the
        host-side stamps the drain puts on every request
        (``compute_latency_stats``), over every request this engine has
        seen: finished, rejected, running and queued.
        ``budget_throttles`` counts the SLO policy's prefill-budget
        throttles (fused engines; 0 elsewhere)."""
        reqs = (list(self.finished) + list(self.rejected)
                + [r for r in self._slot_req if r is not None]
                + list(self.scheduler.queue))
        stats = compute_latency_stats(reqs)
        stats["budget_throttles"] = self.budget_throttles
        return stats

    def fault_stats(self) -> Dict[str, Any]:
        """Robustness telemetry: preemption / resume / timeout /
        cancellation / rejection counters, the recovered-prefill fraction
        of resumed admissions (replayed tokens that rode on radix pages
        instead of being recomputed), and the chaos schedule's own event
        counts when fault injection is active."""
        sched = self.scheduler
        stats: Dict[str, Any] = dict(self.fault_counters)
        stats["resume_admissions"] = sched.resume_admissions
        stats["resume_replayed_tokens"] = sched.resume_replayed_tokens
        stats["resume_recovered_tokens"] = sched.resume_recovered_tokens
        stats["recovered_prefill_fraction"] = (
            sched.resume_recovered_tokens / sched.resume_replayed_tokens
            if sched.resume_replayed_tokens else 0.0)
        if self.chaos is not None:
            stats["chaos"] = self.chaos.stats()
        return stats

    def leaked_pages(self) -> int:
        """Pages leased beyond what live slots and the radix index hold;
        nonzero at full drain is a refcount leak."""
        sched = self.scheduler
        leaked = 0
        for key, pool in sched.pools.items():
            accounted = set()
            for lease in sched._leases.values():
                accounted.update(lease.get(key, ()))
            if sched.radix is not None and key == sched.share_key:
                accounted.update(node.page for node in sched.radix.nodes())
            leaked += pool.in_use - len(accounted)
        return leaked

    # ------------------------------------------------------ observability
    def _trace(self, kind: str, rid: Optional[int] = None,
               slot: Optional[int] = None, ts: Optional[float] = None,
               **attrs: Any) -> None:
        """Record one lifecycle event when tracing is on.  Host-only, at
        chunk boundaries, with the boundary's clock read where one exists
        (``ts``): the chunk stays sync-free and traced runs stay
        token-identical."""
        if self.tracer is None:
            return
        self.tracer.record(kind, self._clock() if ts is None else ts,
                           rid=rid, slot=slot, **attrs)

    def _chaos_event(self, fault: str, **attrs: Any) -> None:
        slot = attrs.pop("slot", None)
        self._trace("chaos", slot=slot, fault=fault, **attrs)

    def observe(self, *, spec: bool = True) -> Dict[str, Any]:
        """One flat snapshot of every stats surface under the stable
        dotted names of ``serve/metrics`` (``pool.pages_in_use``,
        ``sched.preemptions.pressure``, ``spec.acceptance``, ...).
        ``spec=False`` skips the one device read behind
        ``spec_stats``."""
        return metrics_mod.snapshot(self, spec=spec)

    def export_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome-trace / Perfetto JSON of the buffered lifecycle events
        (per-slot tracks, per-request flow arrows across preempt/resume,
        counter tracks for pool occupancy and queue depth), written to
        ``path`` when given.  ``benchmarks/check_trace.py`` validates
        it."""
        if self.tracer is None:
            raise ValueError("tracing is disabled; construct the Engine "
                             "with trace=True (or a capacity / Tracer)")
        obj = trace_mod.to_chrome_trace(self.tracer.events())
        if path is not None:
            with open(path, "w") as f:
                json.dump(obj, f)
        return obj

    def explain(self, rid: int) -> str:
        """Per-request text explain: the causal chain from submit to
        terminal with per-phase durations, from the lifecycle trace."""
        if self.tracer is None:
            raise ValueError("tracing is disabled; construct the Engine "
                             "with trace=True (or a capacity / Tracer)")
        return trace_mod.explain(self.tracer.events(), rid)

    # ------------------------------------------------------------ serving
    def submit(self, req: Request) -> Optional[RequestRejected]:
        """Enqueue a request, or shed it with a typed result.

        Never raises ``PagePoolExhausted``: a request whose worst-case
        reservation exceeds the pool's total budget gets an
        ``"infeasible"`` ``RequestRejected``, and one arriving at a full
        bounded queue is handled by ``shed_policy``.  A ``ttl`` resolves
        to ``deadline = clock() + ttl`` here.  Returns ``None`` when the
        request was accepted.  A request breaking the ``max_len``
        contract still raises ``ValueError``: a caller bug, not load."""
        if self.shards > 1 and (req.ttl is not None
                                or req.deadline is not None):
            raise _unsupported("a ttl or deadline across ranks", "A22")
        if not req.prompt and self.chunked_prefill:
            # two executables admit an empty prompt as the reference
            # does: a fresh slot state, len 0
            raise ValueError("chunked_prefill requires a non-empty prompt")
        if self.cfg.frontend and self._bucket_of(len(req.prompt)) \
                < self.cfg.frontend_len:
            # the frontend's embeddings fill the first frontend_len
            # positions of the prefill; a shorter bucket cannot hold them
            raise ValueError(
                f"{self.cfg.name}: a {len(req.prompt)}-token prompt "
                f"prefills in the {self._bucket_of(len(req.prompt))} "
                f"bucket, shorter than the {self.cfg.frontend_len}-position "
                "frontend")
        if len(req.prompt) + req.max_new_tokens > self.max_len and (
                self.chunked_prefill or not self.cfg.supports_long_context):
            # fused: prompts are staged in a max_len-sized buffer; either
            # mode: a full-attention table caps at max_len tokens, and a
            # longer span would mod-wrap over the oldest (maybe shared) KV
            raise ValueError(
                f"prompt length {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len={self.max_len}")
        try:
            self.scheduler.validate(req)
        except PagePoolExhausted as e:
            return self._reject(req, "infeasible", str(e))
        if req.submit_time is None:       # TTFT clock starts here; a
            req.submit_time = self._clock()   # resume keeps the original
        if req.deadline is None and req.ttl is not None:
            req.deadline = self._clock() + req.ttl
        self._trace("submit", rid=req.rid, ts=req.submit_time,
                    slo_class=req.slo_class, plen=len(req.prompt),
                    max_new=req.max_new_tokens)
        if self.queue_limit is not None \
                and len(self.scheduler.queue) >= self.queue_limit:
            shed = self._shed(req)
            if shed is not None:
                return shed
        self.scheduler.submit(req)
        return None

    def _reject(self, req: Request, kind: str,
                reason: str) -> RequestRejected:
        req.status = RequestStatus.REJECTED
        req.reject_reason = reason
        req.done = True
        if req.finish_time is None:
            req.finish_time = self._clock()
        self.fault_counters["rejected"] += 1
        self.fault_counters[f"rejected_{kind}"] += 1
        self.rejected.append(req)
        self._trace("reject", rid=req.rid, ts=req.finish_time,
                    why=kind, status=req.status)
        return RequestRejected(req=req, kind=kind, reason=reason)

    def _shed(self, req: Request) -> Optional[RequestRejected]:
        """Apply the shed policy to a submission hitting a full queue.
        Returns the rejection, or None once there is room."""
        def room() -> bool:
            return len(self.scheduler.queue) < self.queue_limit

        if self.shed_policy == "block":
            # submission backpressure: serve until the queue drains
            # (bounded: every step finishes or reaps work)
            for _ in range(100_000):
                if room():
                    return None
                if not (self.scheduler.queue or self._live()):
                    break
                self.step()
            if room():
                return None
        elif self.shed_policy == "evict-lru-prefix":
            sched = self.scheduler
            if sched.radix is not None:
                pool = sched.pools[sched.share_key]
                while sched.radix.evict_one(pool) is not None:
                    sched.radix_evictions += 1
            self._reap()
            self._admit()
            if room():
                return None
        elif self.shed_policy == "shed-lowest-class":
            # drop the queued request of the strictly lowest-priority
            # class (worst slack on ties) to make room for a more urgent
            # arrival; when none ranks below the arrival, it sheds itself
            now = self._clock()
            queue = self.scheduler.queue
            victim = max(
                (r for r in queue if r.priority > req.priority),
                key=lambda r: (r.priority, -r.ttft_slack(now)),
                default=None)
            if victim is not None:
                queue.remove(victim)
                self.fault_counters["rejected_shed_lower_class"] += 1
                self._reject(
                    victim, "queue_full",
                    f"shed for higher-priority rid={req.rid} "
                    f"({req.slo_class} over {victim.slo_class})")
                return None
        return self._reject(
            req, "queue_full",
            f"admission queue full ({self.queue_limit} waiting, "
            f"shed_policy={self.shed_policy})")

    def warmup(self) -> None:
        """Run one inert prefill per bucket (two executables; results
        dropped) and one inert chunk (every slot idle: all writes land on
        trash pages), so serving pays no kernel build, library
        initialization or first use of a bucket's shapes.  The sampling
        generator and every slot's ``len`` are restored afterwards, so
        seeded runs are identical with or without warmup."""
        gen_state = self.gen.get_state()
        if not self.chunked_prefill:
            zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
            for b in self.buckets:
                if b < self.cfg.frontend_len:
                    continue        # no prompt of a frontend arch takes it
                self._shapes["prefill"].add((b, self.buckets[-1]))
                tokens = torch.zeros((1, b), dtype=torch.int32,
                                     device=self.device)
                self.executor.prefill(self.params, tokens, zero,
                                      zero.float(), self.gen)
                if self.draft_params is not None:
                    self.executor.draft_prefill(tokens, zero)
        self._warmed = True
        _, self.cache, self.state = self.executor.chunk(
            self.params, self.cache, self.state, self.gen)
        # the S = 1 decode advanced every idle slot's len
        self.cache["len"].zero_()
        self.gen.set_state(gen_state)

    def _req_temp(self, req: Request) -> float:
        if req.temperature is not None:
            return float(req.temperature)
        return self.default_temp

    # ------------------------------------------ two-executable prefill
    def _bucket_of(self, plen: int) -> int:
        """The bucket a ``plen``-token prefill takes (no side effect)."""
        for b in self.buckets:
            if b >= plen:
                return b
        return _next_pow2(max(plen, 1))

    def bucket_for(self, plen: int) -> int:
        b = self._bucket_of(plen)
        if b not in self.buckets:
            self.buckets.append(b)
            self.buckets.sort()
        return b

    def _ctx_row(self, adm, s: int) -> np.ndarray:
        """The ``ceil(s/P)`` context pages a suffix prefill at offset
        ``s`` gathers, from the slot's page row (in its rank's page ids).
        The reference pads the row to a power of two of trash pages to
        bound its executables; eager torch compiles nothing per shape."""
        nctx = -(-s // self.spec.page_size)
        key = self.spec.share_group_key
        return np.asarray(self._local_rows(adm.rows)[key][:nctx], np.int32)

    @property
    def _chunked_ok(self) -> bool:
        """Prompts longer than the largest bucket run as segments when the
        arch has the suffix machinery (one full-attention pool group) and
        no model drafter (whose draft prefill has no suffix path)."""
        return (self.spec.prefix_sharing_capable
                and (self.drafter is None or self.drafter.kind != "model"))

    def _bucketed(self, toks: List[int]):
        """(tokens [1, bucket] zero-padded, length [1]) on the device,
        with no host synchronization."""
        bucket = self.bucket_for(len(toks))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(toks)] = toks
        length = torch.full((1,), len(toks), dtype=torch.int32,
                            device=self.device)
        return host_to_device(padded, self.device), length

    def _prefill_at(self, adm, toks: List[int], s: int,
                    temp: Optional[torch.Tensor]):
        """Prefill ``toks`` at positions ``s..``: a full prefill from 0,
        else a suffix prefill against the slot's first ``s`` tokens.
        ``temp`` None: the slot is another rank's, so only the shape
        counters move (every rank's host state stays the same) and
        ``(None, None)`` comes back."""
        bucket, bmax = self.bucket_for(len(toks)), self.buckets[-1]
        if s == 0:
            self._shapes["prefill"].add((bucket, bmax))
        else:
            ctx_row = self._ctx_row(adm, s)
            ring = self.spec.group_of(self.spec.share_group_key).ring_blocks
            self._shapes["suffix"].add(
                (bucket, min(_next_pow2(len(ctx_row)), ring), bmax))
        if temp is None:
            return None, None
        tokens, length = self._bucketed(toks)
        if s == 0:
            return self.executor.prefill(self.params, tokens, length, temp,
                                         self.gen)
        row = host_to_device(ctx_row, self.device)
        return self.executor.prefill_suffix(self.params, tokens, length, s,
                                            row, self.cache, temp, self.gen)

    def _chunked_prefill(self, adm, s: int) -> int:
        """Run all but the final ``<= Bmax`` prompt tokens of an overlong
        prompt as ``Bmax``-token segments, each attending to the pages the
        earlier ones spliced, and return the final segment's start
        (another rank's slot: the host's part only)."""
        prompt = adm.req.effective_prompt
        bmax = self.buckets[-1]
        owned = self._local_slot(adm.slot) is not None
        temp = (torch.zeros((1,), dtype=torch.float32, device=self.device)
                if owned else None)
        cur = s
        while len(prompt) - cur > bmax:
            _tok, one = self._prefill_at(adm, list(prompt[cur:cur + bmax]),
                                         cur, temp)
            if owned:
                # the slot's table row and len are installed once, at its
                # final admission; later segments read these pages by row
                cache_mod.splice_prefill(self.local_spec, self.cache, one,
                                         cur, bmax, self._local_rows(adm.rows))
            cur += bmax
        return cur

    def _admit_prefilled(self, adm) -> None:
        """Two-executable admission of one request, applied at once:
        copy-on-write, the prefill (full, suffix, or segments then a
        suffix), the splice and the slot's arming.  Applying each
        admission before the next is planned keeps the reference's rule
        that an admission reading pool pages (a CoW source, a prefix
        context) sees every earlier admission's splice.  No host
        synchronization: the first token stays on the device.  Another
        rank's slot takes the host's part only."""
        req, slot = adm.req, adm.slot
        local = self._local_slot(slot)
        prompt = req.effective_prompt
        plen = len(prompt)
        temp_v = self._req_temp(req)
        temp = None
        if local is not None:
            temp = torch.full((1,), temp_v, dtype=torch.float32,
                              device=self.device)
        if adm.cow is not None and local is not None:
            # the slot will write into a shared page: a private copy
            # before any prefill reads it or the splice writes it
            _blk, src, dst = adm.cow
            key = self.scheduler.share_key
            lo = self._page_lo[key]
            self.executor.copy_page(self.cache, src - lo, dst - lo, key)
        s = adm.suffix_start
        if plen - s > self.buckets[-1] and self._chunked_ok:
            s = self._chunked_prefill(adm, s)
        tok, one = self._prefill_at(adm, list(prompt[s:]), s, temp)
        self._slot_req[slot] = req
        self._slot_first[slot] = True
        if local is None:
            return
        draft = None
        if self.draft_params is not None:
            draft = self.executor.draft_prefill(*self._bucketed(list(prompt)))
        self.executor.admit_prefilled(self.cache, self.state, {
            "slot": local, "start": s, "plen": plen,
            "rows": self._local_rows(adm.rows),
            "tok": tok, "one_cache": one, "draft": draft,
            "prompt": list(prompt),
            "out_len0": len(req.out_tokens) + 1,
            "max_new": req.max_new_tokens,
            "eos": -1 if req.eos_id is None else int(req.eos_id),
            "temp": temp_v})
        self._first_tok[local:local + 1].copy_(tok)

    def _admit(self) -> None:
        """Chunk-boundary admission with pool-pressure preemption: admit
        while the queue head fits; when it does not but a slot is free
        (pages, not slots, are the bottleneck), evict a victim
        (``_pick_victim``) and retry.  Victims requeue at the back and
        resume through the radix / suffix path; each carries a
        ``max_preemptions`` cap, and at most ``slots`` evictions happen
        per boundary, so admission cannot livelock."""
        if self.chaos is not None and self._live() \
                and self.chaos.deny_admission():
            return   # injected admission-time exhaustion (delay, not loss)
        self._do_admissions()
        if not self.preemption:
            return
        guard = 0
        while self.scheduler.queue and guard < self.slots \
                and any(r is None for r in self._slot_req):
            victim = self._pick_victim(pressure=True)
            if victim is None:
                return
            guard += 1
            qlen = len(self.scheduler.queue)
            self._preempt_slot(victim, "pressure")
            self._do_admissions()
            if len(self.scheduler.queue) > qlen:
                return   # eviction did not unblock the head; stop churning

    def _pick_victim(self, pressure: bool = False) -> Optional[int]:
        """Victim policy: lowest SLO-class priority first, then fewest
        tokens decoded (least work lost), then most radix-recoverable
        pages (cheapest to resume), then lowest slot.  Slots at their
        preemption cap are never picked.  ``pressure``: pool pressure is
        a shard's, so only slots of a shard with a free slot (whose pages,
        not slots, hold the head back) are candidates."""
        best, best_score = None, None
        P = self.spec.page_size
        shard_of = self.scheduler.shard_of_slot
        free = {shard_of(s) for s, r in enumerate(self._slot_req)
                if r is None}
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None or req.preemptions >= req.max_preemptions:
                continue
            if pressure and shard_of(slot) not in free:
                continue
            valid = len(req.effective_prompt) - (1 if req.out_tokens else 0)
            recoverable = valid // P if self.scheduler.radix is not None \
                else 0
            score = (-req.priority, len(req.out_tokens), -recoverable,
                     slot)
            if best_score is None or score < best_score:
                best, best_score = slot, score
        return best

    def _clear_slot(self, slot: int) -> None:
        """Device and host teardown shared by preemption and reaping:
        drop page references, trash the table rows, clear the active flag
        so the next chunk's dead-tail steps neither sample nor write."""
        self._slot_req[slot] = None
        self._slot_first[slot] = False
        self._slot_stale[slot] = 0
        self._slot_seen_len[slot] = 0
        self._slot_plen[slot] = 0
        if self.chaos is not None:
            self.chaos.clear_stall(slot)
        self.scheduler.release(slot)
        local = self._local_slot(slot)
        if local is not None:
            self.executor.free_slot(self.cache, local)
            self.executor.deactivate(self.state, local)

    def _finish_terminal(self, req: Request, status: str) -> None:
        req.status = status
        req.done = True
        if req.finish_time is None:
            req.finish_time = self._clock()
        if status == RequestStatus.TIMED_OUT:
            self.fault_counters["timed_out"] += 1
        elif status == RequestStatus.CANCELLED:
            self.fault_counters["cancelled"] += 1
        self.finished.append(req)
        self._trace("finish", rid=req.rid, ts=req.finish_time,
                    status=req.status, tokens=len(req.out_tokens))

    def _evict_slot(self, slot: int, status: str) -> None:
        req = self._slot_req[slot]
        self._clear_slot(slot)
        self._finish_terminal(req, status)

    def _preempt_slot(self, slot: int, why: str) -> None:
        """Evict a running slot and requeue its request for resumption:
        its emitted tokens replay as prompt tail on re-admission, and its
        written full pages are preserved in the radix index first, so the
        resume recovers them as a prefix hit instead of recomputing."""
        req = self._slot_req[slot]
        if len(req.out_tokens) >= req.max_new_tokens or (
                req.eos_id is not None and req.out_tokens
                and req.out_tokens[-1] == int(req.eos_id)):
            # everything was already drained (a stalled slot can hide its
            # own finish): complete, don't resume an empty remainder
            self._evict_slot(slot, RequestStatus.FINISHED)
            return
        req.preemptions += 1
        self.fault_counters["preemptions"] += 1
        self.fault_counters[f"{why}_preemptions"] += 1
        self.preemption_log.append({
            "rid": req.rid, "slo_class": req.slo_class, "why": why,
            "candidate_classes": [
                r.slo_class for s2, r in enumerate(self._slot_req)
                if r is not None and s2 != slot
                and r.preemptions < r.max_preemptions]})
        self._trace("preempt", rid=req.rid, slot=slot, why=why,
                    preemptions=req.preemptions)
        upto = None
        if self.chunked_prefill \
                and self._slot_seen_len[slot] < self._slot_plen[slot]:
            # preempted mid-prefill: only the pages the host has SEEN
            # covered are certainly written (a chaos-stalled drain may
            # trail the device); preserve exactly that prefix
            upto = self._slot_seen_len[slot]
        self.scheduler.preserve(slot, req, upto=upto)
        self._clear_slot(slot)
        self.scheduler.requeue(req)

    def _reap(self) -> None:
        """Chunk-boundary reaping of cancelled and deadline-expired
        requests, queued or running: pages free at once, the typed
        terminal status lands in ``finished``, and the same boundary's
        admission pass can re-lease the freed slot."""
        now = self._clock()

        def dead(req: Request) -> bool:
            return req.cancel_requested or (
                req.deadline is not None and now > req.deadline)

        for req in [r for r in self.scheduler.queue if dead(r)]:
            self.scheduler.queue.remove(req)
            self._trace("reap", rid=req.rid, ts=now,
                        why="cancelled" if req.cancel_requested
                        else "timed_out")
            self._finish_terminal(
                req, RequestStatus.CANCELLED if req.cancel_requested
                else RequestStatus.TIMED_OUT)
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None or not dead(req):
                continue
            self._trace("reap", rid=req.rid, slot=slot, ts=now,
                        why="cancelled" if req.cancel_requested
                        else "timed_out")
            self._evict_slot(
                slot, RequestStatus.CANCELLED if req.cancel_requested
                else RequestStatus.TIMED_OUT)

    def _do_admissions(self) -> None:
        """One pass of admissions into the free slots.  Two executables:
        each is prefilled and armed at once (``_admit_prefilled``); fused:
        staged, then armed together by one ``Executor.admit``."""
        free = [i for i in range(self.slots) if self._slot_req[i] is None]
        entries: List[Dict] = []
        # stamp this boundary's admissions with the current chunk id
        self.scheduler.current_chunk = self.chunks
        now = self._clock()
        for adm in self.scheduler.admissions(free, now=now):
            req, slot = adm.req, adm.slot
            prompt = req.effective_prompt   # resume: replay emitted tail
            plen = len(prompt)
            if self.tracer is not None:
                resume = req.preemptions > 0
                if adm.suffix_start > 0:
                    self._trace("radix_hit", rid=req.rid, slot=slot,
                                ts=now, matched_tokens=adm.suffix_start,
                                resume=resume)
                if adm.cow is not None:
                    self._trace("cow", rid=req.rid, slot=slot, ts=now,
                                src_page=adm.cow[1], dst_page=adm.cow[2])
                if resume:
                    self._trace("resume", rid=req.rid, slot=slot, ts=now,
                                preemptions=req.preemptions)
                self._trace("admit", rid=req.rid, slot=slot, ts=now,
                            chunk=self.chunks,
                            suffix_start=adm.suffix_start, plen=plen,
                            resume=resume)
            if req.preemptions > 0:
                self.fault_counters["resumes"] += 1
            self._slot_stale[slot] = 0
            if not self.chunked_prefill:
                self._admit_prefilled(adm)
                continue
            self._slot_req[slot] = req
            self._slot_seen_len[slot] = adm.suffix_start
            self._slot_plen[slot] = plen
            local = self._local_slot(slot)
            if local is None:
                continue            # another rank's slot
            if adm.cow is not None:
                # the slot will write into a shared page: give it a
                # private copy before the generator drops the source pin
                _blk, src, dst = adm.cow
                key = self.scheduler.share_key
                lo = self._page_lo[key]
                self.executor.copy_page(self.cache, src - lo, dst - lo, key)
            pbuf = np.zeros((self.max_len,), np.int32)
            pbuf[:plen] = prompt
            entries.append({
                "slot": local, "start": adm.suffix_start, "plen": plen,
                "rows": self._local_rows(adm.rows), "prompt": pbuf,
                "out_len0": len(req.out_tokens),
                "max_new": req.max_new_tokens,
                "eos": -1 if req.eos_id is None else int(req.eos_id),
                "temp": self._req_temp(req)})
        self.executor.admit(self.cache, self.state, entries)
        self.peak_live_slots = max(
            self.peak_live_slots, sum(r is not None for r in self._slot_req))

    def _update_prefill_budgets(self) -> None:
        """``prefill_budget`` as a dynamic SLO knob, applied at the chunk
        boundary: while an interactive request has blown its TTFT slack
        and still waits on a first token, non-interactive slots' prompt
        slices shrink to a quarter chunk (floor 1); full budgets return
        once the pressure is gone.  A host-to-device copy of a value made
        here, outside the chunk, and only when the vector changes: no
        new shape, and nothing is read from the device."""
        if not self.chunked_prefill or self.policy != "slo":
            return
        S = self.executor.chunk_rows
        now = self._clock()

        def urgent(r: Request) -> bool:
            return (r.priority == 0 and r.first_token_time is None
                    and r.ttft_slack(now) < 0.0)

        pressure = any(urgent(r) for r in self.scheduler.queue) or any(
            r is not None and urgent(r) for r in self._slot_req)
        throttled = max(1, S // 4)
        vec = [throttled if (pressure and r is not None
                             and r.priority > 0) else S
               for r in self._slot_req]
        if vec != self._budget_vec:
            if pressure:
                self.budget_throttles += 1
            self._budget_vec = vec
            lo = self._slot_lo
            self.state["pbudget"] = host_to_device(
                vec[lo:lo + self._lslots], self.device)

    def step_chunk(self) -> torch.Tensor:
        """Launch one chunk.  No host synchronization: safe under
        ``torch.cuda.set_sync_debug_mode("error")``."""
        toks, self.cache, self.state = self.executor.chunk(
            self.params, self.cache, self.state, self.gen)
        self.steps += self.sync_interval
        return toks

    def _drain(self, toks: torch.Tensor) -> None:
        """One batched device-to-host transfer: token history, generated
        counts, active flags, the prefill cursors (fused) and the
        prefill-sampled first tokens (two executables), packed into one
        tensor; under ``rules=`` every rank's tensor, all-gathered over
        the data axis first.  Each slot's new tokens are the non-negative
        entries of its history column; finished slots are evicted (page
        references dropped, table rows trashed).  A chaos-stalled slot
        reports nothing, and a slot that reports no progress for
        ``stall_patience`` drains is preempted by the watchdog."""
        ls = self._lslots
        packed = torch.cat(
            [toks.reshape(-1), self.state["out_len"],
             self.state["active"].to(torch.int32), self.cache["len"],
             self._first_tok])
        if self._dp_group is not None:
            import torch.distributed as dist
            every = packed.new_empty((self.shards * packed.numel(),))
            dist.all_gather_into_tensor(every, packed, group=self._dp_group)
            packed = every
        parts = packed.cpu().numpy().reshape(self.shards, -1)
        self.host_syncs += 1
        n_tok = toks.numel()
        toks_np = np.concatenate(
            [p[:n_tok].reshape(-1, ls) for p in parts], axis=1)
        out_len, active, cache_len, first_tok = (
            np.concatenate([p[n_tok + i * ls:n_tok + (i + 1) * ls]
                            for p in parts]) for i in range(4))
        first = {i: int(first_tok[i]) for i in range(self.slots)
                 if self._slot_first[i]}
        now = self._clock()     # one clock read stamps every token
        self.chunks += 1
        if self.tracer is not None:
            self._trace("chunk", ts=now, chunk=self.chunks,
                        queue_depth=len(self.scheduler.queue),
                        pages_in_use=self.scheduler.pages_in_use,
                        live_slots=sum(r is not None
                                       for r in self._slot_req))
        watchdog: List[int] = []
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            if self.chaos is not None and self.chaos.stalled(slot):
                # injected straggler: the slot reported nothing this
                # boundary.  Progress stalls host-side until the watchdog
                # preempts it; tokens lost meanwhile regenerate on resume
                self._slot_stale[slot] += 1
                if self.stall_patience \
                        and self._slot_stale[slot] >= self.stall_patience:
                    watchdog.append(slot)
                continue
            progressed = False
            if self.chunked_prefill:
                plen0 = self._slot_plen[slot]
                seen = min(int(cache_len[slot]), plen0)
                if seen > self._slot_seen_len[slot]:
                    progressed = True   # mid-prefill progress is no stall
                    prev = self._slot_seen_len[slot]
                    self._slot_seen_len[slot] = seen
                    if prev < plen0:
                        self._trace("prefill", rid=req.rid, slot=slot,
                                    ts=now, seen=seen, plen=plen0,
                                    chunk=self.chunks)
                    if prev < plen0 <= seen:
                        # prefill completed: every prompt page is now
                        # written, so the prompt becomes visible to the
                        # radix index
                        self.scheduler.index_slot(slot, req, plen0)
            if slot in first:
                # the prefill-sampled token, counted by out_len already
                self._slot_first[slot] = False
                req.out_tokens.append(first[slot])
                req.token_times.append(now)
                req.token_chunks.append(self.chunks)
                if req.first_token_time is None:
                    req.first_token_time = now
            k = int(out_len[slot]) - len(req.out_tokens)
            if k > 0:
                vals = [int(t) for t in toks_np[:, slot] if t >= 0]
                if len(vals) > k:
                    raise RuntimeError(f"slot {slot}: drained {len(vals)} "
                                       f"tokens for {k} new")
                req.out_tokens.extend(vals[-k:])
                req.token_times.extend([now] * len(vals[-k:]))
                req.token_chunks.extend([self.chunks] * len(vals[-k:]))
                if req.first_token_time is None and req.token_times:
                    # TTFT from the original submit time, across resumes
                    req.first_token_time = now
                self._slot_stale[slot] = 0
            elif self.stall_patience and not progressed:
                self._slot_stale[slot] += 1
                if self._slot_stale[slot] >= self.stall_patience:
                    watchdog.append(slot)
                    continue
            if not active[slot]:
                req.status = RequestStatus.FINISHED
                req.done = True
                req.finish_time = now
                self.finished.append(req)
                self._trace("finish", rid=req.rid, slot=slot, ts=now,
                            status=req.status, tokens=len(req.out_tokens))
                self._slot_req[slot] = None
                self._slot_stale[slot] = 0
                self.scheduler.release(slot)
                local = self._local_slot(slot)
                if local is not None:
                    self.executor.free_slot(self.cache, local)
        for slot in watchdog:
            # straggler recovery: treat the unresponsive slot as lost and
            # resume its request from the last drained token
            self._preempt_slot(slot, "watchdog")

    def _live(self) -> bool:
        return any(r is not None for r in self._slot_req)

    def _boundary(self) -> bool:
        """The host's work at a chunk boundary: reap cancelled and
        expired requests, apply chaos (stalls, preemption storms; under
        the SLO policy the class-aware victim rule picks who), admit with
        pool-pressure preemption, set the SLO prefill budgets.  Returns
        whether a slot is live, i.e. whether a chunk should run."""
        self._reap()
        if self.chaos is not None:
            live = [i for i in range(self.slots)
                    if self._slot_req[i] is not None]
            self.chaos.tick(live)
            for slot in self.chaos.storm_victims(live):
                if self.policy == "slo":
                    # chaos decides THAT a storm hits; under the SLO
                    # policy the class-aware victim rule decides WHO
                    picked = self._pick_victim()
                    if picked is None:
                        continue
                    slot = picked
                if self._slot_req[slot] is not None:
                    self._preempt_slot(slot, "chaos")
        self._admit()
        self._update_prefill_budgets()
        if self._live():
            return True
        if not self.scheduler.can_progress(0, now=self._clock()):
            head = self.queue[0]
            raise PagePoolExhausted(
                f"wedged: rid={head.rid} cannot be admitted "
                f"({self.scheduler.pool.free_pages} pages free) and no "
                "slot is live to release more")
        return False

    def step(self) -> None:
        """One boundary (``_boundary``), then one chunk and its drain
        (``sync_interval`` micro-steps).  All policy runs on the host at
        the boundary; the chunk itself stays free of host syncs."""
        if self._boundary():
            self._drain(self.step_chunk())

    def run(self, max_steps: int = 1000) -> List[Request]:
        while (self.queue or self._live()) and self.steps < max_steps:
            self.step()
        return self.finished
