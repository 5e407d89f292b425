"""Host-side serving policy layer: queue, admission, eviction, paging,
prefix sharing.

A copy of ``repro/serve/scheduler.py`` (numpy-only, framework-free),
bound to the port's ``CacheSpec``.

The serving runtime is layered (paper §2.2.3: scheduling and memory
management, not math, bound serving throughput once kernels are tuned):

* **Scheduler** (this module) — pure-Python policy: FIFO queue, slot
  assignment, per-group page-budget reservation, refcounted page
  sharing, radix-indexed prefix matching, LRU prefix eviction.  No jax
  arrays, no device work; decisions are made from state the host already
  knows, so the policy layer adds zero device synchronization.
* **Executor** (``serve/engine.Executor``) — the compiled layer: bucketed
  full/suffix prefill, page-granular admission splice, copy-on-write
  page duplication, the fused decode chunk.
* **Driver** (``serve/engine.Engine``) — glues the two: drains tokens once
  per chunk, reports finishes to the scheduler, applies its admissions.

Continuous batching falls out of the layering: at every chunk boundary the
driver reports finished slots (release → refcounts drop, exclusive pages
back to the free list) and asks for admissions (a freed slot is re-leased
to the queue head without recompiling anything — all compiled shapes are
slot-count-stable).

Pages are reserved *worst-case at admission* (``CacheSpec.blocks_needed``,
now a per-pool-group map), which makes mid-run pool exhaustion impossible
for admitted requests: the failure mode surfaces as clean backpressure
(the queue head waits for pages) or as ``PagePoolExhausted`` when a
request can never fit, instead of as silent corruption of a neighbour's
pages.

**Prefix sharing** (sharing-capable specs only — pure full-attention
stacks, see ``CacheSpec.share_group_key``): full prompt pages are indexed
in a radix tree keyed by page content.  Admission walks the tree page-by-
page over the incoming prompt; matched pages are attached to the new
slot's table with a refcount bump and *prefill is skipped for those
tokens* — the Executor prefillls only the suffix, attending to the prefix
through the shared pages.  A slot about to write into a shared page (a
partially-matched page, or the final page of a fully-matched prompt —
the last prompt token is always re-prefilled to produce first-token
logits) gets a private copy first: the admission carries a
``cow=(block, src, dst)`` directive the Executor turns into a jitted
page copy.  The tree itself holds one reference per indexed page, so
popular prefixes survive their originating request; when allocation runs
dry the scheduler evicts **only refcount-1 leaves** (pages no live slot
references) in LRU order, cascading up the tree as parents become
leaves.

**Shards** (``Engine(rules=...)``, data-parallel ranks): with
``shards = n`` the slots split into ``n`` contiguous ranges and every
group's page ids into ``n`` contiguous ranges, one of each a rank.  A
slot leases pages of its own shard only, radix hits match only pages of
the admitting slot's shard, and pool pressure (eviction, preemption) is
decided per shard.  The head of the queue goes to the shard with the
longest cached prefix among those with a free slot (the lowest free slot
on ties).  With one shard every decision is the unsharded one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.serve.cache import CacheSpec


class PagePoolExhausted(RuntimeError):
    """Raised when a request's worst-case page reservation can never be
    satisfied by the pool (the clean backpressure signal — nothing was
    admitted, no cache state was touched)."""


class RequestStatus:
    """Typed terminal/lifecycle states a ``Request`` moves through.

    ``QUEUED -> RUNNING -> FINISHED`` is the happy path; ``PREEMPTED``
    loops back to ``QUEUED -> RUNNING`` (capped by ``max_preemptions``);
    ``TIMED_OUT`` / ``CANCELLED`` / ``REJECTED`` are terminal."""

    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    PREEMPTED = "PREEMPTED"
    FINISHED = "FINISHED"
    TIMED_OUT = "TIMED_OUT"
    CANCELLED = "CANCELLED"
    REJECTED = "REJECTED"

    TERMINAL = frozenset({FINISHED, TIMED_OUT, CANCELLED, REJECTED})


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class: admission priority (lower = more urgent) plus
    the latency contract its requests are graded against — TTFT (submit
    to first token) and TPOT (mean per-token delta after the first), in
    engine-clock units.  ``None`` targets always pass (best-effort)."""

    name: str
    priority: int
    ttft_target: Optional[float]
    tpot_target: Optional[float]


#: Built-in multi-tenant service classes.  ``interactive`` outranks
#: ``batch`` outranks ``best_effort`` at admission and is preempted
#: last under pool pressure; per-request ``ttft_target``/``tpot_target``
#: override the class defaults (which are wall-seconds on a real clock,
#: virtual units under ``serve/traffic.VirtualClock``).
SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", 0, 1.0, 0.1),
    "batch": SLOClass("batch", 1, 20.0, 1.0),
    "best_effort": SLOClass("best_effort", 2, None, None),
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: Optional[float] = None   # None -> engine default
    # --- deadline / cancellation (engine-clock units; ttl is relative
    # and resolved to an absolute deadline at Engine.submit) ---
    deadline: Optional[float] = None
    ttl: Optional[float] = None
    max_preemptions: int = 3
    # --- SLO class + latency contract (None target -> class default;
    # a class absent from SLO_CLASSES grades as best_effort) ---
    slo_class: str = "best_effort"
    ttft_target: Optional[float] = None
    tpot_target: Optional[float] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = RequestStatus.QUEUED
    preemptions: int = 0
    cancel_requested: bool = False
    reject_reason: Optional[str] = None
    # --- latency telemetry, host-stamped (submit at Engine.submit; first
    # token and per-token times at the chunk-boundary drain, so no new
    # device syncs).  submit_time survives preemption: TTFT is measured
    # from the ORIGINAL submit, never from a resume. ---
    submit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    # Parallel to token_times: the engine chunk sequence number whose
    # drain emitted each token.  Tokens drained by the same chunk share
    # one host clock read, so token_times alone aliases them — the
    # chunk id disambiguates TPOT attribution and cross-references the
    # admission_log / trace events (repro.serve.trace).
    token_chunks: List[int] = dataclasses.field(default_factory=list)
    _seq: int = 0   # scheduler-assigned arrival order (slack tiebreak)

    def cancel(self) -> None:
        """Request cooperative cancellation; the engine reaps the slot
        (or drops the queue entry) at the next chunk boundary."""
        self.cancel_requested = True

    @property
    def slo(self) -> SLOClass:
        return SLO_CLASSES.get(self.slo_class, SLO_CLASSES["best_effort"])

    @property
    def priority(self) -> int:
        """Admission priority (lower = more urgent)."""
        return self.slo.priority

    @property
    def resolved_ttft_target(self) -> Optional[float]:
        return self.ttft_target if self.ttft_target is not None \
            else self.slo.ttft_target

    @property
    def resolved_tpot_target(self) -> Optional[float]:
        return self.tpot_target if self.tpot_target is not None \
            else self.slo.tpot_target

    def ttft_slack(self, now: float) -> float:
        """Time remaining until this request's TTFT target is blown
        (negative = already late; +inf when it has no target).  Least
        slack first is the SLO admission order within a priority band."""
        target = self.resolved_ttft_target
        if target is None:
            return float("inf")
        submitted = self.submit_time if self.submit_time is not None else 0.0
        return target - (now - submitted)

    # A preempted request resumes by replaying everything it has already
    # emitted as prompt tail: prefill of ``prompt + out_tokens`` samples
    # the next new token from the last emitted token's logits, which at
    # temperature 0 is exactly the token the uncontended run would have
    # decoded.  Fresh requests (empty ``out_tokens``) reduce to the
    # plain prompt, so admission has ONE representation for both.
    @property
    def effective_prompt(self) -> List[int]:
        return list(self.prompt) + list(self.out_tokens)

    @property
    def effective_max_new(self) -> int:
        return self.max_new_tokens - len(self.out_tokens)


@dataclasses.dataclass
class RequestRejected:
    """Typed load-shedding result from ``Engine.submit``: the request was
    not enqueued.  ``kind`` is ``"infeasible"`` (worst-case reservation
    exceeds the pool budget — it can never run at this config) or
    ``"queue_full"`` (the bounded admission queue shed it)."""

    req: Request
    kind: str
    reason: str


@dataclasses.dataclass
class Admission:
    """One scheduler admission decision, consumed by the Engine driver.

    ``rows`` maps pool-group key -> page-table row (trash-padded).
    ``suffix_start`` counts prompt tokens whose prefill is skipped (they
    ride on shared pages); 0 means a plain full prefill.  ``cow`` names a
    copy-on-write the Executor must perform *before* the splice:
    ``(block, src_page, dst_page)`` in the sharing group."""

    slot: int
    req: Request
    rows: Dict[str, np.ndarray]
    suffix_start: int = 0
    cow: Optional[Tuple[int, int, int]] = None
    # pages this admission holds one reference to, per group (consumed by
    # Scheduler.release when the slot finishes)
    lease: Dict[str, List[int]] = dataclasses.field(default_factory=dict)


class PagePool:
    """Refcounted free-list allocator over physical page ids
    ``0..num_pages-1``.

    Page ``num_pages`` is the trash page — never allocated; unreserved
    page-table entries point at it so stray writes are discarded.  A page
    may be referenced by several slot tables at once (prefix sharing) and
    by the radix index; it returns to the free list only when the last
    reference drops.

    ``shards`` splits the ids into that many contiguous ranges of
    ``per_shard = num_pages / shards`` (shard ``k`` owns ``k * per_shard
    ..``), each with its own free list; ``alloc`` leases from one."""

    def __init__(self, num_pages: int, shards: int = 1):
        if num_pages % shards:
            raise ValueError(f"{shards} shards do not divide {num_pages} "
                             "pages")
        self.num_pages = num_pages
        self.trash = num_pages
        self.per_shard = per = num_pages // shards
        self._free: List[List[int]] = [
            list(range((k + 1) * per - 1, k * per - 1, -1))
            for k in range(shards)]
        self._rc: List[int] = [0] * num_pages
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    def free_in(self, shard: int) -> int:
        return len(self._free[shard])

    def shard_of(self, page: int) -> int:
        return page // self.per_shard

    @property
    def in_use(self) -> int:
        return self.num_pages - self.free_pages

    def in_use_by_shard(self) -> List[int]:
        return [self.per_shard - len(f) for f in self._free]

    def refcount(self, page: int) -> int:
        return self._rc[page]

    def alloc(self, n: int, shard: int = 0) -> Optional[List[int]]:
        """Lease ``n`` fresh pages of ``shard`` at refcount 1, or None
        (backpressure) if not enough of them are free."""
        free = self._free[shard]
        if n > len(free):
            return None
        pages = [free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def retain(self, page: int) -> None:
        """Add a reference to an already-leased page (sharing)."""
        assert self._rc[page] > 0, f"retain of free page {page}"
        self._rc[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert self._rc[page] > 0, f"release of free page {page}"
        self._rc[page] -= 1
        if self._rc[page] == 0:
            self._free[self.shard_of(page)].append(page)
            return True
        return False

    def free(self, pages: List[int]) -> None:
        """Drop one reference on each of ``pages``."""
        for p in pages:
            self.release(p)


class _RadixNode:
    __slots__ = ("tokens", "page", "children", "parent", "last_use")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_RadixNode"]):
        self.tokens = tokens
        self.page = page
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent = parent
        self.last_use = 0


class RadixIndex:
    """Page-granular radix tree over cached prompt prefixes.

    Each node is one *full* physical page (``page_size`` prompt tokens)
    keyed by its token content; a root-to-node path spells a cached
    prompt prefix.  The tree holds one pool reference per node, so
    indexed pages outlive the request that prefilled them; eviction
    (LRU, leaves only, refcount-1 only) is how that memory comes back.

    ``shards`` keeps one tree a shard (``roots``): a prefix cached on one
    shard is no hit on another, whose slots cannot read its pages."""

    def __init__(self, page_size: int, shards: int = 1):
        self.page_size = page_size
        self.roots = [_RadixNode((), -1, None) for _ in range(shards)]
        self._tick = 0
        self.node_count = 0

    def nodes(self) -> Iterator[_RadixNode]:
        """Every node of every shard's tree."""
        stack = [c for r in self.roots for c in r.children.values()]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _touch(self, node: _RadixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    # ------------------------------------------------------------- match
    def match(self, prompt: List[int], shard: int = 0,
              touch: bool = True) -> List[Tuple[int, int, int]]:
        """Longest cached prefix of ``prompt`` in ``shard``'s tree,
        page-by-page (``touch=False``: a probe that leaves LRU as it is).

        Returns ``[(block, page, matched_tokens)]``: every entry but the
        last matches a full page (``matched_tokens == page_size``); the
        last may be a *partial-page match* — a cached page whose first
        ``matched_tokens < page_size`` tokens agree with the prompt's
        remainder (its KV prefix is still exact, but the slot must
        copy-on-write before writing its own divergent tokens into the
        block)."""
        P = self.page_size
        out: List[Tuple[int, int, int]] = []
        node = self.roots[shard]
        nblocks = -(-len(prompt) // P) if prompt else 0
        for b in range(nblocks):
            page_toks = tuple(prompt[b * P:(b + 1) * P])
            child = (node.children.get(page_toks)
                     if len(page_toks) == P else None)
            if child is not None:
                if touch:
                    self._touch(child)
                out.append((b, child.page, P))
                node = child
                continue
            # partial match: the cached page with the longest common
            # prefix against the prompt's remainder (most recent on ties)
            best, best_n = None, 0
            for key, cand in node.children.items():
                n = 0
                for a, c in zip(page_toks, key):
                    if a != c:
                        break
                    n += 1
                if n > best_n or (n == best_n and n and best is not None
                                  and cand.last_use > best.last_use):
                    best, best_n = cand, n
            if best is not None and best_n > 0:
                if touch:
                    self._touch(best)
                out.append((b, best.page, best_n))
            break
        return out

    # ------------------------------------------------------------ insert
    def insert(self, prompt: List[int], row: np.ndarray,
               pool: PagePool, shard: int = 0) -> int:
        """Index every *full* page of ``prompt`` in ``shard``'s tree
        (partial tail pages are still written by their owner, so they
        are never shared).  New nodes take a pool reference; existing
        nodes just refresh LRU.  Returns the number of nodes created."""
        P = self.page_size
        node, created = self.roots[shard], 0
        for b in range(len(prompt) // P):
            key = tuple(prompt[b * P:(b + 1) * P])
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key, int(row[b]), node)
                node.children[key] = child
                pool.retain(child.page)
                self.node_count += 1
                created += 1
            self._touch(child)
            node = child
        return created

    # ---------------------------------------------------------- eviction
    def _leaves(self, shard: Optional[int]) -> Iterator[_RadixNode]:
        roots = self.roots if shard is None else [self.roots[shard]]
        stack = [c for r in roots for c in r.children.values()]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                yield n

    def evict_one(self, pool: PagePool,
                  shard: Optional[int] = None) -> Optional[int]:
        """Drop the least-recently-used *leaf* (of ``shard``'s tree, or
        of any) whose page has no live slot reference (refcount 1 — the
        tree's own).  Shared nodes are denied until every borrowing slot
        releases.  Returns the freed page id, or None when nothing is
        evictable."""
        victim: Optional[_RadixNode] = None
        for leaf in self._leaves(shard):
            if pool.refcount(leaf.page) != 1:
                continue
            if victim is None or leaf.last_use < victim.last_use:
                victim = leaf
        if victim is None:
            return None
        victim.parent.children.pop(victim.tokens)
        self.node_count -= 1
        pool.release(victim.page)
        return victim.page

    def reclaimable(self, pool: PagePool, shard: int = 0) -> int:
        """Pages of ``shard`` the eviction loop could recover right now
        (refcount-1 nodes; a chain of them frees leaf-by-leaf as parents
        become leaves)."""
        stack = list(self.roots[shard].children.values())
        n = 0
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if pool.refcount(node.page) == 1:
                n += 1
        return n


class Scheduler:
    """Continuous-batching policy over ``slots`` cache slots and
    per-pool-group page budgets, with radix-indexed prefix sharing.

    ``policy`` selects the admission order:

    * ``"fifo"`` (default) — strict arrival order; when the head's
      reservation does not fit, later requests do not jump it.
    * ``"slo"`` — priority then least-TTFT-slack-first: at every chunk
      boundary the queue is ordered by ``(SLO-class priority, ttft
      slack, arrival)`` at the boundary's ``now``, so an interactive
      request running out of slack jumps queued batch work while two
      same-class requests keep FIFO order.  The first candidate that
      does not fit still blocks admission (pages it is waiting on must
      not be nibbled away by lower-priority work); victim selection for
      pressure preemption is the Engine's, also class-aware.

    ``shards``: the data-parallel ranks the slots and every group's pages
    split over (module docstring); 1 for one device."""

    def __init__(self, spec: CacheSpec, *, prefix_sharing: bool = True,
                 defer_radix_insert: bool = False, policy: str = "fifo",
                 shards: int = 1):
        if policy not in ("fifo", "slo"):
            raise ValueError(
                f"policy must be 'fifo' or 'slo', got {policy!r}")
        if spec.slots % shards:
            raise ValueError(f"{shards} shards do not divide {spec.slots} "
                             "slots")
        self.policy = policy
        self.spec = spec
        self.shards = shards
        self.slots_per_shard = spec.slots // shards
        self.pools: Dict[str, PagePool] = {
            g.key: PagePool(g.num_pages, shards) for g in spec.groups
        } if spec.has_paged else {}
        # fused chunked prefill defers radix indexing to prefill
        # COMPLETION (Engine calls index_slot): at admission time none of
        # the prompt's pages are written yet, so inserting then would let
        # a same-boundary match attend to garbage
        self.defer_radix_insert = bool(defer_radix_insert)
        self.share_key: Optional[str] = (
            spec.share_group_key
            if prefix_sharing and spec.prefix_sharing_capable else None)
        self.radix: Optional[RadixIndex] = (
            RadixIndex(spec.page_size, shards) if self.share_key else None)
        self.queue: List[Request] = []
        self._leases: Dict[int, Dict[str, List[int]]] = {}
        self._rows: Dict[int, Dict[str, np.ndarray]] = {}
        # fault-injection hook (serve/chaos.ChaosMonkey); a sharing_fault
        # degrades a plan to exclusive pages — the recovery path a real
        # CoW/splice failure would take
        self.chaos = None
        # --- telemetry ---
        self._peak_pages = 0
        self.admissions_total = 0
        self.prefix_hits = 0
        self.prefix_tokens_skipped = 0
        self.shared_page_attaches = 0
        self.cow_copies = 0
        self.radix_evictions = 0
        self.resume_admissions = 0
        self.resume_recovered_tokens = 0
        self.resume_replayed_tokens = 0
        # arrival-order sequence for slack ties + admission-order log
        # [(boundary, rid, priority, slack, chunk)] the property tests
        # replay; ``chunk`` is the engine chunk sequence number current
        # at the boundary (Engine sets ``current_chunk`` before calling
        # admissions), cross-referencing trace events and the per-token
        # ``Request.token_chunks`` telemetry.
        self._seq = 0
        self._boundary = 0
        self.current_chunk = 0
        self.admission_log: List[Tuple[int, int, int, float, int]] = []

    # ------------------------------------------------------------ compat
    @property
    def pool(self) -> PagePool:
        """The widest group's pool (the budget knob / backpressure
        source)."""
        return self.pools[self.spec.widest_group.key]

    def shard_of_slot(self, slot: int) -> int:
        return slot // self.slots_per_shard

    # ---------------------------------------------------------- admission
    def validate(self, req: Request) -> None:
        """Raise ``PagePoolExhausted`` when the request's worst-case page
        reservation exceeds a pool's TOTAL budget — it can never run at
        this config, so queueing it would wedge the head of the line."""
        need = self.spec.blocks_needed(len(req.prompt), req.max_new_tokens)
        for key, n in need.items():
            budget = self.pools[key].per_shard     # one shard's pages
            if n > budget:
                raise PagePoolExhausted(
                    f"request rid={req.rid} needs {n} pages of pool group "
                    f"{key} ({len(req.prompt)} prompt + "
                    f"{req.max_new_tokens} new tokens at page_size="
                    f"{self.spec.page_size}) but that pool only has "
                    f"{budget}; raise --num-pages")

    def submit(self, req: Request) -> None:
        self.validate(req)   # may raise PagePoolExhausted
        req.status = RequestStatus.QUEUED
        self._seq += 1
        req._seq = self._seq
        self.queue.append(req)

    def requeue(self, req: Request) -> None:
        """Return a preempted request to the BACK of the queue: the
        preemption was made to admit the blocked head, so the victim
        resumes once pressure subsides (its ``max_preemptions`` cap keeps
        repeated victimhood bounded)."""
        req.status = RequestStatus.PREEMPTED
        self.queue.append(req)

    def _alloc(self, key: str, n: int, shard: int) -> Optional[List[int]]:
        """Group alloc in ``shard`` with radix eviction pressure: when the
        sharing group's shard runs dry, evict its LRU refcount-1 leaves
        until the request fits or nothing more is evictable."""
        pool = self.pools[key]
        pages = pool.alloc(n, shard)
        while pages is None and self.radix is not None \
                and key == self.share_key:
            if self.radix.evict_one(pool, shard) is None:
                return None
            self.radix_evictions += 1
            pages = pool.alloc(n, shard)
        return pages

    def _plan(self, req: Request, shard: int = 0) -> Optional[Admission]:
        """Build the admission (match, retain, allocate, rows) for the
        queue head, or None on backpressure.  On None every side effect
        is rolled back.

        The sharing attempt runs first; if the *fresh* allocation then
        fails, the plan retries as a miss — the match's own retains can
        pin exactly the refcount-1 radix pages eviction would need, so
        insisting on the match could wedge an admission that plain
        ownership (evicting the matched prefix) can still satisfy.

        An injected sharing fault (chaos) skips the sharing attempt
        outright — the graceful-degradation path a CoW/splice failure
        takes: exclusive pages, full prefill, identical tokens."""
        share = self.radix is not None
        if share and self.chaos is not None and self.chaos.sharing_fault():
            share = False
        adm = self._plan_once(req, share, shard)
        if adm is None and share:
            adm = self._plan_once(req, False, shard)
        return adm

    def _plan_once(self, req: Request, use_sharing: bool,
                   shard: int) -> Optional[Admission]:
        # a resumed (preempted) request replays its generated-so-far
        # tokens as prompt tail; total pages needed are invariant under
        # preemption (orig prompt + orig max_new), so a request that fit
        # at submit always fits again here
        prompt = req.effective_prompt
        plen = len(prompt)
        need = self.spec.blocks_needed(plen, req.effective_max_new)
        P = self.spec.page_size

        shared: List[Tuple[int, int]] = []      # (block, page) attach
        cow_src: Optional[Tuple[int, int]] = None
        s = 0
        spool = self.pools.get(self.share_key) if self.share_key else None
        if use_sharing and self.radix is not None \
                and need.get(self.share_key):
            matched = self.radix.match(prompt, shard)
            m = sum(nt for _, _, nt in matched)
            # always re-prefill >= 1 token: first-token logits come from
            # the suffix prefill, so a fully-matched prompt keeps its
            # last token (and the shared page holding it goes CoW)
            s = min(m, plen - 1) if m else 0
            if s > 0:
                wb = s // P                      # first block written
                shared = [(b, p) for b, p, _ in matched if b < wb]
                over = [(b, p) for b, p, _ in matched if b >= wb]
                assert len(over) <= 1, over      # only the final page
                if over and s % P:
                    # the slot writes into the matched page mid-block, so
                    # the copy's head tokens are genuinely reused
                    cow_src = over[0]
                # s page-aligned with a matched page at wb: the suffix
                # rewrites that block from offset 0 and the ctx gather
                # stops before it — a copy would never be read, so block
                # wb just gets a fresh page instead
                for _, p in shared:
                    spool.retain(p)
                if cow_src is not None:
                    # pin the source across the copy; dropped after the
                    # Executor has issued the page copy (post-yield)
                    spool.retain(cow_src[1])
            else:
                shared, cow_src = [], None

        allocs: Dict[str, List[int]] = {}
        for key, n in need.items():
            n_fresh = n - (len(shared) if key == self.share_key else 0)
            pages = self._alloc(key, n_fresh, shard)
            if pages is None:                    # rollback, backpressure
                for k2, ps in allocs.items():
                    self.pools[k2].free(ps)
                if spool is not None:
                    for _, p in shared:
                        spool.release(p)
                    if cow_src is not None:
                        spool.release(cow_src[1])
                return None
            allocs[key] = pages

        rows: Dict[str, np.ndarray] = {}
        cow: Optional[Tuple[int, int, int]] = None
        lease: Dict[str, List[int]] = {}
        for key, n in need.items():
            g = self.spec.group_of(key)
            row = np.full((g.ring_blocks,), g.trash_page, np.int32)
            fresh = list(allocs[key])
            if key == self.share_key and s > 0:
                wb = s // P
                for b, p in shared:
                    row[b] = p
                nxt = wb
                if cow_src is not None:
                    dst = fresh[0]
                    row[wb] = dst
                    cow = (wb, cow_src[1], dst)
                    nxt = wb + 1
                for i, p in enumerate(fresh[1 if cow_src else 0:]):
                    row[nxt + i] = p
                lease[key] = [p for _, p in shared] + fresh
            else:
                row[:len(fresh)] = fresh
                lease[key] = fresh
            rows[key] = row

        if self.radix is not None and self.share_key in rows \
                and not self.defer_radix_insert:
            self.radix.insert(prompt, rows[self.share_key],
                              self.pools[self.share_key], shard)

        self.admissions_total += 1
        self._peak_pages = max(self._peak_pages, self.pages_in_use)
        if s > 0:
            self.prefix_hits += 1
            self.prefix_tokens_skipped += s
            self.shared_page_attaches += len(shared)
            if cow is not None:
                self.cow_copies += 1
        if req.preemptions > 0:
            # recovered-prefill telemetry: of the replayed effective
            # prompt, how much rode on radix pages instead of recompute
            self.resume_admissions += 1
            self.resume_recovered_tokens += s
            self.resume_replayed_tokens += plen
        return Admission(slot=-1, req=req, rows=rows, suffix_start=s,
                         cow=cow, lease=lease)

    def admission_order(self, now: float) -> List[Request]:
        """The queue in this boundary's admission order: FIFO under the
        default policy; ``(priority, ttft slack, arrival)`` under
        ``"slo"``.  Slack is evaluated once at ``now`` so the order is a
        consistent snapshot even while yields interleave."""
        if self.policy != "slo":
            return list(self.queue)
        return sorted(self.queue,
                      key=lambda r: (r.priority, r.ttft_slack(now), r._seq))

    def _shard_order(self, req: Request, free_slots: List[int]) -> List[int]:
        """The shards to try ``req`` on: those with a free slot, longest
        cached prefix of its prompt first (a probe that leaves LRU as it
        is), then lowest free slot."""
        shards: List[int] = []
        for slot in free_slots:
            k = self.shard_of_slot(slot)
            if k not in shards:
                shards.append(k)
        if self.radix is not None and len(shards) > 1:
            prompt = req.effective_prompt
            shards.sort(key=lambda k: -sum(
                nt for _, _, nt in self.radix.match(prompt, k, touch=False)))
        return shards

    def admissions(self, free_slots: List[int],
                   now: float = 0.0) -> Iterator[Admission]:
        """Yield admissions while the next request in admission order
        fits (in some shard with a free slot).  When it does not fit,
        later (smaller) requests do NOT jump it — head-of-line
        backpressure keeps the order fair (FIFO) and keeps lower-priority
        work from nibbling away the pages a blocked urgent request is
        waiting on (SLO)."""
        free_slots = list(free_slots)
        self._boundary += 1
        order = self.admission_order(now)
        while order and free_slots:
            head = order[0]
            adm = None
            for shard in self._shard_order(head, free_slots):
                adm = self._plan(head, shard)
                if adm is not None:
                    break
            if adm is None:
                return                       # wait for an eviction
            order.pop(0)
            self.queue.remove(head)
            self.admission_log.append(
                (self._boundary, head.rid, head.priority,
                 head.ttft_slack(now), self.current_chunk))
            adm.slot = next(s for s in free_slots
                            if self.shard_of_slot(s) == shard)
            free_slots.remove(adm.slot)
            self._leases[adm.slot] = adm.lease
            self._rows[adm.slot] = adm.rows
            adm.req.status = RequestStatus.RUNNING
            try:
                yield adm
            finally:
                # the Engine has now issued the CoW page copy (device ops
                # on the pool are program-ordered), so the source's
                # admission pin can drop — the tree's own reference still
                # protects it from re-lease unless evicted.
                if adm.cow is not None and self.share_key is not None:
                    self.pools[self.share_key].release(adm.cow[1])

    # ----------------------------------------------------------- eviction
    def release(self, slot: int) -> None:
        """Drop a finished slot's page references.  Exclusive pages go
        straight back to the free list; shared/indexed pages survive
        until their refcount drains (other slots, then the radix tree)."""
        self._rows.pop(slot, None)
        for key, pages in self._leases.pop(slot, {}).items():
            self.pools[key].free(pages)

    def preserve(self, slot: int, req: Request,
                 upto: Optional[int] = None) -> int:
        """Index a slot's pages in the radix tree just before a
        preemption releases them, so re-admission recovers the work via
        suffix prefill instead of recomputing it.  Only tokens whose KV
        has actually been written are indexed: every prompt token, plus
        every generated token except the last emitted one (its KV is
        written by the decode step that *consumes* it, which has not run
        from the host's point of view).  ``upto`` overrides that rule
        with an explicit written-token count — fused chunked prefill
        passes its prefill cursor when preempting a slot mid-prefill.
        Returns radix nodes created."""
        if self.radix is None:
            return 0
        rows = self._rows.get(slot)
        if rows is None or self.share_key not in rows:
            return 0
        valid = req.effective_prompt
        if upto is not None:
            valid = valid[:upto]
        elif req.out_tokens:
            valid = valid[:-1]
        return self.radix.insert(valid, rows[self.share_key],
                                 self.pools[self.share_key],
                                 self.shard_of_slot(slot))

    def index_slot(self, slot: int, req: Request, plen: int) -> int:
        """Deferred radix indexing for fused chunked prefill: called by
        the Engine at the drain that observes a slot's prefill cursor
        reach its prompt end — the instant every prompt page is actually
        written.  Indexes exactly the admission-time effective prompt
        (``plen`` tokens: later decoded tokens ride the same pages but
        are not prefix-stable).  Returns radix nodes created."""
        if self.radix is None:
            return 0
        rows = self._rows.get(slot)
        if rows is None or self.share_key not in rows:
            return 0
        return self.radix.insert(req.effective_prompt[:plen],
                                 rows[self.share_key],
                                 self.pools[self.share_key],
                                 self.shard_of_slot(slot))

    def can_progress(self, live_slots: int, now: float = 0.0) -> bool:
        """False when the engine is wedged: nothing is running and the
        admission-order head still cannot be admitted in any shard even
        after draining every evictable radix page (should be impossible
        given the submit() capacity check — a guard, not a policy)."""
        if not self.queue or live_slots:
            return True
        head = self.admission_order(now)[0]
        need = self.spec.blocks_needed(len(head.effective_prompt),
                                       head.effective_max_new)

        def fits(shard: int) -> bool:
            for key, n in need.items():
                avail = self.pools[key].free_in(shard)
                if self.radix is not None and key == self.share_key:
                    avail += self.radix.reclaimable(self.pools[key], shard)
                if n > avail:
                    return False
            return True

        return any(fits(k) for k in range(self.shards))

    # ---------------------------------------------------------- telemetry
    @property
    def pages_in_use(self) -> int:
        return sum(p.in_use for p in self.pools.values())

    @property
    def pages_in_use_by_group(self) -> Dict[str, int]:
        return {k: p.in_use for k, p in self.pools.items()}

    def pages_in_use_in(self, shard: int) -> Dict[str, int]:
        """Pages in use per group in ``shard`` alone."""
        return {k: p.in_use_by_shard()[shard] for k, p in self.pools.items()}

    @property
    def peak_pages_in_use(self) -> int:
        """True global peak (sampled after every admission — occupancy
        only rises there, so sampling per-pool peaks taken at different
        instants would overstate multi-group archs)."""
        return self._peak_pages

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-sharing telemetry for BENCH_serve.json / launch logs."""
        return {
            "prefix_sharing": self.radix is not None,
            "admissions": self.admissions_total,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.admissions_total
                                if self.admissions_total else 0.0),
            "prefill_tokens_skipped": self.prefix_tokens_skipped,
            "shared_page_attaches": self.shared_page_attaches,
            "cow_copies": self.cow_copies,
            "radix_evictions": self.radix_evictions,
            "radix_pages": (self.radix.node_count
                            if self.radix is not None else 0),
        }
