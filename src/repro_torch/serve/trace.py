"""Bounded ring-buffer request-lifecycle tracing for the serving engine.

Every host-side lifecycle transition -- submit, admit, prefill-cursor
advance, chunk boundary, preempt/resume, copy-on-write, radix hit,
reap, chaos fault, terminal -- is recorded as one :class:`TraceEvent`
``(ts, kind, rid, slot, attrs)``.  Events are recorded **only at chunk
boundaries** by the host driver, timestamped from the engine's
injectable clock (the single per-drain ``_clock()`` read; a
``VirtualClock`` under replay), so tracing adds zero device syncs and
the fused decode chunk stays one compiled executable.  The buffer is a
bounded ring: at capacity the oldest non-terminal event is evicted
(``Tracer.dropped`` counts them) while terminal events (``finish`` /
``reject``) are never dropped.

Exporters: :func:`to_chrome_trace` renders the Chrome trace-event /
Perfetto JSON timeline (per-slot tracks, async queue spans,
per-request flow arrows across preempt/resume, counter tracks for pool
occupancy and queue depth) behind ``Engine.export_trace`` and
validated by ``repro_torch/benchmarks/check_trace.py``; :func:`explain`
renders a per-request causal chain with per-phase durations behind
``Engine.explain``.  ``Tracer.fingerprint()`` is a canonical string
over the buffered events -- two replays of the same seeded traffic on
a ``VirtualClock`` produce byte-identical fingerprints
(``tests/test_torch_trace.py``).

A copy of ``repro/serve/trace.py`` (framework-free), kept in the port
so that it imports nothing of the reference package.
"""

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

# The event taxonomy (the reference's docs/observability.md documents
# each kind):
EVENT_KINDS = (
    "submit",      # request entered the engine (ts = submit_time)
    "admit",       # leased a slot; attrs: chunk, suffix_start, resume
    "resume",      # re-admission of a previously preempted request
    "radix_hit",   # prefix pages attached from the radix index
    "cow",         # copy-on-write page duplication at admission
    "prefill",     # chunked-prefill cursor advance observed by a drain
    "chunk",       # chunk boundary; attrs carry counter samples
    "preempt",     # slot evicted (pressure / chaos / watchdog)
    "reap",        # deadline/cancel enforcement at a boundary
    "chaos",       # injected fault fired (serve/chaos.py)
    "finish",      # terminal: FINISHED / TIMED_OUT / CANCELLED
    "reject",      # terminal: shed at submit (infeasible / queue_full)
)

#: Terminal kinds are never evicted from the ring.
TERMINAL_KINDS = frozenset({"finish", "reject"})

# Chrome-trace thread ids: one engine-wide track for chunk boundaries
# and counters, one queue track for wait phases, one track per slot.
ENGINE_TID = 0
QUEUE_TID = 1
SLOT_TID_BASE = 10


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One lifecycle transition: ``(ts, kind, rid, slot, attrs)``.

    ``seq`` is a per-tracer monotonic sequence number that gives a
    total order even when many events share one chunk-boundary
    timestamp.
    """

    ts: float
    kind: str
    rid: Optional[int] = None
    slot: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seq: int = 0


class Tracer:
    """Bounded structured event ring with terminal-event retention."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque()
        self._pinned: List[TraceEvent] = []   # evicted-but-terminal
        self._seq = 0
        self.dropped = 0                      # non-terminal evictions

    def record(self, kind: str, ts: float, rid: Optional[int] = None,
               slot: Optional[int] = None, **attrs: Any) -> TraceEvent:
        ev = TraceEvent(ts=float(ts), kind=kind, rid=rid, slot=slot,
                        attrs=attrs, seq=self._seq)
        self._seq += 1
        self._ring.append(ev)
        # Evict oldest-first, but terminal events survive eviction by
        # moving to the pinned list (which may push us past capacity:
        # terminal events are never dropped, by contract).
        while (len(self._ring) + len(self._pinned) > self.capacity
               and self._ring):
            old = self._ring.popleft()
            if old.kind in TERMINAL_KINDS:
                self._pinned.append(old)
            else:
                self.dropped += 1
        return ev

    def events(self) -> List[TraceEvent]:
        return sorted(self._pinned + list(self._ring),
                      key=lambda e: e.seq)

    def __len__(self) -> int:
        return len(self._ring) + len(self._pinned)

    def fingerprint(self) -> str:
        """Canonical string over all buffered events.

        Timestamps are ``repr``-ed so replayed ``VirtualClock``
        experiments compare byte-exact.
        """
        lines = []
        for e in self.events():
            a = ",".join(f"{k}={e.attrs[k]!r}" for k in sorted(e.attrs))
            lines.append(f"{e.seq}|{e.ts!r}|{e.kind}|{e.rid}|{e.slot}|{a}")
        return "\n".join(lines)


def _lifecycle_phases(evs: List[TraceEvent]) -> List[
        Tuple[str, float, Optional[float], Optional[int]]]:
    """Contiguous ``(phase, t0, t1, slot)`` segments for one rid.

    Phases are ``queued`` (submit->admit), ``running`` (admit->
    preempt/terminal) and ``requeued`` (preempt->re-admit).  The last
    segment has ``t1 is None`` when the request never reached a
    terminal event in the buffer.
    """
    phases: List[Tuple[str, float, Optional[float], Optional[int]]] = []
    cur: Optional[Tuple[str, float, Optional[int]]] = None
    for e in evs:
        if e.kind == "submit":
            cur = ("queued", e.ts, None)
        elif e.kind == "admit":
            if cur is None:           # submit evicted from the ring
                cur = ("queued", e.ts, None)
            phases.append((cur[0], cur[1], e.ts, cur[2]))
            cur = ("running", e.ts, e.slot)
        elif e.kind == "preempt":
            if cur is not None:
                phases.append((cur[0], cur[1], e.ts, cur[2]))
            cur = ("requeued", e.ts, None)
        elif e.kind in TERMINAL_KINDS:
            if cur is not None:
                phases.append((cur[0], cur[1], e.ts, cur[2]))
                cur = None
    if cur is not None:
        phases.append((cur[0], cur[1], None, cur[2]))
    return phases


# Counter tracks sampled from each chunk event's attrs.
_COUNTER_TRACKS = (
    ("pool.pages_in_use", "pages_in_use"),
    ("sched.queue_depth", "queue_depth"),
    ("pool.live_slots", "live_slots"),
)


def to_chrome_trace(events: Iterable[TraceEvent], *,
                    pid: int = 1) -> Dict[str, Any]:
    """Render events as a Chrome trace-event / Perfetto JSON object.

    Layout: running phases are ``X`` complete events on per-slot
    tracks (``tid = SLOT_TID_BASE + slot``); queued/requeued waits are
    async ``b``/``e`` pairs keyed by rid; one ``s``/``t``/``f`` flow
    chain per request links submit through every admit/preempt hop to
    its terminal event; chunk-boundary counter samples become ``C``
    counter tracks.  ``repro_torch/benchmarks/check_trace.py`` validates
    the result against the trace-event schema.
    """
    evs = sorted(events, key=lambda e: e.seq)
    t0 = min((e.ts for e in evs), default=0.0)

    def us(t: float) -> float:
        return (t - t0) * 1e6

    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": ENGINE_TID, "name": "process_name",
         "args": {"name": "repro_torch.serve"}},
        {"ph": "M", "pid": pid, "tid": ENGINE_TID, "name": "thread_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": pid, "tid": QUEUE_TID, "name": "thread_name",
         "args": {"name": "queue"}},
    ]
    for s in sorted({e.slot for e in evs if e.slot is not None}):
        out.append({"ph": "M", "pid": pid, "tid": SLOT_TID_BASE + s,
                    "name": "thread_name", "args": {"name": f"slot {s}"}})

    by_rid: Dict[int, List[TraceEvent]] = {}
    for e in evs:
        if e.rid is not None:
            by_rid.setdefault(e.rid, []).append(e)

    for rid, revs in sorted(by_rid.items()):
        # Split the rid's event stream into lifecycle generations at
        # terminal events: benchmark harnesses reuse rids across runs
        # within one tracer, and each reuse must get its own wait spans
        # and flow chain (distinct ``id``), not fuse into one.
        gens: List[List[TraceEvent]] = []
        cur_gen: List[TraceEvent] = []
        for e in revs:
            cur_gen.append(e)
            if e.kind in TERMINAL_KINDS:
                gens.append(cur_gen)
                cur_gen = []
        if cur_gen:
            gens.append(cur_gen)
        multi = len(gens) > 1
        for gi, gen in enumerate(gens):
            fid = f"{rid}#{gi}" if multi else str(rid)
            last_ts = gen[-1].ts
            for name, a, b, slot in _lifecycle_phases(gen):
                end = last_ts if b is None else b
                if name == "running" and slot is not None:
                    out.append({"ph": "X", "pid": pid,
                                "tid": SLOT_TID_BASE + slot,
                                "ts": us(a),
                                "dur": max(0.0, us(end) - us(a)),
                                "name": f"run rid={rid}",
                                "cat": "running", "args": {"rid": rid}})
                else:
                    pair = {"pid": pid, "tid": QUEUE_TID,
                            "cat": "request", "id": fid,
                            "name": f"wait rid={rid}"}
                    out.append(dict(pair, ph="b", ts=us(a),
                                    args={"rid": rid, "phase": name}))
                    out.append(dict(pair, ph="e", ts=us(end), args={}))
            # One flow chain per generation: submit -> admits/preempts
            # -> terminal.  The arrows survive preempt/resume slot hops.
            terminal = next((e for e in gen if e.kind in TERMINAL_KINDS),
                            None)
            points: List[Tuple[float, int]] = []
            sub = next((e for e in gen if e.kind == "submit"), None)
            if sub is not None:
                points.append((sub.ts, QUEUE_TID))
            for e in gen:
                if e.kind in ("admit", "preempt") and e.slot is not None:
                    points.append((e.ts, SLOT_TID_BASE + e.slot))
            if terminal is not None:
                ttid = (SLOT_TID_BASE + terminal.slot
                        if terminal.slot is not None else QUEUE_TID)
                points.append((terminal.ts, ttid))
            if len(points) >= 2:
                base = {"pid": pid, "cat": "lifecycle", "id": fid,
                        "name": f"req {rid}"}
                first, mids, last = points[0], points[1:-1], points[-1]
                out.append(dict(base, ph="s", ts=us(first[0]),
                                tid=first[1]))
                for t, tid in mids:
                    out.append(dict(base, ph="t", ts=us(t), tid=tid))
                out.append(dict(base, ph="f", bp="e", ts=us(last[0]),
                                tid=last[1]))

    for e in evs:
        if e.kind == "chunk":
            for cname, akey in _COUNTER_TRACKS:
                if akey in e.attrs:
                    out.append({"ph": "C", "pid": pid, "tid": ENGINE_TID,
                                "ts": us(e.ts), "name": cname,
                                "args": {"value": e.attrs[akey]}})
            out.append({"ph": "i", "s": "g", "pid": pid, "tid": ENGINE_TID,
                        "ts": us(e.ts), "name": "chunk", "cat": "event",
                        "args": dict(e.attrs)})
            continue
        tid = (SLOT_TID_BASE + e.slot if e.slot is not None
               else QUEUE_TID)
        args = dict(e.attrs)
        if e.rid is not None:
            args["rid"] = e.rid
        out.append({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                    "ts": us(e.ts), "name": e.kind, "cat": "event",
                    "args": args})

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.serve.trace"}}


def explain(events: Iterable[TraceEvent], rid: int) -> str:
    """Per-request text explain: the causal chain from submit to
    terminal, with per-phase durations."""
    evs = sorted((e for e in events if e.rid == rid),
                 key=lambda e: e.seq)
    if not evs:
        return f"rid {rid}: no trace events recorded"
    t_base = evs[0].ts
    lines = [f"request {rid}: causal chain ({len(evs)} events)"]
    for e in evs:
        loc = f" slot={e.slot}" if e.slot is not None else ""
        attrs = " ".join(f"{k}={e.attrs[k]}" for k in sorted(e.attrs))
        lines.append(f"  +{e.ts - t_base:.6f}s {e.kind}{loc}"
                     + (f" {attrs}" if attrs else ""))
    phases = _lifecycle_phases(evs)
    if phases:
        agg: Dict[str, Tuple[float, int]] = {}
        for name, a, b, _slot in phases:
            end = evs[-1].ts if b is None else b
            d, n = agg.get(name, (0.0, 0))
            agg[name] = (d + (end - a), n + 1)
        lines.append("phase durations:")
        for name in ("queued", "running", "requeued"):
            if name in agg:
                d, n = agg[name]
                lines.append(f"  {name}: {d:.6f}s over {n} span(s)")
        lines.append(f"  total: {evs[-1].ts - t_base:.6f}s")
    term = next((e for e in evs if e.kind in TERMINAL_KINDS), None)
    if term is not None:
        lines.append(f"terminal: {term.attrs.get('status', term.kind)}")
    else:
        lines.append("terminal: (still in flight)")
    return "\n".join(lines)
