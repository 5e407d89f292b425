"""Typed counters/gauges registry unifying the engine's telemetry.

Nine PRs of serving work accumulated five disconnected stats dicts --
``memory_stats`` / ``fault_stats`` / ``latency_stats`` /
``spec_stats`` / ``prefix_stats`` -- each with its own key spellings.
This module absorbs them behind one flat snapshot with **stable dotted
metric names** (``pool.pages_in_use``, ``sched.preemptions.pressure``,
``spec.acceptance``, ``latency.goodput``, ...), the registry every
dashboard, gate, and future ROADMAP item reports through.

:data:`REGISTRY` declares each stable name with a metric kind
(``counter`` monotonically increases over an engine's lifetime;
``gauge`` samples a level).  Dynamic families (per-SLO-class latency,
per-pool-group occupancy, chaos counters) are declared as prefix
rules.  :func:`snapshot` flattens a live engine into ``{name: value}``
and refuses to emit a name the registry does not know -- renaming a
metric is an API change, not a drive-by edit.  ``Engine.observe()`` is
the public entry point; the reference's ``docs/observability.md``
lists every name.

A copy of ``repro/serve/metrics.py`` (framework-free), kept in the port
so that it imports nothing of the reference package.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

Number = Any  # int | float | bool


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One stable metric name: its kind and one-line meaning."""

    name: str
    kind: str       # "counter" | "gauge"
    help: str = ""


def _c(name: str, help: str = "") -> MetricSpec:
    return MetricSpec(name, "counter", help)


def _g(name: str, help: str = "") -> MetricSpec:
    return MetricSpec(name, "gauge", help)


#: The stable name registry (exact names).
REGISTRY: Tuple[MetricSpec, ...] = (
    # engine driver
    _c("engine.steps", "decode steps issued (sync_interval per chunk)"),
    _c("engine.host_syncs", "batched device->host drains"),
    _c("engine.chunks", "drained chunk count (the chunk sequence id)"),
    _g("engine.queue_depth", "requests waiting for a slot"),
    # page pools
    _g("pool.pages_in_use", "currently referenced pages, all groups"),
    _g("pool.peak_pages_in_use", "high-water referenced pages"),
    _g("pool.live_slots", "slots currently running"),
    _g("pool.peak_live_slots", "high-water concurrent slots"),
    # scheduler / fault machinery
    _c("sched.admissions", "admissions planned (incl. resumes)"),
    _c("sched.preemptions.total", "slot evictions, all causes"),
    _c("sched.preemptions.pressure", "evictions for page pressure"),
    _c("sched.preemptions.chaos", "evictions injected by chaos"),
    _c("sched.preemptions.watchdog", "evictions of stalled slots"),
    _c("sched.resumes", "re-admissions of preempted requests"),
    _c("sched.timed_out", "requests reaped past their deadline"),
    _c("sched.cancelled", "requests reaped after cancel()"),
    _c("sched.rejected.total", "requests shed at submit"),
    _c("sched.rejected.infeasible", "reservation exceeds pool budget"),
    _c("sched.rejected.queue_full", "queue_limit hit, policy=reject"),
    _c("sched.rejected.shed_lower_class", "displaced by a higher class"),
    _g("sched.resume.recovered_prefill_fraction",
       "prefill tokens recovered from the radix index on resume"),
    _c("sched.budget_throttles", "prefill-budget throttle decisions"),
    # latency rollup
    _g("latency.goodput", "fraction of terminal requests meeting SLO"),
    # tracing
    _g("trace.events", "events currently buffered in the tracer"),
    _c("trace.dropped", "non-terminal events evicted at capacity"),
)

#: Dynamic name families: (prefix, kind).
DYNAMIC_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("pool.", "gauge"),            # pool.group.<g>.<k>, byte accounting
    ("latency.class.", "gauge"),   # per-SLO-class percentiles/goodput
    ("latency.", "gauge"),         # overall percentiles
    ("prefix.", "gauge"),          # radix sharing telemetry
    ("spec.", "gauge"),            # speculative decoding telemetry
    ("chaos.", "counter"),         # injected-fault schedule counts
    ("sched.resume.", "counter"),  # resume_* recovery counters
)

_BY_NAME: Dict[str, MetricSpec] = {m.name: m for m in REGISTRY}


def kind_of(name: str) -> Optional[str]:
    """Metric kind for ``name``, or None if the registry rejects it."""
    spec = _BY_NAME.get(name)
    if spec is not None:
        return spec.kind
    for prefix, kind in DYNAMIC_PREFIXES:
        if name.startswith(prefix):
            return kind
    return None


def _put(out: Dict[str, Number], name: str, value: Any) -> None:
    if value is None or isinstance(value, (dict, list, tuple, str)):
        return
    if kind_of(name) is None:
        raise KeyError(f"metric name {name!r} is not in the registry; "
                       "declare it in repro_torch.serve.metrics first")
    out[name] = value


def _flatten(out: Dict[str, Number], prefix: str, d: Dict[str, Any]) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            _flatten(out, f"{prefix}{k}.", v)
        else:
            _put(out, f"{prefix}{k}", v)


# fault_stats() keys -> stable dotted names.
_FAULT_RENAMES = {
    "preemptions": "sched.preemptions.total",
    "pressure_preemptions": "sched.preemptions.pressure",
    "chaos_preemptions": "sched.preemptions.chaos",
    "watchdog_preemptions": "sched.preemptions.watchdog",
    "resumes": "sched.resumes",
    "timed_out": "sched.timed_out",
    "cancelled": "sched.cancelled",
    "rejected": "sched.rejected.total",
    "rejected_infeasible": "sched.rejected.infeasible",
    "rejected_queue_full": "sched.rejected.queue_full",
    "rejected_shed_lower_class": "sched.rejected.shed_lower_class",
    "recovered_prefill_fraction":
        "sched.resume.recovered_prefill_fraction",
}


def snapshot(engine: Any, *, spec: bool = True) -> Dict[str, Number]:
    """Flatten a live engine into ``{dotted_name: value}``.

    ``spec=False`` skips ``spec_stats()`` (the one stats call that
    reads device memory) for strictly host-side sampling.
    """
    out: Dict[str, Number] = {}
    _put(out, "engine.steps", engine.steps)
    _put(out, "engine.host_syncs", engine.host_syncs)
    _put(out, "engine.chunks", getattr(engine, "chunks", 0))
    _put(out, "engine.queue_depth", len(engine.queue))

    mem = engine.memory_stats()
    _put(out, "pool.live_slots", mem.pop("live_slots", None))
    _put(out, "pool.peak_live_slots", mem.pop("peak_live_slots", None))
    _flatten(out, "pool.", mem)
    pages_now = getattr(engine.scheduler, "pages_in_use", None)
    if pages_now is not None:
        _put(out, "pool.pages_in_use", pages_now)
    _put(out, "sched.admissions",
         getattr(engine.scheduler, "admissions_total", None))

    faults = dict(engine.fault_stats())
    chaos = faults.pop("chaos", None)
    for k, v in faults.items():
        name = _FAULT_RENAMES.get(k)
        if name is None:
            name = f"sched.resume.{k[len('resume_'):]}" \
                if k.startswith("resume_") else f"chaos.{k}"
        _put(out, name, v)
    if isinstance(chaos, dict):
        _flatten(out, "chaos.", chaos)

    lat = dict(engine.latency_stats())
    _put(out, "latency.goodput", lat.pop("goodput", None))
    _put(out, "sched.budget_throttles", lat.pop("budget_throttles", None))
    for cls, stats in lat.pop("classes", {}).items():
        _flatten(out, f"latency.class.{cls}.", stats)
    _flatten(out, "latency.", lat.pop("overall", {}))

    _flatten(out, "prefix.", engine.prefix_stats())

    if spec:
        sp = dict(engine.spec_stats())
        if "acceptance_rate" in sp:
            _put(out, "spec.acceptance", sp.pop("acceptance_rate"))
        _flatten(out, "spec.", sp)

    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        _put(out, "trace.events", len(tracer))
        _put(out, "trace.dropped", tracer.dropped)
    return out
