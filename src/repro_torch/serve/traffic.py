"""Deterministic multi-tenant traffic harness: seeded arrival processes,
mixed length distributions, SLO-class mixes, and engine replay.

The paper's serving claim (and the fig04 scheduling study) is only
measurable under controlled load: latency percentiles from an
uncontrolled arrival process compare machines, not schedulers.  This
module generates the "millions of users" side of that experiment as a
**fully deterministic, replayable trace**:

* ``TrafficGenerator`` — seeded ``numpy`` RNG over two arrival
  processes: ``"poisson"`` (exponential interarrivals at ``rate``) and
  ``"bursty"`` (a 2-state Markov-modulated Poisson process: a calm
  state at ``rate`` and a burst state at ``rate * burst_ratio``, with
  seeded state transitions after every arrival).  Each arrival draws an
  SLO class from ``class_mix`` and its prompt/output lengths from that
  class's profile (interactive traffic is short-prompt/short-output,
  batch long/long by default) — same seed, same trace, byte for byte.
* ``VirtualClock`` — a counter the Engine uses as its injectable
  ``clock``; ``replay`` advances it by ``dt`` per chunk boundary, so
  TTFT/TPOT and every deadline decision are functions of the schedule
  alone.  Two replays of one trace produce identical
  ``fault_stats()`` / ``latency_stats()`` counters on any machine.
* ``replay`` — drives an ``Engine`` through a trace: submit every
  request whose arrival time has passed, step, tick.

``repro_torch/benchmarks/fig04_scheduling.py --slo-mix`` builds the
SLO-vs-FIFO comparison on top; ``repro_torch.launch.serve --traffic
poisson:SEED`` is the CLI entry.

A copy of ``repro/serve/traffic.py`` bound to the port's ``Request``:
the same seed draws the same numpy stream, so the same trace, in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request, SLO_CLASSES


@dataclasses.dataclass(frozen=True)
class ClassProfile:
    """Per-class length distributions (inclusive integer ranges) and
    optional explicit latency targets in clock units (None defers to the
    ``SLO_CLASSES`` defaults)."""

    prompt_len: Tuple[int, int]
    max_new: Tuple[int, int]
    ttft_target: Optional[float] = None
    tpot_target: Optional[float] = None


#: Default per-class shapes: interactive = chat turns (short prompt,
#: short completion), batch = document jobs (long/long), best_effort =
#: background filler.
DEFAULT_PROFILES: Dict[str, ClassProfile] = {
    "interactive": ClassProfile(prompt_len=(2, 10), max_new=(4, 10)),
    "batch": ClassProfile(prompt_len=(8, 24), max_new=(10, 24)),
    "best_effort": ClassProfile(prompt_len=(2, 16), max_new=(4, 16)),
}

DEFAULT_MIX: Dict[str, float] = {
    "interactive": 0.5, "batch": 0.3, "best_effort": 0.2,
}


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One trace entry — everything needed to rebuild the ``Request``."""

    rid: int
    arrival: float
    prompt: Tuple[int, ...]
    max_new_tokens: int
    slo_class: str
    ttft_target: Optional[float] = None
    tpot_target: Optional[float] = None

    def to_request(self) -> Request:
        return Request(rid=self.rid, prompt=list(self.prompt),
                       max_new_tokens=self.max_new_tokens,
                       slo_class=self.slo_class,
                       ttft_target=self.ttft_target,
                       tpot_target=self.tpot_target)


class TrafficGenerator:
    """Seeded, deterministic arrival-process generator.

    ``process`` is ``"poisson"`` or ``"bursty"``; ``rate`` is arrivals
    per clock unit in the calm state.  The bursty process multiplies the
    rate by ``burst_ratio`` while in the burst state and moves between
    states after every arrival with probabilities ``p_burst`` (enter)
    and ``p_calm`` (leave) — a discrete Markov-modulated Poisson
    process.  All randomness flows from ONE ``numpy`` generator seeded
    with ``seed``, so two instances with equal arguments emit
    byte-identical traces."""

    def __init__(self, seed: int, *, rate: float = 1.0,
                 process: str = "poisson", burst_ratio: float = 8.0,
                 p_burst: float = 0.08, p_calm: float = 0.25,
                 class_mix: Optional[Dict[str, float]] = None,
                 profiles: Optional[Dict[str, ClassProfile]] = None,
                 vocab: int = 250):
        if process not in ("poisson", "bursty"):
            raise ValueError(
                f"process must be 'poisson' or 'bursty', got {process!r}")
        if rate <= 0.0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.seed = int(seed)
        self.rate = float(rate)
        self.process = process
        self.burst_ratio = float(burst_ratio)
        self.p_burst = float(p_burst)
        self.p_calm = float(p_calm)
        self.class_mix = dict(class_mix or DEFAULT_MIX)
        for cls in self.class_mix:
            if cls not in SLO_CLASSES:
                raise ValueError(f"unknown SLO class {cls!r} in mix "
                                 f"(known: {sorted(SLO_CLASSES)})")
        self.profiles = dict(DEFAULT_PROFILES)
        self.profiles.update(profiles or {})
        self.vocab = int(vocab)

    def generate(self, n: int) -> List[TrafficRequest]:
        """The first ``n`` arrivals of the seeded process (a fresh RNG
        per call: ``generate`` is a pure function of ``(seed, args)``,
        never of generator history)."""
        rng = np.random.default_rng(self.seed)
        names = sorted(self.class_mix)
        weights = np.asarray([self.class_mix[c] for c in names])
        weights = weights / weights.sum()
        out: List[TrafficRequest] = []
        t = 0.0
        bursting = False
        for rid in range(n):
            lam = self.rate * (self.burst_ratio if bursting else 1.0)
            t += float(rng.exponential(1.0 / lam))
            cls = names[int(rng.choice(len(names), p=weights))]
            prof = self.profiles.get(cls, DEFAULT_PROFILES["best_effort"])
            plen = int(rng.integers(prof.prompt_len[0],
                                    prof.prompt_len[1] + 1))
            max_new = int(rng.integers(prof.max_new[0],
                                       prof.max_new[1] + 1))
            prompt = tuple(int(v) for v in
                           rng.integers(1, self.vocab, size=plen))
            out.append(TrafficRequest(
                rid=rid, arrival=t, prompt=prompt,
                max_new_tokens=max_new, slo_class=cls,
                ttft_target=prof.ttft_target,
                tpot_target=prof.tpot_target))
            if self.process == "bursty":
                flip = float(rng.random())
                bursting = (flip >= self.p_calm if bursting
                            else flip < self.p_burst)
        return out


def trace_fingerprint(trace: List[TrafficRequest]) -> str:
    """Canonical string form of a trace — equal strings == byte-identical
    traces (the determinism gate compares these)."""
    parts = []
    for tr in trace:
        parts.append(f"{tr.rid}|{tr.arrival!r}|{tr.slo_class}|"
                     f"{tr.max_new_tokens}|{tr.ttft_target!r}|"
                     f"{tr.tpot_target!r}|{','.join(map(str, tr.prompt))}")
    return "\n".join(parts)


class VirtualClock:
    """Deterministic engine clock: time moves only when ``tick`` is
    called (one chunk boundary == ``dt`` units), so every latency stamp
    and deadline decision replays identically on any machine."""

    def __init__(self, dt: float = 1.0, start: float = 0.0):
        self.dt = float(dt)
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def tick(self) -> None:
        self.now += self.dt


def replay(eng, trace: List[TrafficRequest],
           clock: Optional[VirtualClock] = None,
           max_steps: int = 100_000) -> Dict[str, Any]:
    """Drive ``eng`` through ``trace``: at each boundary submit every
    arrival whose time has come, step, tick.  When the engine goes idle
    before the next arrival the clock jumps straight to it (no busy
    spinning).  ``clock`` should be the SAME object passed as the
    engine's ``clock=`` for deterministic replay.  Returns submit
    results keyed by rid (None == accepted)."""
    clock = clock if clock is not None else VirtualClock()
    pending = sorted(trace, key=lambda tr: (tr.arrival, tr.rid))
    results: Dict[int, Any] = {}
    i = 0
    steps = 0
    while i < len(pending) or eng.queue or eng._live():
        if steps >= max_steps:
            raise RuntimeError(f"replay exceeded {max_steps} steps")
        while i < len(pending) and pending[i].arrival <= clock():
            tr = pending[i]
            results[tr.rid] = eng.submit(tr.to_request())
            i += 1
        if eng.queue or eng._live():
            eng.step()
            steps += 1
            clock.tick()
        elif i < len(pending):
            clock.now = max(clock.now, pending[i].arrival)
    return results
