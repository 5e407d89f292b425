"""Deterministic fault injection for the serving runtime (chaos layer).

Every recovery path the engine claims to have — admission backpressure,
preemption + radix re-admission, straggler detection, CoW/splice
degradation, speculative-drafter isolation — is only trustworthy if it
can be *driven* on demand.  ``ChaosMonkey`` is a seeded schedule of
injectable failure points the ``Engine`` consults at chunk boundaries
(never inside the compiled decode chunk, so the sync-free property is
untouched):

* **admission denial** (``p_deny_admission``) — a chunk boundary where
  every admission plan is treated as pool-exhausted, exercising queue
  backpressure.  Only applied while at least one slot is live, so denial
  can delay but never deadlock.
* **preemption storm** (``p_preempt``) — a live slot is forcibly
  preempted (pages released, prompt pages preserved in the radix index,
  request requeued) even without pool pressure.
* **slot stall** (``p_stall``) — the host drain *ignores* a slot, as if
  its worker stopped reporting.  The stall persists until the engine's
  watchdog notices the lack of progress and preempts the slot; tokens
  emitted while stalled are lost and regenerated after resume, so output
  stays token-identical at temperature 0.
* **sharing fault** (``p_sharing_fault``) — an admission plan is built
  without prefix sharing, the graceful-degradation path a real
  copy-on-write / splice failure takes (exclusive pages, full prefill,
  identical tokens).
* **garbage drafter** (``garbage_drafter=True``) — wraps the speculative
  drafter in ``GarbageDrafter``, which proposes constant nonsense
  tokens.  Rejection sampling (``serve/sampling.spec_accept``) keeps the
  committed output token-identical regardless; only the acceptance rate
  collapses — the fault stays isolated to throughput.

All draws come from one ``numpy`` generator seeded at construction, so a
given (seed, workload) pair replays the exact same fault schedule.

The port's counterpart of ``repro/serve/chaos.py``: ``ChaosMonkey`` is
the reference's, line for line, on the same numpy stream, so one seed
gives one fault schedule in both packages; ``GarbageDrafter`` proposes
in torch, on the port drafter's signature."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch


class ChaosMonkey:
    """Seeded fault schedule the Engine consults at chunk boundaries."""

    def __init__(self, seed: int = 0, *, p_deny_admission: float = 0.0,
                 p_preempt: float = 0.0, p_stall: float = 0.0,
                 p_sharing_fault: float = 0.0,
                 garbage_drafter: bool = False,
                 max_faults: Optional[int] = None):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.p_deny_admission = float(p_deny_admission)
        self.p_preempt = float(p_preempt)
        self.p_stall = float(p_stall)
        self.p_sharing_fault = float(p_sharing_fault)
        self.garbage_drafter = bool(garbage_drafter)
        self.max_faults = max_faults
        self._stalled: Set[int] = set()
        # Optional observer hook: the Engine points this at its tracer
        # so every injected fault lands in the request-lifecycle trace
        # (serve/trace.py).  Called host-side at chunk boundaries
        # only, with (fault_name, **attrs); None disables it.
        self.on_event = None
        self.counters: Dict[str, int] = {
            "admission_denials": 0,
            "forced_preemptions": 0,
            "stalls_started": 0,
            "stalled_drains": 0,
            "sharing_faults": 0,
        }

    @classmethod
    def smoke(cls, seed: int = 0) -> "ChaosMonkey":
        """The CI smoke preset: every failure point enabled at moderate
        rates — enough that a short serve run hits each path, not so
        much that nothing finishes."""
        return cls(seed, p_deny_admission=0.15, p_preempt=0.10,
                   p_stall=0.05, p_sharing_fault=0.25)

    # ------------------------------------------------------------- draws
    def _fire(self, p: float) -> bool:
        if p <= 0.0:
            return False
        if self.max_faults is not None \
                and sum(self.counters.values()) >= self.max_faults:
            return False
        return bool(self._rng.random() < p)

    def _emit(self, fault: str, **attrs) -> None:
        if self.on_event is not None:
            self.on_event(fault, **attrs)

    def deny_admission(self) -> bool:
        """One boundary's admissions are refused (simulated pool
        exhaustion at admission time)."""
        if self._fire(self.p_deny_admission):
            self.counters["admission_denials"] += 1
            self._emit("admission_denial")
            return True
        return False

    def storm_victims(self, live_slots: List[int]) -> List[int]:
        """Slots to forcibly preempt this boundary (at most one)."""
        if live_slots and self._fire(self.p_preempt):
            self.counters["forced_preemptions"] += 1
            victim = int(self._rng.choice(live_slots))
            self._emit("forced_preemption", slot=victim)
            return [victim]
        return []

    def tick(self, live_slots: List[int]) -> None:
        """Per-boundary bookkeeping: maybe pick a new stall victim.  A
        stall persists until the watchdog preempts the slot (the engine
        calls ``clear_stall``), so the only exit is the recovery path."""
        fresh = [s for s in live_slots if s not in self._stalled]
        if fresh and self._fire(self.p_stall):
            victim = int(self._rng.choice(fresh))
            self._stalled.add(victim)
            self.counters["stalls_started"] += 1
            self._emit("stall_started", slot=victim)

    def stalled(self, slot: int) -> bool:
        """True while the drain must pretend ``slot`` reported nothing."""
        if slot in self._stalled:
            self.counters["stalled_drains"] += 1
            return True
        return False

    def clear_stall(self, slot: int) -> None:
        self._stalled.discard(slot)

    def sharing_fault(self) -> bool:
        """Degrade this admission plan to exclusive pages (simulated
        CoW/splice failure)."""
        if self._fire(self.p_sharing_fault):
            self.counters["sharing_faults"] += 1
            self._emit("sharing_fault")
            return True
        return False

    # --------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, int]:
        return dict(self.counters, seed=self.seed)


class GarbageDrafter:
    """Drafter wrapper proposing constant nonsense tokens.

    The speculative contract makes this safe by construction: the drafts
    are deterministic, so their proposal distribution is a point mass
    (``qprobs=None``) and rejection sampling accepts a garbage token
    only when the target model would have emitted it anyway.  Output is
    token-identical to the unwrapped engine; the acceptance rate is what
    collapses — the isolation property the chaos test asserts.  The
    wrapped drafter never proposes: a model drafter's draft cache is
    still filled by its prefill, and never read."""

    def __init__(self, inner, token: int = 7):
        self._inner = inner
        self.token = int(token)

    # the engine branches on these: forward them to the wrapped drafter
    @property
    def kind(self) -> str:
        return self._inner.kind

    @property
    def k(self) -> int:
        return self._inner.k

    @property
    def cfg(self):
        return self._inner.cfg

    def init_cache(self, slots: int, device: torch.device):
        return self._inner.init_cache(slots, device)

    def propose(self, draft_params: Any, cache: Dict, state: Dict,
                gen: torch.Generator, top_k: int
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        tokens = state["tokens"]
        drafts = torch.full((tokens.shape[0], self.k), self.token,
                            dtype=torch.int32, device=tokens.device)
        return drafts, None
