"""PyTorch port: property-based invariants of the port's ``Scheduler``
under the FIFO and SLO policies (hypothesis), case for case with
``tests/test_slo_scheduler.py``: random interleavings of
submit / admit / release / preempt / cancel / tick across SLO classes
never starve an admitted request nor leak pages, the slo policy admits
in (priority, slack) order within a boundary, and FIFO never reorders
the queue.  Every op sequence also runs on the reference's
``Scheduler``, and the two admission logs and queues must be equal."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402


CLASSES = sorted(tsched.SLO_CLASSES)


class _Harness:
    """Pure-host Scheduler driver (the reference test's): admit into free
    slots, release on finish, requeue on preempt, no device work."""

    def __init__(self, mod, policy, slots=4):
        if mod is tsched:
            cfg, cache = reduced(get_config("internlm2-1.8b")), tcache
        else:
            cfg, cache = jax_reduced(jax_get_config("internlm2-1.8b")), \
                jcache
        spec = cache.CacheSpec.from_config(cfg, slots=slots, max_len=64,
                                           page_size=8)
        self.mod = mod
        self.sched = mod.Scheduler(spec, prefix_sharing=False,
                                   policy=policy)
        self.slots = slots
        self.live = {}
        self.now = 0.0
        self.next_rid = 0
        self.submitted = []

    def free_slots(self):
        return [s for s in range(self.slots) if s not in self.live]

    def submit(self, cls, plen, max_new):
        req = self.mod.Request(rid=self.next_rid,
                               prompt=list(range(1, plen + 1)),
                               max_new_tokens=max_new, slo_class=cls,
                               submit_time=self.now)
        self.next_rid += 1
        try:
            self.sched.submit(req)
        except self.mod.PagePoolExhausted:
            return
        self.submitted.append(req)

    def admit(self):
        for adm in self.sched.admissions(self.free_slots(), now=self.now):
            self.live[adm.slot] = adm.req

    def release(self, pick):
        if not self.live:
            return
        slot = sorted(self.live)[pick % len(self.live)]
        req = self.live.pop(slot)
        req.status = self.mod.RequestStatus.FINISHED
        self.sched.release(slot)

    def preempt(self, pick):
        if not self.live:
            return
        slot = sorted(self.live)[pick % len(self.live)]
        req = self.live.pop(slot)
        self.sched.release(slot)
        req.preemptions += 1
        if req.preemptions <= 2:
            self.sched.requeue(req)
        else:
            req.status = self.mod.RequestStatus.FINISHED

    def cancel(self, pick):
        if not self.sched.queue:
            return
        req = self.sched.queue[pick % len(self.sched.queue)]
        self.sched.queue.remove(req)
        req.status = self.mod.RequestStatus.CANCELLED

    def apply(self, ops):
        for op in ops:
            if op[0] == "tick":
                self.now += op[1]
            else:
                getattr(self, op[0])(*op[1:])

    def drain(self):
        for _ in range(20 * (len(self.submitted) + 1)):
            if not self.sched.queue and not self.live:
                return True
            self.now += 1.0
            self.admit()
            self.release(0)
        return False


def _both(ops, policy):
    """The ops on the port's and the reference's scheduler; their
    admission logs and queues (by rid) must be equal."""
    port, ref = _Harness(tsched, policy), _Harness(jsched, policy)
    for h in (port, ref):
        h.apply(ops)
    assert [r.rid for r in port.sched.queue] == \
        [r.rid for r in ref.sched.queue]
    return port, ref


_OPS = st.lists(
    st.one_of(
        st.tuples(st.just("submit"), st.sampled_from(CLASSES),
                  st.integers(2, 12), st.integers(1, 16)),
        st.tuples(st.just("admit")),
        st.tuples(st.just("release"), st.integers(0, 7)),
        st.tuples(st.just("preempt"), st.integers(0, 7)),
        st.tuples(st.just("cancel"), st.integers(0, 7)),
        st.tuples(st.just("tick"), st.integers(1, 5)),
    ), min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, policy=st.sampled_from(["fifo", "slo"]))
def test_random_interleavings_never_starve_or_leak(ops, policy):
    h, ref = _both(ops, policy)
    assert h.drain(), (
        f"{policy}: queue failed to drain — an admitted request starved")
    ref.drain()
    assert h.sched.pages_in_use == 0, (
        f"{policy}: {h.sched.pages_in_use} pages leaked after clean drain")
    for req in h.submitted:
        assert req.status in (tsched.RequestStatus.FINISHED,
                              tsched.RequestStatus.CANCELLED)
    assert h.sched.admission_log == ref.sched.admission_log


@settings(max_examples=60, deadline=None)
@given(ops=_OPS)
def test_slo_admissions_in_slack_order_within_boundary(ops):
    h, ref = _both(ops, "slo")
    h.drain()
    ref.drain()
    by_boundary = {}
    for boundary, rid, prio, slack, _chunk in h.sched.admission_log:
        by_boundary.setdefault(boundary, []).append((prio, slack, rid))
    for boundary, entries in by_boundary.items():
        keys = [(p, s) for p, s, _ in entries]
        assert keys == sorted(keys), (
            f"boundary {boundary} admitted out of slack order: {entries}")
    assert h.sched.admission_log == ref.sched.admission_log


@settings(max_examples=60, deadline=None)
@given(ops=_OPS)
def test_fifo_admissions_in_arrival_order(ops):
    h, ref = _both(ops, "fifo")
    assert h.sched.admission_order(h.now) == h.sched.queue
    h.drain()
    ref.drain()
    assert h.sched.pages_in_use == 0
    assert h.sched.admission_log == ref.sched.admission_log
