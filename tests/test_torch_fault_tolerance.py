"""PyTorch port: robustness of ``serve/engine.Engine`` against the JAX
reference on the same weights, case for case with
``tests/test_fault_tolerance.py``.

Each case runs one scenario on both engines with the same fake clock
and the same chaos seed, then asserts the reference test's own
conditions on the port's engine and holds the two runs equal: tokens,
terminal statuses, per-request preemption counts, ``fault_stats`` (the
chaos counters included), ``preemption_log``, the scheduler's
``admission_log`` and ``leaked_pages``.  Covered: deadline reaping of a
running and of a queued request, cancellation, pool-pressure preemption
with token parity against an uncontended run, a gemma2 windowed ring
that wraps after a resume, the radix recovery of a resumed prompt, the
``reject`` and ``block`` shed policies, and the chaos smoke schedule and
a storm-heavy SLO mix on seeds 0 and 1, both also token-equal to an
unfaulted run.  Beyond the reference test: pool pressure on both paths,
stalls ended by the watchdog on both paths, a chunk free of host syncs
with chaos, tracing and the SLO budget on, and the garbage drafter,
whose constant drafts change the acceptance only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve import chaos as tchaos  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.scheduler import SLO_CLASSES  # noqa: E402
from repro_torch.serve.scheduler import RequestStatus  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the reduced models'
    ops are tiny, so one thread runs them as fast, and test processes
    that share the cores do not spin against each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(arch):
    """(port cfg, port params, JAX cfg, JAX params): the reference's
    ``PRNGKey(0)`` weights through the weight bridge."""
    if arch not in _MODELS:
        jcfg = jax_reduced(jax_get_config(arch))
        jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (reduced(get_config(arch)), tp, jcfg, jp)
    return _MODELS[arch]


class Side:
    """One package's engine, request and chaos classes on the shared
    weights; ``engine(**kw)`` builds its ``Engine``."""

    def __init__(self, name, arch):
        cfg, tp, jcfg, jp = _models(arch)
        self.name = name
        if name == "torch":
            self.cfg, self.params = cfg, tp
            self.mod, self.chaos = tengine, tchaos
            self.extra = {"device": "cpu"}
        else:
            self.cfg, self.params = jcfg, jp
            self.mod, self.chaos = jengine, jchaos
            self.extra = {}
        self.Request = self.mod.Request

    def engine(self, **kw):
        return self.mod.Engine(self.cfg, self.params, **self.extra, **kw)


def _record(eng, reqs):
    return {"tokens": {r.rid: list(r.out_tokens) for r in reqs},
            "status": {r.rid: r.status for r in reqs},
            "preemptions": {r.rid: r.preemptions for r in reqs},
            "fault_stats": eng.fault_stats(),
            "preemption_log": eng.preemption_log,
            "admission_log": list(eng.scheduler.admission_log),
            "leaked": eng.leaked_pages()}


def _both(scenario, arch="internlm2-1.8b"):
    """Run ``scenario(side) -> (engine, requests)`` on both packages and
    hold the records equal; returns the port's engine, requests and
    record."""
    runs = {}
    for name in ("jax", "torch"):
        eng, reqs = scenario(Side(name, arch))
        runs[name] = (eng, reqs, _record(eng, reqs))
    for key, want in runs["jax"][2].items():
        assert runs["torch"][2][key] == want, key
    return runs["torch"]


def _prompts(n):
    return [[(3 * i + j) % 250 + 1 for j in range(2 + (5 * i) % 11)]
            for i in range(n)]


# ---------------------------------------------------------------------------
# deadline reaping + mid-stream cancellation
# ---------------------------------------------------------------------------

def test_deadline_reaped_mid_stream_and_slot_reused_same_boundary():
    def scenario(side):
        clk = {"t": 0.0}
        eng = side.engine(slots=1, max_len=64, prefix_sharing=False,
                          clock=lambda: clk["t"])
        doomed = side.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=40,
                              ttl=5.0)
        waiting = side.Request(rid=1, prompt=[4, 5, 6], max_new_tokens=12)
        assert eng.submit(doomed) is None
        assert eng.submit(waiting) is None
        assert doomed.deadline == 5.0          # resolved at submit
        eng.step()
        assert doomed.status == RequestStatus.RUNNING
        assert eng.scheduler.pool.in_use > 0
        clk["t"] = 10.0
        eng.step()
        assert doomed.status == RequestStatus.TIMED_OUT
        assert doomed.done and 0 < len(doomed.out_tokens) < 40
        assert eng._slot_req[0] is waiting
        eng.run(max_steps=1000)
        return eng, [doomed, waiting]

    eng, (doomed, waiting), _ = _both(scenario)
    assert waiting in eng.finished
    assert waiting.status == RequestStatus.FINISHED
    assert len(waiting.out_tokens) == 12
    assert eng.fault_stats()["timed_out"] == 1
    assert eng.scheduler.pool.in_use == 0
    assert eng.leaked_pages() == 0


def test_queued_request_times_out_without_ever_running():
    def scenario(side):
        eng = side.engine(slots=1, max_len=64, prefix_sharing=False,
                          clock=lambda: 1.0)
        live = side.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=6)
        dead = side.Request(rid=1, prompt=[4, 5, 6], max_new_tokens=6,
                            deadline=0.0)
        eng.submit(live)
        eng.submit(dead)
        done = eng.run(max_steps=1000)
        assert len(done) == 2
        return eng, [live, dead]

    eng, (live, dead), _ = _both(scenario)
    assert dead.status == RequestStatus.TIMED_OUT
    assert dead.out_tokens == []
    assert live.status == RequestStatus.FINISHED
    assert dead.rid not in [e[1] for e in eng.scheduler.admission_log]
    assert eng.leaked_pages() == 0


def test_cancel_mid_stream_frees_slot_same_boundary():
    def scenario(side):
        eng = side.engine(slots=1, max_len=64, prefix_sharing=False,
                          clock=lambda: 0.0)
        victim = side.Request(rid=0, prompt=[7, 8, 9], max_new_tokens=40)
        waiting = side.Request(rid=1, prompt=[4, 5, 6], max_new_tokens=12)
        eng.submit(victim)
        eng.submit(waiting)
        eng.step()
        assert victim.status == RequestStatus.RUNNING
        victim.cancel()
        eng.step()
        assert victim.status == RequestStatus.CANCELLED
        assert victim.done and 0 < len(victim.out_tokens) < 40
        assert eng._slot_req[0] is waiting
        eng.run(max_steps=1000)
        return eng, [victim, waiting]

    eng, (victim, waiting), _ = _both(scenario)
    assert waiting.status == RequestStatus.FINISHED
    assert eng.fault_stats()["cancelled"] == 1
    assert eng.scheduler.pool.in_use == 0
    assert eng.leaked_pages() == 0


# ---------------------------------------------------------------------------
# preemption / resume token parity at temperature 0
# ---------------------------------------------------------------------------

def _load(side, eng, prompts, max_new, **req_kw):
    reqs = [side.Request(rid=i, prompt=list(p), max_new_tokens=max_new,
                         **req_kw) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r) is None
    eng.run(max_steps=100_000)
    return reqs


@pytest.mark.parametrize("chunked", [True, False])
def test_pressure_preemption_token_parity_full_attention(chunked):
    """4 slots x 3-page worst case = 12 > 9 physical pages: the engine
    must preempt, and every resumed request's greedy output equals the
    uncontended run's (the JAX test's case on both paths)."""
    prompts = _prompts(6)
    calm = {}

    def scenario(side):
        kw = dict(slots=4, max_len=64, page_size=8, clock=lambda: 0.0,
                  chunked_prefill=chunked)
        reqs = _load(side, side.engine(**kw), prompts, 12)
        calm[side.name] = {r.rid: list(r.out_tokens) for r in reqs}
        eng = side.engine(num_pages=9, **kw)
        return eng, _load(side, eng, prompts, 12)

    eng, reqs, rec = _both(scenario)
    fs = eng.fault_stats()
    assert fs["pressure_preemptions"] >= 1
    assert any(r.preemptions > 0 for r in reqs)
    assert rec["tokens"] == calm["torch"] == calm["jax"]
    assert all(r.status == RequestStatus.FINISHED for r in reqs)
    assert eng.leaked_pages() == 0


def test_preempt_resume_token_parity_windowed_ring_wrap():
    """gemma2 sliding windows: preempt mid-generation, resume with the
    generated tokens replayed (no radix on windowed archs: a full
    re-prefill), decode past the window after the resume."""
    solo = {}

    def scenario(side):
        window = next(b.window for b in side.cfg.blocks if b.window)
        prompt, max_new = [3, 1, 4, 1, 5], window + 8
        ref = side.Request(rid=0, prompt=list(prompt),
                           max_new_tokens=max_new)
        alone = side.engine(slots=1, max_len=96, clock=lambda: 0.0)
        alone.submit(ref)
        alone.run(max_steps=1000)
        assert len(ref.out_tokens) == max_new
        solo[side.name] = list(ref.out_tokens)
        eng = side.engine(slots=1, max_len=96, clock=lambda: 0.0)
        req = side.Request(rid=0, prompt=list(prompt),
                           max_new_tokens=max_new)
        eng.submit(req)
        eng.step()
        eng.step()
        assert 0 < len(req.out_tokens) < max_new
        eng._preempt_slot(0, "pressure")
        assert req.status == RequestStatus.PREEMPTED
        assert req.preemptions == 1
        assert eng.queue and eng.queue[0] is req
        eng.run(max_steps=1000)
        return eng, [req]

    eng, (req,), _ = _both(scenario, arch="gemma2-2b")
    assert req.status == RequestStatus.FINISHED
    assert req.out_tokens == solo["torch"] == solo["jax"]
    assert eng.fault_stats()["resumes"] == 1
    assert eng.leaked_pages() == 0


def test_resume_recovers_prefill_from_radix_when_pool_has_slack():
    def scenario(side):
        eng = side.engine(slots=2, max_len=64, page_size=8,
                          clock=lambda: 0.0)
        req = side.Request(rid=0, prompt=[(5 * j) % 200 + 1
                                          for j in range(12)],
                           max_new_tokens=20)
        eng.submit(req)
        eng.step()
        assert len(req.out_tokens) > 0
        eng._preempt_slot(0, "watchdog")
        eng.run(max_steps=1000)
        return eng, [req]

    eng, (req,), _ = _both(scenario)
    assert req.status == RequestStatus.FINISHED
    fs = eng.fault_stats()
    assert fs["watchdog_preemptions"] == 1
    assert fs["resumes"] == 1
    assert fs["resume_recovered_tokens"] > 0
    assert fs["recovered_prefill_fraction"] > 0.5
    assert eng.leaked_pages() == 0


# ---------------------------------------------------------------------------
# admission control: typed rejection and shed policies
# ---------------------------------------------------------------------------

def test_queue_full_sheds_typed_rejection():
    def scenario(side):
        eng = side.engine(slots=1, max_len=64, prefix_sharing=False,
                          queue_limit=1, shed_policy="reject",
                          clock=lambda: 0.0)
        first = side.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4)
        shed = side.Request(rid=1, prompt=[4, 5, 6], max_new_tokens=4)
        assert eng.submit(first) is None
        rej = eng.submit(shed)
        assert rej is not None and rej.kind == "queue_full"
        assert rej.req is shed
        eng.run(max_steps=1000)
        return eng, [first, shed]

    eng, (first, shed), _ = _both(scenario)
    assert shed.status == RequestStatus.REJECTED
    assert shed in eng.rejected
    fs = eng.fault_stats()
    assert fs["rejected"] == 1 and fs["rejected_queue_full"] == 1
    assert first.status == RequestStatus.FINISHED


def test_block_shed_policy_applies_backpressure():
    def scenario(side):
        eng = side.engine(slots=1, max_len=64, prefix_sharing=False,
                          queue_limit=1, shed_policy="block",
                          clock=lambda: 0.0)
        first = side.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4)
        second = side.Request(rid=1, prompt=[4, 5, 6], max_new_tokens=4)
        assert eng.submit(first) is None
        assert eng.submit(second) is None     # blocked until admitted
        eng.run(max_steps=1000)
        return eng, [first, second]

    eng, (first, second), _ = _both(scenario)
    assert first in eng.finished and second in eng.finished
    assert second.status == RequestStatus.FINISHED
    assert eng.fault_counters["rejected"] == 0


# ---------------------------------------------------------------------------
# chaos: seeded fault schedules drain clean, token-equal to no faults
# ---------------------------------------------------------------------------

def _unfaulted(prompts, max_new, **kw):
    side = Side("torch", "internlm2-1.8b")
    reqs = _load(side, side.engine(clock=lambda: 0.0, **kw), prompts,
                 max_new)
    return {r.rid: list(r.out_tokens) for r in reqs}


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_smoke_drains_clean(seed):
    prompts = _prompts(6)
    kw = dict(slots=3, max_len=64, page_size=8, num_pages=12)

    def scenario(side):
        eng = side.engine(chaos=side.chaos.ChaosMonkey.smoke(seed),
                          clock=lambda: 0.0, **kw)
        return eng, _load(side, eng, prompts, 8, ttl=600.0)

    eng, reqs, rec = _both(scenario)
    assert all(r.status in RequestStatus.TERMINAL for r in reqs)
    assert all(r.status == RequestStatus.FINISHED and
               len(r.out_tokens) == 8 for r in reqs)
    assert eng.leaked_pages() == 0
    assert eng.decode_compiles == 1
    assert rec["tokens"] == _unfaulted(prompts, 8, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_slo_mix_preempts_interactive_last(seed):
    """Storm-heavy schedule (p_preempt 0.6) + mixed SLO classes under the
    slo policy: every forced preemption picks the lowest-class victim
    available, the storm drains clean, and the tokens equal the
    unfaulted run's."""
    prompts = _prompts(9)
    classes = ["interactive", "batch", "best_effort"]
    kw = dict(slots=3, max_len=64, page_size=8, num_pages=12,
              sync_interval=4, policy="slo")

    def scenario(side):
        eng = side.engine(
            chaos=side.chaos.ChaosMonkey(seed, p_preempt=0.6,
                                         p_deny_admission=0.1,
                                         p_sharing_fault=0.25),
            clock=lambda: 0.0, **kw)
        reqs = [side.Request(rid=i, prompt=list(p), max_new_tokens=16,
                             ttl=600.0, slo_class=classes[i % 3])
                for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.submit(r) is None
        eng.run(max_steps=100_000)
        return eng, reqs

    eng, reqs, rec = _both(scenario)
    assert all(r.status == RequestStatus.FINISHED and
               len(r.out_tokens) == 16 for r in reqs)
    assert eng.leaked_pages() == 0
    assert eng.decode_compiles == 1
    assert eng.preemption_log, "chaos storm produced no preemptions"
    inter_prio = SLO_CLASSES["interactive"].priority
    for ev in eng.preemption_log:
        victim_prio = SLO_CLASSES[ev["slo_class"]].priority
        others = [SLO_CLASSES[c].priority for c in ev["candidate_classes"]]
        assert all(victim_prio >= p for p in others), ev
        if victim_prio == inter_prio:
            assert all(p == inter_prio for p in others)
    assert rec["tokens"] == _unfaulted(prompts, 16, **kw)


@pytest.mark.parametrize("chunked", [True, False])
def test_chaos_stalls_end_in_watchdog_recovery(chunked):
    """Stalls only (p_stall 0.3, patience 2): a stalled slot reports
    nothing until the watchdog preempts it, and its resumed request
    regenerates the lost tokens; both paths, token-equal to the
    unfaulted run."""
    prompts = _prompts(6)
    kw = dict(slots=3, max_len=64, page_size=8, sync_interval=4,
              chunked_prefill=chunked)

    def scenario(side):
        eng = side.engine(chaos=side.chaos.ChaosMonkey(0, p_stall=0.3),
                          stall_patience=2, clock=lambda: 0.0, **kw)
        return eng, _load(side, eng, prompts, 16)

    eng, reqs, rec = _both(scenario)
    fs = eng.fault_stats()
    assert fs["watchdog_preemptions"] >= 1
    assert fs["chaos"]["stalled_drains"] >= 2
    assert all(r.status == RequestStatus.FINISHED for r in reqs)
    assert eng.leaked_pages() == 0
    assert rec["tokens"] == _unfaulted(prompts, 16, **kw)


@pytest.mark.parametrize("chunked", [True, False])
def test_chaos_and_slo_chunk_stays_sync_free(chunked):
    """The boundary work (reaping, chaos, admission, the SLO budget
    upload) happens outside the chunk, which performs no host sync with
    tracing and chaos on."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostSync(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            aten = torch.ops.aten
            name = func.overloadpacket
            if name in (aten._local_scalar_dense, aten.nonzero,
                        aten.masked_select):
                raise AssertionError(f"host sync: {func}")
            if name in (aten.index, aten.index_put, aten.index_put_):
                for ix in args[1]:
                    if ix is not None and ix.dtype == torch.bool:
                        raise AssertionError(f"boolean mask: {func}")
            return func(*args, **(kwargs or {}))

    side = Side("torch", "internlm2-1.8b")
    clk = {"t": 0.0}
    eng = side.engine(slots=3, max_len=64, sync_interval=4, policy="slo",
                      chunked_prefill=chunked, trace=True,
                      chaos=side.chaos.ChaosMonkey.smoke(0),
                      clock=lambda: clk["t"])
    for i, p in enumerate(_prompts(3)):
        eng.submit(side.Request(rid=i, prompt=list(p) * 3,
                                max_new_tokens=12, slo_class="batch"))
    eng.step()
    clk["t"] = 50.0
    eng.submit(side.Request(rid=9, prompt=[9, 9, 9], max_new_tokens=4,
                            slo_class="interactive"))
    clk["t"] = 52.0
    eng._reap()
    eng._admit()
    eng._update_prefill_budgets()
    with NoHostSync():
        toks = eng.step_chunk()
    eng._drain(toks)
    eng.run(max_steps=10_000)
    assert eng.leaked_pages() == 0
    if chunked:
        assert eng.budget_throttles >= 1


@pytest.mark.parametrize("chunked", [True, False])
def test_garbage_drafter_isolated_to_acceptance(chunked):
    """``ChaosMonkey(garbage_drafter=True)`` wraps the n-gram drafter in
    ``GarbageDrafter`` (constant drafts): the tokens equal the unwrapped
    engine's, only the acceptance collapses, and the spec counters equal
    the reference engine's."""
    prompts = [[5, 6, 7] * 4, [9, 8] * 5, [1, 2, 3, 4]]
    kw = dict(slots=2, max_len=64, sync_interval=4, spec="ngram",
              chunked_prefill=chunked)
    stats = {}

    def scenario(side):
        eng = side.engine(chaos=side.chaos.ChaosMonkey(
            0, garbage_drafter=True), clock=lambda: 0.0, **kw)
        assert type(eng.drafter).__name__ == "GarbageDrafter"
        assert eng.drafter.kind == "ngram"
        reqs = _load(side, eng, prompts, 12)
        stats[side.name] = eng.spec_stats()
        return eng, reqs

    eng, reqs, rec = _both(scenario)
    assert stats["torch"] == stats["jax"]
    assert rec["tokens"] == _unfaulted(prompts, 12, **kw)
    plain = Side("torch", "internlm2-1.8b").engine(clock=lambda: 0.0, **kw)
    _load(Side("torch", "internlm2-1.8b"), plain, prompts, 12)
    assert stats["torch"]["acceptance_rate"] \
        < plain.spec_stats()["acceptance_rate"]
    assert eng.leaked_pages() == 0
