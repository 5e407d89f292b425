"""PyTorch port: the latency telemetry of ``serve/engine.py``
(nearest-rank ``percentile``, ``request_ttft``/``request_tpot``,
``request_slo_met`` and ``compute_latency_stats``) against the JAX
reference's functions on the same hand-built requests, with
``tests/test_latency_stats.py``'s hand-computed oracles; then
``Engine.latency_stats()`` after a small run of both modes.  Then the
preemption and SLO-policy cases on the reference's weights: TTFT from the
original submit across a preemption, the SLO admission order, the
engine's interactive-first admission and prefill-budget throttle, and
``shed-lowest-class``, each equal to the JAX engine's; and the
reference's SLO-throttle fault, which the port does not copy (a throttled
fused slot completes at ``rem <= n``, not ``rem <= S``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import engine as jeng  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro.serve.scheduler import RequestStatus as JStatus  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import model_defs  # noqa: E402
from repro_torch.models.module import init_params  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.scheduler import SLO_CLASSES  # noqa: E402
from repro_torch.serve.scheduler import Request, RequestStatus  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the reduced models'
    ops are tiny, so one thread runs them as fast, and test processes
    that share the cores do not spin against each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDES = [(teng, Request, RequestStatus), (jeng, JRequest, JStatus)]


def _req(side, cls="interactive", status="FINISHED", submit=0.0,
         first=None, times=(), rid=0, ttft_target=None, tpot_target=None):
    _mod, req_cls, status_cls = side
    r = req_cls(rid=rid, prompt=[1, 2, 3], max_new_tokens=8,
                slo_class=cls, ttft_target=ttft_target,
                tpot_target=tpot_target)
    r.status = getattr(status_cls, status)
    r.submit_time = submit
    r.first_token_time = first
    r.token_times = list(times)
    return r


@pytest.mark.parametrize("values,q,want", [
    ([], 50, None), ([], 99, None),
    ([7.0], 1, 7.0), ([7.0], 50, 7.0), ([7.0], 99, 7.0),
    ([float(v) for v in range(1, 11)], 50, 5.0),
    ([float(v) for v in range(1, 11)], 90, 9.0),
    ([float(v) for v in range(1, 11)], 99, 10.0),
    ([float(v) for v in range(1, 11)], 100, 10.0),
    ([4.0, 1.0, 3.0, 2.0], 50, 2.0),
    ([1.0, 2.0, 3.0, 4.0], 25, 1.0),
    ([1.0, 2.0, 3.0, 4.0], 26, 2.0),
])
def test_percentile_nearest_rank_oracle(values, q, want):
    assert teng.percentile(values, q) == want
    assert jeng.percentile(values, q) == want


@pytest.mark.parametrize("side", SIDES, ids=["torch", "jax"])
def test_request_ttft_and_tpot_oracle(side):
    mod = side[0]
    r = _req(side, submit=2.0, first=5.0, times=[5.0, 6.0, 8.0])
    assert mod.request_ttft(r) == 3.0
    assert mod.request_tpot(r) == pytest.approx((8.0 - 5.0) / 2)
    assert mod.request_ttft(_req(side, first=None)) is None
    assert mod.request_tpot(_req(side, times=[4.0])) is None
    assert mod.request_ttft(_req(side, submit=None, first=4.0)) is None


@pytest.mark.parametrize("side", SIDES, ids=["torch", "jax"])
def test_slo_met_target_resolution(side):
    mod = side[0]
    ok = _req(side, submit=0.0, first=0.5, times=[0.5, 0.55, 0.6])
    assert ok.resolved_ttft_target == SLO_CLASSES["interactive"].ttft_target
    assert mod.request_slo_met(ok)
    tight = _req(side, submit=0.0, first=0.5, times=[0.5, 0.55, 0.6],
                 ttft_target=0.1)
    assert not mod.request_slo_met(tight)
    assert mod.request_slo_met(_req(side, cls="best_effort", first=None))
    assert not mod.request_slo_met(_req(side, cls="interactive",
                                        first=None))
    dead = _req(side, status="TIMED_OUT", first=0.1, times=[0.1, 0.15])
    assert not mod.request_slo_met(dead)


def _cases(side):
    """The hand-built request lists of ``tests/test_latency_stats.py``."""
    return {
        "empty": [],
        "queued": [_req(side, status="QUEUED", first=None)],
        "single": [_req(side, submit=1.0, first=1.25,
                        times=[1.25, 1.31, 1.35])],
        "slow": [_req(side, submit=1.0, first=1.25,
                      times=[1.25, 1.5, 1.75])],
        "mixed": [_req(side, cls="batch", status="TIMED_OUT", submit=0.0,
                       first=1.0 + i, times=[1.0 + i, 2.0 + i], rid=i)
                  for i in range(3)]
        + [_req(side, cls="interactive", submit=0.0, first=0.2,
                times=[0.2, 0.25, 0.3], rid=10)],
    }


@pytest.mark.parametrize("case", ["empty", "queued", "single", "slow",
                                  "mixed"])
def test_stats_equal_reference_and_oracle(case):
    got = teng.compute_latency_stats(_cases(SIDES[0])[case])
    want = jeng.compute_latency_stats(_cases(SIDES[1])[case])
    assert got == want
    if case == "empty":
        assert got["classes"] == {} and got["goodput"] == 0.0
        assert got["overall"]["ttft_p50"] is None
    elif case == "queued":
        c = got["classes"]["interactive"]
        assert c["count"] == 1 and c["terminal"] == 0 and c["finished"] == 0
        assert c["goodput"] == 0.0
        assert c["ttft_p50"] is None and c["tpot_p99"] is None
    elif case == "single":
        c = got["classes"]["interactive"]
        assert c["ttft_p50"] == c["ttft_p99"] == 0.25
        assert c["tpot_p50"] == pytest.approx(0.05)
        assert c["goodput"] == 1.0 and got["goodput"] == 1.0
    elif case == "slow":
        assert got["goodput"] == 0.0
    else:
        assert got["classes"]["batch"]["goodput"] == 0.0
        assert got["classes"]["batch"]["ttft_p99"] == 3.0
        assert got["classes"]["interactive"]["goodput"] == 1.0
        assert got["goodput"] == 0.25


@pytest.mark.parametrize("chunked", [True, False])
def test_engine_latency_stats_after_a_run(chunked):
    """Every drained request is stamped: TTFT and TPOT percentiles exist
    and are ordered, goodput covers the finished requests, and the FIFO
    policy reports no throttles."""
    cfg = reduced(get_config("internlm2-1.8b"))
    params = init_params(model_defs(cfg), 0, device="cpu")
    eng = teng.Engine(cfg, params, slots=2, max_len=64, sync_interval=4,
                      chunked_prefill=chunked, device="cpu")
    for i in range(4):
        eng.submit(Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=6,
                           slo_class="batch" if i % 2 else "interactive"))
    done = eng.run()
    assert len(done) == 4
    for r in done:
        assert r.submit_time <= r.first_token_time == r.token_times[0]
        assert len(r.token_times) == 6
    ls = eng.latency_stats()
    assert ls["budget_throttles"] == 0
    assert sorted(ls["classes"]) == ["batch", "interactive"]
    for c in list(ls["classes"].values()) + [ls["overall"]]:
        assert c["finished"] == c["terminal"] == c["count"]
        assert 0.0 < c["ttft_p50"] <= c["ttft_p99"]
        assert 0.0 <= c["tpot_p50"] <= c["tpot_p99"]
    assert ls["overall"]["count"] == 4
    assert ls == {**teng.compute_latency_stats(done), "budget_throttles": 0}


# ---------------------------------------------------------------------------
# preemption and the SLO policy (the engine on the reference's weights)
# ---------------------------------------------------------------------------

_BRIDGED = {}


def _bridged():
    """(port cfg, port params, JAX cfg, JAX params): the reference's
    ``PRNGKey(0)`` weights through the weight bridge."""
    if not _BRIDGED:
        import jax
        import jax.numpy as jnp
        import numpy as np
        from repro.configs import get_config as jax_get_config
        from repro.configs import reduced as jax_reduced
        from repro.models import model_defs as jax_model_defs
        from repro.models import module as jm
        from repro_torch.models.module import params_from_numpy

        jcfg = jax_reduced(jax_get_config("internlm2-1.8b"))
        jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        _BRIDGED["m"] = (reduced(get_config("internlm2-1.8b")),
                         params_from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"), jcfg, jp)
    return _BRIDGED["m"]


def _engine(side, **kw):
    cfg, tp, jcfg, jp = _bridged()
    if side[0] is teng:
        return teng.Engine(cfg, tp, device="cpu", **kw)
    return jeng.Engine(jcfg, jp, **kw)


@pytest.mark.parametrize("side", SIDES, ids=["torch", "jax"])
def test_ttft_measured_from_original_submit_across_preemption(side):
    mod, _req_cls, status_cls = side
    r = _req(side, submit=10.0, first=None, times=[])
    r.preemptions = 1
    r.status = status_cls.PREEMPTED
    assert mod.request_ttft(r) is None
    r.status = status_cls.FINISHED
    r.first_token_time = 50.0
    r.token_times = [50.0, 51.0]
    assert mod.request_ttft(r) == 40.0
    stats = mod.compute_latency_stats([r])
    assert stats["classes"]["interactive"]["ttft_p50"] == 40.0


def test_ttft_across_a_real_preemption_equals_reference():
    """On the engine: a request preempted before its first token keeps
    its original submit stamp, so its TTFT covers the wait; the port's
    stamps equal the reference's on the same clock."""
    got = {}
    for side in SIDES:
        clk = {"t": 0.0}
        eng = _engine(side, slots=1, max_len=64, page_size=8,
                      sync_interval=4, clock=lambda: clk["t"])
        r = side[1](rid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=12)
        eng.submit(r)
        clk["t"] = 1.0
        eng._admit()
        eng._preempt_slot(0, "pressure")          # before any token
        clk["t"] = 5.0
        eng.run(max_steps=1000)
        assert r.preemptions == 1 and len(r.out_tokens) == 12
        assert side[0].request_ttft(r) == 5.0
        got[side[0].__name__] = (list(r.out_tokens), r.first_token_time,
                                 eng.latency_stats())
    assert got[teng.__name__] == got[jeng.__name__]


def test_slo_orders_by_priority_then_slack_then_arrival():
    from repro.serve import cache as jcache
    from repro.serve import scheduler as jsched
    from repro_torch.serve import cache as tcache
    from repro_torch.serve import scheduler as tsched

    cfg, _tp, jcfg, _jp = _bridged()
    orders = []
    for sched_mod, cache_mod, c in ((tsched, tcache, cfg),
                                    (jsched, jcache, jcfg)):
        spec = cache_mod.CacheSpec.from_config(c, slots=4, max_len=64,
                                               page_size=8)
        s = sched_mod.Scheduler(spec, prefix_sharing=False, policy="slo")
        R = sched_mod.Request
        for r in (R(rid=0, prompt=[1, 2], max_new_tokens=4,
                    slo_class="batch", submit_time=0.0),
                  R(rid=1, prompt=[1, 2], max_new_tokens=4,
                    slo_class="interactive", submit_time=5.0),
                  R(rid=2, prompt=[1, 2], max_new_tokens=4,
                    slo_class="interactive", submit_time=1.0),
                  R(rid=3, prompt=[1, 2], max_new_tokens=4,
                    slo_class="best_effort", submit_time=0.0)):
            s.submit(r)
        orders.append([r.rid for r in s.admission_order(now=6.0)])
        weird = R(rid=4, prompt=[1], max_new_tokens=2,
                  slo_class="no-such-class")
        assert weird.priority == SLO_CLASSES["best_effort"].priority
        assert weird.ttft_slack(100.0) == float("inf")
        with pytest.raises(ValueError):
            sched_mod.Scheduler(spec, policy="priority")
    assert orders == [[2, 1, 0, 3]] * 2


def test_engine_slo_policy_admits_interactive_first_and_throttles():
    """A late interactive arrival jumps the queue under policy='slo', and
    while its TTFT slack is negative the non-interactive slots' prefill
    budgets drop to a quarter chunk (``pbudget`` on the device,
    ``budget_throttles``); tokens, admission order and throttle count
    equal the reference engine's (3-token prompts: no throttled slot is
    mid-prompt, so the two completion rules agree)."""
    got = {}
    for side in SIDES:
        mod, R, _status = side
        clk = {"t": 0.0}
        eng = _engine(side, slots=2, max_len=64, page_size=8,
                      sync_interval=4, policy="slo", prefix_sharing=False,
                      clock=lambda: clk["t"], chunked_prefill=True)
        for i in range(4):
            eng.submit(R(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=24,
                         slo_class="batch"))
        eng.step()
        assert all(r is not None for r in eng._slot_req)
        clk["t"] = 50.0
        urgent = R(rid=10, prompt=[9, 9, 9], max_new_tokens=4,
                   slo_class="interactive")
        eng.submit(urgent)
        clk["t"] = 52.0
        assert urgent.ttft_slack(clk["t"]) < 0.0
        eng.step()
        assert eng.budget_throttles >= 1
        S = eng.executor.chunk_rows
        vec = [int(v) for v in np.asarray(eng.state["pbudget"])]
        assert any(v == max(1, S // 4) for v in vec), vec
        done = eng.run(max_steps=10_000)
        assert {r.rid for r in done} == {0, 1, 2, 3, 10}
        vec = [int(v) for v in np.asarray(eng.state["pbudget"])]
        assert vec == [S] * eng.spec.slots
        admits = [rid for _, rid, _, _, _ in eng.scheduler.admission_log]
        assert admits.index(10) < admits.index(2)
        assert admits.index(10) < admits.index(3)
        assert eng.leaked_pages() == 0
        ls = eng.latency_stats()
        assert set(ls["classes"]) == {"batch", "interactive"}
        assert ls["classes"]["interactive"]["finished"] == 1
        assert ls["budget_throttles"] == eng.budget_throttles
        got[mod.__name__] = ({r.rid: list(r.out_tokens) for r in done},
                             list(eng.scheduler.admission_log), ls)
    assert got[teng.__name__] == got[jeng.__name__]


def test_shed_lowest_class_evicts_queued_lower_priority():
    got = {}
    for side in SIDES:
        mod, R, status = side
        eng = _engine(side, slots=1, max_len=64, page_size=8,
                      prefix_sharing=False, queue_limit=2,
                      shed_policy="shed-lowest-class", clock=lambda: 0.0)
        eng.submit(R(rid=0, prompt=[1, 2, 3], max_new_tokens=30))
        eng.step()
        assert eng.submit(R(rid=1, prompt=[1, 2], max_new_tokens=4,
                            slo_class="batch")) is None
        assert eng.submit(R(rid=2, prompt=[1, 2], max_new_tokens=4,
                            slo_class="best_effort")) is None
        assert eng.submit(R(rid=3, prompt=[1, 2], max_new_tokens=4,
                            slo_class="interactive")) is None
        assert [r.rid for r in eng.queue] == [1, 3]
        shed = [r for r in eng.rejected if r.rid == 2]
        assert len(shed) == 1 and shed[0].status == status.REJECTED
        assert eng.fault_counters["rejected_shed_lower_class"] == 1
        rej = eng.submit(R(rid=4, prompt=[1, 2], max_new_tokens=4,
                           slo_class="best_effort"))
        assert rej is not None and rej.kind == "queue_full"
        done = eng.run(max_steps=10_000)
        assert {r.rid for r in done} == {0, 1, 3}
        assert eng.leaked_pages() == 0
        got[mod.__name__] = ({r.rid: list(r.out_tokens) for r in done},
                             eng.fault_stats())
    assert got[teng.__name__] == got[jeng.__name__]


# ---------------------------------------------------------------------------
# the reference's SLO-throttle fault, which the port does not copy
# ---------------------------------------------------------------------------

def _throttle_probe(side, policy, plen):
    """Two ``plen``-token batch prompts on a fake clock, one step, then an
    interactive request that has blown its TTFT target: under 'slo' the
    batch slots are throttled to ``max(1, S // 4)`` rows per micro-step.
    Returns (tokens by rid, budget_throttles)."""
    mod, R, _status = side
    clk = {"t": 0.0}
    eng = _engine(side, slots=2, max_len=256, page_size=8,
                  sync_interval=4, prefix_sharing=False,
                  chunked_prefill=True, policy=policy,
                  clock=lambda: clk["t"])
    rng = np.random.default_rng(0)
    for i in range(2):
        eng.submit(R(rid=i, prompt=rng.integers(1, 100, plen).tolist(),
                     max_new_tokens=8, slo_class="batch"))
    eng.step()
    clk["t"] = 50.0
    eng.submit(R(rid=2, prompt=[9, 9, 9], max_new_tokens=8,
                 slo_class="interactive"))
    clk["t"] = 52.0
    done = eng.run(max_steps=10_000)
    return {r.rid: list(r.out_tokens) for r in done}, eng.budget_throttles


def test_reference_slo_throttle_fault_is_not_copied():
    """200-token prompts: after one step a batch slot has rem = 72 prompt
    tokens, and throttled to n = 8 rows it passes through 8 < rem <= 32.
    The reference marks it completing there (``rem <= S``) and commits
    samples of mid-prompt rows as tokens; the port completes at
    ``rem <= n`` and its 'slo' tokens equal both packages' 'fifo'
    tokens."""
    torch_side, jax_side = SIDES
    fifo_t, thr_fifo = _throttle_probe(torch_side, "fifo", 200)
    fifo_j, _ = _throttle_probe(jax_side, "fifo", 200)
    slo_t, thr_t = _throttle_probe(torch_side, "slo", 200)
    slo_j, thr_j = _throttle_probe(jax_side, "slo", 200)
    assert thr_fifo == 0 and thr_t == thr_j >= 1
    assert fifo_t == fifo_j
    assert slo_t == fifo_t                       # the port: correct
    assert slo_j[0] != fifo_j[0] and slo_j[1] != fifo_j[1]
    # the reference's batch outputs: spurious tokens, then the true
    # sequence cut at max_new_tokens
    for rid in (0, 1):
        k = next(i for i in range(1, 8)
                 if slo_j[rid][i:] == fifo_j[rid][:8 - i])
        assert k >= 1, (slo_j[rid], fifo_j[rid])
    assert slo_t[2] == slo_j[2]                  # the interactive one


def test_slo_throttle_without_mid_prompt_slots_equals_reference():
    """40-token prompts finish prefilling in the first step, so no
    throttled slot is ever mid-prompt: the two completion rules agree and
    the port's 'slo' tokens equal the reference's."""
    torch_side, jax_side = SIDES
    slo_t, thr_t = _throttle_probe(torch_side, "slo", 40)
    slo_j, thr_j = _throttle_probe(jax_side, "slo", 40)
    assert thr_t == thr_j >= 1
    assert slo_t == slo_j
