"""PyTorch port: the latency telemetry of ``serve/engine.py``
(nearest-rank ``percentile``, ``request_ttft``/``request_tpot``,
``request_slo_met`` and ``compute_latency_stats``) against the JAX
reference's functions on the same hand-built requests, with
``tests/test_latency_stats.py``'s hand-computed oracles; then
``Engine.latency_stats()`` after a small run of both modes.  The
preemption and SLO-policy cases wait for ROADMAP A11."""

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
