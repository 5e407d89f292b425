"""PyTorch port: the traffic harness (``serve/traffic.py``: seeded
arrival processes, ``VirtualClock``, ``replay``) against the JAX
reference, case for case with ``tests/test_traffic.py``: same seed,
byte-identical traces (and identical to the reference generator's for
seeds 0-2 of both processes), the trace's shape and validation, the
Poisson rate, the clock, and replays through the port's ``Engine`` with
identical counters run to run and equal to the reference engine's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.traffic import (ClassProfile,  # noqa: E402
                                       TrafficGenerator, VirtualClock,
                                       replay, trace_fingerprint)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the reduced models'
    ops are tiny, so one thread runs them as fast, and test processes
    that share the cores do not spin against each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_same_seed_identical_trace():
    for proc in ("poisson", "bursty"):
        a = TrafficGenerator(42, rate=2.0, process=proc).generate(200)
        b = TrafficGenerator(42, rate=2.0, process=proc).generate(200)
        assert trace_fingerprint(a) == trace_fingerprint(b)
        c = TrafficGenerator(42, rate=2.0, process=proc)
        assert trace_fingerprint(c.generate(200)) \
            == trace_fingerprint(c.generate(200))
        d = TrafficGenerator(43, rate=2.0, process=proc).generate(200)
        assert trace_fingerprint(a) != trace_fingerprint(d)


@pytest.mark.parametrize("process", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint_equals_reference_generator(seed, process):
    """The port draws the reference's numpy stream: one seed, one trace,
    in both packages."""
    got = TrafficGenerator(seed, rate=8.0, process=process).generate(64)
    want = jtraffic.TrafficGenerator(seed, rate=8.0,
                                     process=process).generate(64)
    assert trace_fingerprint(got) == jtraffic.trace_fingerprint(want)


def test_trace_shape_and_validation():
    gen = TrafficGenerator(
        7, rate=1.0,
        class_mix={"interactive": 0.5, "batch": 0.5},
        profiles={"interactive": ClassProfile(prompt_len=(3, 5),
                                              max_new=(2, 4),
                                              ttft_target=0.25)})
    trace = gen.generate(100)
    assert [t.rid for t in trace] == list(range(100))
    assert all(trace[i].arrival < trace[i + 1].arrival
               for i in range(99))
    for t in trace:
        assert t.slo_class in ("interactive", "batch")
        if t.slo_class == "interactive":
            assert 3 <= len(t.prompt) <= 5
            assert 2 <= t.max_new_tokens <= 4
            assert t.ttft_target == 0.25
        req = t.to_request()
        assert req.rid == t.rid and list(req.prompt) == list(t.prompt)
        assert req.slo_class == t.slo_class
    with pytest.raises(ValueError):
        TrafficGenerator(0, process="uniform")
    with pytest.raises(ValueError):
        TrafficGenerator(0, rate=0.0)
    with pytest.raises(ValueError):
        TrafficGenerator(0, class_mix={"gold": 1.0})


def test_poisson_empirical_rate_within_tolerance():
    rate = 4.0
    n = 4000
    trace = TrafficGenerator(3, rate=rate, process="poisson").generate(n)
    measured = n / trace[-1].arrival
    assert measured == pytest.approx(rate, rel=5.0 / n ** 0.5)
    flat = TrafficGenerator(3, rate=rate, process="bursty",
                            burst_ratio=1.0).generate(n)
    assert n / flat[-1].arrival == pytest.approx(rate, rel=5.0 / n ** 0.5)
    bursty = TrafficGenerator(3, rate=rate, process="bursty",
                              burst_ratio=8.0, p_burst=0.2).generate(n)
    assert n / bursty[-1].arrival > measured


def test_virtual_clock_ticks():
    clk = VirtualClock(dt=0.25, start=1.0)
    assert clk() == 1.0
    clk.tick()
    clk.tick()
    assert clk() == 1.5


def test_replay_identical_counters_across_runs():
    """Two virtual-clock replays of one trace through the port give
    identical submit results, ``fault_stats``, ``latency_stats``, tokens
    and leaks, and so does the reference engine on the same weights."""
    jcfg = jax_reduced(jax_get_config("internlm2-1.8b"))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = reduced(get_config("internlm2-1.8b"))
    trace = TrafficGenerator(5, rate=3.0, process="bursty").generate(10)
    jtrace = jtraffic.TrafficGenerator(5, rate=3.0,
                                       process="bursty").generate(10)
    kw = dict(slots=2, max_len=64, page_size=8, num_pages=10,
              sync_interval=4, policy="slo", prefix_sharing=False)

    def once(side):
        if side == "torch":
            clk = VirtualClock(dt=0.05)
            eng = Engine(cfg, tp, clock=clk, device="cpu", **kw)
            results = replay(eng, trace, clock=clk)
        else:
            clk = jtraffic.VirtualClock(dt=0.05)
            eng = jengine.Engine(jcfg, jp, clock=clk, **kw)
            results = jtraffic.replay(eng, jtrace, clock=clk)
        fs = eng.fault_stats()
        fs.pop("chaos", None)
        return (results, fs, eng.latency_stats(),
                {r.rid: list(r.out_tokens) for r in eng.finished},
                eng.leaked_pages())

    r1, fs1, ls1, toks1, leak1 = once("torch")
    r2, fs2, ls2, toks2, leak2 = once("torch")
    assert r1 == r2
    assert fs1 == fs2
    assert ls1 == ls2
    assert toks1 == toks2
    assert leak1 == leak2 == 0
    assert set(toks1) == {t.rid for t in trace}
    assert (r1, fs1, ls1, toks1) == once("jax")[:4]
