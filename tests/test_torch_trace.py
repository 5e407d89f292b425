"""PyTorch port: lifecycle tracing, the metric registry and their
exporters (``serve/trace.py``, ``serve/metrics.py``, ``Engine.observe``,
``export_trace``, ``explain``) against the JAX reference, case for case
with ``tests/test_trace.py``.

* Tracing is invisible: traced and untraced port runs give the same
  tokens and shape counters on internlm2 and gemma2, equal to the JAX
  engine's tokens, and the port's event stream is the reference's
  (``Tracer.fingerprint`` equal on the same clock).
* A traced chunk stays free of host synchronization (a dispatch mode
  raising on the ops that synchronize on the card).
* The ring, the Chrome-trace export and ``explain`` equal the
  reference's on the same events; seeded ``TrafficGenerator`` replays on
  a ``VirtualClock`` give identical fingerprints run to run, and equal
  to the reference's.
* ``observe()`` emits only registered names, the same ones as the
  reference's engine.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import trace as jtrace  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.benchmarks.check_trace import validate  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import metrics  # noqa: E402
from repro_torch.serve import trace as ttrace  # noqa: E402
from repro_torch.serve import traffic as ttraffic  # noqa: E402


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
    if arch not in _MODELS:
        jcfg = jax_reduced(jax_get_config(arch))
        jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (reduced(get_config(arch)), tp, jcfg, jp)
    return _MODELS[arch]


def _engine(side, arch="internlm2-1.8b", **kw):
    cfg, tp, jcfg, jp = _models(arch)
    if side == "torch":
        return tengine.Engine(cfg, tp, device="cpu", **kw)
    return jengine.Engine(jcfg, jp, **kw)


def _workload(eng, n=6):
    req_cls = (tengine.Request if isinstance(eng, tengine.Engine)
               else jengine.Request)
    for i in range(n):
        plen = 2 + (3 * i) % 7
        eng.submit(req_cls(rid=i, prompt=[(i + j) % 150 + 1
                                          for j in range(plen)],
                           max_new_tokens=4 + i % 3))
    return eng.run(max_steps=50_000)


def _counters(eng):
    return (eng.prefill_compiles, eng.suffix_prefill_compiles,
            eng.decode_compiles, eng.admit_compiles)


def _port_names(obj):
    """A Chrome-trace object with the package names put back to the
    reference's, so the two exports compare whole."""
    text = json.dumps(obj).replace("repro_torch.serve", "repro.serve")
    return json.loads(text)


class _NoHostSync(TorchDispatchMode):
    """The CPU stand-in for ``torch.cuda.set_sync_debug_mode("error")``:
    raises on the ops that synchronize with the host on a CUDA tensor
    (a scalar read, boolean-mask indexing, a 0-d value written into a
    tensor)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        name = func.overloadpacket
        if name in (aten._local_scalar_dense, aten.nonzero,
                    aten.masked_select):
            raise AssertionError(f"host sync: {func}")
        if name in (aten.index, aten.index_put, aten.index_put_):
            for ix in args[1]:
                if ix is not None and ix.dtype == torch.bool:
                    raise AssertionError(f"boolean-mask indexing: {func}")
            if name is not aten.index and args[2].dim() == 0:
                raise AssertionError(f"0-d value written: {func}")
        if name is aten.copy_ and args[1].dim() == 0 and args[0].dim() == 0:
            raise AssertionError(f"0-d copy: {func}")
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# Tracing on vs off: token parity, shape parity, sync freedom
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-2b"])
def test_tracing_is_invisible_to_outputs_and_compiles(arch):
    runs, fps = {}, {}
    for side, traced in (("torch", False), ("torch", True),
                         ("jax", True)):
        eng = _engine(side, arch, slots=2, max_len=64,
                      prefix_sharing=False, trace=traced,
                      clock=lambda: 0.0)
        done = _workload(eng)
        runs[side, traced] = ({r.rid: list(r.out_tokens) for r in done},
                              _counters(eng))
        if traced:
            evs = eng.tracer.events()
            assert {e.kind for e in evs} >= {"submit", "admit", "chunk",
                                             "finish"}
            assert eng.tracer.dropped == 0
            fps[side] = eng.tracer.fingerprint()
    assert runs["torch", False] == runs["torch", True]
    assert runs["torch", True][0] == runs["jax", True][0]
    assert fps["torch"] == fps["jax"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-2b"])
def test_traced_decode_chunk_stays_sync_free(arch):
    eng = _engine("torch", arch, slots=2, max_len=64,
                  prefix_sharing=False, trace=True)
    eng.submit(tengine.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=32))
    eng.submit(tengine.Request(rid=1, prompt=[4, 5], max_new_tokens=32))
    eng._admit()
    with _NoHostSync():
        toks = eng.step_chunk()
        toks2 = eng.step_chunk()
    eng._drain(torch.cat([toks, toks2]))
    assert eng.host_syncs == 1 and eng.steps == 2 * eng.sync_interval
    assert eng.decode_compiles == 1
    assert len(eng.tracer.events()) > 0


def test_token_chunks_parallel_to_token_times():
    logs = {}
    for side in ("torch", "jax"):
        eng = _engine(side, slots=2, max_len=64, sync_interval=4,
                      prefix_sharing=False, clock=lambda: 0.0)
        done = _workload(eng, n=4)
        for r in done:
            assert len(r.token_chunks) == len(r.token_times) \
                == len(r.out_tokens)
            assert r.token_chunks == sorted(r.token_chunks)
        assert len({c for r in done for c in r.token_chunks}) > 1
        for entry in eng.scheduler.admission_log:
            assert len(entry) == 5 and entry[4] >= 0
        logs[side] = (list(eng.scheduler.admission_log),
                      {r.rid: list(r.token_chunks) for r in done})
    assert logs["torch"] == logs["jax"]


# ---------------------------------------------------------------------------
# Ring buffer: bounded, oldest-first eviction, terminal retention
# ---------------------------------------------------------------------------

def test_ring_evicts_oldest_but_never_terminal_events():
    fps = []
    for mod in (ttrace, jtrace):
        tr = mod.Tracer(capacity=8)
        for i in range(6):
            tr.record("chunk", float(i), chunk=i)
        tr.record("finish", 6.0, rid=0, status="FINISHED")
        tr.record("reject", 7.0, rid=1, why="queue_full")
        assert len(tr) == 8 and tr.dropped == 0
        for i in range(20):
            tr.record("prefill", 8.0 + i, rid=2, slot=0)
        assert len(tr) == tr.capacity
        assert tr.dropped == 20
        kinds = [e.kind for e in tr.events()]
        assert kinds.count("finish") == 1 and kinds.count("reject") == 1
        seqs = [e.seq for e in tr.events()]
        assert seqs == sorted(seqs)
        fps.append(tr.fingerprint())
    assert fps[0] == fps[1]


def test_ring_terminal_events_may_exceed_capacity():
    tr = ttrace.Tracer(capacity=4)
    for i in range(10):
        tr.record("finish", float(i), rid=i, status="FINISHED")
    assert len(tr) == 10 and tr.dropped == 0
    assert all(e.kind in ttrace.TERMINAL_KINDS for e in tr.events())
    assert ttrace.TERMINAL_KINDS == jtrace.TERMINAL_KINDS
    assert ttrace.EVENT_KINDS == jtrace.EVENT_KINDS
    with pytest.raises(ValueError):
        ttrace.Tracer(capacity=0)


def test_engine_trace_capacity_and_eviction_end_to_end():
    got = {}
    for side in ("torch", "jax"):
        eng = _engine(side, slots=2, max_len=64, sync_interval=2,
                      prefix_sharing=False, trace=8, clock=lambda: 0.0)
        done = _workload(eng, n=6)
        assert len(done) == 6
        assert eng.tracer.dropped > 0
        terms = [e for e in eng.tracer.events()
                 if e.kind in ttrace.TERMINAL_KINDS]
        assert sorted(e.rid for e in terms) == list(range(6))
        got[side] = (eng.tracer.dropped, eng.tracer.fingerprint())
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# Deterministic fingerprints under VirtualClock replay
# ---------------------------------------------------------------------------

def _replay_fingerprint(side, seed):
    mod = ttraffic if side == "torch" else jtraffic
    trace = mod.TrafficGenerator(seed, rate=3.0,
                                 process="bursty").generate(8)
    clk = mod.VirtualClock(dt=0.05)
    eng = _engine(side, slots=2, max_len=64, page_size=8, num_pages=10,
                  sync_interval=4, policy="slo", prefix_sharing=False,
                  clock=clk, trace=True)
    mod.replay(eng, trace, clock=clk)
    assert eng.leaked_pages() == 0
    return eng.tracer.fingerprint()


def test_replayed_traffic_yields_identical_fingerprints():
    fp1, fp2 = _replay_fingerprint("torch", 5), _replay_fingerprint("torch",
                                                                     5)
    assert fp1 == fp2
    assert fp1 != _replay_fingerprint("torch", 6)
    assert fp1 == _replay_fingerprint("jax", 5)


# ---------------------------------------------------------------------------
# observe() registry discipline + exporters
# ---------------------------------------------------------------------------

def test_observe_emits_only_registered_names():
    obs = {}
    for side in ("torch", "jax"):
        eng = _engine(side, slots=2, max_len=64, trace=True,
                      clock=lambda: 0.0)
        _workload(eng, n=3)
        obs[side] = eng.observe()
    got = obs["torch"]
    assert got, "observe() returned nothing"
    for name, value in got.items():
        assert metrics.kind_of(name) is not None, name
        assert isinstance(value, (int, float, bool)), (name, value)
    for name in ("engine.chunks", "engine.host_syncs",
                 "pool.pages_in_use", "pool.peak_pages_in_use",
                 "sched.admissions", "sched.preemptions.total",
                 "latency.goodput", "trace.events", "trace.dropped"):
        assert name in got, name
    assert set(got) == set(obs["jax"])
    assert {k: v for k, v in got.items() if not k.startswith("pool.")} \
        == {k: v for k, v in obs["jax"].items() if not k.startswith("pool.")}
    with pytest.raises(KeyError):
        metrics._put({}, "engine.not_a_metric", 1)


def test_export_trace_and_explain_complete_chains(tmp_path):
    exports = {}
    for side in ("jax", "torch"):
        eng = _engine(side, slots=2, max_len=64, trace=True,
                      clock=lambda: 0.0)
        done = _workload(eng, n=4)
        exports[side] = (eng.export_trace(),
                         [eng.explain(r.rid) for r in done])
    # the port's engine and requests from here on
    path = tmp_path / "trace.json"
    obj = eng.export_trace(str(path))
    assert json.loads(path.read_text()) == obj
    assert validate(obj) == []
    evs = obj["traceEvents"]
    for r in done:
        inst = [e for e in evs if e["ph"] == "i"
                and e.get("args", {}).get("rid") == r.rid]
        assert any(e["name"] == "submit" for e in inst), r.rid
        assert any(e["name"] == "finish" for e in inst), r.rid
        flows = [e for e in evs if e["ph"] in ("s", "t", "f")
                 and e.get("id") == str(r.rid)]
        assert [e["ph"] for e in flows][:1] == ["s"]
        assert [e["ph"] for e in flows][-1:] == ["f"]
        txt = eng.explain(r.rid)
        assert "submit" in txt and "terminal: FINISHED" in txt
        assert "queued:" in txt and "running:" in txt
    assert eng.explain(9999) == "rid 9999: no trace events recorded"
    assert _port_names(exports["torch"][0]) == exports["jax"][0]
    assert exports["torch"][1] == exports["jax"][1]
    bare = _engine("torch", slots=1, max_len=64)
    with pytest.raises(ValueError):
        bare.export_trace()
    with pytest.raises(ValueError):
        bare.explain(0)


def test_chrome_trace_preempt_flow_spans_slot_hop():
    objs = []
    for mod in (ttrace, jtrace):
        tr = mod.Tracer()
        tr.record("submit", 0.0, rid=7)
        tr.record("admit", 1.0, rid=7, slot=0, chunk=1)
        tr.record("preempt", 2.0, rid=7, slot=0, why="pressure")
        tr.record("admit", 3.0, rid=7, slot=1, chunk=3, resume=True)
        tr.record("finish", 4.0, rid=7, slot=1, status="FINISHED")
        objs.append(mod.to_chrome_trace(tr.events()))
    obj = objs[0]
    evs = obj["traceEvents"]
    flows = [e for e in evs if e["ph"] in ("s", "t", "f")]
    assert [e["ph"] for e in flows] == ["s", "t", "t", "t", "f"]
    assert flows[-1]["bp"] == "e"
    assert len({e["tid"] for e in flows}) == 3
    waits = [e for e in evs if e["ph"] == "b"]
    assert [w["args"]["phase"] for w in waits] == ["queued", "requeued"]
    runs = [e for e in evs if e["ph"] == "X"]
    assert len(runs) == 2 and all(e["dur"] > 0 for e in runs)
    assert _port_names(obj) == objs[1]
    assert ttrace.explain(ttrace.Tracer().events(), 7) == jtrace.explain(
        jtrace.Tracer().events(), 7)
