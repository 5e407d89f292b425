"""PyTorch port: the serving launcher (``repro_torch.launch.serve``)
against the JAX launcher (``repro.launch.serve``) on the same weights.

* The JAX launcher's ``main()`` (through ``sys.argv``) and the port's
  ``run(build_engine(args, params=bridged), args)`` print identical
  ``req i:`` lines for the default flags, ``--chunked-prefill off``
  (with and without ``--warmup``) and ``--spec-draft ngram --spec-k 4``,
  and the port's shape counters equal the JAX engine's compile counts
  (prefill, suffix, decode, admission) on that traffic.
* Each robustness / SLO / tracing flag (``--chaos``, ``--queue-limit``,
  ``--shed-policy``, ``--ttl``, ``--policy slo``, ``--traffic``,
  ``--trace``) runs to the end and prints the JAX launcher's summary
  lines for it, and its ``req i:`` lines.
* ``--no-smoke`` selects the unreduced config (no weights built here);
  the default serves the reduced one.
* ``--slo-class`` prints the per-class TTFT/TPOT lines.
"""

import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jax_launch  # noqa: E402
import repro.serve.engine as jax_engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
import repro_torch.serve.engine as engine_mod  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the reduced models'
    ops are tiny, so one thread runs them as fast, and test processes
    that share the cores do not spin against each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "internlm2-1.8b"
FLAG_SETS = {
    "defaults": [],
    "two_executables": ["--chunked-prefill", "off"],
    "two_executables_warm": ["--chunked-prefill", "off", "--warmup"],
    "ngram_k4": ["--spec-draft", "ngram", "--spec-k", "4"],
}
_PARAMS = {}


def _bridged():
    """The JAX launcher's weights (``PRNGKey(0)`` on the reduced config)
    through the weight bridge."""
    if not _PARAMS:
        jcfg = jax_reduced(jax_get_config(ARCH))
        jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        _PARAMS["p"] = params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    return _PARAMS["p"]


def _req_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("req ")]


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_launcher_matches_jax_launcher(name, monkeypatch, capsys):
    flags = FLAG_SETS[name]
    engines = []

    class Recording(jax_engine_mod.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(jax_engine_mod, "Engine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jax_launch.main()
    want = capsys.readouterr().out
    (jeng,) = engines

    args = serve.parse_args(flags + ["--device", "cpu"])
    eng = serve.build_engine(args, params=_bridged())
    serve.run(eng, args)
    got = capsys.readouterr().out

    assert len(_req_lines(want)) == 6
    assert _req_lines(got) == _req_lines(want)
    assert (eng.prefill_compiles, eng.suffix_prefill_compiles,
            eng.decode_compiles, eng.admit_compiles) == (
        jeng.prefill_compiles, jeng.suffix_prefill_compiles,
        jeng.decode_compiles, jeng.admit_compiles)
    m = re.search(r"(\d+) prefill shapes / (\d+) suffix shapes / (\d+) "
                  r"decode shapes / (\d+) admit shapes", got)
    assert m and [int(g) for g in m.groups()] == [
        eng.prefill_compiles, eng.suffix_prefill_compiles,
        eng.decode_compiles, eng.admit_compiles]
    for prefix in ("paged KV:", "prefix sharing:"):
        assert any(ln.startswith(prefix) for ln in got.splitlines())
    spec_line = any(ln.startswith("speculative [ngram, k=4]")
                    for ln in got.splitlines())
    assert spec_line == (name == "ngram_k4")
    assert ("warmup:" in got) == ("--warmup" in flags)


A11_FLAGS = {
    "chaos": (["--chaos", "1"], ("faults:", "chaos[seed=1]:",
                                 "chaos: clean drain")),
    "queue_limit": (["--queue-limit", "4"], ("faults:",)),
    "shed_policy": (["--queue-limit", "2", "--shed-policy", "block"],
                    ("faults:",)),
    "ttl": (["--ttl", "600"], ("faults:",)),
    "policy": (["--policy", "slo"], ("slo overall:",)),
    "traffic": (["--traffic", "poisson:1"], ("traffic[poisson:1]:",
                                             "slo[", "slo overall:",
                                             "faults:")),
    "trace": (["--trace", "TRACE"], ("trace:",)),
}


def _lines(text, prefix):
    return [ln.split(" -> ")[0] if prefix == "trace:" else ln
            for ln in text.splitlines() if ln.startswith(prefix)]


@pytest.mark.parametrize("name", list(A11_FLAGS))
def test_a11_flags_match_jax_launcher(name, monkeypatch, capsys, tmp_path):
    """Each robustness / SLO / tracing flag runs to the end on the CPU
    and prints the reference launcher's summary line for it, on the same
    weights: the ``req i:`` lines and the flag's lines equal (the
    ``--policy slo`` line up to its measured latencies)."""
    from repro_torch.benchmarks.check_trace import validate

    flags, prefixes = A11_FLAGS[name]
    path = tmp_path / "trace.json"
    flags = [str(path) if f == "TRACE" else f for f in flags]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jax_launch.main()
    want = capsys.readouterr().out
    want_trace = json.loads(path.read_text()) if name == "trace" else None

    args = serve.parse_args(flags + ["--device", "cpu"])
    serve.run(serve.build_engine(args, params=_bridged()), args)
    got = capsys.readouterr().out

    assert _req_lines(got) == _req_lines(want) and _req_lines(got)
    for prefix in prefixes:
        assert _lines(got, prefix) == _lines(want, prefix), prefix
        assert _lines(got, prefix), prefix
    assert any(ln.startswith("faults:") for ln in got.splitlines())
    if name == "trace":
        obj = json.loads(path.read_text())
        assert validate(obj) == [] and validate(want_trace) == []
        assert len(obj["traceEvents"]) == len(want_trace["traceEvents"])


def test_no_smoke_selects_the_unreduced_config(monkeypatch):
    seen = []

    def fake_engine(cfg, params, **kw):
        seen.append((cfg, params, kw["device"]))
        return "engine"

    monkeypatch.setattr(engine_mod, "Engine", fake_engine)
    for flags, want in ((["--no-smoke"], get_config(ARCH)),
                        ([], reduced(get_config(ARCH)))):
        args = serve.parse_args(flags + ["--device", "cpu"])
        assert serve.build_engine(args, params="weights") == "engine"
        cfg, params, device = seen.pop()
        assert cfg == want and params == "weights" and device == "cpu"
    assert serve.parse_args([]).smoke is True
    assert serve.parse_args([]).device is None


def test_slo_class_prints_latency_lines(capsys):
    args = serve.parse_args(["--slo-class", "interactive", "--requests",
                             "3", "--max-new", "4", "--device", "cpu"])
    serve.run(serve.build_engine(args, params=_bridged()), args)
    out = capsys.readouterr().out
    (cls,) = [ln for ln in out.splitlines() if ln.startswith("slo[")]
    m = re.match(r"slo\[interactive\]: n=3 goodput=\S+ "
                 r"ttft_p50/p99=(\S+)/(\S+)s tpot_p50/p99=(\S+)/(\S+)s", cls)
    assert m, cls
    vals = [float(v) for v in m.groups()]
    assert all(np.isfinite(vals)) and vals[0] <= vals[1]
    assert "slo overall: goodput=" in out and "policy=fifo" in out
