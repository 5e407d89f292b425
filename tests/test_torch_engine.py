"""PyTorch port: the model's multi-row paged forward and the fused
chunked-prefill engine against the JAX reference on the same weights.

Weights are built once by ``repro.models.module.init_params`` and carried
over with ``params_from_numpy``.  Teacher-forced ``forward_verify`` logits
must agree at atol 1e-4 on the same cache state; the fused engine's
greedy tokens must be identical to the JAX ``Engine``'s for prefill
budgets 3/8/13 (more requests than slots) and across a shared-prefix
radix hit with copy-on-write.  A fresh interpreter importing every module
of the port must load no JAX and nothing of ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import forward_decode as jax_forward_decode  # noqa: E402
from repro.models import forward_verify as jax_forward_verify  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import forward_decode, forward_verify  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402


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
REPO = Path(__file__).resolve().parents[1]
PROMPTS = [[(7 * j + i) % 200 + 1 for j in range(3 + 9 * i)]
           for i in range(5)]            # lengths 3, 12, 21, 30, 39
ENGINE_KW = dict(slots=3, max_len=96, sync_interval=4, seed=0)
_jax_verify = jax.jit(jax_forward_verify,
                      static_argnames=("cfg", "paged_kernel", "spec_slack"))
_jax_decode = jax.jit(jax_forward_decode,
                      static_argnames=("cfg", "paged_kernel"))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config(ARCH))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return reduced(get_config(ARCH)), tp, jcfg, jp


def _serve(eng, prompts, max_new, rid0=0):
    for i, p in enumerate(prompts):
        eng.submit((Request if isinstance(eng, Engine) else JRequest)(
            rid=rid0 + i, prompt=list(p), max_new_tokens=max_new))
    done = eng.run(max_steps=50_000)
    return {r.rid: list(r.out_tokens) for r in done if r.rid >= rid0}


@pytest.fixture(scope="module")
def jax_run(models):
    _cfg, _tp, jcfg, jp = models
    eng = JEngine(jcfg, jp, prefill_budget=8, **ENGINE_KW)
    assert eng.chunked_prefill and not eng.paged_kernel
    return _serve(eng, PROMPTS, 10), eng


# ---------------------------------------------------------------------------
# forward_verify / forward_decode on the same cache state
# ---------------------------------------------------------------------------

def _both_caches(cfg, jcfg):
    t = tcache.CacheSpec.from_config(cfg, 3, 64, page_size=8)
    j = jcache.CacheSpec.from_config(jcfg, 3, 64, page_size=8)
    tc, jc = t.init_paged_cache(torch.device("cpu")), j.init_paged_cache()
    key = t.groups[0].key
    rows = np.full((3, t.groups[0].ring_blocks), t.trash_page, np.int32)
    rows[0, :4] = [3, 7, 1, 12]
    rows[1, :3] = [0, 5, 9]           # slot 2 stays unadmitted (all trash)
    tc["page_tables"][key].copy_(torch.as_tensor(rows))
    jc["page_tables"] = {key: jnp.asarray(rows)}
    return tc, jc


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_forward_verify_and_decode_teacher_forced(models, paged_kernel):
    cfg, tp, jcfg, jp = models
    tc, jc = _both_caches(cfg, jcfg)
    rs = np.random.RandomState(0)
    S = 8
    col = np.arange(S)[None, :]
    for n_rows in ([8, 5, 1], [8, 8, 1], [3, 8, 1]):
        n = np.array(n_rows, np.int32)
        wm = (col >= (S - n)[:, None]) & np.array([1, 1, 0], bool)[:, None]
        toks = rs.randint(1, cfg.vocab_size, size=(3, S)).astype(np.int32)
        jl, jc = _jax_verify(jp, jcfg, jnp.asarray(toks), jc,
                             write_mask=jnp.asarray(wm),
                             paged_kernel=paged_kernel,
                             n_rows=jnp.asarray(n))
        tl, tc = forward_verify(tp, cfg, torch.as_tensor(toks), tc,
                                write_mask=torch.as_tensor(wm),
                                paged_kernel=paged_kernel,
                                n_rows=torch.as_tensor(n))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=0, atol=1e-4)
        jc = dict(jc, len=jc["len"] + jnp.asarray(n * [1, 1, 0]))
        tc = dict(tc, len=tc["len"] + torch.as_tensor(n * [1, 1, 0]))
    trash = tc["layers"][0]["pk"].shape[0] - 1
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        np.testing.assert_allclose(tl_["pk"].numpy()[:trash],
                                   np.asarray(jl_["pk"])[:trash],
                                   rtol=0, atol=1e-5)
    tok = rs.randint(1, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    active = np.array([True, True, False])
    jl, _ = _jax_decode(jp, jcfg, jnp.asarray(tok), jc,
                        write_mask=jnp.asarray(active),
                        paged_kernel=paged_kernel)
    tl, tnew = forward_decode(tp, cfg, torch.as_tensor(tok), tc,
                              write_mask=torch.as_tensor(active),
                              paged_kernel=paged_kernel)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=0,
                               atol=1e-4)
    assert tnew["len"].tolist() == (tc["len"] + 1).tolist()


# ---------------------------------------------------------------------------
# the fused engine: greedy token parity with the JAX Engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [3, 8, 13])
def test_fused_engine_token_parity(models, jax_run, budget):
    """Budgets below a page (3 < P=8), page-aligned (8) and straddling a
    page boundary (13); 5 requests through 3 slots."""
    cfg, tp, _jcfg, _jp = models
    want, jeng = jax_run
    eng = Engine(cfg, tp, prefill_budget=budget, device="cpu", **ENGINE_KW)
    assert not eng.paged_kernel            # "auto" on a CPU device
    assert _serve(eng, PROMPTS, 10) == want
    assert eng.leaked_pages() == 0
    if budget == 8:
        assert eng.memory_stats() == jeng.memory_stats()
        assert eng.prefix_stats() == jeng.prefix_stats()


def test_fused_engine_pool_direct_parity(models, jax_run):
    """paged_kernel=True: attention reads the pools through the op (its
    plain version on the CPU) — same tokens."""
    cfg, tp, _jcfg, _jp = models
    eng = Engine(cfg, tp, prefill_budget=13, paged_kernel=True,
                 device="cpu", **ENGINE_KW)
    eng.warmup()
    assert _serve(eng, PROMPTS, 10) == jax_run[0]


def test_fused_engine_prefix_hit_with_cow_parity(models):
    """A prompt enters the radix index when its prefill completes; a later
    request sharing 21 tokens (two full pages + 5 of the third) hits and
    copies the partially matched page before writing into it."""
    cfg, tp, jcfg, jp = models
    head = [(3 * j) % 200 + 1 for j in range(21)]
    waves = [[head + [30, 31, 32], head + [40, 41, 42]], [head + [77]]]
    kw = dict(slots=2, max_len=96, prefill_budget=8, sync_interval=4, seed=0)
    got, want = {}, {}
    eng = Engine(cfg, tp, device="cpu", **kw)
    jeng = JEngine(jcfg, jp, **kw)
    for w, prompts in enumerate(waves):
        got.update(_serve(eng, prompts, 6, rid0=10 * w))
        want.update(_serve(jeng, prompts, 6, rid0=10 * w))
    assert got == want
    ps = eng.prefix_stats()
    assert ps == jeng.prefix_stats()
    assert ps["prefix_hits"] == 1 and ps["cow_copies"] == 1
    assert ps["prefill_tokens_skipped"] == 21
    assert eng.leaked_pages() == 0


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def test_engine_without_device_needs_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    cfg, tp, _jcfg, _jp = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, tp)


@pytest.mark.parametrize("kw,item", [
    ({"rules": sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"}),
      "spec": "ngram"}, "A20")])
def test_unported_arguments_raise(models, kw, item):
    """What the port's engine does not take yet: speculation under
    ``rules=`` (the rules are ported: tests/test_torch_multidevice_serve.py;
    an MoE arch under them raises A19 there)."""
    cfg, tp, _jcfg, _jp = models
    with pytest.raises(NotImplementedError, match=item):
        Engine(cfg, tp, device="cpu", **kw)


def _a11_run(eng, req_cls, what):
    """One small workload through ``eng`` for the argument ``what``;
    returns the observations the argument changes."""
    classes = ["batch", "best_effort", "interactive"]
    reqs = [req_cls(rid=i, prompt=list(p), max_new_tokens=6,
                    slo_class=classes[i % 3])
            for i, p in enumerate(PROMPTS)]
    results = [eng.submit(r) for r in reqs]
    eng.run(max_steps=50_000)
    out = {"tokens": {r.rid: list(r.out_tokens) for r in reqs},
           "status": {r.rid: r.status for r in reqs},
           "rejected": [r is not None for r in results],
           "fault_stats": eng.fault_stats(),
           "admission_log": list(eng.scheduler.admission_log),
           "leaked": eng.leaked_pages()}
    if what == "trace":
        out["fingerprint"] = eng.tracer.fingerprint()
    return out


@pytest.mark.parametrize("what,kw", [
    ("chaos", {"num_pages": 24}),
    ("trace", {"trace": True}),
    ("policy", {"policy": "slo"}),
    ("queue_limit", {"queue_limit": 2}),
    ("shed_policy", {"queue_limit": 2, "shed_policy": "block"}),
])
def test_a11_arguments_match_reference(models, what, kw):
    """Each robustness / SLO / tracing argument runs on the CPU and has
    the reference engine's effect on the same traffic: equal tokens,
    statuses, rejections, fault counters (chaos: the storm's), the
    admission order and, traced, the event stream."""
    from repro.serve.chaos import ChaosMonkey as JChaos
    from repro_torch.serve.chaos import ChaosMonkey

    cfg, tp, jcfg, jp = models
    runs = {}
    for side in ("torch", "jax"):
        extra = dict(kw)
        if what == "chaos":
            extra["chaos"] = (ChaosMonkey if side == "torch" else JChaos)(
                1, p_preempt=0.6, p_stall=0.2)
        if side == "torch":
            eng = Engine(cfg, tp, device="cpu", clock=lambda: 0.0,
                         **ENGINE_KW, **extra)
            runs[side] = _a11_run(eng, Request, what)
        else:
            eng = JEngine(jcfg, jp, clock=lambda: 0.0, **ENGINE_KW, **extra)
            runs[side] = _a11_run(eng, JRequest, what)
    got = runs["torch"]
    assert got == runs["jax"]
    assert got["leaked"] == 0
    fs = got["fault_stats"]
    if what == "chaos":
        assert fs["chaos_preemptions"] >= 1
        assert fs["chaos"]["stalls_started"] >= 1
        assert all(len(t) == 6 for t in got["tokens"].values())
    elif what == "trace":
        assert "preempt" not in got["fingerprint"]
        assert got["fingerprint"].count("|finish|") == len(PROMPTS)
    elif what == "policy":
        # rid 2 (interactive) jumps the queued batch / best_effort rids
        order = [rid for _, rid, _, _, _ in got["admission_log"]]
        assert order.index(2) < order.index(1)
    elif what == "queue_limit":
        # submitted before any step: two queue, three are shed
        assert got["rejected"] == [False, False, True, True, True]
        assert fs["rejected_queue_full"] == 3
    else:
        assert fs["rejected"] == 0 and not any(got["rejected"])
        assert all(s == "FINISHED" for s in got["status"].values())


def test_submit_contracts(models):
    from repro.serve.engine import Engine as JEng
    cfg, tp, jcfg, jp = models
    eng = Engine(cfg, tp, slots=1, max_len=32, device="cpu",
                 clock=lambda: 7.0)
    req = Request(rid=0, prompt=[1, 2], max_new_tokens=2, ttl=1.0)
    assert eng.submit(req) is None
    jreq = JRequest(rid=0, prompt=[1, 2], max_new_tokens=2, ttl=1.0)
    JEng(jcfg, jp, slots=1, max_len=32, clock=lambda: 7.0).submit(jreq)
    # a ttl resolves to an absolute deadline at submit, on the engine's
    # clock, as the reference resolves it
    assert req.deadline == jreq.deadline == 8.0
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(Request(rid=1, prompt=[], max_new_tokens=4))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid=2, prompt=list(range(1, 31)),
                           max_new_tokens=8))


_IMPORT_CHECK = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # and no source file names them, even in a branch never taken
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path, name)
