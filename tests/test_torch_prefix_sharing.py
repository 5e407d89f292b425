"""PyTorch port: the refcounted copy-on-write pool and radix prefix
sharing of the port's engine against the JAX reference on the same
weights, for the cases of ``tests/test_prefix_sharing.py`` that the
other port tests do not hold (its full-page and partial-page hits are in
``tests/test_torch_reference_engine.py``): the radix index's match and
refcount-guarded eviction on the port's copy, a fully matched prompt
whose final shared page goes copy-on-write, eviction of a shared prefix
denied while a slot holds it and allowed after, re-admission of an
evicted prefix, aggressive nested sharing, the fall-back to a miss when
the match would pin the pages eviction needs, the ``max_len`` contract,
dead-tail writes past the table, and disabled sharing.  Tokens and
``prefix_stats`` equal the reference engine's in every case, with the
dense ``ReferenceEngine`` as the token oracle where the reference test
uses it."""

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
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402
from repro_torch.serve.scheduler import PagePool, RadixIndex  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the reduced models'
    ops are tiny, so one thread runs them as fast, and test processes
    that share the cores do not spin against each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PREFIX = [(3 * j) % 200 + 1 for j in range(16)]   # 2 full pages at P=8


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config("internlm2-1.8b"))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return reduced(get_config("internlm2-1.8b")), tp, jcfg, jp


def _pair(models, **kw):
    """(port engine, JAX engine) with the same arguments and weights."""
    cfg, tp, jcfg, jp = models
    return (Engine(cfg, tp, device="cpu", **kw),
            jengine.Engine(jcfg, jp, **kw))


def _load(eng, reqs):
    req_cls = Request if isinstance(eng, (Engine, ReferenceEngine)) \
        else jengine.Request
    for rid, prompt, mn in reqs:
        eng.submit(req_cls(rid=rid, prompt=list(prompt), max_new_tokens=mn))
    return {r.rid: list(r.out_tokens) for r in eng.run()}


def _waves(models, waves, **kw):
    """Run request waves (each drains before the next submits) on both
    engines; tokens and prefix statistics must be equal.  Returns the
    port's engine and tokens."""
    eng, jeng = _pair(models, **kw)
    got, want = {}, {}
    for wave in waves:
        got.update(_load(eng, wave))
        want.update(_load(jeng, wave))
    assert got == want
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.leaked_pages() == jeng.leaked_pages() == 0
    return eng, got


def _dense(models, waves, slots):
    cfg, tp, _jcfg, _jp = models
    ref = ReferenceEngine(cfg, tp, slots=slots, max_len=64, device="cpu")
    want = {}
    for wave in waves:
        want.update(_load(ref, wave))
    return want


# ---------------------------------------------------------------------------
# Radix index unit behaviour (the port's copy)
# ---------------------------------------------------------------------------

def test_radix_match_insert_and_partial():
    pool = PagePool(8)
    idx = RadixIndex(page_size=4)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    pages = pool.alloc(3)
    idx.insert(prompt, np.asarray(pages), pool)
    assert idx.node_count == 2
    assert pool.refcount(pages[0]) == 2
    assert pool.refcount(pages[2]) == 1
    assert idx.match([1, 2, 3, 4, 5, 6, 7, 8, 11]) == [
        (0, pages[0], 4), (1, pages[1], 4)]
    assert idx.match([1, 2, 3, 4, 5, 6, 99, 99]) == [
        (0, pages[0], 4), (1, pages[1], 2)]
    assert idx.match([9, 9, 9, 9, 1]) == []


def test_radix_eviction_denied_until_refcount_drops():
    pool = PagePool(4)
    idx = RadixIndex(page_size=4)
    pages = pool.alloc(2)
    idx.insert([1, 2, 3, 4, 5, 6, 7, 8], np.asarray(pages), pool)
    pool.free(pages)
    pool.retain(pages[1])
    assert idx.evict_one(pool) is None
    assert idx.node_count == 2
    pool.release(pages[1])
    assert idx.evict_one(pool) == pages[1]
    assert idx.evict_one(pool) == pages[0]
    assert idx.evict_one(pool) is None
    assert pool.free_pages == 4 and idx.node_count == 0


# ---------------------------------------------------------------------------
# End-to-end: token parity with the reference engine throughout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [True, False])
def test_write_into_shared_final_page_goes_cow(models, chunked):
    waves = [[(0, PREFIX, 8)], [(1, PREFIX, 8), (2, PREFIX, 8)]]
    eng, got = _waves(models, waves, slots=3, max_len=64,
                      chunked_prefill=chunked)
    assert got == _dense(models, waves, slots=3)
    ps = eng.prefix_stats()
    assert ps["prefix_hits"] == 2
    assert ps["cow_copies"] == 2
    assert ps["prefill_tokens_skipped"] == 2 * 15


def test_eviction_of_shared_prefix_denied_then_allowed_end_to_end(models):
    """Preemption off: while rid 0 still holds the tree-indexed prefix
    pages, rid 1 (needing the whole pool) waits; once rid 0 releases,
    LRU eviction frees the prefix and rid 1 admits."""
    eng, jeng = _pair(models, slots=2, max_len=64, num_pages=8,
                      preemption=False)
    for e in (eng, jeng):
        R = Request if e is eng else jengine.Request
        e.submit(R(rid=0, prompt=list(PREFIX + [5]), max_new_tokens=24))
        e.submit(R(rid=1, prompt=[99] * 40, max_new_tokens=24))
        e.step()
        assert [r.rid for r in e.queue] == [1]
        assert e.prefix_stats()["radix_evictions"] == 0
    done = {r.rid: r for r in eng.run(max_steps=10_000)}
    jdone = {r.rid: r for r in jeng.run(max_steps=10_000)}
    assert len(done[0].out_tokens) == 24 and len(done[1].out_tokens) == 24
    assert {k: r.out_tokens for k, r in done.items()} == \
        {k: r.out_tokens for k, r in jdone.items()}
    ps = eng.prefix_stats()
    assert ps == jeng.prefix_stats()
    assert ps["radix_evictions"] >= 2
    assert ps["radix_pages"] == 5
    assert eng.fault_stats()["preemptions"] == 0


def test_eviction_under_pressure_with_preemption(models):
    """The same traffic with preemption on (the default): rid 1 cannot
    fit beside rid 0, so the engine preempts rid 0, evicts the prefix,
    runs rid 1, and resumes rid 0 — every counter and token equal to the
    reference's, and rid 0's tokens equal to its solo run."""
    eng, jeng = _pair(models, slots=2, max_len=64, num_pages=8)
    for e in (eng, jeng):
        R = Request if e is eng else jengine.Request
        e.submit(R(rid=0, prompt=list(PREFIX + [5]), max_new_tokens=24))
        e.submit(R(rid=1, prompt=[99] * 40, max_new_tokens=24))
    done = {r.rid: list(r.out_tokens) for r in eng.run(max_steps=10_000)}
    jdone = {r.rid: list(r.out_tokens) for r in jeng.run(max_steps=10_000)}
    assert done == jdone
    assert eng.fault_stats() == jeng.fault_stats()
    assert eng.preemption_log == jeng.preemption_log
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.fault_stats()["pressure_preemptions"] >= 1
    assert eng.leaked_pages() == 0
    solo, _ = _pair(models, slots=2, max_len=64)
    assert _load(solo, [(0, PREFIX + [5], 24)])[0] == done[0]


def test_readmission_of_evicted_prefix_rebuilds_index(models):
    eng, jeng = _pair(models, slots=2, max_len=64, num_pages=8)
    for e in (eng, jeng):
        _load(e, [(0, PREFIX + [5], 4)])
        _load(e, [(1, [99] * 40, 24)])
    hits_before = eng.prefix_stats()["prefix_hits"]
    for e in (eng, jeng):
        _load(e, [(2, PREFIX + [5], 4)])
    assert eng.prefix_stats()["prefix_hits"] == hits_before
    for e in (eng, jeng):
        _load(e, [(3, PREFIX + [6], 4)])
    assert eng.prefix_stats()["prefix_hits"] == hits_before + 1
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.leaked_pages() == 0


def test_reference_parity_under_aggressive_sharing(models):
    reqs = []
    for i in range(9):
        cut = [16, 12, 8][i % 3]
        tail = [(11 * i + j) % 150 + 1 for j in range(1 + i % 3)]
        reqs.append((i, PREFIX[:cut] + tail, 4 + i % 3))
    waves = [reqs[:1], reqs[1:]]
    eng, got = _waves(models, waves, slots=3, max_len=64)
    assert got == _dense(models, waves, slots=3)
    ps = eng.prefix_stats()
    assert ps["prefix_hit_rate"] > 0.5
    assert ps["prefill_tokens_skipped"] > 40
    cfg, tp, _jcfg, _jp = models
    excl = Engine(cfg, tp, slots=3, max_len=64, prefix_sharing=False,
                  device="cpu")
    _load(excl, reqs[:1])
    _load(excl, reqs[1:])
    assert (eng.scheduler.peak_pages_in_use
            < excl.scheduler.peak_pages_in_use)


def test_prefix_hit_falls_back_to_miss_when_match_pins_eviction(models):
    prompt = [(3 * j) % 200 + 1 for j in range(24)]
    eng, got = _waves(models, [[(0, prompt, 4)], [(1, prompt, 4)]],
                      slots=1, max_len=32)
    assert got[1] == got[0]
    ps = eng.prefix_stats()
    assert ps["radix_evictions"] >= 2
    assert ps["prefix_hits"] == 0


def test_generation_budget_cannot_wrap_shared_pages(models):
    cfg, tp, _jcfg, _jp = models
    eng = Engine(cfg, tp, slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid=0, prompt=[(3 * j) % 200 + 1
                                          for j in range(24)],
                           max_new_tokens=12))
    assert not eng.queue


def test_dead_tail_decode_cannot_wrap_into_shared_pages(models):
    long_req = (0, PREFIX + [3, 4], 30)
    full_req = (1, PREFIX + [(11 * j) % 150 + 1 for j in range(33)], 15)
    eng, got = _waves(models, [[long_req, full_req]], slots=2, max_len=64)
    assert len(got[1]) == 15
    solo, _ = _pair(models, slots=2, max_len=64)
    assert got[0] == _load(solo, [long_req])[0], \
        "shared prefix corrupted by dead-tail write"


def test_disabled_sharing_is_fully_exclusive(models):
    eng, _ = _waves(models, [[(0, PREFIX, 4), (1, PREFIX, 4)]], slots=2,
                    max_len=64, prefix_sharing=False)
    ps = eng.prefix_stats()
    assert not ps["prefix_sharing"] and ps["prefix_hits"] == 0
    assert eng.suffix_prefill_compiles == 0
