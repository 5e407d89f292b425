"""PyTorch port: speculative decoding (``serve/spec``, the speculative half
of ``serve/sampling``, the dense draft decode cache) against the JAX
reference on the same inputs and weights.

* ``ngram_propose`` on seeded histories, its fallbacks included: drafts
  equal to JAX's.
* ``spec_probs`` within 1e-6; ``spec_accept`` exact at temperature 0 and,
  at temperature > 0, its first emitted token held by distribution
  (torch's Philox is not threefry); ``spec_update`` exact, history and
  counters included.
* Dense ``decode_attention`` and ``forward_decode`` over the dense cache
  within 1e-5; ``ModelDrafter.propose``'s greedy drafts equal.
* ``Engine(spec=...)``: greedy tokens and ``spec_stats`` equal to the JAX
  spec engine's for the n-gram drafter (k 1 and 4, fused and two
  executables) and the model drafter (self and a disagreeing draft), a
  window-16 ring that wraps, pool-direct reads against the gather path,
  prefix sharing against exclusive pages, drafting disabled until a
  prefill completes, EOS and budget clamps, a sampled run, a sync-free
  chunk, an inert warmup, and the capability gate's message.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import forward_decode as jax_forward_decode  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve import sampling as jsampling  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.spec import ModelDrafter as JModelDrafter  # noqa: E402
from repro.serve.spec import SpecConfig as JSpecConfig  # noqa: E402
from repro.serve.spec import check_spec_capable  # noqa: E402
from repro.serve.spec import ngram_propose as jax_ngram  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import forward_decode, model_defs  # noqa: E402
from repro_torch.models.module import (init_params,  # noqa: E402
                                       params_from_numpy)
from repro_torch.serve import sampling  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.spec import (ModelDrafter, SpecConfig,  # noqa: E402
                                    ngram_propose)

ARCH = "internlm2-1.8b"
DRAFT = dict(layers=1, d_model=32, heads=2, d_ff=64)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pair(arch, **kw):
    jcfg = jax_reduced(jax_get_config(arch), **kw)
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return reduced(get_config(arch), **kw), tp, jcfg, jp


@pytest.fixture(scope="module")
def models():
    return _pair(ARCH)


@pytest.fixture(scope="module")
def draft():
    return _pair(ARCH, **DRAFT)


def _ragged_reqs(vocab, n=5, max_new=9):
    out = []
    for i in range(n):
        plen = 2 + (4 * i) % 7
        out.append(([(5 * i + j) % vocab for j in range(plen)],
                    max_new - i % 3))
    return out


def _serve(eng, reqs, eos=None):
    R = Request if isinstance(eng, Engine) else JRequest
    for i, (prompt, mx) in enumerate(reqs):
        eng.submit(R(rid=i, prompt=list(prompt), max_new_tokens=mx,
                     eos_id=eos))
    done = eng.run(max_steps=100_000)
    assert len(done) == len(reqs)
    return {r.rid: list(r.out_tokens) for r in done}


def _both(models, jspec, tspec, reqs, **kw):
    cfg, tp, jcfg, jp = models
    jeng = JEngine(jcfg, jp, spec=jspec, **kw)
    teng = Engine(cfg, tp, spec=tspec, device="cpu", **kw)
    return _serve(jeng, reqs), jeng, _serve(teng, reqs), teng


# ---------------------------------------------------------------------------
# the n-gram drafter
# ---------------------------------------------------------------------------

def _hist(rows, cap):
    h = np.zeros((len(rows), cap + 1), np.int32)
    for i, r in enumerate(rows):
        h[i, :len(r)] = r
    return h, np.array([len(r) for r in rows], np.int32)


def test_ngram_propose_reference_cases():
    """The reference test's four cases: a lookup, a constant run, a
    period-2 cycle and no earlier match (repeat the last token)."""
    cases = [([1, 2, 3, 4, 1, 2, 3], 3, 2, [4, 1, 2]),
             ([7] * 10, 4, 3, [7, 7, 7, 7]),
             ([3, 9] * 5, 5, 3, [3, 9, 3, 9, 3]),
             ([5, 6, 7, 8], 2, 2, [8, 8])]
    for row, k, n, want in cases:
        h, hl = _hist([row], 24)
        got = ngram_propose(_t(h), _t(hl), k=k, n=n)
        assert got.dtype == torch.int32
        assert got.tolist() == [want]
        assert got.tolist() == jax_ngram(jnp.asarray(h), jnp.asarray(hl),
                                         k=k, n=n).tolist()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k,n", [(1, 1), (4, 3), (6, 2)])
def test_ngram_propose_seeded_histories(seed, k, n):
    """Histories over a 5-token vocabulary (many matches), lengths from
    0 (every fallback) up to the full row, some past it (spill)."""
    rs = np.random.RandomState(seed)
    cap = 40
    h = rs.randint(0, 5, size=(9, cap + 1)).astype(np.int32)
    hl = np.array([0, 1, n, n + 1, 7, 19, cap - 1, cap, cap + 3], np.int32)
    got = ngram_propose(_t(h), _t(hl), k=k, n=n)
    want = jax_ngram(jnp.asarray(h), jnp.asarray(hl), k=k, n=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the accept/reject sampler and its bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 3])
def test_spec_probs_matches_reference(top_k):
    rs = np.random.RandomState(1)
    logits = (rs.randn(4, 5, 11) * 2).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.3, 0.0], np.float32)
    got = sampling.spec_probs(_t(logits), _t(temp), top_k)
    want = jsampling.spec_probs(jnp.asarray(logits), jnp.asarray(temp), top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("with_q", [False, True])
def test_spec_accept_greedy_exact(with_q):
    """Temperature 0: random logits, drafts that follow the argmax for a
    random prefix and then diverge; with and without a (greedy one-hot)
    proposal distribution.  ``cand`` up to ``n_acc`` and ``n_acc`` equal
    JAX's."""
    rs = np.random.RandomState(2)
    b, k, v = 16, 4, 13
    logits = rs.randn(b, k + 1, v).astype(np.float32)
    arg = logits.argmax(-1)
    drafts = arg[:, :k].copy()
    cut = rs.randint(0, k + 1, size=b)
    for i, c in enumerate(cut):
        if c < k:
            drafts[i, c] = (arg[i, c] + 1 + rs.randint(v - 1)) % v
    drafts = drafts.astype(np.int32)
    temp = np.zeros((b,), np.float32)
    q = None
    if with_q:
        q = np.eye(v, dtype=np.float32)[drafts]
    cand, n_acc = sampling.spec_accept(
        _t(logits), _t(drafts), None if q is None else _t(q), _t(temp), 0,
        torch.Generator().manual_seed(0))
    jc, jn = jsampling.spec_accept(
        jnp.asarray(logits), jnp.asarray(drafts),
        None if q is None else jnp.asarray(q), jnp.asarray(temp), 0,
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(n_acc.numpy(), cut)
    for i in range(b):
        m = int(jn[i]) + 1
        assert cand[i, :m].tolist() == np.asarray(jc)[i, :m].tolist()


def test_spec_accept_matches_target_distribution():
    """Speculative sampling guarantee: whatever the proposal, the first
    emitted token's marginal equals the target's distribution (the
    reference test's setup, 6000 draws, atol 0.03)."""
    v, k, n = 5, 2, 6000
    rs = np.random.RandomState(3)
    plog = (rs.randn(1, k + 1, v) * 1.5).astype(np.float32)
    qlog = rs.randn(1, k, v).astype(np.float32)
    temp = torch.ones((n,))
    gen = torch.Generator().manual_seed(7)
    qprobs = sampling.spec_probs(_t(qlog).expand(n, k, v), temp, 0)
    drafts = torch.multinomial(qprobs.reshape(n * k, v), 1,
                               generator=gen).reshape(n, k).to(torch.int32)
    cand, _ = sampling.spec_accept(_t(plog).expand(n, k + 1, v), drafts,
                                   qprobs, temp, 0, gen)
    emp = np.bincount(cand[:, 0].numpy(), minlength=v) / n
    want = np.asarray(jsampling.spec_probs(
        jnp.asarray(plog), jnp.ones((1,), jnp.float32), 0))[0, 0]
    np.testing.assert_allclose(emp, want, atol=0.03)


def _spec_states(cap=16):
    """The same slot state in both packages: 4 slots with EOS ids, budgets
    that clamp, one inactive slot and a history near its cap."""
    t = sampling.make_slot_state(4, torch.device("cpu"), hist_cap=cap)
    j = jsampling.make_slot_state(4, 0, hist_cap=cap)
    vals = {"active": np.array([True, True, False, True]),
            "max_new": np.array([10, 2, 5, 9], np.int32),
            "out_len": np.array([1, 0, 2, 3], np.int32),
            "eos": np.array([4, -1, -1, 8], np.int32),
            "tokens": np.array([1, 2, 3, 4], np.int32),
            "hist_len": np.array([3, 3, 5, cap - 1], np.int32)}
    hist = np.random.RandomState(4).randint(1, 9, (4, cap + 1))
    vals["hist"] = hist.astype(np.int32)
    for key, val in vals.items():
        t[key] = _t(val)
        j[key] = jnp.asarray(val)
    return t, j


@pytest.mark.parametrize("commit", [None, [True, False, True, True]])
def test_spec_update_matches_reference(commit):
    t, j = _spec_states()
    cand = np.array([[2, 3, 4, 5], [7, 8, 9, 6], [1, 1, 1, 1],
                     [5, 8, 6, 7]], np.int32)
    n_acc = np.array([3, 3, 1, 2], np.int32)
    c_t = None if commit is None else _t(np.array(commit))
    c_j = None if commit is None else jnp.asarray(np.array(commit))
    ts, tem, tn = sampling.spec_update(t, _t(cand), _t(n_acc), commit=c_t)
    js, jem, jn = jsampling.spec_update(j, jnp.asarray(cand),
                                        jnp.asarray(n_acc),
                                        jax.random.PRNGKey(1), commit=c_j)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    for key in ("tokens", "out_len", "active", "hist_len", "spec_steps",
                "spec_drafted", "spec_accepted", "spec_emitted"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                      err_msg=key)
    # the spill column takes masked and overflowing writes: not compared
    np.testing.assert_array_equal(ts["hist"].numpy()[:, :-1],
                                  np.asarray(js["hist"])[:, :-1])


def test_decode_update_appends_history():
    t, j = _spec_states()
    nxt = np.array([6, 7, 8, 9], np.int32)
    commit = np.array([True, False, True, True])
    ts, tem = sampling.decode_update(t, _t(nxt), commit=_t(commit))
    js, jem = jsampling.decode_update(j, jnp.asarray(nxt),
                                      jax.random.PRNGKey(0),
                                      commit=jnp.asarray(commit))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    for key in ("tokens", "out_len", "active", "hist_len"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    np.testing.assert_array_equal(ts["hist"].numpy()[:, :-1],
                                  np.asarray(js["hist"])[:, :-1])


# ---------------------------------------------------------------------------
# the dense draft decode cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (None, 20.0)])
def test_dense_decode_attention(window, softcap):
    rs = np.random.RandomState(5)
    q = rs.randn(3, 1, 4, 16).astype(np.float32)
    ck = rs.randn(3, 2, 12, 16).astype(np.float32)
    cv = rs.randn(3, 2, 12, 16).astype(np.float32)
    cl = np.array([12, 7, 1], np.int32)
    got = tatt.decode_attention(_t(q), _t(ck), _t(cv), _t(cl),
                                window=window, softcap=softcap)
    want = jatt.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.asarray(cl),
                                 window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("arch", [ARCH, "gemma2-2b"])
def test_dense_forward_decode(arch):
    """Three decode steps over a dense per-slot cache (random contents,
    ragged lengths; gemma2: window 16 inside a 24-entry cache, softcaps,
    tied and scaled embeddings): logits and the written caches within
    1e-5 of JAX's."""
    cfg, tp, jcfg, jp = _pair(arch)
    rs = np.random.RandomState(6)
    shape = tatt.init_cache_shape(cfg, 3, 24)
    assert shape == jatt.init_cache_shape(jcfg, 3, 24)[0]
    layers = [{"k": rs.randn(*shape).astype(np.float32),
               "v": rs.randn(*shape).astype(np.float32)}
              for _ in cfg.blocks]
    tc = {"layers": [{k: _t(v.copy()) for k, v in lc.items()}
                     for lc in layers],
          "len": _t(np.array([0, 9, 20], np.int32))}
    jc = {"layers": [{k: jnp.asarray(v) for k, v in lc.items()}
                     for lc in layers],
          "len": jnp.asarray(np.array([0, 9, 20], np.int32))}
    for step in range(3):
        tok = rs.randint(1, cfg.vocab_size, (3, 1)).astype(np.int32)
        tl, tc = forward_decode(tp, cfg, _t(tok), tc)
        jl, jc = jax_forward_decode(jp, jcfg, jnp.asarray(tok), jc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5, err_msg=f"step {step}")
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl_[key].numpy(), np.asarray(jl_[key]),
                                       rtol=0, atol=1e-5)


def test_model_drafter_propose_matches_reference(models, draft):
    """Greedy drafts of the disagreeing draft model from the same draft
    cache and slot state: drafts equal, proposal distributions and the
    draft cache (the extra forward that writes the last draft's KV
    included) within 1e-5."""
    _cfg, _tp, jcfg, _jp = models
    dcfg, dtp, djcfg, djp = draft
    k, slots, tokens = 3, 3, 40
    td = ModelDrafter(dcfg, k, cache_tokens=tokens)
    jd = JModelDrafter(djcfg, k, cache_tokens=tokens)
    rs = np.random.RandomState(8)
    tcache = td.init_cache(slots, torch.device("cpu"))
    jcache = jd.init_cache(slots)
    for tl_, jl_ in zip(tcache, jcache):
        for key in ("k", "v"):
            val = rs.randn(*jl_[key].shape).astype(np.float32)
            tl_[key].copy_(_t(val))
            jl_[key] = jnp.asarray(val)
    lens = np.array([0, 5, 30], np.int32)
    toks = rs.randint(1, jcfg.vocab_size, slots).astype(np.int32)
    tstate = {"tokens": _t(toks), "temp": torch.zeros(slots)}
    jstate = {"tokens": jnp.asarray(toks), "temp": jnp.zeros((slots,))}
    tdr, tq = td.propose(dtp, {"draft": tcache, "len": _t(lens)}, tstate,
                         torch.Generator().manual_seed(0), 0)
    jdr, jq, jout = jd.propose(djp, {"draft": jcache,
                                     "len": jnp.asarray(lens)},
                               jstate, jax.random.PRNGKey(0), 0)
    np.testing.assert_array_equal(tdr.numpy(), np.asarray(jdr))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    for tl_, jl_ in zip(tcache, jout["draft"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl_[key].numpy(), np.asarray(jl_[key]),
                                       rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

STAT_KEYS = ("spec_steps", "drafted_tokens", "accepted_tokens",
             "emitted_tokens")


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_engine_ngram_parity(models, chunked, k):
    cfg = models[0]
    reqs = _ragged_reqs(cfg.vocab_size)
    kw = dict(slots=2, max_len=64, chunked_prefill=chunked)
    want, jeng, got, teng = _both(models, JSpecConfig(k=k), SpecConfig(k=k),
                                  reqs, **kw)
    assert teng.chunked_prefill == chunked
    assert got == want
    assert teng.spec_stats() == jeng.spec_stats()
    assert teng.leaked_pages() == 0
    assert teng.memory_stats() == jeng.memory_stats()


def test_engine_model_drafter_self_speculation(models):
    """Draft model == target (its own tensors): every draft accepted,
    tokens and statistics equal to JAX's, two executables forced."""
    cfg, tp, jcfg, jp = models
    reqs = _ragged_reqs(cfg.vocab_size)
    want, jeng, got, teng = _both(
        models, JSpecConfig(draft="self", k=3, draft_cfg=jcfg,
                            draft_params=jp),
        SpecConfig(draft="self", k=3, draft_cfg=cfg, draft_params=tp),
        reqs, slots=2, max_len=64)
    assert not teng.chunked_prefill and teng.drafter.kind == "model"
    assert got == want
    st = teng.spec_stats()
    assert st == jeng.spec_stats()
    assert st["acceptance_rate"] > 0.99 and st["tokens_per_step"] > 2.5
    # the dense draft cache: one max_len + k + 1 row per slot and layer
    assert teng.cache["draft"][0]["k"].shape == (2, cfg.num_kv_heads, 68,
                                                 cfg.resolved_head_dim)


def test_engine_model_drafter_disagreeing_draft(models, draft):
    cfg = models[0]
    dcfg, dtp, djcfg, djp = draft
    reqs = _ragged_reqs(cfg.vocab_size, n=3)
    want, jeng, got, teng = _both(
        models, JSpecConfig(draft="tiny", k=3, draft_cfg=djcfg,
                            draft_params=djp),
        SpecConfig(draft="tiny", k=3, draft_cfg=dcfg, draft_params=dtp),
        reqs, slots=2, max_len=64)
    assert got == want
    assert teng.spec_stats() == jeng.spec_stats()
    # and equal to plain decoding: rejection sampling hides the drafts
    plain = Engine(cfg, models[1], slots=2, max_len=64, device="cpu")
    assert _serve(plain, reqs) == got


@pytest.mark.parametrize("chunked", [True, False])
def test_engine_windowed_ring_wraps_under_speculation(chunked):
    """gemma2's window-16 rings wrap during a drafted run of 26 tokens;
    the ring slack (``spec_tokens``) keeps the verify rows' writes off
    in-window history: tokens, statistics and per-round memory statistics
    equal to JAX's."""
    models = _pair("gemma2-2b")
    cfg, tp, jcfg, jp = models
    kw = dict(slots=2, max_len=96, sync_interval=4, seed=0,
              chunked_prefill=chunked, prefill_budget=4)
    jeng = JEngine(jcfg, jp, spec=JSpecConfig(k=4), **kw)
    teng = Engine(cfg, tp, spec=SpecConfig(k=4), device="cpu", **kw)
    assert teng.spec.spec_tokens == jeng.spec.spec_tokens
    stats = {}
    for eng in (jeng, teng):
        for i, p in enumerate([[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8]]):
            R = Request if eng is teng else JRequest
            eng.submit(R(rid=i, prompt=p, max_new_tokens=26))
        rounds = []
        while eng.queue or eng._live():
            eng.step()
            rounds.append(eng.memory_stats())
        stats[eng is teng] = rounds
    assert ({r.rid: r.out_tokens for r in teng.finished}
            == {r.rid: r.out_tokens for r in jeng.finished})
    assert stats[True] == stats[False]
    assert teng.spec_stats() == jeng.spec_stats()


def test_engine_pool_direct_reads_match_gather(models):
    """Verify rows read through the paged-attention op (its plain version
    on the CPU) give the gather path's tokens, fused and two executables."""
    cfg, tp, _jcfg, _jp = models
    reqs = _ragged_reqs(cfg.vocab_size, n=4)
    for chunked in (True, False):
        out = [_serve(Engine(cfg, tp, spec=SpecConfig(k=4), slots=2,
                             max_len=64, paged_kernel=pk,
                             chunked_prefill=chunked, device="cpu"), reqs)
               for pk in (False, True)]
        assert out[0] == out[1]


def test_engine_prefix_sharing_matches_exclusive(models):
    """Speculation on radix prefix sharing: shared pages are copied on
    write at admission, verify writes never reach them, and the tokens
    equal the exclusive engine's (and JAX's)."""
    cfg, tp, jcfg, jp = models
    prefix = [(3 * j) % 200 + 1 for j in range(16)]
    tail = [50, 51, 52, 53, 54, 55, 56, 57]
    waves = [[(prefix + tail, 8)],
             [(prefix + tail[:3] + [99], 8), (prefix + tail, 8),
              (prefix + tail[:2] + [7, 8], 8)]]
    engs = {"excl": Engine(cfg, tp, spec=SpecConfig(k=4), slots=2,
                           max_len=64, prefix_sharing=False, device="cpu"),
            "shared": Engine(cfg, tp, spec=SpecConfig(k=4), slots=2,
                             max_len=64, device="cpu"),
            "jax": JEngine(jcfg, jp, spec=JSpecConfig(k=4), slots=2,
                           max_len=64)}
    out = {name: {} for name in engs}
    for w, wave in enumerate(waves):
        for name, eng in engs.items():
            R = JRequest if name == "jax" else Request
            for i, (p, mx) in enumerate(wave):
                eng.submit(R(rid=10 * w + i, prompt=list(p),
                             max_new_tokens=mx))
            out[name].update({r.rid: list(r.out_tokens)
                              for r in eng.run(max_steps=100_000)})
    assert out["shared"] == out["excl"] == out["jax"]
    ps = engs["shared"].prefix_stats()
    assert ps == engs["jax"].prefix_stats()
    assert ps["prefix_hits"] >= 3 and ps["cow_copies"] >= 2
    assert engs["shared"].leaked_pages() == 0


def test_engine_drafting_disabled_until_prefill_completes(models):
    """K = 4 with a 4-token budget (5 rows per micro-step): while the slot
    is mid-prefill it emits nothing and the counters stay 0; the output
    equals the two-executable spec engine's and JAX's."""
    cfg, tp, jcfg, jp = models
    prompt = [(5 * j) % 180 + 1 for j in range(20)]
    eng = Engine(cfg, tp, slots=1, max_len=96, sync_interval=1, seed=0,
                 spec=SpecConfig(k=4), prefill_budget=4, device="cpu")
    assert eng.chunked_prefill and eng.executor.chunk_rows == 5
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8))
    for _ in range(3):
        eng.step()
        req = eng._slot_req[0]
        assert req is not None and not req.out_tokens
        assert 0 < eng._slot_seen_len[0] < len(prompt)
        st = eng.spec_stats()
        assert st["spec_steps"] == 0 and st["drafted_tokens"] == 0
    (done,) = eng.run(max_steps=50_000)
    assert len(done.out_tokens) == 8 and eng.spec_stats()["spec_steps"] > 0
    legacy = Engine(cfg, tp, slots=1, max_len=96, sync_interval=4,
                    spec=SpecConfig(k=4), chunked_prefill=False,
                    device="cpu")
    jeng = JEngine(jcfg, jp, slots=1, max_len=96, sync_interval=1, seed=0,
                   spec=JSpecConfig(k=4), prefill_budget=4)
    want = _serve(jeng, [(prompt, 8)])[0]
    assert list(done.out_tokens) == want == _serve(legacy, [(prompt, 8)])[0]
    assert eng.spec_stats() == jeng.spec_stats()


@pytest.mark.parametrize("chunked", [True, False])
def test_engine_eos_and_budget(models, chunked):
    """A round that reaches EOS stops at it (EOS emitted); budgets are
    exact even where a verify round could overshoot them."""
    cfg, tp, _jcfg, _jp = models
    kw = dict(slots=2, max_len=64, chunked_prefill=chunked, device="cpu")
    probe = _serve(Engine(cfg, tp, **kw), [([2, 3], 8)])[0]
    eos = probe[3]
    got = _serve(Engine(cfg, tp, spec=SpecConfig(k=4), **kw),
                 [([2, 3], 8)], eos=eos)[0]
    assert got == probe[:probe.index(eos) + 1]
    out = _serve(Engine(cfg, tp, spec=SpecConfig(k=4), **kw),
                 [([4, 5], 7), ([6], 3)])
    assert len(out[0]) == 7 and len(out[1]) == 3


def test_engine_sampled_run_mixes_temperatures(models):
    """A greedy slot beside a sampled one (temperature 1.5): the greedy
    slot equals a solo greedy run; the sampled one completes with
    in-vocabulary tokens and no leaked page."""
    cfg, tp, _jcfg, _jp = models
    eng = Engine(cfg, tp, slots=2, max_len=64, spec=SpecConfig(k=3),
                 seed=11, device="cpu")
    eng.submit(Request(rid=0, prompt=[2, 3], max_new_tokens=6))
    eng.submit(Request(rid=1, prompt=[2, 3], max_new_tokens=6,
                       temperature=1.5))
    done = {r.rid: r for r in eng.run()}
    solo = _serve(Engine(cfg, tp, slots=2, max_len=64, spec=SpecConfig(k=3),
                         device="cpu"), [([2, 3], 6)])
    assert done[0].out_tokens == solo[0]
    assert len(done[1].out_tokens) == 6
    assert all(0 <= t < cfg.vocab_size for t in done[1].out_tokens)
    assert eng.leaked_pages() == 0


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


@pytest.mark.parametrize("draft_kind", ["ngram", "model"])
def test_engine_spec_chunk_is_sync_free(models, draft, draft_kind):
    cfg, tp, _jcfg, _jp = models
    spec = SpecConfig(k=4)
    if draft_kind == "model":
        spec = SpecConfig(draft="tiny", k=4, draft_cfg=draft[0],
                          draft_params=draft[1])
    eng = Engine(cfg, tp, slots=2, max_len=64, spec=spec, device="cpu")
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=40))
    eng.submit(Request(rid=1, prompt=[4, 5], max_new_tokens=40))
    with _NoHostSync():
        eng._admit()
        toks = eng.step_chunk()
    eng._drain(toks)
    assert eng.host_syncs == 1
    assert toks.shape == (eng.sync_interval * 5, 2)


def test_engine_spec_warmup_inert(models):
    """Warmup (every bucket's prefill, one idle chunk) adds nothing to
    the counters and leaves seeded runs as they were."""
    cfg, tp, _jcfg, _jp = models
    reqs = [([1 + i] * (2 + 7 * i), 5) for i in range(3)]
    base = Engine(cfg, tp, slots=2, max_len=64, spec=SpecConfig(k=4),
                  device="cpu")
    want = _serve(base, reqs)
    eng = Engine(cfg, tp, slots=2, max_len=64, spec=SpecConfig(k=4),
                 device="cpu")
    eng.warmup()
    assert eng.spec_stats()["spec_steps"] == 0
    assert _serve(eng, reqs) == want
    assert eng.spec_stats() == base.spec_stats()
    st = eng.spec_stats()
    # the first token of each request comes from its prefill, not a round
    assert st["emitted_tokens"] == sum(len(v) for v in want.values()) - 3


def test_engine_spec_argument_forms(models):
    """``spec`` takes ``"ngram"``, a draft config name (its weights drawn
    from ``seed + 17``) or a ``SpecConfig``; anything else is a TypeError,
    and k < 1 a ValueError."""
    cfg, tp, _jcfg, _jp = models
    eng = Engine(cfg, tp, slots=1, max_len=32, spec="ngram", device="cpu")
    assert eng.drafter.kind == "ngram" and eng.spec_config.k == 4
    assert eng.state["hist"].shape == (1, 32 + 4 + 3)
    eng = Engine(cfg, tp, slots=1, max_len=32, spec=ARCH, seed=3,
                 device="cpu")
    assert eng.drafter.kind == "model" and not eng.chunked_prefill
    assert dataclasses.asdict(eng.drafter.cfg) == dataclasses.asdict(
        reduced(get_config(ARCH)))
    want = init_params(model_defs(eng.drafter.cfg), 20, device="cpu")
    for (name, a), (_, b) in zip(eng.draft_params.named_parameters(),
                                 want.named_parameters()):
        assert torch.equal(a, b), name
    assert "hist" not in eng.state
    with pytest.raises(TypeError, match="SpecConfig"):
        Engine(cfg, tp, slots=1, max_len=32, spec=3, device="cpu")
    with pytest.raises(ValueError, match="spec.k"):
        Engine(cfg, tp, slots=1, max_len=32, spec=SpecConfig(k=0),
               device="cpu")
    with pytest.raises(ValueError, match="model drafter"):
        Engine(cfg, tp, slots=1, max_len=32, spec=ARCH,
               chunked_prefill=True, device="cpu")


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-7b"])
def test_capability_gate_message(arch):
    """Recurrent-state archs cannot roll back rejected drafts: the
    engine raises the reference's ``check_spec_capable`` message."""
    jcfg = jax_reduced(jax_get_config(arch))
    with pytest.raises(ValueError) as want:
        check_spec_capable(jcfg)
    cfg = reduced(get_config(arch))
    tp = init_params(model_defs(cfg), 0, device="cpu")
    with pytest.raises(ValueError) as got:
        Engine(cfg, tp, slots=1, max_len=32, spec=SpecConfig(k=2),
               device="cpu")
    assert str(got.value) == str(want.value)
    assert "speculative" in str(got.value)
