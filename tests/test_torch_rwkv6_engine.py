"""PyTorch port: rwkv6 (time-mix + channel-mix, no attention) through the
two-executable serving path, against the JAX reference on the same
weights (reduced rwkv6-7b: 2 layers, d 64, 4 wkv heads of 16; fp32,
TF32 off).

* ``forward_prefill`` (a 13-token prompt padded to 16 and a 30-token
  prompt padded to 32, with a pad token that is not 0) and
  ``forward_decode`` steps on slot caches: logits and every state leaf
  at atol 1e-4; the padded prefill as its unpadded prompt's (the
  reference's ``test_bucketed_prefill_matches_unpadded``); decoding a
  prompt token by token as prefilling it.
* ``CacheSpec``: every layer a STATE layer, no pool groups, no pages
  (``has_paged`` False, ``blocks_needed == {}``), state shapes and
  memory accounting as the reference's.
* ``admit_cache``: the state splice into a slot's row, bitwise the
  prefill's state and as the reference's (1e-4: the two prefills sum in
  other orders), the other rows untouched.
* ``Engine(chunked_prefill="auto")``: two executables with no pools to
  read, greedy tokens and ``memory_stats`` after every round identical
  to the JAX ``Engine``'s, with more requests than slots and one prompt
  longer than the largest bucket (64); ``chunked_prefill=True`` raises.
* An empty prompt (the reference's ``test_empty_prompt_no_stale_slot``):
  admitted on two executables with a fresh state and ``len`` 0, its
  tokens and its neighbour's = the JAX engine's, the neighbour's = its
  solo run's; the same on an attention arch (internlm2,
  ``chunked_prefill=False``), whose fused mode refuses it with the
  reference's message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import forward_decode as jax_forward_decode  # noqa: E402
from repro.models import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.models import forward_decode, forward_prefill  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "rwkv6-7b"
_jax_prefill = jax.jit(jax_forward_prefill, static_argnames=("cfg",))
_jax_decode = jax.jit(jax_forward_decode,
                      static_argnames=("cfg", "paged_kernel"))
# prompts of 3..70 tokens (70 > the largest bucket, 64), more requests
# than slots
LENS = [3, 20, 37, 70, 9, 50]
BUDGETS = [30, 12, 25, 5, 40, 1]
PROMPTS = [[(7 * j + i) % 200 + 1 for j in range(n)]
           for i, n in enumerate(LENS)]
ENGINE_KW = dict(slots=3, max_len=64, page_size=8, sync_interval=4, seed=0)


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def _build(layers=2, seed=0):
    """Both packages' reduced rwkv6 on the reference's weights, with the
    zero-init mixing and decay LoRA leaves redrawn so that every term of
    the blocks contributes."""
    jcfg = jax_reduced(jax_get_config(ARCH), layers=layers)
    cfg = reduced(get_config(ARCH), layers=layers)
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(seed),
                        jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    rs = np.random.RandomState(seed + 1)
    for lp in tree["layers"]:
        for key in ("mu_inner", "mu", "mix_b", "decay_b"):
            lp["mixer"][key] = (rs.randn(*lp["mixer"][key].shape)
                                * 0.2).astype(np.float32)
        for key in ("mu_k", "mu_r"):
            lp["ffn"][key] = rs.rand(*lp["ffn"][key].shape).astype(
                np.float32)
    tp = params_from_numpy(tree, device="cpu")
    return cfg, tp, jcfg, jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def models():
    return _build()


def _close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol, err_msg=msg)


def _assert_layers(tl, jl, tol=1e-4):
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert set(t) == set(j) == {"tshift", "wkv", "cshift"}, (i, set(t))
        for k in j:
            _close(t[k], j[k], tol, msg=f"layer {i} {k}")


# ---------------------------------------------------------------------------
# forward_prefill and forward_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plen,bucket", [(13, 16), (30, 32)])
def test_forward_prefill_padded_vs_jax(models, plen, bucket):
    """A prompt right-padded with 9s: logits and state as the
    reference's; the padded prompt's logits and states as its unpadded
    prefill's (the reference's ``test_bucketed_prefill_matches_unpadded``)."""
    cfg, tp, jcfg, jp = models
    toks = np.full((1, bucket), 9, np.int32)
    toks[0, :plen] = [(5 * j) % 200 + 1 for j in range(plen)]
    jl, jc = _jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          length=jnp.asarray([plen], jnp.int32))
    before = wkv_ops.launches
    tl, tc = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                             length=torch.tensor([plen], dtype=torch.int32))
    assert wkv_ops.launches == before        # CPU tensors: the plain path
    _close(tl, jl)
    assert tc["len"].tolist() == [plen]
    _assert_layers(tc["layers"], jc["layers"])
    ul, uc = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(
        toks[:, :plen])})
    torch.testing.assert_close(ul, tl, rtol=1e-4, atol=1e-4)
    for lu, lp in zip(uc["layers"], tc["layers"]):
        for k in lu:
            torch.testing.assert_close(lu[k], lp[k], rtol=1e-4, atol=1e-4)


def _slot_pair(cfg, tp, jcfg, jp, prompt, slot=1, slots=2, max_len=64):
    """Both packages' slot caches with ``prompt`` prefilled and admitted
    into ``slot`` (no pool groups: the page rows are empty)."""
    tspec = tcache.CacheSpec.from_config(cfg, slots, max_len, page_size=8)
    jspec = jcache.CacheSpec.from_config(jcfg, slots, max_len, page_size=8)
    toks = np.asarray([prompt], np.int32)
    _jl, jone = _jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _tl, tone = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)})
    jc = jcache.admit_cache(jspec, jspec.init_paged_cache(), jone,
                            jnp.int32(slot), jnp.int32(0),
                            jnp.int32(len(prompt)), {})
    tc = tcache.admit_cache(tspec, tspec.init_paged_cache(
        torch.device("cpu")), tone, slot, 0, len(prompt), {})
    return tc, jc


def _assert_cache(tc, jc, tol=1e-5):
    _assert_layers(tc["layers"], jc["layers"], tol)
    assert tc["page_tables"] == {} and dict(jc["page_tables"]) == {}
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_forward_decode_vs_jax(models):
    """12 decode steps after an 11-token prompt in slot 1 (slot 0 idle,
    its state stepping on its own tokens as in the reference): logits
    and every state row as the reference's at every step."""
    cfg, tp, jcfg, jp = models
    prompt = [(3 * j) % 200 + 1 for j in range(11)]
    tc, jc = _slot_pair(cfg, tp, jcfg, jp, prompt)
    rs = np.random.RandomState(1)
    for _step in range(12):
        toks = rs.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        wm = np.asarray([False, True])
        jl, jc = _jax_decode(jp, jcfg, jnp.asarray(toks), jc,
                             write_mask=jnp.asarray(wm), paged_kernel=False)
        tl, tc = forward_decode(tp, cfg, torch.as_tensor(toks), tc,
                                write_mask=torch.as_tensor(wm))
        _close(tl, jl)
        _assert_cache(tc, jc, tol=1e-4)
    assert int(tc["len"][1]) == 23


def test_decode_matches_prefill(models):
    """A prefill of the first token, then ``forward_decode`` through the
    rest of a 20-token prompt: the last logits and every state leaf as
    one prefill of the whole prompt (the recurrent path against the
    chunked one)."""
    cfg, tp, _jcfg, _jp = models
    prompt = torch.tensor([[(11 * j) % 200 + 1 for j in range(20)]],
                          dtype=torch.int32)
    spec = tcache.CacheSpec.from_config(cfg, 1, 64, page_size=8)
    cache = spec.init_paged_cache(torch.device("cpu"))
    _l, one = forward_prefill(tp, cfg, {"tokens": prompt[:, :1]})
    tcache.admit_cache(spec, cache, one, 0, 0, 1, {})
    for t in range(1, 20):
        logits, cache = forward_decode(tp, cfg, prompt[:, t:t + 1], cache)
    want_l, want = forward_prefill(tp, cfg, {"tokens": prompt})
    torch.testing.assert_close(logits, want_l, rtol=1e-4, atol=1e-4)
    for got, w in zip(cache["layers"], want["layers"]):
        for k in w:
            torch.testing.assert_close(got[k], w[k], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,max_len,page_size,num_pages", [
    (2, 64, 8, None), (3, 12, 4, None), (4, 256, 16, 9), (1, 16, 16, None)])
def test_cachespec_matches_reference(models, slots, max_len, page_size,
                                     num_pages):
    cfg, _tp, jcfg, _jp = models
    ts = tcache.CacheSpec.from_config(cfg, slots, max_len,
                                      page_size=page_size,
                                      num_pages=num_pages)
    js = jcache.CacheSpec.from_config(jcfg, slots, max_len,
                                      page_size=page_size,
                                      num_pages=num_pages)
    assert [ls.kind for ls in ts.layers] == [ls.kind for ls in js.layers] \
        == [tcache.STATE] * cfg.num_layers
    for tl, jl in zip(ts.layers, js.layers):
        assert (tl.ring_blocks, tl.window, tl.group) == \
            (jl.ring_blocks, jl.window, jl.group)
        assert tl.state == {k: shp for k, (shp, _ax) in jl.state.items()}
    assert ts.groups == [] and list(js.groups) == []
    assert not ts.has_paged and not js.has_paged
    assert (ts.num_pages, ts.max_blocks) == (js.num_pages, js.max_blocks)
    assert not ts.prefix_sharing_capable and not js.prefix_sharing_capable
    assert ts.blocks_needed(30, 40) == js.blocks_needed(30, 40) == {}
    assert ts.memory_stats({}, 0) == js.memory_stats({}, 0)
    assert ts.memory_stats({}, 17) == js.memory_stats({}, 17)
    # the zeroed caches: the same leaves, shapes and dtypes, no tables
    tc = ts.init_paged_cache(torch.device("cpu"))
    jc = js.init_paged_cache()
    assert tc["page_tables"] == {} and dict(jc["page_tables"]) == {}
    for t, j in zip(tc["layers"], jc["layers"]):
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
        assert all(not bool(v.any()) for v in t.values())
    # eviction touches only the length: there are no tables to trash
    tc["len"].fill_(5)
    assert tcache.free_slot_cache(ts, tc, 0) is tc
    assert tc["len"].tolist() == [0] + [5] * (slots - 1)


def test_admit_cache_state_splice_vs_jax(models):
    """Two admissions into a 3-slot cache (slot 2, then slot 0): lengths
    and every state row as the reference's; the third slot's state rows
    stay zero."""
    cfg, tp, jcfg, jp = models
    tspec = tcache.CacheSpec.from_config(cfg, 3, 64, page_size=8)
    jspec = jcache.CacheSpec.from_config(jcfg, 3, 64, page_size=8)
    tc = tspec.init_paged_cache(torch.device("cpu"))
    jc = jspec.init_paged_cache()
    for slot, plen, bucket in ((2, 21, 32), (0, 6, 8)):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = [(11 * j + slot) % 200 + 1 for j in range(plen)]
        _jl, jone = _jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 length=jnp.asarray([plen], jnp.int32))
        _tl, tone = forward_prefill(tp, cfg,
                                    {"tokens": torch.as_tensor(toks)},
                                    length=torch.tensor([plen],
                                                        dtype=torch.int32))
        jc = jcache.admit_cache(jspec, jc, jone, jnp.int32(slot),
                                jnp.int32(0), jnp.int32(plen), {})
        out = tcache.admit_cache(tspec, tc, tone, slot, 0, plen, {})
        assert out is tc
        _assert_cache(tc, jc, tol=1e-4)
        for big, small in zip(tc["layers"], tone["layers"]):
            assert all(torch.equal(big[k][slot], small[k][0]) for k in big)
    for layer in tc["layers"]:
        assert all(not bool(leaf[1].any()) for leaf in layer.values())


def test_segments_refuse_state_layers(models):
    cfg, tp, _jcfg, _jp = models
    spec = tcache.CacheSpec.from_config(cfg, 1, 64, page_size=8)
    cache = spec.init_paged_cache(torch.device("cpu"))
    _l, one = forward_prefill(tp, cfg, {"tokens": torch.ones(
        1, 8, dtype=torch.int32)})
    with pytest.raises(ValueError, match="segment"):
        tcache.splice_prefill(spec, cache, one, 0, 8, {})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve_rounds(eng, req_cls):
    """Submit every prompt, then run round by round, recording the memory
    statistics after each round."""
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        assert eng.submit(req_cls(rid=i, prompt=list(p),
                                  max_new_tokens=n)) is None
    stats = []
    while eng.queue or eng._live():
        eng.step()
        stats.append(eng.memory_stats())
    return {r.rid: list(r.out_tokens) for r in eng.finished}, stats


@pytest.fixture(scope="module")
def jax_run(models):
    _cfg, _tp, jcfg, jp = models
    eng = JEngine(jcfg, jp, **ENGINE_KW)
    assert not eng.chunked_prefill and not eng.paged_kernel
    tokens, stats = _serve_rounds(eng, JRequest)
    return tokens, stats, eng


@pytest.mark.parametrize("paged_kernel", ["auto", True])
def test_engine_token_and_memory_parity(models, jax_run, paged_kernel):
    """Six requests on three slots, one prompt (70) past the largest
    bucket (64); asking for the paged kernel changes nothing: there are
    no pools to read."""
    cfg, tp, _jcfg, _jp = models
    jtokens, jstats, jeng = jax_run
    eng = Engine(cfg, tp, device="cpu", paged_kernel=paged_kernel,
                 **ENGINE_KW)
    assert not eng.chunked_prefill and not eng.paged_kernel
    eng.warmup()
    before = wkv_ops.launches
    tokens, stats = _serve_rounds(eng, Request)
    assert wkv_ops.launches == before        # CPU tensors: the plain path
    assert tokens == jtokens
    assert [len(tokens[i]) for i in range(len(LENS))] == BUDGETS
    assert stats == jstats
    assert all(s["pages_in_use"] == 0 and s["pool_groups"] == {}
               for s in stats)
    assert max(s["live_slots"] for s in stats) == ENGINE_KW["slots"]
    assert eng.buckets == jeng.buckets == [8, 16, 32, 64, 128]
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.prefix_stats()["prefix_hits"] == 0
    assert eng.leaked_pages() == 0


def test_engine_mode_contract(models):
    """``"auto"`` picks two executables; an explicit fused opt-in raises
    naming ``chunked_prefill``, as the reference's engine does."""
    cfg, tp, jcfg, jp = models
    assert not Engine(cfg, tp, device="cpu").chunked_prefill
    assert not JEngine(jcfg, jp, slots=1, max_len=32).chunked_prefill
    with pytest.raises(ValueError, match="chunked_prefill"):
        Engine(cfg, tp, device="cpu", chunked_prefill=True)
    with pytest.raises(ValueError, match="chunked_prefill"):
        JEngine(jcfg, jp, slots=1, max_len=32, chunked_prefill=True)


def test_long_prompt_takes_a_larger_bucket(models):
    """A prompt past the largest bucket, and a span past ``max_len``
    (state archs have no ring to wrap), on a one-slot engine: the same
    tokens as the reference's."""
    cfg, tp, jcfg, jp = models
    kw = dict(slots=1, max_len=32, page_size=8, sync_interval=4, seed=0,
              buckets=[8, 16])
    prompt = [(13 * j) % 200 + 1 for j in range(40)]
    out = []
    for eng, req in ((JEngine(jcfg, jp, **kw), JRequest),
                     (Engine(cfg, tp, device="cpu", **kw), Request)):
        eng.submit(req(rid=0, prompt=list(prompt), max_new_tokens=6))
        (done,) = eng.run()
        out.append((list(done.out_tokens), list(eng.buckets)))
    assert out[0] == out[1]
    assert out[1][1] == [8, 16, 64]


def test_engine_has_no_pools(models):
    cfg, tp, _jcfg, _jp = models
    eng = Engine(cfg, tp, device="cpu", **ENGINE_KW)
    assert eng.scheduler.pools == {} and eng.scheduler.radix is None
    assert eng.spec.groups == [] and eng.cache["page_tables"] == {}


# ---------------------------------------------------------------------------
# the prefill through the Hopper kernel (on the card only)
# ---------------------------------------------------------------------------

def test_cuda_prefill_launches_kernel_per_layer(models):
    """On the card every rwkv6 layer of a padded prefill is one
    ``rwkv6_wkv`` launch, and logits and states agree with the CPU's
    chunked path (1e-4)."""
    if not wkv_ops.supported():
        pytest.skip("needs a CUDA device where the rwkv6_wkv kernel builds "
                    "and launches (ops.supported() is False)")
    cfg, tp, _jcfg, _jp = models
    dev = torch.device("cuda")
    toks = torch.full((1, 32), 9, dtype=torch.int32)
    toks[0, :21] = torch.arange(1, 22)
    length = torch.tensor([21], dtype=torch.int32)
    want_l, want = forward_prefill(tp, cfg, {"tokens": toks}, length=length)
    before = wkv_ops.launches
    got_l, got = forward_prefill(tp.to(dev), cfg, {"tokens": toks.to(dev)},
                                 length=length.to(dev))
    assert wkv_ops.launches == before + cfg.num_layers
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-4, atol=1e-4)
    for g, w in zip(got["layers"], want["layers"]):
        for k in w:
            torch.testing.assert_close(g[k].cpu(), w[k], rtol=1e-4,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# an empty prompt on two executables
# ---------------------------------------------------------------------------

def _empty_prompt_run(eng, req_cls, with_empty=True):
    if with_empty:
        assert eng.submit(req_cls(rid=0, prompt=[], max_new_tokens=4)) \
            is None
    assert eng.submit(req_cls(rid=1, prompt=[4, 5, 6],
                              max_new_tokens=4)) is None
    done = eng.run()
    return {r.rid: list(r.out_tokens) for r in done}


def _internlm2():
    jcfg = jax_reduced(jax_get_config("internlm2-1.8b"))
    cfg = reduced(get_config("internlm2-1.8b"))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tp, jcfg, jp


@pytest.mark.parametrize("arch", [ARCH, "internlm2-1.8b"])
def test_empty_prompt_no_stale_slot(models, arch):
    cfg, tp, jcfg, jp = models if arch == ARCH else _internlm2()
    kw = dict(slots=2, max_len=64, page_size=8, sync_interval=4, seed=0,
              chunked_prefill=False)
    jtok = _empty_prompt_run(JEngine(jcfg, jp, **kw), JRequest)
    tok = _empty_prompt_run(Engine(cfg, tp, device="cpu", **kw), Request)
    assert tok == jtok
    assert sorted(tok) == [0, 1] and all(len(t) == 4 for t in tok.values())
    solo = _empty_prompt_run(Engine(cfg, tp, device="cpu", **kw), Request,
                             with_empty=False)
    assert solo[1] == tok[1]
    if arch != ARCH:        # the fused mode refuses it, as the reference
        kw["chunked_prefill"] = True
        for eng, req in ((JEngine(jcfg, jp, **kw), JRequest),
                         (Engine(cfg, tp, device="cpu", **kw), Request)):
            with pytest.raises(ValueError, match="chunked_prefill requires "
                                                 "a non-empty prompt"):
                eng.submit(req(rid=0, prompt=[], max_new_tokens=4))
