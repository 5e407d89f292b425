"""PyTorch port: zamba2 (Mamba2 backbone + shared attention) through the
two-executable serving path, against the JAX reference on the same
weights (reduced zamba2-7b: 4 layers, 3 Mamba2 and one shared attention
block with a window of 16; fp32, TF32 off).

* ``forward_prefill`` (a 13-token prompt padded to 16 with a pad token
  that is not 0, and a 30-token prompt wider than the window) and
  ``forward_decode`` steps on paged caches through a ring that wraps:
  logits, every KV row and every Mamba2 state leaf at atol 1e-4; also at
  the shared attention's full-width head dim 112.
* ``CacheSpec``: per-layer kinds, rings, pool groups and budgets, state
  shapes and memory accounting as the reference's.
* ``admit_cache``: the state splice into a slot's row, the KV splice and
  the tables as the reference's (1e-6; states bitwise).
* ``Engine(chunked_prefill="auto")``: two executables, greedy tokens and
  ``memory_stats`` after every round identical to the JAX ``Engine``'s,
  on prompts and budgets that wrap the window-16 ring in prefill and in
  decode, and one prompt longer than the largest bucket (64).
* ``flash_attention_ref`` at dh 112 (H = Hkv, a window) against JAX's
  oracle: atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.models import forward_decode as jax_forward_decode  # noqa: E402
from repro.models import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import forward_decode, forward_prefill  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "zamba2-7b"
WIDTHS = {"reduced": {}, "dh112": {"d_model": 224, "heads": 2}}
_jax_prefill = jax.jit(jax_forward_prefill, static_argnames=("cfg",))
_jax_decode = jax.jit(jax_forward_decode,
                      static_argnames=("cfg", "paged_kernel"))
# prompts of 3..70 tokens (70 > the largest bucket, 64) and budgets that
# carry prompts and outputs past the 16-token window
LENS = [3, 20, 37, 70, 9, 50]
BUDGETS = [30, 12, 25, 5, 40, 1]
PROMPTS = [[(7 * j + i) % 200 + 1 for j in range(n)]
           for i, n in enumerate(LENS)]
ENGINE_KW = dict(slots=3, max_len=64, page_size=8, sync_interval=4, seed=0)


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def _build(width="reduced", layers=4, seed=0):
    kw = dict(WIDTHS[width], layers=layers)
    jcfg = jax_reduced(jax_get_config(ARCH), **kw)
    cfg = reduced(get_config(ARCH), **kw)
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(seed),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tp, jcfg, jp


@pytest.fixture(scope="module")
def models():
    return _build()


def _close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol, err_msg=msg)


def _assert_layers(tl, jl, tol=1e-4):
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert set(t) == set(j), (i, set(t), set(j))
        for k in j:
            _close(t[k], j[k], tol, msg=f"layer {i} {k}")


# ---------------------------------------------------------------------------
# forward_prefill and forward_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_prefill_padded_vs_jax(width):
    """A 13-token prompt right-padded with 9s to 16, and a 30-token prompt
    (wider than the window) in a 32 bucket: logits, KV and state as the
    reference's; the padded prompt's logits and states as its unpadded
    prefill's (the reference's ``test_bucketed_prefill_matches_unpadded``)."""
    cfg, tp, jcfg, jp = _build(width)
    for plen, bucket in ((13, 16), (30, 32)):
        toks = np.full((1, bucket), 9, np.int32)
        toks[0, :plen] = [(5 * j) % 200 + 1 for j in range(plen)]
        jl, jc = _jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              length=jnp.asarray([plen], jnp.int32))
        tl, tc = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                 length=torch.tensor([plen],
                                                     dtype=torch.int32))
        _close(tl, jl)
        assert tc["len"].tolist() == [plen]
        _assert_layers(tc["layers"], jc["layers"])
        ul, uc = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(
            toks[:, :plen])})
        torch.testing.assert_close(ul, tl, rtol=1e-4, atol=1e-4)
        for lu, lp in zip(uc["layers"], tc["layers"]):
            for k in lu:
                p = lp[k][..., :plen, :] if k in ("k", "v") else lp[k]
                torch.testing.assert_close(lu[k], p, rtol=1e-4, atol=1e-4)


def _paged_pair(cfg, tp, jcfg, jp, prompt, slot=1, slots=2, max_len=64):
    """Both packages' paged caches with ``prompt`` prefilled and admitted
    into ``slot`` (identity page rows)."""
    tspec = tcache.CacheSpec.from_config(cfg, slots, max_len, page_size=8)
    jspec = jcache.CacheSpec.from_config(jcfg, slots, max_len, page_size=8)
    rows = {g.key: np.arange(slot * g.ring_blocks,
                             (slot + 1) * g.ring_blocks, dtype=np.int32)
            for g in tspec.groups}
    toks = np.asarray([prompt], np.int32)
    _jl, jone = _jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _tl, tone = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)})
    jc = jcache.admit_cache(jspec, jspec.init_paged_cache(), jone,
                            jnp.int32(slot), jnp.int32(0),
                            jnp.int32(len(prompt)),
                            {k: jnp.asarray(v) for k, v in rows.items()})
    tc = tcache.admit_cache(tspec, tspec.init_paged_cache(
        torch.device("cpu")), tone, slot, 0, len(prompt), rows)
    return tspec, tc, jspec, jc


def _assert_cache(tc, jc, tol=1e-6):
    _assert_layers(tc["layers"], jc["layers"], tol)
    assert set(tc["page_tables"]) == set(jc["page_tables"])
    for k in jc["page_tables"]:
        np.testing.assert_array_equal(tc["page_tables"][k].numpy(),
                                      np.asarray(jc["page_tables"][k]))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("paged_kernel", [False, True])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_decode_vs_jax(width, paged_kernel):
    """12 decode steps after an 11-token prompt in slot 1 (slot 0 idle):
    the window-16 ring (2 pages of 8) wraps.  Logits, pools and states
    as the reference's gather path at every step; the port reads pools
    through the gather path or the kernel's plain version."""
    cfg, tp, jcfg, jp = _build(width)
    prompt = [(3 * j) % 200 + 1 for j in range(11)]
    _ts, tc, _js, jc = _paged_pair(cfg, tp, jcfg, jp, prompt)
    rs = np.random.RandomState(1)
    for _step in range(12):
        toks = rs.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        wm = np.asarray([False, True])
        jl, jc = _jax_decode(jp, jcfg, jnp.asarray(toks), jc,
                             write_mask=jnp.asarray(wm), paged_kernel=False)
        tl, tc = forward_decode(tp, cfg, torch.as_tensor(toks), tc,
                                write_mask=torch.as_tensor(wm),
                                paged_kernel=paged_kernel)
        _close(tl[1:], jl[1:])
        _assert_cache(tc, jc, tol=1e-4)
    assert int(tc["len"][1]) == 23


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
    assert [ls.kind for ls in ts.layers] == [ls.kind for ls in js.layers]
    assert tcache.STATE == jcache.STATE and tcache.PAGED_KV == jcache.PAGED_KV
    for tl, jl in zip(ts.layers, js.layers):
        assert (tl.ring_blocks, tl.window, tl.group) == \
            (jl.ring_blocks, jl.window, jl.group)
        if jl.kind == jcache.STATE:
            assert tl.state == {k: shp for k, (shp, _ax) in
                                jl.state.items()}
    assert [dataclasses.astuple(g) for g in ts.groups] == \
        [dataclasses.astuple(g) for g in js.groups]
    assert (ts.num_pages, ts.trash_page, ts.max_blocks, ts.has_paged) == \
        (js.num_pages, js.trash_page, js.max_blocks, js.has_paged)
    assert not ts.prefix_sharing_capable and not js.prefix_sharing_capable
    assert ts.blocks_needed(30, 40) == js.blocks_needed(30, 40)
    assert ts.memory_stats({}, 0) == js.memory_stats({}, 0)
    busy = {g.key: 2 for g in ts.groups}
    assert ts.memory_stats(busy, 17) == js.memory_stats(busy, 17)
    # the zeroed caches: the same leaves, shapes and dtypes
    tc = ts.init_paged_cache(torch.device("cpu"))
    jc = js.init_paged_cache()
    for t, j in zip(tc["layers"], jc["layers"]):
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
        assert all(not bool(v.any()) for v in t.values())


def test_admit_cache_state_splice_vs_jax(models):
    """Two admissions into a 3-slot cache (slot 2, then slot 0): KV pools,
    tables, lengths and every state row as the reference's; the third
    slot's state rows stay zero."""
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
        rows = {g.key: np.asarray([slot * 2 + 1, slot * 2], np.int32)
                for g in tspec.groups}
        jc = jcache.admit_cache(jspec, jc, jone, jnp.int32(slot),
                                jnp.int32(0), jnp.int32(plen),
                                {k: jnp.asarray(v) for k, v in rows.items()})
        out = tcache.admit_cache(tspec, tc, tone, slot, 0, plen, rows)
        assert out is tc
        _assert_cache(tc, jc, tol=1e-5)
    for ls, layer in zip(tspec.layers, tc["layers"]):
        if ls.kind == tcache.STATE:
            assert not bool(layer["ssm"][1].any())
            assert not bool(layer["conv"][1].any())


def test_segments_refuse_state_layers(models):
    cfg, tp, _jcfg, _jp = models
    spec = tcache.CacheSpec.from_config(cfg, 1, 64, page_size=8)
    cache = spec.init_paged_cache(torch.device("cpu"))
    _l, one = forward_prefill(tp, cfg, {"tokens": torch.ones(1, 8,
                                                             dtype=torch.int32)})
    rows = {g.key: np.arange(g.ring_blocks, dtype=np.int32)
            for g in spec.groups}
    with pytest.raises(ValueError, match="segment"):
        tcache.splice_prefill(spec, cache, one, 0, 8, rows)


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


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_engine_token_and_memory_parity(models, jax_run, paged_kernel):
    cfg, tp, _jcfg, _jp = models
    jtokens, jstats, jeng = jax_run
    eng = Engine(cfg, tp, device="cpu", paged_kernel=paged_kernel,
                 **ENGINE_KW)
    assert not eng.chunked_prefill
    eng.warmup()
    tokens, stats = _serve_rounds(eng, Request)
    assert tokens == jtokens
    assert [len(tokens[i]) for i in range(len(LENS))] == BUDGETS
    assert stats == jstats
    assert eng.buckets == jeng.buckets == [8, 16, 32, 64, 128]
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.prefix_stats()["prefix_hits"] == 0
    assert eng.leaked_pages() == 0


def test_engine_mode_contract(models):
    cfg, tp, _jcfg, _jp = models
    assert not Engine(cfg, tp, device="cpu").chunked_prefill
    with pytest.raises(ValueError, match="chunked_prefill"):
        Engine(cfg, tp, device="cpu", chunked_prefill=True)


# ---------------------------------------------------------------------------
# the shared attention's head dim at full width: 112
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"causal": True, "window": 48},
                                {"causal": True, "window": 4096},
                                {"causal": False}])
def test_flash_ref_dh112_vs_jax(kw):
    rs = np.random.RandomState(112)
    q, k, v = (rs.randn(1, 4, 100, 112).astype(np.float32) * s
               for s in (0.5, 0.5, 1.0))
    got = flash_attention_ref(*map(torch.as_tensor, (q, k, v)), **kw)
    want = jax_flash_ref(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    fa_ops._check(*map(torch.as_tensor, (q, k, v)),
                  causal=kw.get("causal", True))
