"""PyTorch port: the two-executable serving path (``chunked_prefill=False``)
against the JAX reference on the same weights.

* ``forward_prefill`` with bucket padding (``length``) and as a suffix
  prefill against paged context: logits and cache at atol 1e-4.
* ``splice_paged_layer`` and ``admit_cache``: fp32 pools equal, int8 and
  fp8_e4m3 codes and scales bitwise equal to the reference's eager
  functions (its fp32 splice re-quantized page by page where the span is
  wider than the ring), on pad tokens, a non-page-aligned copy-on-write
  start, a windowed ring that wraps inside the bucket and a bucket as
  wide as the ring.
* ``Engine(chunked_prefill=False)``: greedy tokens, prefix and memory
  statistics identical to the JAX legacy ``Engine`` on reduced internlm2
  (more requests than slots, a prefix hit with CoW, overlong prompts run
  as segments with ``buckets=[8, 16]``, ``max_new_tokens=1``), and
  identical to the port's own fused engine for prefill budgets 3/8/13.
  8-bit pools are held on the chain-overfit model in
  ``tests/test_torch_quantized.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import forward_prefill  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "internlm2-1.8b"
PROMPTS = [[(7 * j + i) % 200 + 1 for j in range(3 + 9 * i)]
           for i in range(5)]            # lengths 3, 12, 21, 30, 39
ENGINE_KW = dict(slots=3, max_len=96, sync_interval=4, seed=0)
KV_DTYPES = ["fp32", "int8", "fp8_e4m3"]
JAX_DTYPES = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
_jax_prefill = jax.jit(jax_forward_prefill, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config(ARCH))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return reduced(get_config(ARCH)), tp, jcfg, jp


def _bits(x):
    """Raw bytes of a torch or jax/numpy array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.element_size() == 1:
            return x.view(torch.uint8).numpy()
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint8) if a.itemsize == 1 else a.view(np.uint32)


def _to_torch(x):
    """A jax/numpy array as a torch tensor of the same dtype (fp8 through
    its bytes)."""
    a = np.asarray(x)
    if a.dtype == np.dtype(jnp.float8_e4m3fn):
        return torch.as_tensor(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.as_tensor(a.copy())


# ---------------------------------------------------------------------------
# forward_prefill
# ---------------------------------------------------------------------------

def test_forward_prefill_padded_vs_jax(models):
    """A 13-token prompt padded to a 16-token bucket: logits at position
    12 and the whole cache (padding included) as the reference's."""
    cfg, tp, jcfg, jp = models
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = [(5 * j) % 200 + 1 for j in range(13)]
    jl, jc = _jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          length=jnp.asarray([13], jnp.int32))
    tl, tc = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                             length=torch.tensor([13], dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert tc["len"].tolist() == [13]
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        for key in ("k", "v"):
            assert tuple(tl_[key].shape) == (1, cfg.num_kv_heads, 16,
                                             cfg.resolved_head_dim)
            np.testing.assert_allclose(tl_[key].numpy(),
                                       np.asarray(jl_[key]), rtol=0,
                                       atol=1e-4)
    # unpadded: the last row, len = S
    tl2, tc2 = forward_prefill(tp, cfg,
                               {"tokens": torch.as_tensor(toks[:, :13])})
    np.testing.assert_allclose(tl2.numpy(), tl.numpy(), rtol=0, atol=1e-5)
    assert tc2["len"].tolist() == [13]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_forward_prefill_with_ctx_vs_jax(models, kv_dtype):
    """A 10-token suffix at offset 11 attends to 11 context tokens read
    through a page row (pages 3, 0, then trash) from random pools."""
    cfg, tp, jcfg, jp = models
    tspec = tcache.CacheSpec.from_config(cfg, 2, 64, page_size=8,
                                         kv_dtype=kv_dtype)
    tc = tspec.init_paged_cache(torch.device("cpu"))
    rs = np.random.RandomState(3)
    jlayers = []
    for tl_ in tc["layers"]:
        entry = {}
        for pool, sc in (("pk", "ks"), ("pv", "vs")):
            x = rs.randn(*tl_[pool].shape).astype(np.float32)
            if kv_dtype == "fp32":
                tl_[pool].copy_(torch.as_tensor(x))
                entry[pool] = jnp.asarray(x)
            else:
                jq, js = jatt.quantize_pages(jnp.asarray(x),
                                             JAX_DTYPES[kv_dtype])
                tl_[pool].copy_(_to_torch(jq))
                tl_[sc].copy_(_to_torch(js))
                entry[pool], entry[sc] = jq, js
        jlayers.append(entry)
    trash = tspec.trash_page
    row = np.array([3, 0, trash, trash], np.int32)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = [(3 * j) % 200 + 1 for j in range(10)]
    jl, jcc = jax_forward_prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks)},
        length=jnp.asarray([10], jnp.int32),
        ctx={"off": jnp.int32(11), "row": jnp.asarray(row),
             "layers": jlayers})
    tl, tcc = forward_prefill(
        tp, cfg, {"tokens": torch.as_tensor(toks)},
        length=torch.tensor([10], dtype=torch.int32),
        ctx={"off": 11, "row": torch.as_tensor(row),
             "layers": tc["layers"]})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for tl_, jl_ in zip(tcc["layers"], jcc["layers"]):
        np.testing.assert_allclose(tl_["k"].numpy(), np.asarray(jl_["k"]),
                                   rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# splice_paged_layer / admit_cache
# ---------------------------------------------------------------------------

# (start, valid_len, bucket, ring_blocks): pads after a full prefill; a
# suffix at a non-page-aligned start (CoW: the page keeps its earlier
# tokens); a windowed ring of 2 pages wrapping inside a 16-token bucket,
# from 0 and from a non-aligned start; a bucket that is exactly full; a
# short prompt in a bucket as wide as the ring
SPLICE_CASES = [(0, 11, 16, 8), (6, 9, 16, 8), (0, 13, 16, 2),
                (3, 16, 16, 2), (8, 8, 8, 8), (0, 5, 8, 2)]


def _quantized_splice_oracle(qpool, qscale, pre, row, start, valid,
                             ring_blocks, P, trash):
    """What an 8-bit splice must leave: the reference's fp32 splice on the
    dequantized pool, with every page that received a token re-quantized
    (the others keep their codes and scales)."""
    deq = jatt.dequantize_pages(qpool, qscale)
    fp, _ = jcache.splice_paged_layer(
        deq, deq, jnp.asarray(pre), jnp.asarray(pre), jnp.asarray(row),
        jnp.int32(start), jnp.int32(valid), ring_blocks, P, trash)
    bucket = pre.shape[2]
    g = start + np.arange(valid)
    if bucket > ring_blocks * P:
        g = g[g >= start + valid - ring_blocks * P]
    touched = sorted({int(row[b]) for b in (g // P) % ring_blocks} - {trash})
    touched = np.asarray(touched, np.int32)
    q, s = jatt.quantize_pages(fp[touched], qpool.dtype)
    return qpool.at[touched].set(q), qscale.at[touched].set(s), touched


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("start,valid,bucket,ring_blocks", SPLICE_CASES)
def test_splice_paged_layer_vs_jax(kv_dtype, start, valid, bucket,
                                   ring_blocks):
    rs = np.random.RandomState(start + valid + ring_blocks)
    P, hkv, dh, npg = 4, 2, 8, 12
    trash = npg
    pools = [rs.randn(npg + 1, P, hkv, dh).astype(np.float32) * 2
             for _ in range(2)]
    pre = [rs.randn(1, hkv, bucket, dh).astype(np.float32) * 3
           for _ in range(2)]
    row = rs.permutation(npg)[:ring_blocks].astype(np.int32)
    if ring_blocks > 4:
        row[-2:] = trash                   # reservation ran out
    args = (np.asarray(row), start, valid, ring_blocks, P, trash)
    jpre = [jnp.asarray(x) for x in pre]
    tpre = [torch.as_tensor(x) for x in pre]
    if kv_dtype == "fp32":
        jk, jv = jcache.splice_paged_layer(
            *(jnp.asarray(x) for x in pools), *jpre, jnp.asarray(row),
            jnp.int32(start), jnp.int32(valid), ring_blocks, P, trash)
        tk, tv = (torch.as_tensor(x.copy()) for x in pools)
        assert tcache.splice_paged_layer(
            tk, tv, *tpre, torch.as_tensor(row), start, valid, ring_blocks,
            P, trash) is None
        np.testing.assert_array_equal(tk.numpy()[:trash],
                                      np.asarray(jk)[:trash])
        np.testing.assert_array_equal(tv.numpy()[:trash],
                                      np.asarray(jv)[:trash])
        return
    qs = [jatt.quantize_pages(jnp.asarray(x), JAX_DTYPES[kv_dtype])
          for x in pools]
    tk, tv = _to_torch(qs[0][0]), _to_torch(qs[1][0])
    tks, tvs = _to_torch(qs[0][1]), _to_torch(qs[1][1])
    tcache.splice_paged_layer(tk, tv, *tpre, torch.as_tensor(row), start,
                              valid, ring_blocks, P, trash, scale_k=tks,
                              scale_v=tvs)
    (wk, wks, touched), (wv, wvs, _) = (
        _quantized_splice_oracle(*q, x, *args) for q, x in zip(qs, pre))
    assert len(touched) > 0
    for got, want in ((tk, wk), (tv, wv), (tks, wks), (tvs, wvs)):
        np.testing.assert_array_equal(_bits(got)[:trash],
                                      _bits(want)[:trash])
    assert bool(torch.isfinite(tks).all())
    if (bucket - 1) // P + 2 <= ring_blocks:
        # no two pages of the span share a ring slot: the reference's
        # quantized splice leaves the same pools
        jk, jv, jks, jvs = jcache.splice_paged_layer(
            qs[0][0], qs[1][0], *jpre, jnp.asarray(row), jnp.int32(start),
            jnp.int32(valid), ring_blocks, P, trash, scale_k=qs[0][1],
            scale_v=qs[1][1])
        for got, want in ((tk, jk), (tv, jv), (tks, jks), (tvs, jvs)):
            np.testing.assert_array_equal(_bits(got)[:trash],
                                          _bits(want)[:trash])


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_admit_cache_vs_jax(models, kv_dtype):
    """``admit_cache`` on a CacheSpec: pools (bitwise for 8-bit), the
    slot's table row and ``len``; the other slots untouched."""
    cfg, _tp, jcfg, _jp = models
    tspec = tcache.CacheSpec.from_config(cfg, 3, 64, page_size=8,
                                         kv_dtype=kv_dtype)
    jspec = jcache.CacheSpec.from_config(jcfg, 3, 64, page_size=8,
                                         kv_dtype=kv_dtype)
    tc = tspec.init_paged_cache(torch.device("cpu"))
    jc = jspec.init_paged_cache()
    rs = np.random.RandomState(7)
    one = [{k: rs.randn(1, cfg.num_kv_heads, 16, cfg.resolved_head_dim)
            .astype(np.float32) for k in ("k", "v")} for _ in cfg.blocks]
    key = tspec.groups[0].key
    nb = tspec.groups[0].ring_blocks
    rows = np.full((nb,), tspec.trash_page, np.int32)
    rows[:3] = [5, 2, 9]
    start, plen = 5, 18                    # a suffix of 13 at offset 5
    assert tcache.admit_cache(
        tspec, tc, {"layers": [{k: torch.as_tensor(v) for k, v in e.items()}
                               for e in one]},
        1, start, plen, {key: rows}) is tc
    jc = jcache.admit_cache(
        jspec, jc, {"layers": [{k: jnp.asarray(v) for k, v in e.items()}
                               for e in one]},
        jnp.int32(1), jnp.int32(start), jnp.int32(plen),
        {key: jnp.asarray(rows)})
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [0, 18, 0]
    np.testing.assert_array_equal(tc["page_tables"][key].numpy(),
                                  np.asarray(jc["page_tables"][key]))
    trash = tspec.trash_page
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        for k in tl_:
            np.testing.assert_array_equal(_bits(tl_[k])[:trash],
                                          _bits(jl_[k])[:trash])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_admit_cache_bucket_as_wide_as_ring(models, kv_dtype):
    """A 20-token prompt prefilled in a 32-token bucket as wide as the
    ring (max_len 32, pages of 8: J = 5 logical pages over 4 ring slots):
    its three pages hold its KV, to within the quantization step."""
    cfg, _tp, _jcfg, _jp = models
    spec = tcache.CacheSpec.from_config(cfg, 2, 32, page_size=8,
                                        kv_dtype=kv_dtype)
    key, nb = spec.groups[0].key, spec.groups[0].ring_blocks
    assert nb * spec.page_size == 32
    cache = spec.init_paged_cache(torch.device("cpu"))
    rs = np.random.RandomState(3)
    one = [{k: rs.randn(1, cfg.num_kv_heads, 32, cfg.resolved_head_dim)
            .astype(np.float32) for k in ("k", "v")} for _ in cfg.blocks]
    rows = np.full((nb,), spec.trash_page, np.int32)
    rows[:3] = [4, 1, 6]
    tcache.admit_cache(spec, cache, {"layers": [
        {k: torch.as_tensor(v) for k, v in e.items()} for e in one]},
        0, 0, 20, {key: rows})
    tol = 1 / 127 if kv_dtype == "int8" else 1 / 8
    for big, small in zip(cache["layers"], one):
        for pk, sk, name in (("pk", "ks", "k"), ("pv", "vs", "v")):
            deq = big[pk].float() * big[sk][:, None, :, None]
            got = deq[torch.as_tensor(rows[:3])].reshape(24, *deq.shape[2:])
            want = small[name][0].transpose(1, 0, 2)[:20]
            assert not bool(got[20:].any())
            err = np.abs(got[:20].numpy() - want)
            amax = np.abs(want).max(axis=(0, 2), keepdims=True)
            assert (err <= tol * amax).all()


# ---------------------------------------------------------------------------
# the two-executable engine: greedy tokens of the JAX legacy Engine
# ---------------------------------------------------------------------------

def _serve(eng, prompts, max_new, rid0=0):
    for i, p in enumerate(prompts):
        eng.submit((Request if isinstance(eng, Engine) else JRequest)(
            rid=rid0 + i, prompt=list(p), max_new_tokens=max_new))
    done = eng.run(max_steps=50_000)
    return {r.rid: list(r.out_tokens) for r in done if r.rid >= rid0}


@pytest.fixture(scope="module")
def jax_legacy_run(models):
    _cfg, _tp, jcfg, jp = models
    eng = JEngine(jcfg, jp, chunked_prefill=False, **ENGINE_KW)
    assert not eng.chunked_prefill and not eng.paged_kernel
    return _serve(eng, PROMPTS, 10), eng


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_legacy_engine_token_parity(models, jax_legacy_run, paged_kernel):
    """5 requests through 3 slots; decode through the gather path and the
    kernel's plain version; warmup stays inert."""
    cfg, tp, _jcfg, _jp = models
    want, jeng = jax_legacy_run
    eng = Engine(cfg, tp, chunked_prefill=False, paged_kernel=paged_kernel,
                 device="cpu", **ENGINE_KW)
    assert not eng.chunked_prefill and eng.buckets == [8, 16, 32, 64, 128]
    assert eng.spec.spec_tokens == 0 and "prompt" not in eng.state
    eng.warmup()
    assert _serve(eng, PROMPTS, 10) == want
    assert eng.leaked_pages() == 0
    assert eng.memory_stats() == jeng.memory_stats()
    assert eng.prefix_stats() == jeng.prefix_stats()


@pytest.mark.parametrize("budget", [3, 8, 13])
def test_legacy_engine_matches_fused(models, jax_legacy_run, budget):
    """The port's fused engine gives the two-executable engine's tokens
    for budgets below a page, page-aligned and straddling a page."""
    cfg, tp, _jcfg, _jp = models
    eng = Engine(cfg, tp, prefill_budget=budget, device="cpu", **ENGINE_KW)
    assert eng.chunked_prefill
    assert _serve(eng, PROMPTS, 10) == jax_legacy_run[0]


def _both_engines(models, **kw):
    cfg, tp, jcfg, jp = models
    return (Engine(cfg, tp, chunked_prefill=False, device="cpu", **kw),
            JEngine(jcfg, jp, chunked_prefill=False, **kw))


def test_legacy_prefix_hit_with_cow_parity(models):
    """Admission-time radix insert: a later request sharing 21 tokens (two
    full pages and 5 of the third) hits, copies the partial page, and
    suffix-prefills against the shared pages; in the second wave two
    requests admitted at one boundary both hit."""
    head = [(3 * j) % 200 + 1 for j in range(21)]
    waves = [[head + [30, 31, 32]], [head + [40, 41, 42], head + [77]]]
    eng, jeng = _both_engines(models, slots=2, max_len=96, sync_interval=4,
                              seed=0)
    got, want = {}, {}
    for w, prompts in enumerate(waves):
        got.update(_serve(eng, prompts, 6, rid0=10 * w))
        want.update(_serve(jeng, prompts, 6, rid0=10 * w))
    assert got == want
    ps = eng.prefix_stats()
    assert ps == jeng.prefix_stats()
    assert ps["prefix_hits"] == 2 and ps["cow_copies"] == 2
    assert eng.leaked_pages() == 0


def test_legacy_overlong_prompts_as_segments(models):
    """Prompts longer than the largest bucket (16) run as 16-token
    segments, each a suffix prefill over the pages the earlier ones
    spliced; no bucket is added."""
    prompts = [[(11 * j) % 250 + 1 for j in range(37)],
               [(5 * j) % 200 + 3 for j in range(50)], [3, 1, 4]]
    eng, jeng = _both_engines(models, slots=2, max_len=96, sync_interval=4,
                              seed=0, buckets=[8, 16])
    got = _serve(eng, prompts, 7)
    assert got == _serve(jeng, prompts, 7)
    assert eng.buckets == [8, 16]
    assert eng.leaked_pages() == 0
    # and the same tokens as one full prefill per prompt
    single, _ = _both_engines(models, slots=2, max_len=96, sync_interval=4,
                              seed=0)
    assert _serve(single, prompts, 7) == got


def test_legacy_max_new_one_decodes_nothing(models):
    """A max_new_tokens=1 request ends with its prefill-sampled token: the
    slot is never armed for decode."""
    eng, jeng = _both_engines(models, **ENGINE_KW)
    got = _serve(eng, PROMPTS[:4], 1)
    assert got == _serve(jeng, PROMPTS[:4], 1)
    assert all(len(t) == 1 for t in got.values())
    assert not bool(eng.state["active"].any())
    assert eng.leaked_pages() == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_reference_padded_quantized_splice_drops_the_prompt(kv_dtype):
    """A quirk of the reference, pinned so that it is not taken for a port
    fault (ROADMAP C): its legacy engine pads every prefill's KV to the
    largest bucket, and when that padded span (128 tokens, J = 17 pages)
    is wider than the ring (12 pages of 8), the quantized splice's
    aliasing rule keeps only logical pages 5.. and sends a 17-token
    prompt's pages 0-2 to the trash page.  The port's splice of the same
    padded span groups tokens by ring slot, and the prompt lands in its
    pages."""
    P, hkv, dh, npg, trash = 8, 2, 16, 30, 30
    rs = np.random.RandomState(0)
    kv = rs.randn(1, hkv, 128, dh).astype(np.float32)
    row = np.arange(12, dtype=np.int32)
    qdt = JAX_DTYPES[kv_dtype]
    pool = jnp.zeros((npg + 1, P, hkv, dh), qdt)
    scale = jnp.full((npg + 1, hkv), 1e-30, jnp.float32)
    jk, _jv, _sk, _sv = jcache.splice_paged_layer(
        pool, pool, jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(row),
        jnp.int32(0), jnp.int32(17), 12, P, trash, scale_k=scale,
        scale_v=scale)
    assert not np.asarray(jk[:trash]).astype(np.float32).any()
    tk, tv = _to_torch(pool), _to_torch(pool)
    tsk, tsv = _to_torch(scale), _to_torch(scale)
    tcache.splice_paged_layer(tk, tv, torch.as_tensor(kv),
                              torch.as_tensor(kv),
                              torch.as_tensor(row), 0, 17, 12, P, trash,
                              scale_k=tsk, scale_v=tsv)
    written = [i for i in range(trash) if bool(tk[i].float().abs().sum())]
    assert written == [0, 1, 2]


def test_legacy_warmup_keeps_sampled_runs_reproducible(models):
    """Sampled decoding (temperature, top-k): the first token is drawn on
    the device by the prefill, and warmup's inert prefills and chunk
    restore the generator, so a seeded run is the same with or without
    warmup."""
    cfg, tp, _jcfg, _jp = models
    runs = []
    for warm in (False, True):
        eng = Engine(cfg, tp, chunked_prefill=False, temperature=1.0,
                     top_k=5, device="cpu", **ENGINE_KW)
        if warm:
            eng.warmup()
        runs.append(_serve(eng, PROMPTS, 6))
    assert runs[0] == runs[1]
    assert all(len(t) == 6 for t in runs[0].values())


def test_chunked_prefill_auto_is_fused(models):
    cfg, tp, _jcfg, _jp = models
    eng = Engine(cfg, tp, device="cpu", **ENGINE_KW)
    assert eng.chunked_prefill and eng.spec.spec_tokens == 31
