"""PyTorch port: int8 and fp8_e4m3 paged KV pools against the JAX reference.

Same numpy inputs on both sides, at these tolerances:

* ``quantize_pages`` / ``dequantize_pages`` / ``rmw_quantized_pages``:
  bitwise-equal codes and scales (fp8 compared through uint8 views) —
  the port keeps the reference's order of operations exactly.
* The plain ``paged_attention_ref`` with scales against JAX's ref and its
  interpret-mode Pallas kernel, and ``paged_decode_step`` on quantized
  pools (pools and scales bitwise, outputs): atol 1e-5, fp32 summed in
  another order.
* ``CacheSpec`` byte accounting and ``memory_stats``: equal field for
  field.
* The fused engine on 8-bit pools: greedy tokens identical to the JAX
  ``Engine`` at the same ``kv_dtype``, on the reduced internlm2 overfit
  in JAX on a token chain (as ``fig14``'s ``quantized_pool_comparison``):
  at random init the top-1/top-2 logit gap sits below the 8-bit
  rounding noise, so token agreement would measure noise.
* The Hopper kernel on 8-bit pools against its plain version (atol
  1e-4) runs only where ``ops.supported(kv_dtype)`` passes; here it
  skips.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.paged_attention import paged_attention_ref as jax_ref  # noqa: E402,E501
from repro.kernels.paged_attention import \
    paged_decode_attention as jax_kernel  # noqa: E402
from repro.kernels.paged_attention import supported as jax_supported  # noqa: E402,E501
from repro.models import attention as jatt  # noqa: E402
from repro.models import forward_train as jax_forward_train  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_ref  # noqa: E402,E501
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "internlm2-1.8b"
ATOL = 1e-5
KV_DTYPES = ["int8", "fp8_e4m3"]
JAX_DTYPES = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
MODES = {"full": {}, "window": {"window": 12}, "softcap": {"softcap": 20.0}}

_jax_ref = jax.jit(jax_ref, static_argnames=("window", "softcap"))
# The quantizing reference functions run eagerly, op by op: under jit XLA
# may rewrite the divide by qmax and move a scale by an ulp, and the
# transcription is held bitwise to the reference's operations.
_jax_step = jatt.paged_decode_step
_jax_rmw = jatt.rmw_quantized_pages


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
    its bytes: torch does not take ml_dtypes arrays)."""
    a = np.asarray(x)
    if a.dtype == np.dtype(jnp.float8_e4m3fn):
        return torch.as_tensor(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.as_tensor(a.copy())


def _quantized_pools(rs, shape, kv_dtype, scale=1.0):
    """fp32 pages from ``rs`` quantized by the JAX reference -> jax
    (pool, scales), torch (pool, scales)."""
    x = (rs.randn(*shape) * scale).astype(np.float32)
    jq, js = jatt.quantize_pages(jnp.asarray(x), JAX_DTYPES[kv_dtype])
    return (jq, js), (_to_torch(jq), _to_torch(js))


# ---------------------------------------------------------------------------
# (a) quantize / dequantize / RMW: bitwise against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("page_size,hkv", [(4, 1), (8, 2), (16, 4)])
def test_quantize_dequantize_rmw_bitwise(kv_dtype, page_size, hkv):
    rs = np.random.RandomState(page_size + hkv)
    dh, npg = 16, 9
    # pages of very different magnitudes, one all-zero (floor scale)
    x = (rs.randn(npg + 1, page_size, hkv, dh)
         * np.exp(rs.randn(npg + 1, 1, hkv, 1) * 3)).astype(np.float32)
    x[2] = 0.0
    jq, js = jatt.quantize_pages(jnp.asarray(x), JAX_DTYPES[kv_dtype])
    pool_dtype = tcache.kv_pool_dtype(kv_dtype)
    tq, ts = tatt.quantize_pages(torch.as_tensor(x), pool_dtype)
    assert tq.dtype == pool_dtype and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(
        tatt.dequantize_pages(tq, ts).numpy(),
        np.asarray(jatt.dequantize_pages(jq, js)))
    assert bool((tatt.dequantize_pages(tq, ts)[2] == 0).all())

    # RMW of [B, J] pages with duplicate trash entries and partial writes
    trash = npg
    phys = np.array([[0, 3, trash], [5, trash, trash], [7, 1, 8]])
    new = rs.randn(3, 3, page_size, hkv, dh).astype(np.float32) * 2
    wrote = rs.rand(3, 3, page_size) < 0.4
    wrote[1, 0] = False                 # a page re-quantized unchanged
    jpool, jscale = _jax_rmw(jq, js, jnp.asarray(phys), jnp.asarray(new),
                             jnp.asarray(wrote))
    tpool, tscale = tq.clone(), ts.clone()
    assert tatt.rmw_quantized_pages(tpool, tscale, torch.as_tensor(phys),
                                    torch.as_tensor(new),
                                    torch.as_tensor(wrote)) is None
    np.testing.assert_array_equal(_bits(tpool)[:trash],
                                  _bits(jpool)[:trash])
    np.testing.assert_array_equal(_bits(tscale)[:trash],
                                  _bits(jscale)[:trash])
    assert bool(torch.isfinite(tscale).all()) and bool((tscale > 0).all())


def test_kv_pool_qmax():
    assert tatt.kv_pool_qmax(torch.int8) == jatt.kv_pool_qmax(jnp.int8)
    assert (tatt.kv_pool_qmax(torch.float8_e4m3fn)
            == jatt.kv_pool_qmax(jnp.float8_e4m3fn))
    assert tatt.kv_pool_qmax(torch.float32) is None


# ---------------------------------------------------------------------------
# (b) the plain version with scales against JAX's ref and interpret kernel
# ---------------------------------------------------------------------------

def _attn_case(s, kv_dtype, seed, h=4, hkv=2, page_size=4, nb=4, dh=16,
               b=4):
    """Quantized pools, distinct pages per slot, slot 0 with an all-trash
    tail, slot 3 dead (all trash); cache lengths un-aligned, one wrapped
    past the ring."""
    rs = np.random.RandomState(seed)
    npg = 4 * nb
    q = (rs.randn(b, s, h, dh) * 0.5).astype(np.float32)
    (jk, jks), (tk, tks) = _quantized_pools(
        rs, (npg + 1, page_size, hkv, dh), kv_dtype, 0.5)
    (jv, jvs), (tv, tvs) = _quantized_pools(
        rs, (npg + 1, page_size, hkv, dh), kv_dtype)
    pt = np.stack([rs.permutation(npg)[:nb] for _ in range(b)])
    pt[0, -max(1, nb // 2):] = npg
    pt[3] = npg
    ring = page_size * nb
    cl = np.array([ring - 3, s + page_size + 1, 2 * ring + 5, 7], np.int32)
    pt = pt.astype(np.int32)
    jargs = (q, jk, jv, pt, cl)
    jscales = dict(k_scale=jks, v_scale=jvs)
    targs = (torch.as_tensor(q), tk, tv, torch.as_tensor(pt),
             torch.as_tensor(cl))
    tscales = dict(k_scale=tks, v_scale=tvs)
    return jargs, jscales, targs, tscales


@pytest.fixture(scope="module")
def jax_interpret():
    if not jax_supported("int8"):
        pytest.skip("JAX Pallas interpret-mode probe failed")
    return jax.jit(functools.partial(jax_kernel, interpret=True),
                   static_argnames=("window", "softcap"))


@pytest.mark.parametrize("s", [1, 3, 5])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_plain_with_scales_vs_jax(jax_interpret, kv_dtype, mode, s):
    if kv_dtype == "fp8_e4m3" and not jax_supported("fp8_e4m3"):
        pytest.skip("JAX build has no fp8 Pallas interpret support")
    jargs, jscales, targs, tscales = _attn_case(
        s, kv_dtype, seed=10 * s + len(mode))
    kw = MODES[mode]
    got = paged_attention_ref(*targs, **tscales, **kw).numpy()
    want = np.asarray(_jax_ref(*jargs, **jscales, **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want_k = np.asarray(jax_interpret(*jargs, **jscales, **kw))
    np.testing.assert_allclose(got, want_k, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[3], 0.0)          # dead slot
    # the wrapper on CPU tensors is the plain version, with no launch
    before = ops.launches
    np.testing.assert_array_equal(
        ops.paged_attention(*targs, **tscales, **kw).numpy(), got)
    assert ops.launches == before


# ---------------------------------------------------------------------------
# (c) paged_decode_step on quantized pools: RMW writes, then attend
# ---------------------------------------------------------------------------

# (S, window, ring blocks): plain decode, windowed decode, a full ring,
# a multi-row step crossing pages (J = 3 of 4 blocks) and a windowed ring
# narrower than the touched span (J = 3 > 2 blocks) that wraps
STEP_CASES = [(1, None, 4), (1, 5, 2), (4, None, 4), (8, None, 4),
              (5, 2, 2)]


def _step_inputs(s, window, nb, kv_dtype, seed):
    rs = np.random.RandomState(seed)
    b, h, hkv, dh, page_size = 3, 4, 2, 16, 4
    npg = 12
    (jk, jks), (tk, tks) = _quantized_pools(
        rs, (npg + 1, page_size, hkv, dh), kv_dtype)
    (jv, jvs), (tv, tvs) = _quantized_pools(
        rs, (npg + 1, page_size, hkv, dh), kv_dtype)
    pt = np.stack([rs.permutation(npg)[:nb] for _ in range(b)])
    pt[2, -1] = npg                          # reservation ran out
    q = rs.randn(b, s, h, dh).astype(np.float32)
    kk = (rs.randn(b, s, hkv, dh) * 3).astype(np.float32)
    vv = (rs.randn(b, s, hkv, dh) * 3).astype(np.float32)
    ring = nb * page_size
    # slot 2's trash block is never a valid position (the trash page's
    # contents are scratch: duplicate RMW writes race there)
    cl = np.array([s + 2, ring + 3, page_size * (nb - 1)], np.int32)
    if s == 1:
        wm = np.array([True, True, False])
    else:                                    # right-aligned pad rows
        n = np.array([s, s - 1, 1])
        wm = np.arange(s)[None, :] >= (s - n)[:, None]
    jc = {"pk": jk, "pv": jv, "ks": jks, "vs": jvs, "pt": pt, "wm": wm}
    tc = {"pk": tk, "pv": tv, "ks": tks, "vs": tvs,
          "pt": torch.as_tensor(pt.astype(np.int32)),
          "wm": torch.as_tensor(wm)}
    return (q, kk, vv, cl), jc, tc


@pytest.mark.parametrize("paged_kernel", [False, True])
@pytest.mark.parametrize("s,window,nb", STEP_CASES)
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_paged_decode_step_quantized_vs_jax(kv_dtype, s, window, nb,
                                            paged_kernel):
    (q, kk, vv, cl), jc, tc = _step_inputs(s, window, nb, kv_dtype,
                                           seed=7 * s + nb)
    jout, jnew = _jax_step(q, kk, vv, jc, cl, window=window, softcap=None,
                           paged_kernel=paged_kernel)
    pools = {k: tc[k] for k in ("pk", "pv", "ks", "vs")}
    tout, tnew = tatt.paged_decode_step(
        *(torch.as_tensor(x) for x in (q, kk, vv)), tc, torch.as_tensor(cl),
        window=window, softcap=None, paged_kernel=paged_kernel)
    # in place, and the scale pools ride along in the returned cache
    assert set(tnew) == {"pk", "pv", "ks", "vs"}
    assert all(tnew[k] is pools[k] for k in pools)
    trash = pools["pk"].shape[0] - 1
    for key in pools:
        np.testing.assert_array_equal(_bits(tnew[key])[:trash],
                                      _bits(jnew[key])[:trash], err_msg=key)
    assert bool(torch.isfinite(tnew["ks"]).all())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# (d) CacheSpec: byte accounting, scale floor, copy-on-write with scales
# ---------------------------------------------------------------------------

SIZES = [(4, 96, 8, 0), (3, 100, 4, 31), (8, 1024, 16, 31)]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("which", ["reduced", "full"])
@pytest.mark.parametrize("slots,max_len,page_size,spec_tokens", SIZES)
def test_quantized_cachespec_matches_reference(kv_dtype, which, slots,
                                               max_len, page_size,
                                               spec_tokens):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if which == "reduced":
        cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
    kw = dict(page_size=page_size, spec_tokens=spec_tokens,
              kv_dtype=kv_dtype)
    t = tcache.CacheSpec.from_config(cfg, slots, max_len, **kw)
    j = jcache.CacheSpec.from_config(jcfg, slots, max_len, **kw)
    assert (t.quantized, t.kv_dtype_bytes) == (j.quantized, j.kv_dtype_bytes)
    assert t.pool_dtype == tcache.kv_pool_dtype(kv_dtype)
    for g_t, g_j in zip(t.groups, j.groups):
        assert t.scale_shape_for(g_t) == j.scale_shape_for(g_j)
        assert t.group_page_bytes(g_t) == j.group_page_bytes(g_j)
        assert t.group_page_bytes(g_t, 4) == j.group_page_bytes(g_j, 4)
    assert t.paged_kv_bytes() == j.paged_kv_bytes()
    assert t.paged_kv_bytes(4) == j.paged_kv_bytes(4)
    use = {g.key: g.num_pages // 3 for g in t.groups}
    assert t.memory_stats(use, 123) == j.memory_stats(use, 123)
    assert t.memory_stats({}, 0) == j.memory_stats({}, 0)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_init_has_scale_floor(kv_dtype):
    cfg, jcfg = reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH))
    t = tcache.CacheSpec.from_config(cfg, 3, 64, page_size=8,
                                     kv_dtype=kv_dtype)
    j = jcache.CacheSpec.from_config(jcfg, 3, 64, page_size=8,
                                     kv_dtype=kv_dtype)
    tc = t.init_paged_cache(torch.device("cpu"))
    jc = j.init_paged_cache()
    for tl, jl in zip(tc["layers"], jc["layers"]):
        assert set(tl) == set(jl) == {"pk", "pv", "ks", "vs"}
        for key in tl:
            assert tuple(tl[key].shape) == tuple(jl[key].shape)
            np.testing.assert_array_equal(_bits(tl[key]), _bits(jl[key]))
        assert tl["pk"].dtype == tcache.kv_pool_dtype(kv_dtype)
        assert bool((tl["ks"] == np.float32(1e-30)).all())
        # an unwritten page dequantizes to exact zeros
        assert bool((tatt.dequantize_pages(tl["pk"], tl["ks"]) == 0).all())


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_copy_shared_page_carries_scales(kv_dtype):
    cfg, jcfg = reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH))
    t = tcache.CacheSpec.from_config(cfg, 2, 64, page_size=8,
                                     kv_dtype=kv_dtype)
    j = jcache.CacheSpec.from_config(jcfg, 2, 64, page_size=8,
                                     kv_dtype=kv_dtype)
    tc = t.init_paged_cache(torch.device("cpu"))
    jc = j.init_paged_cache()
    rs = np.random.RandomState(3)
    jlayers = []
    for tl in tc["layers"]:
        entry = {}
        for pool, sc in (("pk", "ks"), ("pv", "vs")):
            (jq, js), (tq, ts) = _quantized_pools(
                rs, tuple(tl[pool].shape), kv_dtype)
            tl[pool].copy_(tq)
            tl[sc].copy_(ts)
            entry[pool], entry[sc] = jq, js
        jlayers.append(entry)
    jc = dict(jc, layers=jlayers)
    key = t.groups[0].key
    assert tcache.copy_shared_page(t, tc, key, 1, 4) is tc
    jc = jcache.copy_shared_page(j, jc, key, jnp.int32(1), jnp.int32(4))
    for tl, jl in zip(tc["layers"], jc["layers"]):
        for k in ("pk", "pv", "ks", "vs"):
            np.testing.assert_array_equal(_bits(tl[k]), _bits(jl[k]))
        np.testing.assert_array_equal(
            tatt.dequantize_pages(tl["pk"][4], tl["ks"][4]).numpy(),
            tatt.dequantize_pages(tl["pk"][1], tl["ks"][1]).numpy())


# ---------------------------------------------------------------------------
# (e) the fused engine on 8-bit pools: greedy tokens of the JAX Engine
# ---------------------------------------------------------------------------

def _chain(start, n, vocab):
    toks = [start % vocab]
    for _ in range(n - 1):
        toks.append((toks[-1] * 31 + 17) % vocab)
    return toks


@pytest.fixture(scope="module")
def chain_model():
    """Reduced internlm2 overfit in JAX on ``next = (cur*31 + 17) % V``
    (80 adamw steps, as fig14's quantized_pool_comparison), carried to
    the port by the weight bridge."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    vocab = jcfg.vocab_size
    params = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
    ocfg = adamw.AdamWConfig(lr=3e-3)
    opt = adamw.init(params, ocfg)

    @jax.jit
    def train_step(p, o, toks):
        def loss_fn(w):
            return jax_forward_train(w, jcfg, {"tokens": toks[:, :-1],
                                               "labels": toks[:, 1:]})
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        new_p, new_o, _ = adamw.update(grads, o, p, ocfg)
        return new_p, new_o, loss

    for it in range(80):
        batch = jnp.asarray([_chain(1 + 8 * it + bi, 33, vocab)
                             for bi in range(8)], jnp.int32)
        params, opt, _loss = train_step(params, opt, batch)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return reduced(get_config(ARCH)), tp, jcfg, params


ENGINE_KW = dict(slots=3, max_len=96, page_size=8, sync_interval=4,
                 prefill_budget=8, seed=0)


def _prompts(vocab):
    return [_chain(11 + 7 * i, 5 + 4 * i, vocab) for i in range(5)]


def _serve(eng, prompts, max_new, rid0=0):
    req = Request if isinstance(eng, Engine) else JRequest
    for i, p in enumerate(prompts):
        eng.submit(req(rid=rid0 + i, prompt=list(p), max_new_tokens=max_new))
    done = eng.run(max_steps=50_000)
    return {r.rid: list(r.out_tokens) for r in done if r.rid >= rid0}


@pytest.fixture(scope="module")
def jax_runs(chain_model):
    _cfg, _tp, jcfg, jp = chain_model
    runs = {}
    for kv_dtype in KV_DTYPES:
        eng = JEngine(jcfg, jp, kv_dtype=kv_dtype, **ENGINE_KW)
        assert eng.kv_dtype == kv_dtype and not eng.paged_kernel
        runs[kv_dtype] = (_serve(eng, _prompts(jcfg.vocab_size), 12), eng)
    return runs


@pytest.mark.parametrize("paged_kernel", [False, True])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_engine_token_parity(chain_model, jax_runs, kv_dtype,
                                       paged_kernel):
    """5 requests through 3 slots on 8-bit pools, gather path and
    pool-direct (the plain version on the CPU): the JAX Engine's tokens,
    memory telemetry and no leaked pages."""
    cfg, tp, _jcfg, _jp = chain_model
    want, jeng = jax_runs[kv_dtype]
    eng = Engine(cfg, tp, kv_dtype=kv_dtype, paged_kernel=paged_kernel,
                 device="cpu", **ENGINE_KW)
    assert eng.kv_dtype == eng.requested_kv_dtype == kv_dtype
    eng.warmup()
    got = _serve(eng, _prompts(cfg.vocab_size), 12)
    assert got == want
    # the chain model follows its chain: parity is not vacuous
    assert any(toks[:3] == _chain(_prompts(cfg.vocab_size)[rid][-1], 4,
                                  cfg.vocab_size)[1:]
               for rid, toks in got.items())
    assert eng.leaked_pages() == 0
    assert eng.memory_stats() == jeng.memory_stats()
    for layer in eng.cache["layers"]:       # scale pools survived the run
        assert layer["pk"].dtype == tcache.kv_pool_dtype(kv_dtype)
        assert layer["ks"].dtype == torch.float32
        assert bool(torch.isfinite(layer["ks"]).all())


def test_quantized_engine_prefix_hit_with_cow_parity(chain_model):
    """int8 pools: a later request shares 21 tokens of an indexed prompt
    (two full pages and 5 of the third), hits, and copies the partially
    matched page with its scale rows before writing into it."""
    cfg, tp, jcfg, jp = chain_model
    head = _chain(5, 21, cfg.vocab_size)
    waves = [[head + [30, 31, 32], head + [40, 41, 42]], [head + [77]]]
    kw = dict(slots=2, max_len=96, page_size=8, prefill_budget=8,
              sync_interval=4, seed=0, kv_dtype="int8")
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
    assert eng.leaked_pages() == 0


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_legacy_engine_token_parity(chain_model, kv_dtype):
    """The two-executable engine (``chunked_prefill=False``) on 8-bit
    pools: each prefill is spliced by the page-granular re-quantizing
    RMW, decode re-quantizes one page per step; the JAX legacy Engine's
    tokens, memory and prefix telemetry.  A later wave shares 21 tokens
    with an indexed prompt (a hit with copy-on-write of a partial page).

    The largest bucket (32) stays below the ring (96 tokens): the
    reference pads every prefill's KV to its largest bucket, and where
    that padded span is wider than the ring its quantized splice sends
    the prompt's own pages to the trash page (ROADMAP C;
    ``tests/test_torch_legacy_engine.py`` pins it).  The port's splice
    keeps the prompt whatever the span (held there too), so the two
    agree exactly where the reference keeps it."""
    cfg, tp, jcfg, jp = chain_model
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype, chunked_prefill=False,
              buckets=[8, 16, 32])
    head = _chain(5, 21, cfg.vocab_size)
    waves = [_prompts(cfg.vocab_size), [head + [30, 31, 32]],
             [head + [40, 41, 42], head + [77]]]
    eng = Engine(cfg, tp, device="cpu", **kw)
    jeng = JEngine(jcfg, jp, **kw)
    got, want = {}, {}
    for w, prompts in enumerate(waves):
        got.update(_serve(eng, prompts, 12, rid0=10 * w))
        want.update(_serve(jeng, prompts, 12, rid0=10 * w))
    assert got == want
    ps = eng.prefix_stats()
    assert ps == jeng.prefix_stats()
    assert ps["prefix_hits"] == 2 and ps["cow_copies"] == 2
    assert eng.memory_stats() == jeng.memory_stats()
    assert eng.leaked_pages() == 0
    # the chain model follows its chain: parity is not vacuous
    assert all(toks[:3] == _chain(p[-1], 4, cfg.vocab_size)[1:]
               for toks, p in zip((got[i] for i in range(5)),
                                  _prompts(cfg.vocab_size)))


# ---------------------------------------------------------------------------
# (f) kv_dtype validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype,pool,scaled", [
    ("auto", torch.float32, False), ("fp32", torch.float32, False),
    ("int8", torch.int8, True), ("fp8_e4m3", torch.float8_e4m3fn, True)])
def test_engine_kv_dtype_pools(chain_model, kv_dtype, pool, scaled):
    cfg, tp, _jcfg, _jp = chain_model
    eng = Engine(cfg, tp, slots=2, max_len=32, kv_dtype=kv_dtype,
                 device="cpu")
    want = "fp32" if kv_dtype == "auto" else kv_dtype
    assert eng.kv_dtype == eng.requested_kv_dtype == want
    assert eng.spec.kv_dtype == want
    for layer in eng.cache["layers"]:
        assert layer["pk"].dtype == layer["pv"].dtype == pool
        assert ("ks" in layer) == ("vs" in layer) == scaled
    assert eng.memory_stats()["kv_dtype"] == want


@pytest.mark.parametrize("bad", ["bf16", "int4", "fp8", "FP32", ""])
def test_engine_rejects_unknown_kv_dtype(chain_model, bad):
    cfg, tp, _jcfg, _jp = chain_model
    with pytest.raises(ValueError, match="kv_dtype"):
        Engine(cfg, tp, slots=2, max_len=32, kv_dtype=bad, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        tcache.CacheSpec.from_config(cfg, 2, 32, kv_dtype=bad)


def test_wrapper_checks_scales():
    """8-bit pools need both scales, fp32 pools take none, and K/V pools
    share one dtype; the checks run before any launch."""
    _j, _js, (q, pk, pv, pt, cl), sc = _attn_case(2, "int8", seed=1)
    q4 = q.contiguous()
    with pytest.raises(ValueError, match="scale"):
        ops._check(q4, pk, pv, pt, cl, None, None)
    with pytest.raises(ValueError, match="scale"):
        ops._check(q4, pk.float(), pv.float(), pt, cl, sc["k_scale"],
                   sc["v_scale"])
    with pytest.raises(TypeError, match="one dtype"):
        ops._check(q4, pk, pv.float(), pt, cl, sc["k_scale"], sc["v_scale"])
    with pytest.raises(ValueError, match="scales must be"):
        ops._check(q4, pk, pv, pt, cl, sc["k_scale"][:-1],
                   sc["v_scale"][:-1])
    ops._check(q4, pk, pv, pt, cl, sc["k_scale"], sc["v_scale"])
    with pytest.raises(ValueError, match="kv_dtype"):
        ops.supported("int4")


def test_ctypes_signature_matches_c_entry_point():
    """The wrapper's argtypes follow the C signature in the CUDA source
    (the compiler is on the card only; a wrong arity would be found there
    at the first launch)."""
    import ctypes
    import re

    src = ops.SOURCE.read_text()
    params = re.search(r"int paged_attention_fwd\(([^)]*)\)", src).group(1)
    want = []
    for decl in params.split(","):
        decl = " ".join(decl.split())
        if "*" in decl:
            want.append(ctypes.c_void_p)
        elif decl.startswith("float "):
            want.append(ctypes.c_float)
        else:
            assert decl.startswith("int "), decl
            want.append(ctypes.c_int)
    assert ops.FWD_ARGTYPES == want


# ---------------------------------------------------------------------------
# (g) the Hopper kernel on 8-bit pools against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the quantized kernel runs only "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("s", [1, 5, 32])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_cuda_quantized_kernel_vs_plain(cuda_device, kv_dtype, mode, s):
    if not ops.supported(kv_dtype):
        pytest.skip(f"the paged-attention kernel does not build or launch "
                    f"with {kv_dtype} pools here")
    _j, _js, targs, tscales = _attn_case(s, kv_dtype, seed=s, h=16, hkv=8,
                                         page_size=16, nb=8, dh=128)
    args = [x.to(cuda_device) for x in targs]
    sc = {k: v.to(cuda_device) for k, v in tscales.items()}
    before = ops.launches_by_dtype[kv_dtype]
    got = ops.paged_attention(*args, **sc, **MODES[mode])
    want = paged_attention_ref(*args, **sc, **MODES[mode])
    torch.cuda.synchronize()
    assert ops.launches_by_dtype[kv_dtype] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert bool((got[3] == 0).all())
