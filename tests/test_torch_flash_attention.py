"""PyTorch port: flash attention and the prefill half of the attention
module against the JAX reference.

Same numpy inputs on both sides (bf16 by rounding the same fp32 values in
each framework), at these tolerances:

* the port's ``flash_attention_ref`` against JAX's ``flash_attention_ref``
  and the interpret-mode Pallas ``flash_attention`` (64 x 64 blocks, as
  ``tests/test_kernels.py``), on the reference's grid of shapes x causal /
  window / full / softcap, plus an odd length and a non-causal Sq != Skv:
  fp32 atol 1e-5 (the summation order differs), bf16 2e-2 (one bf16 ulp
  of the rounded output);
* ``chunked_attention``, ``prefix_prefill_attention`` and ``apply`` in
  prefill mode with and without a paged context (fp32 and int8 pools):
  atol 1e-5.
* The Hopper kernel against its plain version (fp32 1e-4, bf16 2e-2 x
  max|want|) runs only where ``ops.supported()`` passes; here it skips.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_kernel  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_ref as jax_ref  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402

ARCH = "internlm2-1.8b"
MODES = {"causal": {"causal": True},
         "window": {"causal": True, "window": 48},
         "full": {"causal": False},
         "softcap": {"causal": True, "softcap": 20.0}}
# the reference's grid (G = 1, 2 and 8) plus an odd length
SHAPES = [(128, 128, 4, 4, 64), (256, 256, 4, 2, 64), (128, 128, 8, 1, 32),
          (37, 37, 4, 2, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=0, atol=1e-5)


def _qkv(b, h, hkv, sq, skv, dh, seed):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, h, sq, dh) * 0.5).astype(np.float32)
    k = (rs.randn(b, hkv, skv, dh) * 0.5).astype(np.float32)
    v = rs.randn(b, hkv, skv, dh).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.as_tensor(a).to(tdt) for a in arrays])


# ---------------------------------------------------------------------------
# the plain version against JAX's oracle and interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sq,skv,h,hkv,dh", SHAPES)
def test_plain_vs_jax_ref_and_pallas(sq, skv, h, hkv, dh, dtype, mode):
    kw = MODES[mode]
    (jq, jk, jv), (tq, tk, tv) = _both(
        _qkv(2, h, hkv, sq, skv, dh, seed=sq + h + dh + len(mode)), dtype)
    got = flash_attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    want = np.asarray(jax_ref(jq, jk, jv, **kw), np.float32)
    np.testing.assert_allclose(got, want, **_tol(dtype))
    kern = np.asarray(jax_kernel(jq, jk, jv, block_q=64, block_k=64,
                                 interpret=True, **kw), np.float32)
    np.testing.assert_allclose(got, kern, **_tol(dtype))
    # the wrapper on CPU tensors is the plain version, with no launch
    before = ops.launches
    np.testing.assert_array_equal(
        ops.flash_attention(tq, tk, tv, **kw).float().numpy(), got)
    assert ops.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_noncausal_unequal_lengths(dtype):
    """Cross-attention shape: Sq != Skv, no causal mask."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 4, 2, 24, 40, 32, seed=5),
                                       dtype)
    got = flash_attention_ref(tq, tk, tv, causal=False).float().numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_ref(jq, jk, jv, causal=False), np.float32),
        **_tol(dtype))
    np.testing.assert_allclose(
        got, np.asarray(jax_kernel(jq, jk, jv, causal=False, interpret=True),
                        np.float32), **_tol(dtype))


# ---------------------------------------------------------------------------
# the attention module's prefill half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_chunked_attention_vs_jax(mode):
    """[B,S,H,dh] layout; JAX's query-chunked loop (chunks of 32) against
    the port's one kernel call."""
    kw = MODES[mode]
    q, k, v = _qkv(2, 4, 2, 96, 96, 16, seed=11)
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
               for x in (q, k, v))
    want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_chunk=32, **kw)
    got = tatt.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), q_chunk=32, **kw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("off", [0, 5, 16, 29])
def test_prefix_prefill_attention_vs_jax(off, softcap):
    """A suffix of 12 tokens at positions off.. against a 32-token
    gathered context of which the first ``off`` are valid (the rest is
    trash-page padding, filled with noise)."""
    rs = np.random.RandomState(off)
    s, c, h, hkv, dh = 12, 32, 4, 2, 16
    q = rs.randn(1, s, h, dh).astype(np.float32)
    k, v = (rs.randn(1, s, hkv, dh).astype(np.float32) for _ in range(2))
    ck, cv = (rs.randn(1, c, hkv, dh).astype(np.float32) * 3
              for _ in range(2))
    want = jatt.prefix_prefill_attention(
        *(jnp.asarray(x) for x in (q, k, v, ck, cv)), jnp.int32(off),
        softcap=softcap)
    targs = [torch.as_tensor(x) for x in (q, k, v, ck, cv)]
    got = tatt.prefix_prefill_attention(*targs, off, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # a 0-d device tensor offset works the same
    got_t = tatt.prefix_prefill_attention(*targs, torch.tensor(off),
                                          softcap=softcap)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


@pytest.fixture(scope="module")
def layer():
    """One reduced internlm2 attention layer's weights, on both sides."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    rs = np.random.RandomState(0)
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    w = {"wq": rs.randn(d, h, dh), "wk": rs.randn(d, hkv, dh),
         "wv": rs.randn(d, hkv, dh), "wo": rs.randn(h, dh, d)}
    w = {k: (x * d ** -0.5).astype(np.float32) for k, x in w.items()}
    return (cfg, {k: torch.as_tensor(x) for k, x in w.items()},
            jcfg, {k: jnp.asarray(x) for k, x in w.items()})


@pytest.mark.parametrize("window", [None, 8])
def test_apply_prefill_vs_jax(layer, window):
    cfg, tw, jcfg, jw = layer
    x = np.random.RandomState(1).randn(1, 24, cfg.d_model).astype(np.float32)
    pos = np.arange(24)
    jy, jc = jatt.apply(jw, jnp.asarray(x), cfg=jcfg, window=window,
                        positions=jnp.asarray(pos), mode="prefill")
    ty, tc = tatt.apply(tw, torch.as_tensor(x), cfg=cfg, window=window,
                        positions=torch.as_tensor(pos)[None],
                        mode="prefill")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == (1, cfg.num_kv_heads, 24,
                                        cfg.resolved_head_dim)
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_apply_prefill_with_ctx_vs_jax(layer, kv_dtype):
    """A suffix prefill at offset 13 reads the prefix through a page row
    (2 context pages of 8, then a trash entry) from an fp32 or int8 pool
    (dequantized in the gather)."""
    cfg, tw, jcfg, jw = layer
    rs = np.random.RandomState(2)
    hkv, dh, psz, npg = cfg.num_kv_heads, cfg.resolved_head_dim, 8, 6
    pk, pv = (rs.randn(npg + 1, psz, hkv, dh).astype(np.float32)
              for _ in range(2))
    row = np.array([4, 1, npg], np.int32)
    off, s = 13, 9
    x = rs.randn(1, s, cfg.d_model).astype(np.float32)
    pos = off + np.arange(s)
    jctx = {"row": jnp.asarray(row), "off": jnp.int32(off)}
    tctx = {"row": torch.as_tensor(row), "off": off}
    if kv_dtype == "int8":
        for name, pool in (("k", pk), ("v", pv)):
            jq, js = jatt.quantize_pages(jnp.asarray(pool), jnp.int8)
            jctx[f"p{name}"], jctx[f"{name}s"] = jq, js
            tctx[f"p{name}"] = torch.as_tensor(np.array(jq))
            tctx[f"{name}s"] = torch.as_tensor(np.array(js))
    else:
        jctx.update(pk=jnp.asarray(pk), pv=jnp.asarray(pv))
        tctx.update(pk=torch.as_tensor(pk), pv=torch.as_tensor(pv))
    jy, jc = jatt.apply(jw, jnp.asarray(x), cfg=jcfg, window=None,
                        positions=jnp.asarray(pos), mode="prefill", ctx=jctx)
    ty, tc = tatt.apply(tw, torch.as_tensor(x), cfg=cfg, window=None,
                        positions=torch.as_tensor(pos)[None],
                        mode="prefill", ctx=tctx)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0,
                               atol=1e-5)


def test_apply_unported_modes_raise(layer):
    """The dense mode (teacher-forced logits, whisper's encoder) against
    JAX's ``apply(mode="dense")``, causal with and without a window and
    non-causal: atol 1e-5 and no cache.  The dense decode cache still
    takes one row per slot."""
    cfg, tw, jcfg, jw = layer
    xs = np.random.RandomState(2).randn(2, 21, cfg.d_model).astype(
        np.float32)
    pos = np.arange(21)
    for causal, window in ((True, None), (True, 8), (False, None)):
        jy, jc = jatt.apply(jw, jnp.asarray(xs), cfg=jcfg, window=window,
                            positions=jnp.asarray(pos), mode="dense",
                            causal=causal)
        ty, tc = tatt.apply(tw, torch.as_tensor(xs), cfg=cfg, window=window,
                            positions=torch.as_tensor(pos)[None],
                            mode="dense", causal=causal)
        assert tc is None and jc is None
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5, err_msg=f"{causal} {window}")
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    # the dense decode cache (the model drafter's) takes one row per slot
    with pytest.raises(NotImplementedError, match="needs a paged cache"):
        tatt.apply(tw, x, cfg=cfg, window=None, positions=pos,
                   mode="decode", cache={"k": x, "v": x},
                   cache_len=torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the query offset: a context-parallel rank's queries against its keys
# ---------------------------------------------------------------------------

# (shards, options): causal, a window that slices the keys, a softcap
OFFSET_CASES = [(2, {}), (4, {}), (4, {"window": 24}),
                (2, {"window": 40, "softcap": 20.0}), (4, {"softcap": 20.0})]


def _shard_calls(n, s, window, causal=True):
    """Each query shard's (rows, key start, key count, q_offset), as
    ``models/attention.cp_attention`` slices them."""
    s_loc = s // n
    out = []
    for i in range(n):
        start, klen = tatt.cp_kv_slice(i * s_loc, s_loc, s, causal, window)
        out.append((slice(i * s_loc, (i + 1) * s_loc), start, klen,
                    i * s_loc - start))
    return out


@pytest.mark.parametrize("n,kw", OFFSET_CASES)
def test_query_offset_shards_equal_unsharded(n, kw):
    """The shards' outputs, concatenated, equal the unsharded call, and
    their gradients (dk, dv summed into the keys each shard was given)
    equal its gradients: the plain version forward, the explicit-product
    backward, and the meta work count (live scores) summed."""
    b, h, hkv, s, dh = 2, 4, 2, 96, 32
    q, k, v = (torch.as_tensor(a) for a in _qkv(b, h, hkv, s, s, dh, 11))
    do = torch.as_tensor(np.random.RandomState(12).randn(b, h, s, dh)
                         .astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = ops.flash_attention(*leaves, **kw)
    want_g = torch.autograd.grad(want, leaves, do)
    got = torch.empty_like(want)
    got_g = [torch.zeros_like(t) for t in (q, k, v)]
    live = 0
    for rows, start, klen, off in _shard_calls(n, s, kw.get("window")):
        qs = q[:, :, rows].contiguous().requires_grad_()
        ks = k[:, :, start:start + klen].contiguous().requires_grad_()
        vs = v[:, :, start:start + klen].contiguous().requires_grad_()
        out = ops.flash_attention(qs, ks, vs, q_offset=off, **kw)
        np.testing.assert_array_equal(
            out.detach().numpy(),
            flash_attention_ref(qs, ks, vs, q_offset=off, **kw)
            .detach().numpy())
        got[:, :, rows] = out.detach()
        dq, dk, dv = torch.autograd.grad(out, (qs, ks, vs), do[:, :, rows])
        got_g[0][:, :, rows] += dq
        got_g[1][:, :, start:start + klen] += dk
        got_g[2][:, :, start:start + klen] += dv
        live += ops.live_scores(rows.stop - rows.start, klen, True,
                                kw.get("window"), off)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for name, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name}")
    assert live == ops.live_scores(s, s, True, kw.get("window"))


@pytest.mark.parametrize("mode", list(MODES))
def test_query_offset_zero_is_the_old_call(mode):
    """``q_offset=0`` gives the very bits of the call without it, forward
    and backward."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 4, 2, 37, 37, 32, 3))
    kw = MODES[mode]
    out = flash_attention_ref(q, k, v, **kw)
    np.testing.assert_array_equal(
        flash_attention_ref(q, k, v, q_offset=0, **kw).numpy(), out.numpy())
    do = torch.ones_like(out)
    for a, b in zip(ops.flash_attention_bwd(q, k, v, out, do, **kw),
                    ops.flash_attention_bwd(q, k, v, out, do, q_offset=0,
                                            **kw)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_check_refuses_query_offset_past_the_keys():
    q = torch.zeros(1, 4, 8, 32)
    k = torch.zeros(1, 2, 16, 32)
    ops._check(q, k, k, causal=True, q_offset=8)
    with pytest.raises(ValueError, match="q_offset"):
        ops._check(q, k, k, causal=True, q_offset=9)
    with pytest.raises(ValueError, match="q_offset"):
        ops._check(q, k, k, causal=True, q_offset=-1)
    ops._check(q, k, k, causal=False, q_offset=9)


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------

def test_wrapper_checks_before_launch():
    q = torch.zeros(1, 4, 8, 32)
    k = torch.zeros(1, 2, 8, 32)
    ops._check(q, k, k, causal=True)
    with pytest.raises(TypeError, match="one dtype"):
        ops._check(q, k.double(), k, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(q.transpose(2, 3), k, k, causal=True)
    with pytest.raises(ValueError, match="shape"):
        ops._check(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32),
                   causal=True)
    with pytest.raises(ValueError, match="dh"):
        ops._check(torch.zeros(1, 4, 8, 48), torch.zeros(1, 2, 8, 48),
                   torch.zeros(1, 2, 8, 48), causal=True)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        ops._check(torch.zeros(1, 4, 9, 32), k, k, causal=True)
    ops._check(torch.zeros(1, 4, 9, 32), k, k, causal=False)


def test_ctypes_signature_matches_c_entry_point():
    """The wrapper's argtypes follow the C signature in the CUDA source
    (the compiler is on the card only)."""
    import ctypes

    src = ops.SOURCE.read_text()
    params = re.search(r"int flash_attention_fwd\(([^)]*)\)", src).group(1)
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
# the Hopper kernel against its plain version (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash-attention kernel runs "
                    "only on the card)")
    if not ops.supported():
        pytest.skip("the flash-attention kernel does not build or launch "
                    "here")
    return torch.device("cuda")


# (B, H, Hkv, Sq, Skv, dh, options)
CUDA_CASES = [
    (1, 16, 8, 512, 512, 128, {}),
    (1, 16, 8, 128, 128, 128, {"window": 48}),
    (1, 16, 8, 128, 128, 128, {"softcap": 50.0}),
    (1, 16, 8, 100, 77, 128, {"causal": False}),
    (2, 8, 1, 37, 37, 64, {}),
    (1, 4, 2, 100, 100, 32, {"window": 48}),
    (1, 4, 2, 200, 200, 256, {"softcap": 20.0}),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,sq,skv,dh,kw", CUDA_CASES)
def test_cuda_kernel_vs_plain(cuda_device, b, h, hkv, sq, skv, dh, kw,
                              dtype):
    tdt = DTYPES[dtype][1]
    q, k, v = (torch.as_tensor(x).to(cuda_device, tdt)
               for x in _qkv(b, h, hkv, sq, skv, dh, seed=sq))
    before = ops.launches
    got = ops.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    err = float((got.float() - want.float()).abs().max())
    bound = 1e-4 if dtype == "float32" \
        else 2e-2 * float(want.float().abs().max())
    assert err <= bound


# (B, H, Hkv, S, dh, shards, options): the query offset on the card
CUDA_OFFSET_CASES = [
    (2, 8, 4, 256, 64, 4, {}),
    (1, 4, 2, 320, 128, 2, {"window": 100}),
    (1, 4, 2, 288, 256, 8, {"window": 64, "softcap": 20.0}),
]


@pytest.mark.parametrize("b,h,hkv,s,dh,n,kw", CUDA_OFFSET_CASES)
def test_cuda_kernel_query_offset_vs_plain(cuda_device, b, h, hkv, s, dh, n,
                                           kw):
    """Each query shard's kernel output at its offset = its plain
    version, and the shards concatenated = the unsharded kernel's."""
    q, k, v = (torch.as_tensor(x).to(cuda_device)
               for x in _qkv(b, h, hkv, s, s, dh, seed=s))
    want = ops.flash_attention(q, k, v, **kw)
    got = torch.empty_like(want)
    for rows, start, klen, off in _shard_calls(n, s, kw.get("window")):
        qs = q[:, :, rows].contiguous()
        ks = k[:, :, start:start + klen].contiguous()
        vs = v[:, :, start:start + klen].contiguous()
        got[:, :, rows] = ops.flash_attention(qs, ks, vs, q_offset=off, **kw)
        plain = flash_attention_ref(qs, ks, vs, q_offset=off, **kw)
        assert float((got[:, :, rows] - plain).abs().max()) <= 1e-4
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4
