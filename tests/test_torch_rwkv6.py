"""PyTorch port: the RWKV6 wkv kernel's plain version and the rwkv6
time-mix / channel-mix against the JAX reference.

Same numpy inputs on both sides (fp32, TF32 off), at these tolerances:

* the rwkv6-7b config and its ``reduced()`` form: field for field; the
  full model's parameter count from the defs;
* the weight bridge on reduced rwkv6: bitwise, key for key;
* the port's ``rwkv6_wkv_ref`` against JAX's ``rwkv6_wkv_ref`` (1e-5)
  and the interpret-mode Pallas kernel (2e-4, as
  ``tests/test_kernels.py``: its factored chunk form sums in another
  order) at ``tests/test_kernels.py``'s cases, and with an initial
  state; a pad step (k = 0, lw = 0) keeps the state bit for bit;
* ``wkv_chunked`` (CPU: the chunked algorithm) against JAX's, with and
  without an initial state, S a multiple of 16 or not: 1e-5;
  ``wkv_model_layout`` (CPU: the recurrence) against it: 1e-4;
* ``groupnorm``, ``_token_shift``, ``_ddlerp`` and ``_state_at``: 1e-6
  (the shifts and picks bitwise);
* ``time_mix`` and ``channel_mix`` in dense, padded prefill and decode
  modes, outputs and new state: 1e-5.
* The Hopper kernel against its plain version (1e-4 x max|want|), on
  strong, weak and mixed decay too, runs only where ``ops.supported()``
  passes; here it skips.
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.rwkv6_wkv import rwkv6_wkv as jax_kernel  # noqa: E402
from repro.kernels.rwkv6_wkv import \
    rwkv6_wkv_ref as jax_wkv_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.models import rwkv6 as jr6  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model_defs  # noqa: E402
from repro_torch.models import rwkv6 as tr6  # noqa: E402
from repro_torch.models.module import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)

ARCH = "rwkv6-7b"
# tests/test_kernels.py's (s, k, chunk) cases
KERNEL_CASES = [(64, 32, 16), (128, 64, 16), (48, 64, 8)]


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def _wkv_inputs(bh, s, k, seed, h0=False, decay="default"):
    """tests/test_kernels.py's distributions, from numpy: r and k N(0,
    0.25), v N(0, 1), lw = clip(-2|N(0, 1)|, -5, 0), u N(0, 0.09).
    ``decay`` "strong": lw = -5 (the model's clamp); "weak": lw uniform in
    [-6.8e-4, -3.4e-4] (|lw| >= exp(-8) in the model); "mixed": the first
    half of the channels strong, the second weak."""
    rs = np.random.RandomState(seed)
    r = (rs.randn(bh, s, k) * 0.5).astype(np.float32)
    kk = (rs.randn(bh, s, k) * 0.5).astype(np.float32)
    v = rs.randn(bh, s, k).astype(np.float32)
    lw = np.clip(-np.abs(rs.randn(bh, s, k)) * 2, -5.0, 0.0).astype(
        np.float32)
    weak = (-3.4e-4 * (1.0 + rs.rand(bh, s, k))).astype(np.float32)
    if decay == "strong":
        lw = np.full_like(lw, -5.0)
    elif decay == "weak":
        lw = weak
    elif decay == "mixed":
        lw = np.concatenate([np.full_like(lw[..., :k // 2], -5.0),
                             weak[..., k // 2:]], axis=-1)
    u = (rs.randn(bh, k) * 0.3).astype(np.float32)
    hh = rs.randn(bh, k, k).astype(np.float32) if h0 else None
    return r, kk, v, lw, u, hh


def _model_inputs(b, s, h, k, seed, h0=False, decay="default"):
    """The model's layout: r, k, v, lw [B,S,H,K], u [H,K], h0 [B,H,K,K]."""
    r, kk, v, lw, _u, _hh = _wkv_inputs(b * h, s, k, seed, decay=decay)
    rs = np.random.RandomState(seed + 1)
    u = (rs.randn(h, k) * 0.3).astype(np.float32)
    hh = rs.randn(b, h, k, k).astype(np.float32) if h0 else None

    def model(z):
        return np.ascontiguousarray(z.reshape(b, h, s, k).transpose(0, 2, 1,
                                                                    3))
    return model(r), model(kk), model(v), model(lw), u, hh


def _t(*arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["full", "reduced", "reduced4"])
def test_config_fields_match_reference(make):
    if make == "full":
        got, want = get_config(ARCH), jax_get_config(ARCH)
    else:
        kw = {"layers": 4} if make == "reduced4" else {}
        got = reduced(get_config(ARCH), **kw)
        want = jax_reduced(jax_get_config(ARCH), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tr6.hdims(got) == jr6.hdims(want)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def test_full_config_shape():
    """32 rwkv6 blocks of 64 heads of 64; 7,576,752,128 parameters (30.3
    GB in fp32), the reference's defs' count."""
    cfg = get_config(ARCH)
    assert cfg.num_layers == 32 and tr6.hdims(cfg) == (64, 64)
    assert {(b.mixer, b.ffn) for b in cfg.blocks} == {("rwkv6",
                                                       "rwkv_cmix")}
    got = sum(int(np.prod(d.shape)) for d in _flat(model_defs(cfg)).values())
    want = sum(int(np.prod(d.shape)) for d in
               _flat(jax_model_defs(jax_get_config(ARCH))).values())
    assert got == want == 7_576_752_128


@pytest.mark.parametrize("layers", [2, 4])
def test_weight_bridge_round_trip(layers):
    """Every reference leaf (``mu``, ``mix_a``/``mix_b``, ``w0``,
    ``decay_a``/``decay_b``, ``bonus_u``, ``ln_x``, the channel-mix
    ``mu_k``/``mu_r``, ...) comes over key for key, bitwise, in the
    port's own defs' shapes."""
    jcfg = jax_reduced(jax_get_config(ARCH), layers=layers)
    cfg = reduced(get_config(ARCH), layers=layers)
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(3),
                        jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, device="cpu")
    got = params_to_numpy(tp)
    want = _flat(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    defs = {k: tuple(d.shape) for k, d in _flat(model_defs(cfg)).items()}
    assert defs == {k: v.shape for k, v in want.items()}
    assert "layers.0.mixer.ln_x.bias" in got and "layers.0.ffn.mu_r" in got


def test_w0_init_range():
    """The port's own init draws w0 = U(0.5, 3), as the reference."""
    from repro_torch.models.module import init_params
    cfg = reduced(get_config(ARCH))
    tp = init_params(model_defs(cfg), 0, device="cpu")
    w0 = tp["layers"][0]["mixer"]["w0"]
    assert bool((w0 >= 0.5).all()) and bool((w0 <= 3.0).all())
    assert float(w0.std()) > 0
    assert not bool(tp["layers"][0]["mixer"]["decay_b"].any())


# ---------------------------------------------------------------------------
# the plain wkv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,k,chunk", KERNEL_CASES)
def test_plain_wkv_vs_jax_ref_and_pallas(s, k, chunk):
    r, kk, v, lw, u, _ = _wkv_inputs(3, s, k, seed=s + k)
    y, hf = rwkv6_wkv_ref(*_t(r, kk, v, lw, u))
    assert y.dtype == torch.float32 and tuple(hf.shape) == (3, k, k)
    jy, jh = jax_wkv_ref(*_j(r, kk, v, lw, u))
    _close(y.numpy(), jy, 1e-5)
    _close(hf.numpy(), jh, 1e-5)
    ky, kh = jax_kernel(*_j(r, kk, v, lw, u), chunk=chunk, interpret=True)
    _close(y.numpy(), ky, 2e-4)
    _close(hf.numpy(), kh, 2e-4)
    # the wrapper on CPU tensors is the plain version, with no launch
    before = ops.launches
    wy, wh = ops.rwkv6_wkv(*_t(r, kk, v, lw, u))
    assert torch.equal(wy, y) and torch.equal(wh, hf)
    assert ops.launches == before


def test_plain_wkv_with_initial_state():
    r, kk, v, lw, u, hh = _wkv_inputs(2, 40, 16, seed=9, h0=True)
    y, hf = rwkv6_wkv_ref(*_t(r, kk, v, lw, u, hh))
    jy, jh = jax_wkv_ref(*_j(r, kk, v, lw, u), h0=jnp.asarray(hh))
    _close(y.numpy(), jy, 1e-5)
    _close(hf.numpy(), jh, 1e-5)
    # two halves chained through the state give the whole
    y1, h1 = rwkv6_wkv_ref(*_t(r[:, :17], kk[:, :17], v[:, :17],
                               lw[:, :17], u, hh))
    y2, h2 = rwkv6_wkv_ref(*_t(r[:, 17:], kk[:, 17:], v[:, 17:],
                               lw[:, 17:], u), h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, hf, rtol=1e-5, atol=1e-5)


def test_plain_wkv_pad_steps_keep_state():
    """Steps with k = 0 and lw = 0 (the model's masking of bucket
    padding) leave the state bit for bit as it was."""
    r, kk, v, lw, u, hh = _wkv_inputs(2, 24, 16, seed=4, h0=True)
    kk[:, 10:] = 0.0
    lw[:, 10:] = 0.0
    _y, h_all = rwkv6_wkv_ref(*_t(r, kk, v, lw, u, hh))
    _y, h_ten = rwkv6_wkv_ref(*_t(r[:, :10], kk[:, :10], v[:, :10],
                                  lw[:, :10], u, hh))
    assert torch.equal(h_all, h_ten)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s", [32, 24, 13, 50])
def test_wkv_chunked_vs_jax(s, h0):
    """The CPU chunked algorithm (chunk halved until it divides S, as the
    reference) and the recurrence adapter, against JAX's chunked wkv."""
    r, kk, v, lw, u, hh = _model_inputs(2, s, 3, 16, seed=s, h0=h0)
    jy, jh = jr6.wkv_chunked(*_j(r, kk, v, lw, u),
                             None if hh is None else jnp.asarray(hh))
    ty, th = tr6.wkv_chunked(*_t(r, kk, v, lw, u),
                             None if hh is None else torch.as_tensor(hh))
    _close(ty.numpy(), jy, 1e-5)
    _close(th.numpy(), jh, 1e-5)
    before = ops.launches
    my, mh = ops.wkv_model_layout(*_t(r, kk, v, lw, u, hh))
    assert ops.launches == before
    assert tuple(my.shape) == r.shape and tuple(mh.shape) == (2, 3, 16, 16)
    _close(my.numpy(), jy, 1e-4)
    _close(mh.numpy(), jh, 1e-4)


# ---------------------------------------------------------------------------
# the pieces of the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-5, 64e-5])
def test_groupnorm_vs_jax(eps):
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 5, 64) * 3 + 1).astype(np.float32)
    p = {"scale": rs.randn(64).astype(np.float32),
         "bias": rs.randn(64).astype(np.float32)}
    got = tlayers.groupnorm({k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x), 4, eps=eps)
    want = jlayers.groupnorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), 4, eps=eps)
    _close(got.numpy(), want, 1e-5)
    assert set(tlayers.groupnorm_defs(64)) == set(jlayers.groupnorm_defs(64))


@pytest.mark.parametrize("s", [1, 7])
@pytest.mark.parametrize("state", [False, True])
def test_token_shift_vs_jax(s, state):
    rs = np.random.RandomState(s)
    x = rs.randn(2, s, 8).astype(np.float32)
    st = rs.randn(2, 1, 8).astype(np.float32) if state else None
    got = tr6._token_shift(torch.as_tensor(x),
                           None if st is None else torch.as_tensor(st))
    want = jr6._token_shift(jnp.asarray(x),
                            None if st is None else jnp.asarray(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [None, [5, 9], [0, 3]])
def test_state_at_vs_jax(length):
    x = np.random.RandomState(3).randn(2, 9, 8).astype(np.float32)
    ln = None if length is None else np.asarray(length, np.int32)
    got = tr6._state_at(torch.as_tensor(x),
                        None if ln is None else torch.as_tensor(ln))
    want = jr6._state_at(jnp.asarray(x),
                         None if ln is None else jnp.asarray(ln))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def blocks():
    """Reduced rwkv6's time-mix and channel-mix weights (the zero-init
    leaves redrawn so every term contributes), in both packages."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    defs = {"tm": jr6.time_mix_defs(jcfg), "cm": jr6.channel_mix_defs(jcfg)}
    jp = jm.init_params(defs, jax.random.PRNGKey(5), jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    rs = np.random.RandomState(6)
    for key in ("mu_inner", "mu", "mix_b", "decay_b"):
        tree["tm"][key] = (rs.randn(*tree["tm"][key].shape)
                           * 0.2).astype(np.float32)
    for key in ("mu_k", "mu_r"):
        tree["cm"][key] = rs.rand(*tree["cm"][key].shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return cfg, jcfg, params_from_numpy(tree, device="cpu"), jp


@pytest.mark.parametrize("idx", range(len(tr6.MIX_NAMES)))
def test_ddlerp_vs_jax(blocks, idx):
    _cfg, _jcfg, tp, jp = blocks
    rs = np.random.RandomState(idx)
    x = rs.randn(2, 6, 64).astype(np.float32)
    xx = rs.randn(2, 6, 64).astype(np.float32)
    got = tr6._ddlerp(tp["tm"], torch.as_tensor(x), torch.as_tensor(xx), idx)
    want = jr6._ddlerp(jp["tm"], jnp.asarray(x), jnp.asarray(xx), idx)
    _close(got.numpy(), want, 1e-6)


def _x(b, s, d, seed):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def _assert_state(ts, js, tol=1e-5):
    assert set(ts) == set(js)
    for k in js:
        _close(ts[k].numpy(), js[k], tol, msg=k)


@pytest.mark.parametrize("fn", ["time_mix", "channel_mix"])
def test_dense_vs_jax(blocks, fn):
    cfg, jcfg, tp, jp = blocks
    key = "tm" if fn == "time_mix" else "cm"
    x = _x(2, 19, cfg.d_model, seed=1)
    ty, ts = getattr(tr6, fn)(tp[key], torch.as_tensor(x), cfg, mode="dense")
    jy, js = getattr(jr6, fn)(jp[key], jnp.asarray(x), jcfg, mode="dense")
    assert ts is None and js is None
    _close(ty.numpy(), jy, 1e-5)


@pytest.mark.parametrize("fn", ["time_mix", "channel_mix"])
def test_padded_prefill_vs_jax(blocks, fn):
    """Rows padded to 16 with true lengths 11, 16 and 0: outputs and the
    carried state as the reference's, and the short row's state as its
    own unpadded prefill's."""
    cfg, jcfg, tp, jp = blocks
    key = "tm" if fn == "time_mix" else "cm"
    x = _x(3, 16, cfg.d_model, seed=2)
    ln = np.asarray([11, 16, 0], np.int32)
    ty, ts = getattr(tr6, fn)(tp[key], torch.as_tensor(x), cfg,
                              mode="prefill", length=torch.as_tensor(ln))
    jy, js = getattr(jr6, fn)(jp[key], jnp.asarray(x), jcfg, mode="prefill",
                              length=jnp.asarray(ln))
    _close(ty.numpy(), jy, 1e-5)
    _assert_state(ts, js)
    _uy, us = getattr(tr6, fn)(tp[key], torch.as_tensor(x[:1, :11]), cfg,
                               mode="prefill")
    for k in us:
        torch.testing.assert_close(us[k], ts[k][:1], rtol=1e-5, atol=1e-5)
    # the empty row carries zeros: no token shifted, no state written
    assert all(not bool(ts[k][2].any()) for k in ts)


def test_decode_vs_jax(blocks):
    """Five decode steps after a 7-token prefill, time-mix then
    channel-mix on one merged state as the decoder threads it: outputs
    and states as the reference's at every step, and the last state as
    one prefill of the whole sequence."""
    cfg, jcfg, tp, jp = blocks
    x = _x(2, 12, cfg.d_model, seed=3)

    def run(mod, p, c, xs, mode, state):
        y, tm = mod.time_mix(p["tm"], xs, c, mode=mode, state=state)
        y2, cm = mod.channel_mix(p["cm"], xs, c, mode=mode, state=state)
        return y, y2, {**tm, **cm}

    _a, _b, ts = run(tr6, tp, cfg, torch.as_tensor(x[:, :7]), "prefill",
                     None)
    _a, _b, js = run(jr6, jp, jcfg, jnp.asarray(x[:, :7]), "prefill", None)
    for t in range(7, 12):
        ty, ty2, ts = run(tr6, tp, cfg, torch.as_tensor(x[:, t:t + 1]),
                          "decode", ts)
        jy, jy2, js = run(jr6, jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                          "decode", js)
        _close(ty.numpy(), jy, 1e-5)
        _close(ty2.numpy(), jy2, 1e-5)
        _assert_state(ts, js)
    _a, _b, whole = run(tr6, tp, cfg, torch.as_tensor(x), "prefill", None)
    for k in whole:
        torch.testing.assert_close(ts[k], whole[k], rtol=1e-4, atol=1e-4)


def test_state_shapes_match_reference():
    cfg = reduced(get_config(ARCH))
    jcfg = jax_reduced(jax_get_config(ARCH))
    assert tr6.state_shapes(cfg, 3) == {
        k: shape for k, (shape, _axes) in jr6.state_shapes(jcfg, 3).items()}
    assert (tr6.LOG_W_MIN, tr6.CHUNK_Q, tr6.MIX_NAMES) == \
        (jr6.LOG_W_MIN, jr6.CHUNK_Q, jr6.MIX_NAMES)


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------

def test_wrapper_checks_before_launch():
    r, kk, v, lw, u, hh = _t(*_wkv_inputs(2, 8, 4, seed=0, h0=True))
    shapes = {"r": (2, 8, 4), "k": (2, 8, 4), "v": (2, 8, 4),
              "lw": (2, 8, 4), "u": (2, 4), "h0": (2, 4, 4)}
    named = [("r", r), ("k", kk), ("v", v), ("lw", lw), ("u", u),
             ("h0", hh)]
    ops._check(named, shapes)
    with pytest.raises(TypeError, match="fp32"):
        ops._check([("r", r.double())] + named[1:], shapes)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops._check(named, dict(shapes, v=(2, 8, 5)))
    with pytest.raises(ValueError, match="innermost"):
        ops._check(named[:2] + [("v", v.transpose(1, 2).contiguous()
                                 .transpose(1, 2))] + named[3:], shapes)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(named[:5] + [("h0", torch.zeros(2, 4, 8)[..., :4])],
                   shapes)
    big = torch.zeros(2, 8, 129)
    with pytest.raises(ValueError, match="K <= 128"):
        ops._check([("r", big)], {"r": (2, 8, 129)})
    # a strided view in the model's layout passes: no copy is needed
    whole = torch.zeros(2, 8, 3, 4, 4)
    ops._check([("r", whole[..., 0, :])], {"r": (2, 8, 3, 4)})


def _c_argtypes(fn: str):
    """The ctypes argtypes of C function ``fn`` (its return type and name)
    as declared in the CUDA source."""
    src = ops.SOURCE.read_text()
    params = re.search(re.escape(fn) + r"\(([^)]*)\)", src).group(1)
    want = []
    for decl in params.split(","):
        decl = " ".join(decl.split())
        if "*" in decl:
            want.append(ctypes.c_void_p)
        else:
            assert decl.startswith("int "), decl
            want.append(ctypes.c_int)
    return want, params


def test_ctypes_signature_matches_c_entry_point():
    """The wrapper's argtypes follow the C signature in the CUDA source,
    the scratch pointer among them (the compiler is on the card only)."""
    want, params = _c_argtypes("int rwkv6_wkv_fwd")
    assert ops.FWD_ARGTYPES == want
    assert "void* scratch" in params


def test_ctypes_signature_of_scratch_size():
    """The scratch the wrapper allocates is sized by the library from
    shapes alone (B, H, S, K): its argtypes follow the source too."""
    want, _params = _c_argtypes("long long rwkv6_wkv_scratch_floats")
    assert ops.SCRATCH_ARGTYPES == want == [ctypes.c_int] * 4


def test_wrapper_refuses_other_devices():
    r = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rwkv6_wkv(r, r, r, r, torch.zeros(1, 4, device="meta"))


# ---------------------------------------------------------------------------
# the Hopper kernel against its plain version (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_kernel():
    if not ops.supported():
        pytest.skip("needs a CUDA device where the rwkv6_wkv kernel builds "
                    "and launches (ops.supported() is False)")
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("bh,s,k,h0,decay", [
    (3, 64, 32, False, "default"),
    (3, 128, 64, False, "default"),
    (3, 48, 64, False, "default"),
    (2, 1000, 64, True, "default"),
    (3, 77, 100, True, "default"),
    (3, 300, 64, True, "strong"),
    (3, 1000, 64, True, "weak"),
    (2, 300, 64, True, "mixed"),
])
def test_cuda_kernel_vs_plain(cuda_kernel, bh, s, k, h0, decay):
    args = [None if a is None else a.to(cuda_kernel)
            for a in _t(*_wkv_inputs(bh, s, k, seed=s, h0=h0,
                                     decay=decay))]
    before = ops.launches
    got = ops.rwkv6_wkv(*args)
    want = rwkv6_wkv_ref(*args)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


@pytest.mark.parametrize("b,s,h,h0,decay", [
    (2, 50, 8, False, "default"),
    (2, 50, 8, True, "default"),
    (1, 256, 64, False, "default"),
    (2, 130, 8, True, "strong"),
    (2, 130, 8, True, "weak"),
    (2, 130, 8, True, "mixed"),
])
def test_cuda_model_layout_vs_plain(cuda_kernel, b, s, h, h0, decay):
    args = [None if a is None else a.to(cuda_kernel)
            for a in _t(*_model_inputs(b, s, h, 64, seed=7, h0=h0,
                                       decay=decay))]
    before = ops.launches
    got = ops.wkv_model_layout(*args)
    assert ops.launches == before + 1
    want = ops.wkv_model_layout(*[None if a is None else a.cpu()
                                  for a in args])
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w) <= 1e-4


def test_cuda_pad_steps_keep_state(cuda_kernel):
    r, kk, v, lw, u, hh = _wkv_inputs(2, 40, 64, seed=11, h0=True)
    kk[:, 25:] = 0.0
    lw[:, 25:] = 0.0
    full = [a.to(cuda_kernel) for a in _t(r, kk, v, lw, u, hh)]
    cut = [a.to(cuda_kernel) for a in _t(r[:, :25], kk[:, :25], v[:, :25],
                                         lw[:, :25], u, hh)]
    _y, h_all = ops.rwkv6_wkv(*full)
    _y, h_cut = ops.rwkv6_wkv(*cut)
    assert torch.equal(h_all, h_cut)
