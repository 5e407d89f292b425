"""PyTorch port: the Mamba2 scan and mixer against the JAX reference.

Same numpy inputs on both sides (fp32, TF32 off), at these tolerances:

* the zamba2-7b config and its ``reduced()`` form: field for field;
* the port's ``mamba2_scan_ref`` against JAX's ``mamba2_scan_ref`` and
  the interpret-mode Pallas kernel at ``tests/test_kernels.py``'s cases:
  atol/rtol 1e-4 (the Pallas kernel's chunked sums differ from the
  per-step recurrence; JAX's ref alone agrees to 1e-5);
* the port's ``ssd_chunked`` (CPU: the chunked algorithm) against JAX's,
  with and without an initial state: 1e-5; ``scan_model_layout`` (CPU:
  the recurrence) against JAX's ``ssd_chunked``: 1e-4;
* ``_conv`` with and without a carried state and ``length``: 1e-6;
  ``mamba2.apply`` in dense, padded prefill and decode modes, outputs
  and new state: 1e-5;
* the weight bridge on reduced zamba2: bitwise, key for key.
* The Hopper kernel against its plain version (1e-4 x max|want|) runs
  only where ``ops.supported()`` passes; here it skips.
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
from repro.kernels.mamba2_scan import mamba2_scan as jax_kernel  # noqa: E402
from repro.kernels.mamba2_scan import \
    mamba2_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba2_scan_ref  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import model_defs  # noqa: E402
from repro_torch.models.module import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)

ARCH = "zamba2-7b"
# tests/test_kernels.py's (s, p, n, chunk) cases
KERNEL_CASES = [(64, 32, 16, 16), (128, 64, 32, 32), (96, 64, 64, 32)]


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def _scan_inputs(bh, s, p, n, seed, h0=False, strong=False):
    """tests/test_kernels.py's distributions, from numpy; ``strong``: a =
    -16 and dt uniform in [0.01, 1.5) (cum falls by ~770 over one of the
    kernel's 64-row chunks)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(bh, s, p).astype(np.float32)
    dt = (np.abs(rs.randn(bh, s)) * 0.4 + 0.01).astype(np.float32)
    b = (rs.randn(bh, s, n) * 0.5).astype(np.float32)
    c = (rs.randn(bh, s, n) * 0.5).astype(np.float32)
    a = (-np.abs(rs.randn(bh)) - 0.05).astype(np.float32)
    if strong:
        dt = (0.01 + 1.49 * rs.rand(bh, s)).astype(np.float32)
        a = np.full(bh, -16.0, np.float32)
    hh = rs.randn(bh, n, p).astype(np.float32) if h0 else None
    return x, dt, b, c, a, hh


def _model_inputs(bsz, s, h, p, n, seed, h0=False):
    """The model's layout: x [B,S,H,P], dt [B,S,H], b/c [B,S,N], a_log
    [H], h0 [B,H,N,P]."""
    rs = np.random.RandomState(seed)
    x = rs.randn(bsz, s, h, p).astype(np.float32)
    dt = (np.abs(rs.randn(bsz, s, h)) * 0.4 + 0.01).astype(np.float32)
    b = (rs.randn(bsz, s, n) * 0.5).astype(np.float32)
    c = (rs.randn(bsz, s, n) * 0.5).astype(np.float32)
    a_log = np.log(rs.uniform(1.0, 16.0, h)).astype(np.float32)
    hh = rs.randn(bsz, h, n, p).astype(np.float32) if h0 else None
    return x, dt, b, c, a_log, hh


def _t(*arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


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
    assert got.resolved_head_dim == want.resolved_head_dim
    assert tm2.dims(got) == jm2.dims(want)


def test_full_config_shape():
    cfg = get_config(ARCH)
    mixers = [b.mixer for b in cfg.blocks]
    assert cfg.num_layers == 81 and cfg.resolved_head_dim == 112
    assert mixers.count("mamba2") == 68 and mixers.count("shared_attn") == 13
    assert [b.shared_group for b in cfg.blocks
            if b.mixer == "shared_attn"] == [i % 2 for i in range(13)]
    assert tm2.dims(cfg) == (7168, 112, 64, 64)


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


@pytest.mark.parametrize("layers", [2, 4])
def test_weight_bridge_round_trip(layers):
    """Every reference leaf (the ``shared`` list, the Mamba2 ``a_log``,
    ``dt_bias``, ``d_skip``, ``conv_w*``, ...) comes over key for key,
    bitwise, in the port's own defs' shapes."""
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
    assert "shared.0.proj_in" in got and "layers.0.mixer.a_log" in got


def test_a_log_init_range():
    """The port's own init draws a_log = log U(1, 16), as the reference."""
    from repro_torch.models.module import init_params
    cfg = reduced(get_config(ARCH))
    tp = init_params(model_defs(cfg), 0, device="cpu")
    a_log = tp["layers"][0]["mixer"]["a_log"]
    assert bool((a_log >= 0).all()) and bool((a_log <= np.log(16.0)).all())
    assert float(a_log.std()) > 0


# ---------------------------------------------------------------------------
# the plain scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,p,n,chunk", KERNEL_CASES)
def test_plain_scan_vs_jax_ref_and_pallas(s, p, n, chunk):
    x, dt, b, c, a, _ = _scan_inputs(3, s, p, n, seed=s + n)
    y, hf = mamba2_scan_ref(*_t(x, dt, b, c, a))
    assert y.dtype == torch.float32 and tuple(hf.shape) == (3, n, p)
    jy, jh = jax_scan_ref(*_j(x, dt, b, c, a))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    ky, kh = jax_kernel(*_j(x, dt, b, c, a), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hf.numpy(), np.asarray(kh), rtol=1e-4,
                               atol=1e-4)
    # the wrapper on CPU tensors is the plain version, with no launch
    before = ops.launches
    wy, wh = ops.mamba2_scan(*_t(x, dt, b, c, a))
    assert torch.equal(wy, y) and torch.equal(wh, hf)
    assert ops.launches == before


def test_plain_scan_with_initial_state():
    x, dt, b, c, a, hh = _scan_inputs(2, 40, 16, 16, seed=9, h0=True)
    y, hf = mamba2_scan_ref(*_t(x, dt, b, c, a, hh))
    jy, jh = jax_scan_ref(*_j(x, dt, b, c, a), h0=jnp.asarray(hh))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    # two halves chained through the state give the whole
    y1, h1 = mamba2_scan_ref(*_t(x[:, :17], dt[:, :17], b[:, :17],
                                 c[:, :17], a, hh))
    y2, h2 = mamba2_scan_ref(*_t(x[:, 17:], dt[:, 17:], b[:, 17:],
                                 c[:, 17:], a), h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, hf, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 16), (13, 8)])
def test_ssd_chunked_vs_jax(s, chunk, h0):
    """The CPU chunked algorithm (chunk halved until it divides S, as the
    reference) and the recurrence adapter, against JAX's chunked scan."""
    x, dt, b, c, a_log, hh = _model_inputs(2, s, 4, 16, 16, seed=s + chunk,
                                           h0=h0)
    jy, jh = jm2.ssd_chunked(*_j(x, dt, a_log, b, c), chunk,
                             None if hh is None else jnp.asarray(hh))
    ty, th = tm2.ssd_chunked(*_t(x, dt, a_log, b, c), chunk,
                             None if hh is None else torch.as_tensor(hh))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    before = ops.launches
    my, mh = ops.scan_model_layout(*_t(x, dt, b, c, a_log, hh))
    assert ops.launches == before
    assert tuple(my.shape) == x.shape and tuple(mh.shape) == (2, 4, 16, 16)
    np.testing.assert_allclose(my.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(mh.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state,length", [(False, None), (True, None),
                                          (False, [5, 9]), (False, [0, 3])])
def test_conv_vs_jax(state, length):
    rs = np.random.RandomState(4)
    w = rs.randn(4, 12).astype(np.float32)
    bias = rs.randn(12).astype(np.float32)
    x = rs.randn(2, 9, 12).astype(np.float32)
    cs = rs.randn(2, 3, 12).astype(np.float32) if state else None
    ln = None if length is None else np.asarray(length, np.int32)
    jy, js = jm2._conv(jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x),
                       None if cs is None else jnp.asarray(cs), 4,
                       None if ln is None else jnp.asarray(ln))
    ty, ts = tm2._conv(torch.as_tensor(w), torch.as_tensor(bias),
                       torch.as_tensor(x),
                       None if cs is None else torch.as_tensor(cs), 4,
                       None if ln is None else torch.as_tensor(ln))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=0)


@pytest.fixture(scope="module")
def mixer():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jp = jm.init_params(jm2.mamba2_defs(jcfg), jax.random.PRNGKey(5),
                        jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return cfg, jcfg, params_from_numpy(tree, device="cpu"), jp


def _x(b, s, d, seed):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def _assert_state(ts, js, tol=1e-5):
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def test_apply_dense_vs_jax(mixer):
    cfg, jcfg, tp, jp = mixer
    x = _x(2, 19, cfg.d_model, seed=1)
    ty, ts = tm2.apply(tp, torch.as_tensor(x), cfg, mode="dense")
    jy, js = jm2.apply(jp, jnp.asarray(x), jcfg, mode="dense")
    assert ts is None and js is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_apply_padded_prefill_vs_jax(mixer):
    """Rows padded to 16 with true lengths 11 and 16: outputs and the
    carried conv and SSM state as the reference's, and the state of the
    short row as its own unpadded prefill's."""
    cfg, jcfg, tp, jp = mixer
    x = _x(2, 16, cfg.d_model, seed=2)
    ln = np.asarray([11, 16], np.int32)
    ty, ts = tm2.apply(tp, torch.as_tensor(x), cfg, mode="prefill",
                       length=torch.as_tensor(ln))
    jy, js = jm2.apply(jp, jnp.asarray(x), jcfg, mode="prefill",
                       length=jnp.asarray(ln))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    _assert_state(ts, js)
    _y, short = tm2.apply(tp, torch.as_tensor(x[:1, :11]), cfg,
                          mode="prefill")
    for k in short:
        torch.testing.assert_close(ts[k][:1], short[k], rtol=1e-5,
                                   atol=1e-5)


def test_apply_decode_vs_jax(mixer):
    """Five decode steps from a prefill's state, outputs and state as the
    reference's at every step."""
    cfg, jcfg, tp, jp = mixer
    x = _x(2, 12, cfg.d_model, seed=3)
    _ty, ts = tm2.apply(tp, torch.as_tensor(x[:, :7]), cfg, mode="prefill")
    _jy, js = jm2.apply(jp, jnp.asarray(x[:, :7]), jcfg, mode="prefill")
    for t in range(7, 12):
        ty, ts = tm2.apply(tp, torch.as_tensor(x[:, t:t + 1]), cfg,
                           mode="decode", state=ts)
        jy, js = jm2.apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                           mode="decode", state=js)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        _assert_state(ts, js)
    # decoding equals prefilling the whole sequence
    _y, whole = tm2.apply(tp, torch.as_tensor(x), cfg, mode="prefill")
    for k in whole:
        torch.testing.assert_close(ts[k], whole[k], rtol=1e-4, atol=1e-4)


def test_state_shapes_match_reference():
    cfg = reduced(get_config(ARCH))
    jcfg = jax_reduced(jax_get_config(ARCH))
    assert tm2.state_shapes(cfg, 3) == {
        k: shape for k, (shape, _axes) in jm2.state_shapes(jcfg, 3).items()}


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------

def test_wrapper_checks_before_launch():
    x, dt, b, c, a, hh = _t(*_scan_inputs(2, 8, 4, 4, seed=0, h0=True))
    shapes = {"x": (2, 8, 4), "dt": (2, 8), "b": (2, 8, 4), "c": (2, 8, 4),
              "a": (2,), "h0": (2, 4, 4)}
    named = [("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a), ("h0", hh)]
    ops._check(named, shapes)
    with pytest.raises(TypeError, match="fp32"):
        ops._check([("x", x.double())] + named[1:], shapes)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops._check(named, dict(shapes, b=(2, 8, 5)))
    with pytest.raises(ValueError, match="innermost"):
        ops._check(named[:2] + [("b", b.transpose(1, 2).contiguous()
                                 .transpose(1, 2))] + named[3:], shapes)
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(0, 1).contiguous().transpose(0, 1)
        ops._check([("x", xt)] + named[1:], shapes)
    big = torch.zeros(2, 8, 129)
    with pytest.raises(ValueError, match="N <= 128"):
        ops._check(named[:2] + [("b", big), ("c", big)] + named[4:5],
                   dict(shapes, b=(2, 8, 129), c=(2, 8, 129)))


def test_ctypes_signature_matches_c_entry_point():
    """The wrapper's argtypes follow the C signature in the CUDA source
    (the compiler is on the card only)."""
    src = ops.SOURCE.read_text()
    params = re.search(r"int mamba2_scan_fwd\(([^)]*)\)", src).group(1)
    want = []
    for decl in params.split(","):
        decl = " ".join(decl.split())
        if "*" in decl:
            want.append(ctypes.c_void_p)
        else:
            assert decl.startswith("int "), decl
            want.append(ctypes.c_int)
    assert ops.FWD_ARGTYPES == want


# ---------------------------------------------------------------------------
# the Hopper kernel against its plain version (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_kernel():
    if not ops.supported():
        pytest.skip("needs a CUDA device where the mamba2_scan kernel "
                    "builds and launches (ops.supported() is False)")
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("bh,s,p,n,h0,strong", [
    (3, 64, 32, 16, False, False), (3, 128, 64, 32, False, False),
    (3, 96, 64, 64, False, False), (2, 1000, 64, 64, False, False),
    (3, 77, 20, 100, True, False), (3, 300, 64, 64, True, True)])
def test_cuda_kernel_vs_plain(cuda_kernel, bh, s, p, n, h0, strong):
    args = [None if a is None else a.to(cuda_kernel)
            for a in _t(*_scan_inputs(bh, s, p, n, seed=s, h0=h0,
                                      strong=strong))]
    before = ops.launches
    got = ops.mamba2_scan(*args)
    want = mamba2_scan_ref(*args)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


@pytest.mark.parametrize("h0", [False, True])
def test_cuda_model_layout_vs_plain(cuda_kernel, h0):
    x, dt, b, c, a_log, hh = _model_inputs(2, 50, 8, 64, 64, seed=7, h0=h0)
    bc = torch.as_tensor(np.concatenate([b, c], -1)).to(cuda_kernel)
    args = [None if a is None else a.to(cuda_kernel)
            for a in _t(x, dt, None, None, a_log, hh)]
    before = ops.launches
    got = ops.scan_model_layout(args[0], args[1], bc[..., :64], bc[..., 64:],
                                args[4], args[5])
    assert ops.launches == before + 1
    want = ops.scan_model_layout(*[None if a is None else a.cpu() for a in
                                   (args[0], args[1], bc[..., :64],
                                    bc[..., 64:], args[4], args[5])])
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w) <= 1e-4
