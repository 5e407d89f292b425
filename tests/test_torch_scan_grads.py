"""PyTorch port: the backwards of the two scans on the CPU.

``mamba2_scan_chunked_bwd_ref`` and ``rwkv6_wkv_chunked_bwd_ref`` are the
algebra of the CUDA kernels ``mamba2_scan_bwd`` and ``rwkv6_wkv_bwd``: the
chunked forms transposed, in chunks of 64, every exponent <= 0 (Mamba2's
summed from terms of one sign; rwkv6's through 16-row pivots, its diagonal
sub-blocks' triangles per element, and dlw's rectangle summed from parts
in which no pair enters twice), the products in 3xTF32 as
``kernels/tf32.py`` models them, the chunks' states passed in fp32.
``mamba2_scan_bwd_ref`` and ``rwkv6_wkv_bwd_ref`` are the per-step
reverse recurrences.  On the same numpy inputs they are held

* against ``torch.autograd.grad`` through the plain per-step versions
  (``mamba2_scan_ref``, ``rwkv6_wkv_ref``, which compute in fp32 whatever
  they are given) within ``TOL_AUTOGRAD`` = 1e-5 x max|want| per
  gradient: the same fp32 products, summed in another order;
* against ``jax.vjp`` of the JAX oracles (``repro.kernels.*.ref``) within
  ``TOL_JAX`` = 1e-4 x max|want|: two frameworks' fp32 sums, the gate the
  card puts on the kernels;
* in the model's layout, summed as the kernels sum them (db and dc over
  the heads that share b/c, da over the batch rows that share a, du over
  the batch rows that share u), against ``jax.vjp`` of the JAX package's
  chunked forms ``ssd_chunked`` and ``wkv_chunked`` within ``TOL_JAX``
  (``TOL_WKV_CHUNKED`` = 1e-3 for rwkv6: ``wkv_chunked`` factors its decay
  through exp(+-cumsum) up to exp(80) within a chunk, and its fp32
  gradients sit 2-4e-4 x max|g| off float64, as ``tests/test_torch_train.py``
  records).  The port's CPU wrappers, which differentiate through the
  plain versions, meet the same gates.

Cases: with and without an initial state, S not a multiple of the chunks
(77, 130, 37, 200; 128 fills the chunks of 64 exactly), dt near 0 and
strong decays (a = -16 with dt up to 1.5; lw = -5), weak and mixed rwkv6
decays, lw > 0 on some channels (the kernel reads min(lw, 0): dlw is 0
there), ``dh_final`` given and None.  Under the model's own decays
(Mamba2's dt a down to ~ -40 a step, rwkv6's lw down to -5) the per-step
algorithms are within 1e-5 of float64 on every gradient, the kernels'
chunked algebra within 1e-4 (the card's ``KERNEL_TOL``), and the chunked
forms that training runs on the CPU within 1e-3: the tolerance of
``chip_smoke.py``'s card-vs-CPU training parity for these two archs.  The
C entry points' signatures, the backwards' chunk constant (the forwards'
``kQ``) and their kernels' names are checked against the CUDA sources
(the compiler is on the card only).
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba2_scan.ref import (  # noqa: E402
    mamba2_scan_ref as jax_scan_ref)
from repro.kernels.rwkv6_wkv.ref import (  # noqa: E402
    rwkv6_wkv_ref as jax_wkv_ref)
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops as mops  # noqa: E402
from repro_torch.kernels.mamba2_scan.ref import (  # noqa: E402
    CHUNK_ROWS as MAMBA_CHUNK_ROWS, mamba2_scan_bwd_ref,
    mamba2_scan_chunked_bwd_ref, mamba2_scan_ref)
from repro_torch.kernels.rwkv6_wkv import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import (  # noqa: E402
    CHUNK_ROWS as WKV_CHUNK_ROWS, rwkv6_wkv_bwd_ref,
    rwkv6_wkv_chunked_bwd_ref, rwkv6_wkv_ref)
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402
from repro_torch.models.rwkv6 import wkv_chunked  # noqa: E402

TOL_AUTOGRAD = 1e-5   # x max|want|: the plain version's autograd, fp32
TOL_JAX = 1e-4        # x max|want|: jax.vjp of the JAX functions, fp32
TOL_WKV_CHUNKED = 1e-3   # x max|want|: jax.vjp of wkv_chunked, fp32
TOL_F64_CARD = 1e-4   # x max|want|: the card's KERNEL_TOL, vs float64


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _torch(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def _present(values):
    return [v for v in values if v is not None]


def _autograd(fn, inputs, cots):
    """Gradients of ``fn(*inputs)`` (outputs y, h_final) with the
    cotangents ``cots`` (dh_final None: y's alone), for the inputs that
    are not None."""
    leaves = [None if t is None else t.clone().requires_grad_()
              for t in _torch(inputs)]
    y, hf = fn(*leaves)
    dy, dhf = _torch(cots)
    outs, gs = ([y, hf], [dy, dhf]) if dhf is not None else ([y], [dy])
    return [g.numpy() for g in
            torch.autograd.grad(outs, _present(leaves), gs)]


def _vjp(fn, inputs, cots):
    """``jax.vjp`` of ``fn`` over the inputs that are not None."""
    given = [i for i, t in enumerate(inputs) if t is not None]

    def f(*xs):
        args = list(inputs)
        for i, x in zip(given, xs):
            args[i] = x
        return fn(*args)
    primals = [jnp.asarray(inputs[i]) for i in given]
    (y, hf), pull = jax.vjp(f, *primals)
    dy, dhf = cots
    return [np.asarray(g) for g in pull(
        (jnp.asarray(dy), jnp.zeros_like(hf) if dhf is None
         else jnp.asarray(dhf)))]


# ---------------------------------------------------------------------------
# mamba2_scan
# ---------------------------------------------------------------------------

# (bh, s, p, n, h0, dt/decay, dh_final): S ragged against the backward's
# chunk of 8 (77, 37) and the forward's of 64 (130), "tiny": dt ~ 1e-4
# (near 0), "strong": a = -16 with dt up to 1.5, N = 100 (the kernel's
# 128-row state, 4-step chunks)
MAMBA_CASES = [
    (3, 77, 20, 12, False, "default", False),
    (3, 77, 20, 12, True, "default", True),
    (2, 130, 16, 24, True, "strong", False),
    (2, 37, 16, 8, False, "tiny", True),
    (2, 37, 24, 100, True, "default", True),
]


def mamba_inputs(bh, s, p, n, seed, h0=False, decay="default"):
    rs = np.random.RandomState(seed)
    x = rs.randn(bh, s, p).astype(np.float32)
    if decay == "strong":
        dt = (0.01 + 1.49 * rs.rand(bh, s)).astype(np.float32)
        a = np.full(bh, -16.0, np.float32)
    elif decay == "tiny":
        dt = (rs.rand(bh, s) * 2e-4).astype(np.float32)
        a = (-np.abs(rs.randn(bh)) - 0.05).astype(np.float32)
    else:
        dt = (np.abs(rs.randn(bh, s)) * 0.4 + 0.01).astype(np.float32)
        a = (-np.abs(rs.randn(bh)) - 0.05).astype(np.float32)
    b = (rs.randn(bh, s, n) * 0.5).astype(np.float32)
    c = (rs.randn(bh, s, n) * 0.5).astype(np.float32)
    hh = rs.randn(bh, n, p).astype(np.float32) if h0 else None
    return x, dt, b, c, a, hh


def _cotangents(y_shape, h_shape, seed, with_dh):
    rs = np.random.RandomState(seed)
    dy = rs.randn(*y_shape).astype(np.float32)
    dh = rs.randn(*h_shape).astype(np.float32) if with_dh else None
    return dy, dh


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba2_bwd_ref_vs_autograd_and_jax(case):
    bh, s, p, n, h0, decay, with_dh = case
    inputs = mamba_inputs(bh, s, p, n, seed=s + n, h0=h0, decay=decay)
    cots = _cotangents((bh, s, p), (bh, n, p), seed=7 + s, with_dh=with_dh)
    got = _present(mamba2_scan_bwd_ref(*_torch(inputs), *_torch(cots)))
    assert len(got) == (6 if h0 else 5)
    want = _autograd(mamba2_scan_ref, inputs, cots)
    oracle = _vjp(jax_scan_ref, inputs, cots)
    for g, w, o in zip(got, want, oracle):
        assert _rel(g.numpy(), w) <= TOL_AUTOGRAD
        assert _rel(g.numpy(), o) <= TOL_JAX


def test_mamba2_bwd_ref_dh_final_none_is_zero():
    inputs = mamba_inputs(2, 37, 16, 8, seed=1, h0=True)
    dy, _ = _cotangents((2, 37, 16), (2, 8, 16), seed=2, with_dh=False)
    none = mamba2_scan_bwd_ref(*_torch(inputs), torch.as_tensor(dy), None)
    zero = mamba2_scan_bwd_ref(*_torch(inputs), torch.as_tensor(dy),
                               torch.zeros(2, 8, 16))
    for a, b in zip(none, zero):
        assert torch.equal(a, b)


def _mamba_model_inputs(B, H, S, P, N, seed, h0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, H, P).astype(np.float32)
    dt = (np.abs(rs.randn(B, S, H)) * 0.4 + 0.01).astype(np.float32)
    a_log = np.log(1.0 + 15.0 * rs.rand(H)).astype(np.float32)
    b = (rs.randn(B, S, N) * 0.5).astype(np.float32)
    c = (rs.randn(B, S, N) * 0.5).astype(np.float32)
    hh = rs.randn(B, H, N, P).astype(np.float32) if h0 else None
    return x, dt, a_log, b, c, hh


@pytest.mark.parametrize("h0,with_dh", [(False, False), (True, True)])
def test_mamba2_model_layout_sums_vs_ssd_chunked(h0, with_dh):
    """db and dc summed over the heads, da over the batch (then through
    a = -exp(a_log)): ``mamba2_scan_bwd_ref`` on the broadcast inputs and
    the port's CPU ``scan_model_layout`` under autograd, both against
    ``jax.vjp`` of the JAX ``ssd_chunked``."""
    B, H, S, P, N, chunk = 2, 3, 48, 16, 8, 16
    x, dt, a_log, b, c, hh = _mamba_model_inputs(B, H, S, P, N, seed=11,
                                                 h0=h0)
    dy, dhf = _cotangents((B, S, H, P), (B, H, N, P), seed=12,
                          with_dh=with_dh)
    oracle = _vjp(lambda x_, dt_, al, b_, c_, h_: jax_ssd_chunked(
        x_, dt_, al, b_, c_, chunk, h_), (x, dt, a_log, b, c, hh),
        (dy, dhf))
    # the kernel's sums, from the plain backward on the broadcast inputs
    t = dict(zip(("x", "dt", "a_log", "b", "c"),
                 _torch((x, dt, a_log, b, c))))
    a = -torch.exp(t["a_log"])
    flat = mamba2_scan_bwd_ref(
        t["x"].transpose(1, 2).reshape(B * H, S, P),
        t["dt"].transpose(1, 2).reshape(B * H, S),
        t["b"][:, None].expand(B, H, S, N).reshape(B * H, S, N),
        t["c"][:, None].expand(B, H, S, N).reshape(B * H, S, N),
        a[None].expand(B, H).reshape(B * H),
        None if hh is None else torch.as_tensor(hh).reshape(B * H, N, P),
        torch.as_tensor(dy).transpose(1, 2).reshape(B * H, S, P),
        None if dhf is None else torch.as_tensor(dhf).reshape(B * H, N, P))
    dx, ddt, db, dc, da, dh0 = flat
    sums = [dx.reshape(B, H, S, P).transpose(1, 2),
            ddt.reshape(B, H, S).transpose(1, 2),
            da.reshape(B, H).sum(0) * a,
            db.reshape(B, H, S, N).sum(1), dc.reshape(B, H, S, N).sum(1)]
    if h0:
        sums.append(dh0.reshape(B, H, N, P))
    wrapper = _autograd(
        lambda x_, dt_, al, b_, c_, h_: mops.scan_model_layout(
            x_, dt_, b_, c_, al, h_), (x, dt, a_log, b, c, hh), (dy, dhf))
    for g, w, o in zip(sums, wrapper, oracle):
        assert _rel(g.numpy(), o) <= TOL_JAX
        assert _rel(w, o) <= TOL_JAX


# the reference's cases, plus chunks of 64 filled exactly (S = 128) and
# three chunks, the last ragged, from an initial state (S = 200)
MAMBA_CHUNKED_CASES = MAMBA_CASES + [
    (2, 128, 16, 24, False, "default", True),
    (2, 200, 16, 24, True, "default", True),
]


@pytest.mark.parametrize("case", MAMBA_CHUNKED_CASES)
def test_mamba2_chunked_bwd_ref_vs_autograd_and_jax(case):
    """The kernel's algebra (chunks of 64, the exponents summed from
    pivots, the products in 3xTF32) against autograd through the per-step
    plain version and ``jax.vjp`` of the JAX oracle."""
    bh, s, p, n, h0, decay, with_dh = case
    inputs = mamba_inputs(bh, s, p, n, seed=s + n, h0=h0, decay=decay)
    cots = _cotangents((bh, s, p), (bh, n, p), seed=7 + s, with_dh=with_dh)
    got = _present(mamba2_scan_chunked_bwd_ref(*_torch(inputs),
                                               *_torch(cots)))
    assert len(got) == (6 if h0 else 5)
    want = _autograd(mamba2_scan_ref, inputs, cots)
    oracle = _vjp(jax_scan_ref, inputs, cots)
    for g, w, o in zip(got, want, oracle):
        assert _rel(g.numpy(), w) <= TOL_AUTOGRAD
        assert _rel(g.numpy(), o) <= TOL_JAX


def _chunked_model_grads(x, dt, a_log, b, c, dy, h0=None, dhf=None):
    """``mamba2_scan_chunked_bwd_ref`` on the model layout's inputs
    broadcast to the kernel's, summed as the kernel sums them: dx, ddt
    and (through a = -exp(a_log)) da_log, db, dc, and dh0 when h0 is
    given, all in the model's layout."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    t = [torch.as_tensor(v) for v in (x, dt, a_log, b, c, dy)]
    xt, dtt, alt, bt, ct, dyt = t
    a = -torch.exp(alt)
    dx, ddt, db, dc, da, dh0 = mamba2_scan_chunked_bwd_ref(
        xt.transpose(1, 2).reshape(B * H, S, P),
        dtt.transpose(1, 2).reshape(B * H, S),
        bt[:, None].expand(B, H, S, N).reshape(B * H, S, N),
        ct[:, None].expand(B, H, S, N).reshape(B * H, S, N),
        a[None].expand(B, H).reshape(B * H),
        None if h0 is None else torch.as_tensor(h0).reshape(B * H, N, P),
        dyt.transpose(1, 2).reshape(B * H, S, P),
        None if dhf is None else torch.as_tensor(dhf).reshape(B * H, N, P))
    out = [dx.reshape(B, H, S, P).transpose(1, 2),
           ddt.reshape(B, H, S).transpose(1, 2),
           da.reshape(B, H).sum(0) * a,
           db.reshape(B, H, S, N).sum(1), dc.reshape(B, H, S, N).sum(1)]
    if h0 is not None:
        out.append(dh0.reshape(B, H, N, P))
    return out


@pytest.mark.parametrize("h0,with_dh", [(False, False), (True, True)])
def test_mamba2_chunked_bwd_model_layout_vs_ssd_chunked(h0, with_dh):
    """``mamba2_scan_chunked_bwd_ref`` on the broadcast inputs, db and dc
    summed over the heads and da over the batch, against ``jax.vjp`` of
    the JAX ``ssd_chunked``: S = 96 is one chunk of 64 and a ragged one."""
    B, H, S, P, N, chunk = 2, 3, 96, 16, 8, 16
    x, dt, a_log, b, c, hh = _mamba_model_inputs(B, H, S, P, N, seed=13,
                                                 h0=h0)
    dy, dhf = _cotangents((B, S, H, P), (B, H, N, P), seed=14,
                          with_dh=with_dh)
    oracle = _vjp(lambda x_, dt_, al, b_, c_, h_: jax_ssd_chunked(
        x_, dt_, al, b_, c_, chunk, h_), (x, dt, a_log, b, c, hh),
        (dy, dhf))
    got = _chunked_model_grads(x, dt, a_log, b, c, dy, hh, dhf)
    assert len(got) == len(oracle)
    for g, o in zip(got, oracle):
        assert _rel(g.numpy(), o) <= TOL_JAX


# ---------------------------------------------------------------------------
# rwkv6_wkv
# ---------------------------------------------------------------------------

WEAK_LW = -3.4e-4   # the smallest |lw| the model gives (exp(-8))

# (bh, s, k, h0, decay, dh_final): S ragged against the chunks, "strong"
# lw = -5 (the model's clamp), "weak" |lw| ~ 3.4e-4, "mixed" half of the
# channels each, "positive": lw > 0 on some channels (read as 0), K = 100
# (the kernel's 128-row state, 4-step chunks)
RWKV_CASES = [
    (3, 77, 12, False, "default", False),
    (3, 77, 12, True, "default", True),
    (2, 130, 16, True, "strong", False),
    (2, 37, 16, False, "weak", True),
    (2, 77, 16, True, "mixed", True),
    (2, 37, 8, False, "positive", False),
    (2, 37, 100, True, "default", True),
]


def wkv_inputs(bh, s, k, seed, h0=False, decay="default"):
    rs = np.random.RandomState(seed)
    r = (rs.randn(bh, s, k) * 0.5).astype(np.float32)
    kk = (rs.randn(bh, s, k) * 0.5).astype(np.float32)
    v = rs.randn(bh, s, k).astype(np.float32)
    lw = np.clip(-np.abs(rs.randn(bh, s, k)) * 2, -5.0, 0.0)
    weak = WEAK_LW * (1.0 + rs.rand(bh, s, k))
    if decay == "strong":
        lw = np.full_like(lw, -5.0)
    elif decay == "weak":
        lw = weak
    elif decay == "mixed":
        lw = np.concatenate([np.full_like(lw[..., :k // 2], -5.0),
                             weak[..., k // 2:]], axis=-1)
    elif decay == "positive":
        lw = np.where(rs.rand(bh, s, k) < 0.2, 0.3, lw)
    u = (rs.randn(bh, k) * 0.3).astype(np.float32)
    hh = rs.randn(bh, k, k).astype(np.float32) if h0 else None
    return r, kk, v, lw.astype(np.float32), u, hh


def _clamped(fn):
    """``fn`` on min(lw, 0), the decay the kernel reads."""
    def run(r, k, v, lw, u, h0):
        return fn(r, k, v, jnp.minimum(lw, 0.0) if isinstance(
            lw, jnp.ndarray) else lw.clamp(max=0.0), u, h0)
    return run


@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_bwd_ref_vs_autograd_and_jax(case):
    bh, s, k, h0, decay, with_dh = case
    inputs = wkv_inputs(bh, s, k, seed=s + k, h0=h0, decay=decay)
    cots = _cotangents((bh, s, k), (bh, k, k), seed=9 + s, with_dh=with_dh)
    got = _present(rwkv6_wkv_bwd_ref(*_torch(inputs), *_torch(cots)))
    assert len(got) == (6 if h0 else 5)
    want = _autograd(_clamped(rwkv6_wkv_ref), inputs, cots)
    oracle = _vjp(_clamped(jax_wkv_ref), inputs, cots)
    for g, w, o in zip(got, want, oracle):
        assert _rel(g.numpy(), w) <= TOL_AUTOGRAD
        assert _rel(g.numpy(), o) <= TOL_JAX
    if decay == "positive":
        lw = torch.as_tensor(inputs[3])
        assert not bool(got[3][lw > 0].any())


def test_rwkv6_bwd_ref_dh_final_none_is_zero():
    inputs = wkv_inputs(2, 37, 8, seed=1, h0=True)
    dy, _ = _cotangents((2, 37, 8), (2, 8, 8), seed=2, with_dh=False)
    none = rwkv6_wkv_bwd_ref(*_torch(inputs), torch.as_tensor(dy), None)
    zero = rwkv6_wkv_bwd_ref(*_torch(inputs), torch.as_tensor(dy),
                             torch.zeros(2, 8, 8))
    for a, b in zip(none, zero):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h0,with_dh", [(False, False), (True, True)])
def test_rwkv6_model_layout_sums_vs_wkv_chunked(h0, with_dh):
    """du summed over the batch: ``rwkv6_wkv_bwd_ref`` on the broadcast
    inputs and the port's CPU ``wkv_model_layout`` under autograd, both
    against ``jax.vjp`` of the JAX ``wkv_chunked``."""
    B, H, S, K = 2, 3, 48, 16
    flat_in = wkv_inputs(B * H, S, K, seed=21, h0=h0)

    def model(z):       # [B*H, S, K] -> [B, S, H, K]
        return np.ascontiguousarray(
            z.reshape(B, H, S, K).transpose(0, 2, 1, 3))
    r, k, v, lw = (model(z) for z in flat_in[:4])
    u = flat_in[4][:H]
    hh = None if flat_in[5] is None else flat_in[5].reshape(B, H, K, K)
    dy, dhf = _cotangents((B, S, H, K), (B, H, K, K), seed=22,
                          with_dh=with_dh)
    oracle = _vjp(jax_wkv_chunked, (r, k, v, lw, u, hh), (dy, dhf))

    def flat(z):
        return torch.as_tensor(z).transpose(1, 2).reshape(B * H, S, K)
    dr, dk, dv, dlw, du, dh0 = rwkv6_wkv_bwd_ref(
        flat(r), flat(k), flat(v), flat(lw),
        torch.as_tensor(u)[None].expand(B, H, K).reshape(B * H, K),
        None if hh is None else torch.as_tensor(hh).reshape(B * H, K, K),
        flat(dy),
        None if dhf is None else torch.as_tensor(dhf).reshape(B * H, K, K))

    def back(z):
        return z.reshape(B, H, S, K).transpose(1, 2)
    sums = [back(dr), back(dk), back(dv), back(dlw),
            du.reshape(B, H, K).sum(0)]
    if h0:
        sums.append(dh0.reshape(B, H, K, K))
    wrapper = _autograd(wops.wkv_model_layout, (r, k, v, lw, u, hh),
                        (dy, dhf))
    for g, w, o in zip(sums, wrapper, oracle):
        assert _rel(g.numpy(), o) <= TOL_WKV_CHUNKED
        assert _rel(w, o) <= TOL_WKV_CHUNKED
        assert _rel(g.numpy(), w) <= TOL_JAX


# the reference's cases, plus chunks of 64 filled exactly (S = 128) and
# four chunks, the last ragged, from an initial state (S = 200)
RWKV_CHUNKED_CASES = RWKV_CASES + [
    (2, 128, 16, False, "default", True),
    (2, 200, 16, True, "default", True),
]


@pytest.mark.parametrize("case", RWKV_CHUNKED_CASES)
def test_rwkv6_chunked_bwd_ref_vs_autograd_and_jax(case):
    """The kernel's algebra (chunks of 64, the decays through 16-row
    pivots, the diagonal sub-blocks per element, the rectangle of dlw
    summed by sub-blocks, the products in 3xTF32) against autograd through
    the per-step plain version and ``jax.vjp`` of the JAX oracle."""
    bh, s, k, h0, decay, with_dh = case
    inputs = wkv_inputs(bh, s, k, seed=s + k, h0=h0, decay=decay)
    cots = _cotangents((bh, s, k), (bh, k, k), seed=9 + s, with_dh=with_dh)
    got = _present(rwkv6_wkv_chunked_bwd_ref(*_torch(inputs),
                                             *_torch(cots)))
    assert len(got) == (6 if h0 else 5)
    want = _autograd(_clamped(rwkv6_wkv_ref), inputs, cots)
    oracle = _vjp(_clamped(jax_wkv_ref), inputs, cots)
    for g, w, o in zip(got, want, oracle):
        assert _rel(g.numpy(), w) <= TOL_AUTOGRAD
        assert _rel(g.numpy(), o) <= TOL_JAX
    if decay == "positive":
        lw = torch.as_tensor(inputs[3])
        assert not bool(got[3][lw > 0].any())


def _chunked_wkv_model_grads(r, k, v, lw, u, dy, h0=None, dhf=None):
    """``rwkv6_wkv_chunked_bwd_ref`` on the model layout's inputs (numpy,
    [B,S,H,K], u [H,K]) broadcast to the kernel's, summed as the kernel
    sums them: dr, dk, dv, dlw in the model's layout, du over the batch,
    and dh0 [B,H,K,K] when h0 is given."""
    B, S, H, K = r.shape

    def flat(z):
        return torch.as_tensor(z).transpose(1, 2).reshape(B * H, S, K)

    def back(z):
        return z.reshape(B, H, S, K).transpose(1, 2)
    dr, dk, dv, dlw, du, dh0 = rwkv6_wkv_chunked_bwd_ref(
        flat(r), flat(k), flat(v), flat(lw),
        torch.as_tensor(u)[None].expand(B, H, K).reshape(B * H, K),
        None if h0 is None else torch.as_tensor(h0).reshape(B * H, K, K),
        flat(dy),
        None if dhf is None else torch.as_tensor(dhf).reshape(B * H, K, K))
    out = [back(dr), back(dk), back(dv), back(dlw),
           du.reshape(B, H, K).sum(0)]
    if h0 is not None:
        out.append(dh0.reshape(B, H, K, K))
    return out


@pytest.mark.parametrize("h0,with_dh", [(False, False), (True, True)])
def test_rwkv6_chunked_bwd_model_layout_vs_wkv_chunked(h0, with_dh):
    """``rwkv6_wkv_chunked_bwd_ref`` on the broadcast inputs, du summed
    over the batch, against ``jax.vjp`` of the JAX ``wkv_chunked``, at
    ``test_rwkv6_model_layout_sums_vs_wkv_chunked``'s shape (one ragged
    chunk; the cases above cross chunks)."""
    B, H, S, K = 2, 3, 48, 16
    flat_in = wkv_inputs(B * H, S, K, seed=23, h0=h0)

    def model(z):       # [B*H, S, K] -> [B, S, H, K]
        return np.ascontiguousarray(
            z.reshape(B, H, S, K).transpose(0, 2, 1, 3))
    r, k, v, lw = (model(z) for z in flat_in[:4])
    u = flat_in[4][:H]
    hh = None if flat_in[5] is None else flat_in[5].reshape(B, H, K, K)
    dy, dhf = _cotangents((B, S, H, K), (B, H, K, K), seed=24,
                          with_dh=with_dh)
    oracle = _vjp(jax_wkv_chunked, (r, k, v, lw, u, hh), (dy, dhf))
    got = _chunked_wkv_model_grads(r, k, v, lw, u, dy, hh, dhf)
    assert len(got) == len(oracle)
    for g, o in zip(got, oracle):
        assert _rel(g.numpy(), o) <= TOL_WKV_CHUNKED


# ---------------------------------------------------------------------------
# against float64, under the model's decays
# ---------------------------------------------------------------------------

TOL_F64_KERNEL = 1e-5   # x max|want|: the kernels' algorithm vs float64
TOL_F64_CHUNKED = 1e-3  # x max|want|: the CPU's chunked forms vs float64


def _scan64(x, dt, a_log, b, c):
    """The model layout's recurrence, step by step, in the inputs' dtype."""
    B, S, H, P = x.shape
    a = -torch.exp(a_log)
    h = torch.zeros(B, H, b.shape[-1], P, dtype=x.dtype)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t] * a)[..., None, None] * h + torch.einsum(
            "bn,bh,bhp->bhnp", b[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], h))
    return torch.stack(ys, 1)


def _wkv64(r, k, v, lw, u):
    B, S, H, K = r.shape
    h = torch.zeros(B, H, K, K, dtype=r.dtype)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               h + u[None, :, :, None] * kv))
        h = torch.exp(lw[:, t])[..., None] * h + kv
    return torch.stack(ys, 1)


def _grads(fn, inputs, dy, dtype):
    leaves = [torch.as_tensor(t).to(dtype).requires_grad_() for t in inputs]
    return [g.double() for g in torch.autograd.grad(
        fn(*leaves), leaves, torch.as_tensor(dy).to(dtype))]


def test_mamba2_grads_vs_float64_under_model_decays():
    """dt = softplus of a unit normal and a = -exp(log U(1, 16)), as the
    model's init gives them (dt a down to ~ -40 a step), over one of
    ``ssd_chunked``'s 256-step chunks: the per-step plain version (the
    CPU wrapper's) within ``TOL_F64_KERNEL`` of float64 on every
    gradient; the card kernel's chunked algebra
    (``mamba2_scan_chunked_bwd_ref``: chunks of 64, every exponent a sum
    of one sign) within ``TOL_F64_CARD``; the chunked form that training
    runs on the CPU, whose exponents are differences of cumsums reaching
    thousands, within ``TOL_F64_CHUNKED`` (the gate of chip_smoke's
    card-vs-CPU training parity)."""
    B, S, H, P, N = 1, 256, 8, 16, 16
    rs = np.random.RandomState(31)
    x = rs.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, S, H))).astype(np.float32)
    a_log = np.log(1.0 + 15.0 * rs.rand(H)).astype(np.float32)
    b = (rs.randn(B, S, N) * 0.5).astype(np.float32)
    c = (rs.randn(B, S, N) * 0.5).astype(np.float32)
    dy = rs.randn(B, S, H, P).astype(np.float32)
    inputs = (x, dt, a_log, b, c)
    want = _grads(_scan64, inputs, dy, torch.float64)
    kernel = _grads(lambda x_, dt_, al, b_, c_: mops.scan_model_layout(
        x_, dt_, b_, c_, al)[0], inputs, dy, torch.float32)
    chunked = _grads(lambda x_, dt_, al, b_, c_: ssd_chunked(
        x_, dt_, al, b_, c_, 256)[0], inputs, dy, torch.float32)
    card = _chunked_model_grads(*inputs, dy)
    for g, c_, k, w in zip(kernel, chunked, card, want):
        assert _rel(g, w) <= TOL_F64_KERNEL
        assert _rel(c_, w) <= TOL_F64_CHUNKED
        assert _rel(k.double(), w) <= TOL_F64_CARD


def test_rwkv6_grads_vs_float64_under_model_decays():
    """lw in [-5, 0] as the model clamps it: the per-step plain version
    (the CPU wrapper's) within ``TOL_F64_KERNEL`` of float64 on every
    gradient; the card kernel's chunked algebra
    (``rwkv6_wkv_chunked_bwd_ref``: chunks of 64, the decays through
    16-row pivots) within ``TOL_F64_CARD``; the chunked form that training
    runs on the CPU within ``TOL_F64_CHUNKED``."""
    B, S, H, K = 1, 64, 4, 16
    rs = np.random.RandomState(32)
    r, k = ((rs.randn(B, S, H, K) * 0.5).astype(np.float32)
            for _ in range(2))
    v = rs.randn(B, S, H, K).astype(np.float32)
    lw = np.clip(-np.abs(rs.randn(B, S, H, K)) * 2, -5.0, 0.0) \
        .astype(np.float32)
    u = (rs.randn(H, K) * 0.3).astype(np.float32)
    dy = rs.randn(B, S, H, K).astype(np.float32)
    inputs = (r, k, v, lw, u)
    want = _grads(_wkv64, inputs, dy, torch.float64)
    kernel = _grads(lambda *t: wops.wkv_model_layout(*t)[0], inputs, dy,
                    torch.float32)
    chunked = _grads(lambda *t: wkv_chunked(*t)[0], inputs, dy,
                     torch.float32)
    card = _chunked_wkv_model_grads(*inputs, dy)
    for g, c_, k_, w in zip(kernel, chunked, card, want):
        assert _rel(g, w) <= TOL_F64_KERNEL
        assert _rel(c_, w) <= TOL_F64_CHUNKED
        assert _rel(k_.double(), w) <= TOL_F64_CARD


# ---------------------------------------------------------------------------
# the CUDA sources (the compiler is on the card only)
# ---------------------------------------------------------------------------

def _c_argtypes(source, fn: str):
    params = re.search(re.escape(fn) + r"\(([^)]*)\)",
                       source.read_text()).group(1)
    want = []
    for decl in params.split(","):
        decl = " ".join(decl.split())
        if "*" in decl:
            want.append(ctypes.c_void_p)
        else:
            assert decl.startswith("int "), decl
            want.append(ctypes.c_int)
    return want


# per source, the backward's kernels besides the reduce; both are the
# chunked forms transposed, in the forward's chunks of kQ rows
BWD_KERNELS = {
    "mamba2_scan": ("exponents", "states", "chunk"),
    "rwkv6_wkv": ("states", "chunk"),
}


@pytest.mark.parametrize("ops,prefix,rows", [
    (mops, "mamba2_scan", MAMBA_CHUNK_ROWS),
    (wops, "rwkv6_wkv", WKV_CHUNK_ROWS)])
def test_backward_entry_points_match_the_source(ops, prefix, rows):
    assert ops.BWD_ARGTYPES == _c_argtypes(ops.SOURCE, f"int {prefix}_bwd")
    scratch = _c_argtypes(ops.SOURCE, f"long long {prefix}_bwd_scratch_floats")
    assert scratch == [ctypes.c_int] * len(scratch)
    src = ops.SOURCE.read_text()
    assert int(re.search(r"constexpr int kQ = (\d+);",
                         src).group(1)) == rows
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert {f"{prefix}_bwd_{k}_kernel" for k in BWD_KERNELS[prefix]} \
        | {f"{prefix}_bwd_reduce_kernel"} <= set(names)
