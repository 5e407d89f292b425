"""PyTorch port: the RWKV6 wkv kernel's chunked decomposition on the CPU.

``rwkv6_wkv_chunked_ref`` is what ``csrc/rwkv6_wkv.cu`` computes: chunks of
``CHUNK_ROWS`` steps (the last ragged), the cumsum of lw restarted per
chunk and summed row by row in fp32, A in sub-blocks of ``SUB_ROWS`` rows
(through a pivot left of the diagonal and in a diagonal sub-block's
lower-left quadrant, per element in its two triangles of ``TRI_ROWS``
rows; every exponent <= 0), the products in 3xTF32 (as
``kernels/tf32.py`` models the tensor cores) and the state passed between
chunks in fp32.  It is held, on the same numpy inputs, against JAX's
per-step oracle and the interpret-mode Pallas kernel (which takes no
initial state) within 1e-4 x max|want| on y and on the final state: the
same gate ``chip_smoke.py`` puts on the kernel against the plain version.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_wkv import rwkv6_wkv as jax_kernel  # noqa: E402
from repro.kernels.rwkv6_wkv import \
    rwkv6_wkv_ref as jax_wkv_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import (  # noqa: E402
    CHUNK_ROWS, SUB_ROWS, TRI_ROWS, chunk_cumsum, rwkv6_wkv_chunked_ref)

TOL = 1e-4   # x max|want|, on y and on the state
# the smallest |lw| the model gives: lw = -exp(clamp(w0 + lora, -8, 2))
# (models/rwkv6.py), so |lw| >= exp(-8) = 3.35e-4
WEAK_LW = -3.4e-4

# (bh, s, k, h0, decay, pallas chunk or None): tests/test_kernels.py's
# three cases, S not a multiple of the kernel's chunk (1000, 77, 37),
# an initial state, K = 100 (padded to 128), and three decays: "strong"
# (lw = -5, the model's clamp, on every channel: c falls by 320 within a
# chunk), "weak" (|lw| near its smallest, a long memory) and "mixed"
# (half the channels strong, half weak).  The Pallas kernel takes no h0,
# and its chunk must divide S.
CASES = [
    (3, 64, 32, False, "default", 16),
    (3, 128, 64, False, "default", 16),
    (3, 48, 64, False, "default", 8),
    (2, 1000, 64, False, "default", 8),
    (3, 77, 64, False, "default", 1),
    (3, 37, 64, False, "default", 1),
    (2, 300, 64, True, "default", None),
    (3, 77, 100, True, "default", None),
    (3, 80, 100, False, "default", 16),
    (2, 200, 64, False, "strong", 8),
    (2, 300, 64, True, "strong", None),
    (2, 256, 64, False, "weak", 16),
    (2, 300, 64, True, "weak", None),
    (2, 192, 64, False, "mixed", 16),
    (2, 300, 64, True, "mixed", None),
]


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def wkv_inputs(bh, s, k, seed, h0=False, decay="default"):
    """tests/test_kernels.py's distributions (r, k N(0, 0.25), v N(0, 1),
    lw = clip(-2|N(0, 1)|, -5, 0), u N(0, 0.09)); ``decay`` "strong": lw
    = -5; "weak": lw uniform in [2 WEAK_LW, WEAK_LW]; "mixed": the first
    half of the channels strong, the second weak."""
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
    u = (rs.randn(bh, k) * 0.3).astype(np.float32)
    hh = rs.randn(bh, k, k).astype(np.float32) if h0 else None
    return r, kk, v, lw.astype(np.float32), u, hh


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _torch(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("bh,s,k,h0,decay,chunk", CASES)
def test_chunked_vs_jax_oracle_and_pallas(bh, s, k, h0, decay, chunk):
    arrays = wkv_inputs(bh, s, k, seed=s + k, h0=h0, decay=decay)
    y, hf = rwkv6_wkv_chunked_ref(*_torch(arrays))
    assert y.dtype == torch.float32 and tuple(y.shape) == (bh, s, k)
    assert tuple(hf.shape) == (bh, k, k)
    assert bool(torch.isfinite(y).all() and torch.isfinite(hf).all())
    r, kk, v, lw, u, hh = (None if a is None else jnp.asarray(a)
                           for a in arrays)
    jy, jh = jax_wkv_ref(r, kk, v, lw, u, h0=hh)
    assert _rel(y, jy) <= TOL
    assert _rel(hf, jh) <= TOL
    if chunk is not None:
        ky, kh = jax_kernel(r, kk, v, lw, u, chunk=chunk, interpret=True)
        assert _rel(y, ky) <= TOL
        assert _rel(hf, kh) <= TOL


@pytest.mark.parametrize("cut", [1, 64, 100])
def test_chunked_state_chains_through_h0(cut):
    """Two calls chained through the state give one call's y and state:
    h0 enters as the first chunk's h_prev, wherever the cut falls."""
    r, kk, v, lw, u, hh = _torch(wkv_inputs(2, 200, 32, seed=cut, h0=True))
    y, hf = rwkv6_wkv_chunked_ref(r, kk, v, lw, u, hh)
    y1, h1 = rwkv6_wkv_chunked_ref(r[:, :cut], kk[:, :cut], v[:, :cut],
                                   lw[:, :cut], u, hh)
    y2, h2 = rwkv6_wkv_chunked_ref(r[:, cut:], kk[:, cut:], v[:, cut:],
                                   lw[:, cut:], u, h1)
    assert _rel(torch.cat([y1, y2], 1), y) <= TOL
    assert _rel(h2, hf) <= TOL


def test_chunked_empty_sequence_returns_h0():
    r, kk, v, lw, u, hh = _torch(wkv_inputs(2, 0, 8, seed=0, h0=True))
    y, hf = rwkv6_wkv_chunked_ref(r, kk, v, lw, u, hh)
    assert tuple(y.shape) == (2, 0, 8) and torch.equal(hf, hh)
    y0, hz = rwkv6_wkv_chunked_ref(r, kk, v, lw, u)
    assert tuple(y0.shape) == (2, 0, 8) and not bool(hz.any())


def test_chunked_pad_steps_keep_state():
    """Steps with k = 0 and lw = 0 (the model's masking of bucket padding)
    after the real ones leave the state bit for bit as the real steps left
    it, as the kernel's zero-filled tail of a ragged chunk does: the
    chunks stay aligned to t = 0, exp(0) = 1 and a chunk of padding adds
    an exact 0."""
    r, kk, v, lw, u, hh = wkv_inputs(2, 300, 32, seed=3, h0=True)
    kk[:, 90:] = 0.0
    lw[:, 90:] = 0.0
    _y, h_all = rwkv6_wkv_chunked_ref(*_torch((r, kk, v, lw, u, hh)))
    _y, h_cut = rwkv6_wkv_chunked_ref(*_torch((r[:, :90], kk[:, :90],
                                               v[:, :90], lw[:, :90], u,
                                               hh)))
    assert torch.equal(h_all, h_cut)


@pytest.mark.parametrize("k", [16, 64, 100])
def test_chunk_cumsum_never_rises(k):
    """The kernel's cumsum agrees with a float64 cumsum to fp32 rounding
    and never rises along the rows (each exponent of the decomposition is
    then <= 0 exactly), on mixed decay; a positive lw is read as 0."""
    lw = torch.as_tensor(wkv_inputs(2, CHUNK_ROWS, k, seed=k,
                                    decay="mixed")[3])
    lw[0, 5] = 0.25           # outside the contract: read as 0
    c = chunk_cumsum(lw)
    want = torch.cumsum(lw.double().clamp(max=0.0), dim=1)
    assert float((c.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert bool((c[:, 1:] <= c[:, :-1]).all()) and bool((c <= 0).all())


def test_every_exponent_is_at_most_zero(monkeypatch):
    """The decomposition takes no exp of a positive argument: every
    argument the emulation hands torch.exp, on strong decay (where a
    positive exponent would overflow) and mixed decay."""
    args = []
    real_exp = torch.exp

    def exp(x, *a, **kw):
        finite = x[torch.isfinite(x)]
        args.append(float(finite.max()) if finite.numel() else -np.inf)
        return real_exp(x, *a, **kw)

    monkeypatch.setattr(torch, "exp", exp)
    for decay in ("strong", "mixed"):
        rwkv6_wkv_chunked_ref(*_torch(wkv_inputs(2, 150, 32, seed=5, h0=True,
                                                 decay=decay)))
    assert args and max(args) <= 0.0


def test_kernel_source_constants_and_names():
    """The emulation's chunk, sub-block and triangle are the kernel's, and
    every CUDA kernel in the source (the forward's three, the backward's
    three) has ``rwkv6_wkv`` in its name (chip_smoke.py's profiler
    families and device times select kernels by that name)."""
    src = ops.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert const("kQ") == CHUNK_ROWS and const("kSub") == SUB_ROWS
    assert SUB_ROWS == 2 * TRI_ROWS
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert len(names) == 6 and all("rwkv6_wkv" in name for name in names)
