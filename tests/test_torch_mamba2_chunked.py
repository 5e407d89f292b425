"""PyTorch port: the Mamba2 scan kernel's chunked decomposition on the CPU.

``mamba2_scan_chunked_ref`` is what ``csrc/mamba2_scan.cu`` computes: chunks
of ``CHUNK_ROWS`` steps (the last ragged), the cumsum restarted per chunk,
the exponent masked before exp, the four products in 3xTF32 (as
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

from repro.kernels.mamba2_scan import mamba2_scan as jax_kernel  # noqa: E402
from repro.kernels.mamba2_scan import \
    mamba2_scan_ref as jax_scan_ref  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops  # noqa: E402
from repro_torch.kernels.mamba2_scan.ref import (  # noqa: E402
    CHUNK_ROWS, mamba2_scan_chunked_ref)

TOL = 1e-4   # x max|want|, on y and on the state

# (bh, s, p, n, h0, decay, pallas chunk or None): tests/test_kernels.py's
# three cases, S not a multiple of the kernel's chunk (1000, 77, 37, and
# 300 with an initial state), P = 20 with N = 100, and strong decay (a =
# -16, dt up to 1.5: cum falls by ~770 over one of the kernel's chunks and
# ~3000 over the Pallas kernel's 256).  The Pallas kernel takes no h0.
CASES = [
    (3, 64, 32, 16, False, "default", 16),
    (3, 128, 64, 32, False, "default", 32),
    (3, 96, 64, 64, False, "default", 32),
    (2, 1000, 64, 64, False, "default", 256),
    (3, 77, 64, 64, False, "default", 256),
    (3, 37, 64, 64, False, "default", 256),
    (3, 77, 20, 100, True, "default", None),
    (3, 77, 20, 100, False, "default", 256),
    (3, 256, 64, 64, False, "strong", 256),
    (2, 300, 64, 64, True, "strong", None),
]


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def scan_inputs(bh, s, p, n, seed, h0=False, decay="default"):
    """tests/test_kernels.py's distributions; ``decay="strong"``: a = -16
    and dt uniform in [0.01, 1.5)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(bh, s, p).astype(np.float32)
    if decay == "strong":
        dt = (0.01 + 1.49 * rs.rand(bh, s)).astype(np.float32)
        a = np.full(bh, -16.0, np.float32)
    else:
        dt = (np.abs(rs.randn(bh, s)) * 0.4 + 0.01).astype(np.float32)
        a = (-np.abs(rs.randn(bh)) - 0.05).astype(np.float32)
    b = (rs.randn(bh, s, n) * 0.5).astype(np.float32)
    c = (rs.randn(bh, s, n) * 0.5).astype(np.float32)
    hh = rs.randn(bh, n, p).astype(np.float32) if h0 else None
    return x, dt, b, c, a, hh


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _torch(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("bh,s,p,n,h0,decay,chunk", CASES)
def test_chunked_vs_jax_oracle_and_pallas(bh, s, p, n, h0, decay, chunk):
    arrays = scan_inputs(bh, s, p, n, seed=s + n, h0=h0, decay=decay)
    y, hf = mamba2_scan_chunked_ref(*_torch(arrays))
    assert y.dtype == torch.float32 and tuple(y.shape) == (bh, s, p)
    assert tuple(hf.shape) == (bh, n, p)
    assert bool(torch.isfinite(y).all() and torch.isfinite(hf).all())
    x, dt, b, c, a, hh = (None if v is None else jnp.asarray(v)
                          for v in arrays)
    jy, jh = jax_scan_ref(x, dt, b, c, a, h0=hh)
    assert _rel(y, jy) <= TOL
    assert _rel(hf, jh) <= TOL
    if chunk is not None:
        ky, kh = jax_kernel(x, dt, b, c, a, chunk=chunk, interpret=True)
        assert _rel(y, ky) <= TOL
        assert _rel(hf, kh) <= TOL


@pytest.mark.parametrize("cut", [1, 64, 100])
def test_chunked_state_chains_through_h0(cut):
    """Two calls chained through the state give one call's y and state:
    h0 enters as the first chunk's h_prev, wherever the cut falls."""
    x, dt, b, c, a, hh = _torch(scan_inputs(2, 200, 32, 64, seed=cut,
                                            h0=True))
    y, hf = mamba2_scan_chunked_ref(x, dt, b, c, a, hh)
    y1, h1 = mamba2_scan_chunked_ref(x[:, :cut], dt[:, :cut], b[:, :cut],
                                     c[:, :cut], a, hh)
    y2, h2 = mamba2_scan_chunked_ref(x[:, cut:], dt[:, cut:], b[:, cut:],
                                     c[:, cut:], a, h1)
    assert _rel(torch.cat([y1, y2], 1), y) <= TOL
    assert _rel(h2, hf) <= TOL


def test_chunked_empty_sequence_returns_h0():
    x, dt, b, c, a, hh = _torch(scan_inputs(2, 0, 8, 16, seed=0, h0=True))
    y, hf = mamba2_scan_chunked_ref(x, dt, b, c, a, hh)
    assert tuple(y.shape) == (2, 0, 8) and torch.equal(hf, hh)
    y0, hz = mamba2_scan_chunked_ref(x, dt, b, c, a)
    assert tuple(y0.shape) == (2, 0, 8) and not bool(hz.any())


def test_chunked_pad_rows_leave_the_state():
    """Rows with dt = 0 (the model's length mask) past the real ones leave
    the state as the real rows left it, as the kernel's zero-filled tail
    of a ragged chunk does."""
    x, dt, b, c, a, _ = _torch(scan_inputs(2, 130, 16, 32, seed=3))
    dt_pad = dt.clone()
    dt_pad[:, 90:] = 0.0
    y_all, h_all = mamba2_scan_chunked_ref(x, dt_pad, b, c, a)
    y_cut, h_cut = mamba2_scan_chunked_ref(x[:, :90], dt[:, :90], b[:, :90],
                                           c[:, :90], a)
    assert _rel(h_all, h_cut) <= 1e-6
    assert _rel(y_all[:, :90], y_cut) <= 1e-6


def test_kernel_source_constants_and_names():
    """The emulation's chunk is the kernel's, and every CUDA kernel in the
    source has ``mamba2_scan`` in its name (chip_smoke.py's profiler
    families and device times select kernels by that name)."""
    src = ops.SOURCE.read_text()
    assert int(re.search(r"constexpr int kQ = (\d+);", src).group(1)) \
        == CHUNK_ROWS
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert names and all("mamba2_scan" in name for name in names)
