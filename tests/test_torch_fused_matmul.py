"""PyTorch port: fused_matmul (the paper's §5 data-preparation study)
against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages
(bf16 operands are made as fp32 values that bf16 holds exactly, so
both sides cast them without rounding).  Tolerances:

* ``prep`` bitwise (one fp32 cast and one multiply on both sides);
* ``matmul1`` and ``fused_matmul`` (CPU: the plain version) against
  JAX's ``ref.matmul1``: 1e-5 x max|want| with an fp32 output (only the
  product's summation order differs) and one bf16 ulp (2**-7 x
  max|want|) with a bf16 output, where the fp32 sums are rounded
  afterwards; against the interpret-mode Pallas kernel at ``block_*=128``
  within ``tests/test_kernels.py``'s own tolerances (2e-4 fp32, 2e-2
  bf16), at its 3 shapes x {fp32, bf16} x {scaled, unscaled}, plus int8
  x with fp32 w (2e-4 x max|want|: its outputs are ~127x larger, and so
  is each sum's fp32 rounding);
* ``matmul``'s gradients (dw, dscale, and dx for a float x) against the
  reference's ``custom_vjp`` ``ops.matmul`` and ``jax.grad`` of
  ``matmul1``: 1e-5 x max|want| in fp32, one bf16 ulp for a bf16 dx;
* ragged shapes (the port's kernel masks its edges; the reference's
  blocks would refuse them) against a float64 numpy product: 1e-5;
* fig11's byte count against the reference's ``cost_analysis`` on
  XLA:CPU, exactly.

The Hopper kernel against its plain version runs only where
``ops.supported()`` passes; here it skips.
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.fused_matmul as jax_pkg  # noqa: E402
from repro.kernels.fused_matmul import fused_matmul as jax_kernel  # noqa: E402
from repro.kernels.fused_matmul import matmul as jax_matmul  # noqa: E402
from repro.kernels.fused_matmul import matmul1 as jax_matmul1  # noqa: E402
from repro.kernels.fused_matmul import prep as jax_prep  # noqa: E402
import repro_torch.kernels.fused_matmul as port_pkg  # noqa: E402
from repro_torch.benchmarks import fig09_operator_scaling as fig09  # noqa: E402
from repro_torch.benchmarks import fig11_fused_prep as fig11  # noqa: E402
from repro_torch.kernels.fused_matmul import ops  # noqa: E402
from repro_torch.kernels.fused_matmul import (matmul, matmul1,  # noqa: E402
                                              prep)

# tests/test_kernels.py's fused-matmul shapes (m, k, n)
SHAPES = [(128, 128, 128), (256, 512, 128), (512, 256, 384)]
# (x dtype, w dtype): the reference test's two, and fig09/fig11's
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("int8", "float32")]
CASES = [(shape, dt, scaled) for shape in SHAPES for dt in DTYPES[:2]
         for scaled in (False, True)] \
    + [((256, 512, 128), DTYPES[2], scaled) for scaled in (False, True)]
RAGGED = [(37, 29, 53), (1, 64, 65), (65, 1, 33), (5, 7, 9), (3, 200, 130)]
BF16_ULP = 2.0 ** -7
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int8": torch.int8}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16, "int8": jnp.int8}


def _values(rng, shape, dtype):
    """fp32 numpy values that ``dtype`` holds exactly."""
    if dtype == "int8":
        return rng.integers(-127, 127, shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(v).to(TORCH_DT[dtype]).float().numpy()


def _inputs(m, k, n, xd, wd, scaled, seed=0):
    rng = np.random.default_rng(seed)
    x = _values(rng, (m, k), xd)
    w = _values(rng, (k, n), wd)
    sc = (np.abs(rng.standard_normal((m, 1))).astype(np.float32)
          if scaled else None)
    return x, w, sc


def _to_torch(x, w, sc, xd, wd):
    return (torch.from_numpy(x).to(TORCH_DT[xd]),
            torch.from_numpy(w).to(TORCH_DT[wd]),
            None if sc is None else torch.from_numpy(sc))


def _to_jax(x, w, sc, xd, wd):
    return (jnp.asarray(x).astype(JAX_DT[xd]), jnp.asarray(w).astype(
        JAX_DT[wd]), None if sc is None else jnp.asarray(sc))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _case_id(case):
    (m, k, n), (xd, wd), scaled = case
    return f"{m}x{k}x{n}-{xd}-{wd}-{'scaled' if scaled else 'unscaled'}"


def test_exports_mirror_the_reference():
    assert set(port_pkg.__all__) == set(jax_pkg.__all__) | {"supported"}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_version_matches_jax_oracle(case):
    (m, k, n), (xd, wd), scaled = case
    arrays = _inputs(m, k, n, xd, wd, scaled)
    tx, tw, ts = _to_torch(*arrays, xd, wd)
    jx, jw, js = _to_jax(*arrays, xd, wd)
    np.testing.assert_array_equal(prep(tx, ts).numpy(),
                                  np.asarray(jax_prep(jx, js)))
    want = jax_matmul1(jx, jw, js)
    tol = BF16_ULP if wd == "bfloat16" else 1e-5
    for got in (matmul1(tx, tw, ts), port_pkg.fused_matmul_ref(tx, tw, ts),
                ops.fused_matmul(tx, tw, ts)):
        assert got.dtype == TORCH_DT[wd]
        assert _rel(got, want) <= tol
    # an explicit fp32 output from bf16 operands: no rounding after the sum
    got = ops.fused_matmul(tx, tw, ts, out_dtype=torch.float32)
    want = jax_matmul1(jx, jw, js, out_dtype=jnp.float32)
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_version_matches_pallas_kernel(case):
    (m, k, n), (xd, wd), scaled = case
    arrays = _inputs(m, k, n, xd, wd, scaled, seed=1)
    got = ops.fused_matmul(*_to_torch(*arrays, xd, wd))
    want = jax_kernel(*_to_jax(*arrays, xd, wd), block_m=128, block_n=128,
                      block_k=128, interpret=True)
    if xd == "int8":
        # outputs ~127x the float cases': the fp32 rounding of each sum
        # grows with them, so the reference's 2e-4 is taken x max|want|
        assert _rel(got, want) <= 2e-4
        return
    tol = dict(rtol=2e-2, atol=2e-2) if wd == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("xd", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("scaled", [False, True])
def test_matmul_gradients_match_custom_vjp_and_autodiff(xd, scaled):
    m, k, n = 64, 48, 32
    x, w, sc = _inputs(m, k, n, xd, "float32", scaled, seed=2)
    g = np.random.default_rng(3).standard_normal((m, n)).astype(np.float32)
    float_x = xd != "int8"

    tx, tw, ts = _to_torch(x, w, sc, xd, "float32")
    tw.requires_grad_(True)
    if float_x:
        tx.requires_grad_(True)
    if ts is not None:
        ts.requires_grad_(True)
    (matmul(tx, tw, ts) * torch.from_numpy(g)).sum().backward()
    got = {"dw": tw.grad}
    if float_x:
        got["dx"] = tx.grad
    else:
        assert tx.grad is None
    if ts is not None:
        got["dscale"] = ts.grad

    jx, jw, js = _to_jax(x, w, sc, xd, "float32")
    names = (["dx"] if float_x else []) + ["dw"] + (["dscale"] if scaled
                                                    else [])
    argnums = tuple(i for i, name in enumerate(["dx", "dw", "dscale"])
                    if name in names)
    for op in (jax_matmul, jax_matmul1):
        def loss(a, b, s, op=op):
            return jnp.sum(op(a, b, s) * g)
        grads = jax.grad(loss, argnums=argnums)(jx, jw, js)
        for name, want in zip(names, grads):
            tol = BF16_ULP if (name == "dx" and xd == "bfloat16") else 1e-5
            assert got[name].dtype == {"dx": TORCH_DT[xd],
                                       "dw": torch.float32,
                                       "dscale": torch.float32}[name]
            assert _rel(got[name], want) <= tol, (op, name)


@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("xd", ["int8", "float16", "float32"])
def test_ragged_shapes_match_float64_product(m, k, n, xd):
    x, w, sc = _inputs(m, k, n, xd, "float32", True, seed=4)
    got = ops.fused_matmul(*_to_torch(x, w, sc, xd, "float32"))
    want = (x.astype(np.float64) * sc.astype(np.float64)) \
        @ w.astype(np.float64)
    assert _rel(got, want) <= 1e-5


def _bad_calls():
    x = torch.zeros(4, 6, dtype=torch.int8)
    w = torch.zeros(6, 5)
    sc = torch.ones(4, 1)
    meta = torch.device("meta")
    return [
        ("x_float64", TypeError, "x must be", (x.double(), w, sc), {}),
        ("w_int8", TypeError, "w must be", (x, w.to(torch.int8), sc), {}),
        ("w_float16", TypeError, "w must be", (x, w.half(), sc), {}),
        ("out_float16", TypeError, "out_dtype",
         (x, w, sc), {"out_dtype": torch.float16}),
        ("scale_float64", TypeError, "x_scale must be",
         (x, w, sc.double()), {}),
        ("x_on_meta", ValueError, "cuda or cpu",
         (x.to(meta), w.to(meta), None), {}),
        ("w_on_meta", ValueError, "w is on", (x, w.to(meta), sc), {}),
        ("scale_on_meta", ValueError, "x_scale is on", (x, w, sc.to(meta)),
         {}),
        ("x_not_contiguous", ValueError, "x must be contiguous",
         (torch.zeros(6, 4, dtype=torch.int8).T, w, sc), {}),
        ("w_not_contiguous", ValueError, "w must be contiguous",
         (x, torch.zeros(5, 6).T, sc), {}),
        ("scale_not_contiguous", ValueError, "x_scale must be contiguous",
         (x, w, torch.ones(4, 2)[:, :1]), {}),
        ("x_3d", ValueError, "shape mismatch", (x[None], w, sc), {}),
        ("k_mismatch", ValueError, "shape mismatch", (x, w[:5], sc), {}),
        ("empty_m", ValueError, ">= 1", (x[:0], w, None), {}),
        ("scale_shape", ValueError, "x_scale must be", (x, w, sc[:, 0]),
         {}),
    ]


@pytest.mark.parametrize("name,exc,match,args,kw", _bad_calls(),
                         ids=[c[0] for c in _bad_calls()])
def test_wrapper_refuses(name, exc, match, args, kw):
    before = ops.launches
    with pytest.raises(exc, match=match):
        ops.fused_matmul(*args, **kw)
    assert ops.launches == before


def test_cpu_calls_launch_nothing():
    before = ops.launches
    x, w, sc = _to_torch(*_inputs(8, 16, 4, "int8", "float32", True),
                         "int8", "float32")
    ops.fused_matmul(x, w, sc)
    w.requires_grad_(True)
    matmul(x, w, sc).sum().backward()
    assert ops.launches == before


def test_ctypes_signature_matches_c_entry_point():
    """The wrapper's argtypes follow the C signature in the CUDA source
    (the compiler is on the card only)."""
    src = ops.SOURCE.read_text()
    params = re.search(r"int fused_matmul_fwd\(([^)]*)\)", src).group(1)
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
# fig09 and fig11
# ---------------------------------------------------------------------------

def test_unfused_bytes_equal_reference_cost_analysis():
    n = 128
    x8 = jnp.zeros((n, n), jnp.int8)
    w = jnp.zeros((n, n), jnp.float32)
    sc = jnp.ones((n, 1), jnp.float32)
    ca_p = jax.jit(jax_prep).lower(x8, sc).compile().cost_analysis()
    ca_d = jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((n, n), jnp.float32), w).compile() \
        .cost_analysis()
    assert fig11.unfused_bytes(n) == \
        ca_p["bytes accessed"] + ca_d["bytes accessed"]
    assert fig11.fused_bytes(n) == n * n + 4 * n + 4 * n * n + 4 * n * n
    # 47.05% at fig11's n = 1024, the scales' 4n included (1 - 9/17 =
    # 47.06% in the limit)
    saved = 100 * (1 - fig11.fused_bytes(1024) / fig11.unfused_bytes(1024))
    assert f"{saved:.1f}" == "47.0"


def _rows(out):
    rows = {}
    for line in out.strip().splitlines():
        name, us, derived = line.split(",", 2)
        rows[name] = (float(us), dict(kv.split("=") for kv in
                                      derived.split(",")))
    return rows


@pytest.mark.parametrize("n", [32, 64])
def test_fig09_main_on_cpu(n, capsys):
    res = fig09.main(["--device", "cpu", "--sizes", f"{n},{2 * n}"])
    rows = _rows(capsys.readouterr().out)
    assert list(rows) == [f"fig09.matmul_{n}", f"fig09.matmul_{2 * n}"]
    for us, derived in rows.values():
        assert us > 0
        assert set(derived) == {"kernel_us", "prep_overhead_pct"}
        assert 0 <= float(derived["prep_overhead_pct"]) <= 100
    assert sorted(res) == [n, 2 * n]


@pytest.mark.parametrize("n", [32, 64])
def test_fig11_main_on_cpu(n, capsys):
    before = ops.launches
    res = fig11.main(["--device", "cpu", "--n", str(n)])
    rows = _rows(capsys.readouterr().out)
    assert list(rows) == ["fig11.fused_prep", "fig11.unfused_prep"]
    fused, unfused = rows["fig11.fused_prep"], rows["fig11.unfused_prep"]
    assert set(fused[1]) == {"speedup", "bytes_saved_pct"}
    assert fused[1]["speedup"].endswith("x")
    saved = 100 * (1 - (9 * n * n + 4 * n) / (17 * n * n + 4 * n))
    assert fused[1]["bytes_saved_pct"] == f"{saved:.1f}"
    assert set(unfused[1]) == {"bytes"}
    assert float(unfused[1]["bytes"]) == pytest.approx(17 * n * n + 4 * n,
                                                       rel=1e-3)
    assert res["fused_calls"] == 12          # 2 warm-up + 10 timed
    assert ops.launches == before            # the CPU runs the plain version


def test_fig_inputs_follow_the_reference_distributions():
    x8, w, sc = fig09.make_inputs(256, torch.device("cpu"))
    assert (x8.dtype, w.dtype, sc.dtype) == (torch.int8, torch.float32,
                                             torch.float32)
    assert x8.shape == w.shape == (256, 256) and sc.shape == (256, 1)
    assert int(x8.min()) >= -127 and int(x8.max()) <= 126
    assert bool((sc >= 0).all())
    again = fig09.make_inputs(256, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip((x8, w, sc), again))


# ---------------------------------------------------------------------------
# the Hopper kernel against its plain version (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_kernel():
    if not ops.supported():
        pytest.skip("needs a CUDA device where the fused_matmul kernel "
                    "builds and launches (ops.supported() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", SHAPES + RAGGED)
@pytest.mark.parametrize("xd,wd,od", [("int8", "float32", "float32"),
                                      ("bfloat16", "bfloat16", "bfloat16"),
                                      ("float16", "float32", "float32"),
                                      ("float32", "float32", "bfloat16")])
def test_cuda_kernel_vs_plain(cuda_kernel, m, k, n, xd, wd, od):
    arrays = _inputs(m, k, n, xd, wd, True, seed=5)
    x, w, sc = (a.to(cuda_kernel) for a in _to_torch(*arrays, xd, wd))
    before = ops.launches
    got = ops.fused_matmul(x, w, sc, out_dtype=TORCH_DT[od])
    want = matmul1(x, w, sc, out_dtype=TORCH_DT[od])
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert _rel(got.cpu(), want.cpu()) <= (2e-2 if od == "bfloat16"
                                           else 1e-4)
