"""PyTorch port: the tensor-core matrix products of ``moe_gmm`` and
``fused_matmul``, emulated on the CPU.

Both CUDA kernels share one GEMM arithmetic (``kernels/common/
tf32_gemm.cuh``: ``mma.sync`` for ``moe_gmm``, ``wgmma`` for
``fused_matmul``): fp32 operands split in two TF32 halves, 3 TF32
products per fp32 product (2 where one operand is exact in TF32, 1 where
both are), each 64-deep stage's products summed apart and promoted into an
fp32 total.  ``moe_gmm`` runs it transposed per (group, expert, F tile)
over the expert's live rows in steps of 16; ``fused_matmul`` takes x at its
stored width and applies the row scale to the fp32 sum.  The tensor cores' accumulator is modelled as
rounding toward zero, which is why each stage is summed apart.  Here
``kernels/tf32.py`` and the ``*_tiled_ref`` functions emulate that
arithmetic and decomposition, and are held

* against the plain versions, JAX's oracles and the interpret-mode Pallas
  kernels on the same numpy inputs (the reference tests' shapes, counts
  65 / 72 / 80, a count of 0, C = 300 with every row live, D and F not
  multiples of 4; fused_matmul's dtypes and ragged shapes): fp32 within
  1e-5 x max|want| of the plain versions (only summation orders differ),
  bf16 within one bf16 ulp, the Pallas kernels within their tests' 2e-4;
* against float64 at moe_gmm's D = 6144 and fused_matmul's n = 512,
  within 1e-5, where one TF32 product per fp32 product misses 1e-4, and
  for both orders of fused_matmul's row scale on every case of
  ``chip_smoke.py``'s ``FMM_CASES`` (full K, a corner of the output);
* rows at or past a count exactly 0, and the rows the kernel computes.

The kernels against their plain versions at the same cases need the card
(``ops.supported()``); here they skip.
"""

import importlib.util
import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_matmul import fused_matmul as jax_fmm_kernel  # noqa: E402,E501
from repro.kernels.fused_matmul import matmul1 as jax_matmul1  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_gmm_kernel  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm_ref as jax_gmm_ref  # noqa: E402
from repro_torch.kernels import build, tf32  # noqa: E402
from repro_torch.kernels.fused_matmul import ops as fops  # noqa: E402
from repro_torch.kernels.fused_matmul.ref import (  # noqa: E402
    fused_matmul_tiled_ref, matmul1)
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.moe_gmm import ref as gref  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    moe_gmm_ref, moe_gmm_rows_computed, moe_gmm_tiled_ref)

BF16_ULP = 2.0 ** -7
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int8": torch.int8}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16, "int8": jnp.int8}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# TF32 arithmetic
# ---------------------------------------------------------------------------

def test_rna_and_split_match_the_bit_formulas():
    rs = np.random.RandomState(0)
    x = (rs.randn(20000) * 10.0 ** rs.uniform(-6, 6, 20000)).astype(
        np.float32)
    bits = x.view(np.uint32)
    want = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    big, small = tf32.split(torch.from_numpy(x))
    np.testing.assert_array_equal(tf32.rna(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(big.numpy(), want)
    assert not (small.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(big.double().numpy() + small.double().numpy() - x)
    assert (err <= np.abs(x) * 2.0 ** -21).all()


def test_every_fp16_value_is_exact_in_tf32():
    """fp16 has 11 significant bits and its subnormals (down to 2^-24)
    are normal numbers in TF32's 8-bit exponent: so fp16 x needs no
    small half, like int8 and bf16."""
    every = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.float16).float()
    finite = every[torch.isfinite(every)]
    assert finite.numel() == 63488
    assert torch.equal(tf32.rna(finite), finite)
    assert all(tf32.exact_in_tf32(dt) for dt in
               (torch.int8, torch.bfloat16, torch.float16))
    assert not tf32.exact_in_tf32(torch.float32)


@pytest.mark.parametrize("a,b,n", [
    ("float32", "float32", 3), ("int8", "float32", 2),
    ("bfloat16", "float32", 2), ("float16", "float32", 2),
    ("float32", "bfloat16", 2), ("int8", "bfloat16", 1),
    ("bfloat16", "bfloat16", 1)])
def test_tf32_products_per_fp32_product(a, b, n):
    assert tf32.products(TORCH_DT[a], TORCH_DT[b]) == n


def test_mma_sum_drops_nothing_for_exact_operands():
    """Small integers: every product and sum is exact, so the emulated
    mainloop equals the integer product for any mix of split sides."""
    rs = np.random.RandomState(1)
    a = torch.as_tensor(rs.randint(-50, 50, (24, 37)).astype(np.float32))
    b = torch.as_tensor(rs.randint(-50, 50, (37, 19)).astype(np.float32))
    want = (a.double() @ b.double()).float()
    for a_exact in (False, True):
        for b_exact in (False, True):
            assert torch.equal(tf32.mma_sum(a, b, a_exact, b_exact), want)


# ---------------------------------------------------------------------------
# moe_gmm: the kernel's decomposition
# ---------------------------------------------------------------------------

# name, (E, C, D, F), counts per expert: the reference test's shapes with
# its pattern [C, C//2, 0, 1], then the row cases of the redesign
GMM_CASES = [
    ("ref_4x64x128x128", (4, 64, 128, 128), None),
    ("ref_8x32x64x256", (8, 32, 64, 256), None),
    ("ref_4x80x64x128", (4, 80, 64, 128), None),
    ("counts_65_72_80_0", (4, 80, 96, 136), [65, 72, 80, 0]),
    ("counts_0_1_full", (4, 80, 64, 128), [0, 1, 80, 80]),
    ("c300_all_live", (2, 300, 64, 136), [300, 300]),
    ("c300_passes", (4, 300, 40, 64), [300, 129, 128, 0]),
    ("ragged_d67_f73", (4, 37, 67, 73), [37, 18, 0, 1]),
]


def _gmm_case(e, c, d, f, counts, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(e, c, d).astype(np.float32)
    w = (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    if counts is None:
        counts = [c, c // 2, 0, 1] * (e // 4)
    return x, w, np.asarray(counts, np.int32)


def _divisor_block(n, want):
    return want if n % want == 0 else n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,counts", GMM_CASES,
                         ids=[c[0] for c in GMM_CASES])
def test_moe_tiled_ref_vs_plain_jax_and_pallas(name, shape, counts, dtype):
    e, c, d, f = shape
    x, w, cnt = _gmm_case(e, c, d, f, counts, seed=len(name) + c)
    tdt, jdt = TORCH_DT[dtype], JAX_DT[dtype]
    tx, tw = torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt)
    tc = torch.as_tensor(cnt)
    got = moe_gmm_tiled_ref(tx, tw, tc)
    assert got.dtype == tdt and got.shape == (e, c, f)
    valid = np.arange(c)[None, :, None] < cnt[:, None, None]
    assert not _np(got)[~np.broadcast_to(valid, got.shape)].any()
    tol = 1e-5 if dtype == "float32" else BF16_ULP
    assert _rel(_np(got), _np(moe_gmm_ref(tx, tw, tc))) <= tol
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    assert _rel(_np(got), _np(jax_gmm_ref(jx, jw, jnp.asarray(cnt)))) <= tol
    kern = _np(jax_gmm_kernel(jx, jw, jnp.asarray(cnt),
                              block_m=_divisor_block(c, 32),
                              block_n=_divisor_block(f, 64),
                              block_k=_divisor_block(d, 64), interpret=True))
    np.testing.assert_allclose(
        _np(got) * valid, kern * valid,
        **(dict(rtol=2e-4, atol=2e-4) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2)))


def test_moe_tiled_ref_group_dimension_and_no_counts():
    x, w, cnt = _gmm_case(4, 24, 40, 72, [24, 3, 0, 17], seed=3)
    x2 = np.stack([x, x[::-1].copy()])
    c2 = np.stack([cnt, cnt[::-1].copy()])
    got = moe_gmm_tiled_ref(torch.as_tensor(x2), torch.as_tensor(w),
                            torch.as_tensor(c2))
    assert got.shape == (2, 4, 24, 72)
    for g in range(2):
        want = moe_gmm_tiled_ref(torch.as_tensor(x2[g]), torch.as_tensor(w),
                                 torch.as_tensor(c2[g]))
        assert torch.equal(got[g], want)
    full = moe_gmm_tiled_ref(torch.as_tensor(x), torch.as_tensor(w))
    assert _rel(_np(full), np.einsum("ecd,edf->ecf", x.astype(np.float64),
                                     w.astype(np.float64))) <= 1e-6


@pytest.mark.parametrize("counts,capacity,rows", [
    ([65, 72, 80, 0], 80, 80 + 80 + 80),
    ([1, 0, 9, 16], 16, 16 + 16 + 16),
    ([300], 300, 128 + 128 + 48),
    ([129, 500, -3], 200, 128 + 16 + 128 + 80),
    (None, 37, 48)])
def test_rows_computed_in_steps_of_sixteen(counts, capacity, rows):
    """An expert's rows are computed in passes of 128, each rounded up to
    16: n8 tiles taken in turn by 2 warps (the old kernel: tiles of 64,
    so 65-80 live rows took 128)."""
    assert moe_gmm_rows_computed(counts, capacity) == rows


def test_moe_3xtf32_within_1e5_of_float64_at_dbrx_depth():
    """dbrx's D = 6144 (the gate/up product's K): 3xTF32 with the stage
    promotion stays within 1e-5 of float64, one TF32 product misses the
    kernels' 1e-4 gate."""
    x, w, cnt = _gmm_case(2, 16, 6144, 64, [16, 9], seed=5)
    tx, tw, tc = (torch.as_tensor(a) for a in (x, w, cnt))
    mask = np.arange(16)[None, :, None] < cnt[:, None, None]
    exact = np.einsum("ecd,edf->ecf", x.astype(np.float64),
                      w.astype(np.float64)) * mask
    assert _rel(_np(moe_gmm_tiled_ref(tx, tw, tc)), exact) <= 1e-5
    one = np.einsum("ecd,edf->ecf", tf32.rna(tx).double().numpy(),
                    tf32.rna(tw).double().numpy()) * mask
    assert _rel(one, exact) > 1e-4


def test_stage_promotion_holds_a_truncating_accumulator_to_fp32():
    """The tensor cores add into their accumulator rounding toward zero
    (as modelled in ``tf32.mma_sum``): over dbrx's D = 6144 at 3 products
    one accumulator drifts past the kernels' 1e-4 (max abs), while a
    fresh accumulator per 64-deep stage, added into an fp32 total rounded
    to nearest, stays within 1e-5 of float64."""
    rs = np.random.RandomState(9)
    x = torch.as_tensor(rs.randn(16, 6144).astype(np.float32))
    w = torch.as_tensor((rs.randn(6144, 64) / np.sqrt(6144)).astype(
        np.float32))
    exact = (x.double() @ w.double()).numpy()
    drift = tf32.mma_sum(x, w, False, False, stage_k=None).double().numpy()
    assert np.abs(drift - exact).max() > 1e-4
    staged = tf32.mma_sum(x, w, False, False).double().numpy()
    assert _rel(staged, exact) <= 1e-5
    assert tf32.STAGE_K == 64


def test_moe_kernel_constants_match_the_emulation():
    src = gops.SOURCE.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kBF"] == gref.F_TILE
    assert consts["kBR"] == gref.ROW_PASS
    assert consts["kRowStep"] == gref.ROW_STEP == tf32.K_STEP * consts["kWN"]
    header = (gops.SOURCE.parents[2] / "common" / "tf32_gemm.cuh").read_text()
    assert re.search(r"constexpr int kBK = (\d+);", header).group(1) == str(
        tf32.STAGE_K)


def test_moe_wrapper_reads_no_device_value_on_the_host():
    """dbrx's fused chunk runs under set_sync_debug_mode("error"): the
    wrapper hands row_counts to the kernel and never reads them."""
    code = inspect.getsource(gops.moe_gmm)
    for call in (".item(", ".tolist(", ".cpu(", "int(", ".numpy("):
        assert call not in code, call


# ---------------------------------------------------------------------------
# fused_matmul: stored-width x, the epilogue scale, 2 / 1 products
# ---------------------------------------------------------------------------

FMM_SHAPES = [(128, 128, 128), (256, 512, 128), (512, 256, 384)]
FMM_CASES_CPU = (
    [(s, xd, xd, od, sc) for s in FMM_SHAPES
     for xd, od in (("float32", "float32"), ("bfloat16", "bfloat16"))
     for sc in (False, True)]
    + [((256, 512, 128), "int8", "float32", "float32", sc)
       for sc in (False, True)]
    + [((512, 256, 384), "float16", "float32", "float32", True),
       ((256, 512, 128), "int8", "bfloat16", "float32", True),
       ((37, 53, 29), "int8", "float32", "float32", True),
       ((37, 1000, 29), "int8", "float32", "float32", True),
       ((40, 64, 31), "int8", "float32", "float32", True),
       ((37, 53, 29), "bfloat16", "float32", "float32", False),
       ((300, 1, 200), "int8", "float32", "float32", True),
       ((256, 256, 256), "int8", "float32", "bfloat16", True)])


def _fmm_id(case):
    (m, k, n), xd, wd, od, sc = case
    return f"{m}x{k}x{n}-{xd}-{wd}-{od}-{'scaled' if sc else 'unscaled'}"


def _values(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-127, 127, shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(v).to(TORCH_DT[dtype]).float().numpy()


def _fmm_inputs(m, k, n, xd, wd, scaled, seed):
    rng = np.random.default_rng(seed)
    x, w = _values(rng, (m, k), xd), _values(rng, (k, n), wd)
    sc = (np.abs(rng.standard_normal((m, 1))).astype(np.float32)
          if scaled else None)
    return x, w, sc


@pytest.mark.parametrize("case", FMM_CASES_CPU, ids=_fmm_id)
def test_fused_tiled_ref_vs_plain_and_jax(case):
    (m, k, n), xd, wd, od, scaled = case
    x, w, sc = _fmm_inputs(m, k, n, xd, wd, scaled, seed=m + k + n)
    tx = torch.from_numpy(x).to(TORCH_DT[xd])
    tw = torch.from_numpy(w).to(TORCH_DT[wd])
    ts = None if sc is None else torch.from_numpy(sc)
    got = fused_matmul_tiled_ref(tx, tw, ts, out_dtype=TORCH_DT[od])
    assert got.dtype == TORCH_DT[od] and got.shape == (m, n)
    tol = BF16_ULP if od == "bfloat16" else 1e-5
    assert _rel(_np(got), _np(matmul1(tx, tw, ts,
                                      out_dtype=TORCH_DT[od]))) <= tol
    jx = jnp.asarray(x).astype(JAX_DT[xd])
    jw = jnp.asarray(w).astype(JAX_DT[wd])
    js = None if sc is None else jnp.asarray(sc)
    want = jax_matmul1(jx, jw, js, out_dtype=JAX_DT[od])
    assert _rel(_np(got), _np(want)) <= tol
    if (m, k, n) in FMM_SHAPES and xd == wd:
        kern = jax_fmm_kernel(jx, jw, js, block_m=128, block_n=128,
                              block_k=128, interpret=True)
        assert _rel(_np(got), _np(kern)) <= (2e-2 if od == "bfloat16"
                                             else 2e-4)


def test_fused_epilogue_scale_within_1e5_of_float64_at_n512():
    """fig09's int8 x with fp32 w and row scales at n = 512: the kernel's
    2 products with the scale on the sum, and the reference's order
    (prep, then an fp32 product), both within 1e-5 of float64; one TF32
    product misses 1e-4."""
    x, w, sc = _fmm_inputs(512, 512, 512, "int8", "float32", True, seed=7)
    tx = torch.from_numpy(x).to(torch.int8)
    tw, ts = torch.from_numpy(w), torch.from_numpy(sc)
    exact = (x.astype(np.float64) * sc) @ w.astype(np.float64)
    assert _rel(_np(fused_matmul_tiled_ref(tx, tw, ts)), exact) <= 1e-5
    assert _rel(_np(matmul1(tx, tw, ts)), exact) <= 1e-5
    one = (x.astype(np.float64) * sc) @ tf32.rna(tw).double().numpy()
    assert _rel(one, exact) > 1e-4


def _chip_smoke_fmm_cases():
    path = build.REPO_ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FMM_CASES, mod.KERNEL_TOL, mod.FMM_BF16_TOL


def test_epilogue_order_within_the_card_gate_on_every_fmm_case():
    """Every ``FMM_CASES`` case of chip_smoke.py at full K (a 64 x 64
    corner of the output: each output's arithmetic depends on K only):
    the kernel's order and the plain version's, each against float64,
    and the two against each other inside the card's gate."""
    cases, fp32_tol, bf16_tol = _chip_smoke_fmm_cases()
    assert len(cases) >= 29
    for i, (name, (m, k, n), xd, wd, od, scaled) in enumerate(cases):
        m, n = min(m, 64), min(n, 64)
        x, w, sc = _fmm_inputs(m, k, n, xd, wd, scaled, seed=100 + i)
        tx = torch.from_numpy(x).to(TORCH_DT[xd])
        tw = torch.from_numpy(w).to(TORCH_DT[wd])
        ts = None if sc is None else torch.from_numpy(sc)
        odt = TORCH_DT[od]
        kern = fused_matmul_tiled_ref(tx, tw, ts, out_dtype=odt)
        plain = matmul1(tx, tw, ts, out_dtype=odt)
        exact = x.astype(np.float64) @ w.astype(np.float64)
        if sc is not None:
            exact = exact * sc
        tol = BF16_ULP if od == "bfloat16" else 1e-5
        assert _rel(_np(kern), exact) <= tol, name
        assert _rel(_np(plain), exact) <= tol, name
        gate = bf16_tol if od == "bfloat16" else fp32_tol
        assert _rel(_np(kern), _np(plain)) <= gate, name


def test_gemm_sources_share_the_mainloop_header():
    common = build.REPO_ROOT / "src" / "repro_torch" / "kernels" / "common"
    for ops in (fops, gops):
        assert build.sources_of(ops.SOURCE)[1:] == [
            (common / "tf32_gemm.cuh").resolve(),
            (common / "tf32_mma.cuh").resolve()]


# ---------------------------------------------------------------------------
# The kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_kernels():
    if not (gops.supported() and fops.supported()):
        pytest.skip("needs a CUDA device where the moe_gmm and fused_matmul "
                    "kernels build and launch (ops.supported() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,counts", GMM_CASES,
                         ids=[c[0] for c in GMM_CASES])
def test_cuda_moe_gmm_vs_plain(cuda_kernels, name, shape, counts, dtype):
    e, c, d, f = shape
    x, w, cnt = _gmm_case(e, c, d, f, counts, seed=len(name) + c)
    tdt = TORCH_DT[dtype]
    tx = torch.as_tensor(x).to(cuda_kernels, tdt)
    tw = torch.as_tensor(w).to(cuda_kernels, tdt)
    tc = torch.as_tensor(cnt).to(cuda_kernels)
    got = gops.moe_gmm(tx, tw, tc)
    want = moe_gmm_ref(tx, tw, tc)
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    tol = 1e-4 if dtype == "float32" else 2e-2 * scale
    assert float((got.float() - want.float()).abs().max()) <= tol
    pad = torch.arange(c, device=cuda_kernels)[None, :] >= tc[:, None]
    assert not bool(got[pad].any())


@pytest.mark.parametrize("case", FMM_CASES_CPU, ids=_fmm_id)
def test_cuda_fused_matmul_vs_plain(cuda_kernels, case):
    (m, k, n), xd, wd, od, scaled = case
    x, w, sc = _fmm_inputs(m, k, n, xd, wd, scaled, seed=m + k + n)
    tx = torch.from_numpy(x).to(cuda_kernels, TORCH_DT[xd])
    tw = torch.from_numpy(w).to(cuda_kernels, TORCH_DT[wd])
    ts = None if sc is None else torch.from_numpy(sc).to(cuda_kernels)
    got = fops.fused_matmul(tx, tw, ts, out_dtype=TORCH_DT[od])
    want = matmul1(tx, tw, ts, out_dtype=TORCH_DT[od])
    torch.cuda.synchronize()
    assert _rel(_np(got.cpu()), _np(want.cpu())) <= (
        2e-2 if od == "bfloat16" else 1e-4)
