"""PyTorch port: the arithmetic of the attention kernels' tensor-core tiles,
emulated on the CPU.

The paged and flash kernels run their products on TF32 tensor cores with
fp32 operands split in two TF32 halves, three products per fp32 product
("3xTF32", ``kernels/common/tf32_mma.cuh``).  Here, with numpy:

* ``rna`` rounds to TF32 by integer ops on the bits, as the kernels do;
* int8 and fp8_e4m3 codes and bf16 values are exact in TF32, so those
  operands need no small half;
* at the main shapes (internlm2's causal prefill, S = 1024, dh = 128, and
  its fused paged chunk, 64 rows over 1024 positions) attention through
  3xTF32 products stays within 1e-6 of float64 and errs less than fp32
  products do (4.4e-7 and 2.9e-8 against fp32's 1.1e-6 and 2.1e-7),
  while one TF32 product per fp32 product misses the kernels' 1e-4 gate
  (9.7e-4 and 1.3e-4);
* the m16n8k8 fragment layouts, and the kernels' reuse of the score
  fragment as the PV product's A fragment with the keys renumbered, give
  P @ V exactly;
* ``kernels/build.py`` keys a library by the headers its source includes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402


def rna(x):
    """Round float32 to TF32 (10-bit mantissa, nearest, ties away from
    zero) by integer ops on the bits: the kernels' ``rna_tf32``."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_view(x):
    """What the tensor core reads of a float32 register: its 19 high
    bits (the low 13 mantissa bits dropped)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """The kernels' split: big rounded to TF32, small = x - big handed over
    unrounded, so the tensor core truncates it."""
    big = rna(x)
    return big, tf32_view(np.asarray(x, np.float32) - big)


def matmul_3xtf32(a, b):
    """a @ b by the kernels' three TF32 products, summed in float64."""
    ab, as_ = split(a)
    bb, bs = split(b)
    f = np.float64
    return as_.astype(f) @ bb.astype(f) + ab.astype(f) @ bs.astype(f) \
        + ab.astype(f) @ bb.astype(f)


def matmul_tf32(a, b):
    return rna(a).astype(np.float64) @ rna(b).astype(np.float64)


def matmul_fp32(a, b):
    return (torch.from_numpy(a) @ torch.from_numpy(b)).double().numpy()


def attention(q, k, v, mask, matmul):
    """softmax(q k^T / sqrt(dh)) v with both products through ``matmul``
    and the softmax in float64."""
    s = matmul(q, np.ascontiguousarray(k.T)) * q.shape[1] ** -0.5
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
    return matmul(p, v)


# ---------------------------------------------------------------------------
# TF32 rounding and the operands that are exact in it
# ---------------------------------------------------------------------------

def test_rna_rounds_to_ten_mantissa_bits_ties_away():
    rs = np.random.RandomState(0)
    x = (rs.randn(10000) * 10.0 ** rs.uniform(-8, 8, 10000)).astype(
        np.float32)
    r = rna(x)
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()
    # within half a TF32 ulp (2^-11 of the binade's base)
    assert (np.abs(r.astype(np.float64) - x) <= np.abs(x) * 2.0 ** -11).all()
    # ties go away from zero: 1 + 2^-11 is halfway between 1 and 1 + 2^-10
    tie = np.float32(1 + 2.0 ** -11)
    assert rna(tie) == np.float32(1 + 2.0 ** -10)
    assert rna(-tie) == -np.float32(1 + 2.0 ** -10)
    # big + small, small as the tensor core reads it, is x to 2^-21
    big, small = split(x)
    err = np.abs(big.astype(np.float64) + small - x)
    assert (err <= np.abs(x) * 2.0 ** -21).all()


def test_int8_fp8_and_bf16_values_are_exact_in_tf32():
    codes = np.arange(-128, 128, dtype=np.float32)
    np.testing.assert_array_equal(rna(codes), codes)
    every_fp8 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn).float().numpy()
    finite = every_fp8[np.isfinite(every_fp8)]
    assert finite.size == 254                  # all but the two NaNs
    np.testing.assert_array_equal(rna(finite), finite)
    bf16 = torch.randn(100000, generator=torch.Generator().manual_seed(1)
                       ).mul_(1000).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(rna(bf16), bf16)
    # so the small half of such an operand is 0, and its 2 products are
    # the 3 of a split fp32 operand
    rs = np.random.RandomState(2)
    w = rs.randn(16, 64).astype(np.float32)
    c = rs.randint(-127, 128, (64, 8)).astype(np.float32)
    assert not split(c)[1].any()
    wb, ws = split(w)
    two = ws.astype(np.float64) @ c + wb.astype(np.float64) @ c
    np.testing.assert_array_equal(two, matmul_3xtf32(w, c))


# ---------------------------------------------------------------------------
# Attention at the main shapes: 3xTF32 against fp32 and TF32
# ---------------------------------------------------------------------------

def _qkv(rows, keys, dh, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, dh).astype(np.float32),
            rs.randn(keys, dh).astype(np.float32),
            rs.randn(keys, dh).astype(np.float32))


@pytest.mark.parametrize("shape", ["flash_causal_s1024", "paged_chunk_s32"])
def test_3xtf32_attention_within_1e6_where_tf32_is_not(shape):
    """internlm2's causal prefill (S = 1024, dh = 128, one head), and the
    fused chunk's 64 rows of one kv head (S = 32 queries x G = 2) over
    1024 cached positions, q, k, v ~ N(0, 1)."""
    if shape == "flash_causal_s1024":
        q, k, v = _qkv(1024, 1024, 128, seed=3)
        mask = np.tril(np.ones((1024, 1024), bool))
    else:
        q, k, v = _qkv(64, 1024, 128, seed=4)
        qpos = 1024 - 32 + np.arange(64) // 2
        mask = np.arange(1024)[None, :] <= qpos[:, None]
    exact = attention(q, k, v, mask, lambda a, b: a.astype(np.float64)
                      @ b.astype(np.float64))
    err3 = np.abs(attention(q, k, v, mask, matmul_3xtf32) - exact).max()
    err32 = np.abs(attention(q, k, v, mask, matmul_fp32) - exact).max()
    err1 = np.abs(attention(q, k, v, mask, matmul_tf32) - exact).max()
    assert err3 <= 1e-6 and err3 <= err32, (err3, err32)
    assert err1 > 1e-4, err1                   # the kernels' fp32 gate


def test_3xtf32_products_track_fp32_products():
    """The two products alone (scores, then weights @ V) at the main
    shapes, against float64: 3xTF32 errs no more than fp32 does."""
    q, k, v = _qkv(64, 1024, 128, seed=5)
    kt = np.ascontiguousarray(k.T)
    f = np.float64
    s_exact = q.astype(f) @ kt.astype(f)
    s3 = np.abs(matmul_3xtf32(q, kt) - s_exact).max()
    s32 = np.abs(matmul_fp32(q, kt) - s_exact).max()
    s1 = np.abs(matmul_tf32(q, kt) - s_exact).max()
    assert s3 <= 2 * s32 and s1 > 100 * s32, (s3, s32, s1)
    p = np.random.RandomState(6).rand(64, 1024).astype(np.float32) / 1024
    pv_exact = p.astype(f) @ v.astype(f)
    assert np.abs(matmul_3xtf32(p, v) - pv_exact).max() <= 1e-6


# ---------------------------------------------------------------------------
# m16n8k8 fragments: the renumbered PV product
# ---------------------------------------------------------------------------

def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3            # g, t


def mma(a_frag, b_frag, c_frag):
    """mma.sync m16n8k8 on per-lane fragments (PTX ISA layouts): a [32,4]
    of a 16x8 A, b [32,2] of an 8x8 B (k x n), c [32,4] of a 16x8 C."""
    g, t = _lanes()
    a = np.zeros((16, 8))
    a[g, t], a[g + 8, t] = a_frag[:, 0], a_frag[:, 1]
    a[g, t + 4], a[g + 8, t + 4] = a_frag[:, 2], a_frag[:, 3]
    b = np.zeros((8, 8))
    b[t, g], b[t + 4, g] = b_frag[:, 0], b_frag[:, 1]
    c = np.zeros((16, 8))
    c[g, 2 * t], c[g, 2 * t + 1] = c_frag[:, 0], c_frag[:, 1]
    c[g + 8, 2 * t], c[g + 8, 2 * t + 1] = c_frag[:, 2], c_frag[:, 3]
    d = c + a @ b
    return np.stack([d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t],
                     d[g + 8, 2 * t + 1]], axis=1)


def test_score_fragment_reused_as_pv_a_fragment():
    """warp_scores then warp_pv of tf32_mma.cuh, lane by lane: scores of
    16 rows x 32 keys in C fragments, reused as A fragments with logical
    key t = physical 2t and t + 4 = 2t + 1, V rows read to match.  Small
    integers keep every sum exact, so the check is equality."""
    rs = np.random.RandomState(7)
    dh = 24
    q = rs.randint(-3, 4, (16, dh)).astype(float)
    k = rs.randint(-3, 4, (32, dh)).astype(float)
    v = rs.randint(-3, 4, (32, dh)).astype(float)
    g, t = _lanes()
    s = np.zeros((4, 32, 4))                   # [n-tile][lane][c0..c3]
    for n in range(4):
        for k0 in range(0, dh, 8):
            a = np.stack([q[g, k0 + t], q[g + 8, k0 + t], q[g, k0 + t + 4],
                          q[g + 8, k0 + t + 4]], axis=1)
            b = np.stack([k[8 * n + g, k0 + t], k[8 * n + g, k0 + t + 4]],
                         axis=1)
            s[n] = mma(a, b, s[n])
    o = np.zeros((dh // 8, 32, 4))
    for kk in range(4):
        a = np.stack([s[kk][:, 0], s[kk][:, 2], s[kk][:, 1], s[kk][:, 3]],
                     axis=1)
        for j in range(dh // 8):
            b = np.stack([v[8 * kk + 2 * t, 8 * j + g],
                          v[8 * kk + 2 * t + 1, 8 * j + g]], axis=1)
            o[j] = mma(a, b, o[j])
    got = np.zeros((16, dh))
    for j in range(dh // 8):
        got[g, 8 * j + 2 * t], got[g, 8 * j + 2 * t + 1] = o[j][:, 0], \
            o[j][:, 1]
        got[g + 8, 8 * j + 2 * t], got[g + 8, 8 * j + 2 * t + 1] = \
            o[j][:, 2], o[j][:, 3]
    np.testing.assert_array_equal(got, (q @ k.T) @ v)


# ---------------------------------------------------------------------------
# the build keys a library by its headers
# ---------------------------------------------------------------------------

def test_library_path_hashes_included_headers(tmp_path):
    (tmp_path / "common").mkdir()
    (tmp_path / "k").mkdir()
    header = tmp_path / "common" / "h.cuh"
    header.write_text("#pragma once\nconstexpr int kX = 1;\n")
    source = tmp_path / "k" / "k.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "../common/h.cuh"\n'
                      "int f() { return kX; }\n")
    assert build.sources_of(source) == [source.resolve(), header.resolve()]
    before = build.library_path(source)
    header.write_text("#pragma once\nconstexpr int kX = 2;\n")
    assert build.library_path(source) != before


def test_attention_sources_share_the_tf32_header():
    header = (build.REPO_ROOT / "src" / "repro_torch" / "kernels" / "common"
              / "tf32_mma.cuh").resolve()
    for ops in (pa_ops, fa_ops):
        assert build.sources_of(ops.SOURCE)[1:] == [header]
