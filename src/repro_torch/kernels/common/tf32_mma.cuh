// TF32 tensor-core tiles at fp32 accuracy, and cp.async staging, for the
// attention kernels of this package on NVIDIA Hopper (sm_90a).  Included by
// paged_attention.cu and flash_attention.cu (kernels/build.py hashes every
// header a source includes, so an edit here rebuilds both).
//
// The port's numerics are fp32 with TF32 off, so a product on the tensor
// cores splits each fp32 operand x into two TF32 values, big = rna(x) and
// small = x - big, and sums three TF32 products per fp32 product
// ("3xTF32"): a_small*b_big + a_big*b_small + a_big*b_big, accumulated in
// fp32.  The dropped a_small*b_small term is ~2^-22 of the product, so the
// result carries fp32's error, not TF32's (2^-11).  Operands whose values
// are exact in TF32 (int8 and fp8_e4m3 codes, bf16) skip their small part:
// 2 products when one side is exact, 1 when both are.  rna(x) rounds to
// the nearest value with a 10-bit mantissa, ties away from zero, by integer
// ops on the bits (the rounding of cvt.rna.tf32.f32, with the 13 low bits
// cleared explicitly).  small is handed over unrounded: the tensor core
// reads the 19 high bits of an operand register, so small loses at most
// 2^-10 of itself (2^-21 of x), and the split costs 3 instructions, not 5.
//
// Warp tiles use mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  With
// g = lane / 4 and t = lane % 4, its fragments are (PTX ISA):
//   A (16 x 8, row)  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col)   b0 (k = t, n = g)         b1 (k = t + 4, n = g)
//   C (16 x 8)       c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// The C fragment of the scores is not laid out as an A fragment.  warp_pv
// does not move it: it renumbers the 8 keys of each k step so that logical
// key t is physical key 2t and logical key t + 4 is physical key 2t + 1.
// Then a0..a3 are c0, c2, c1, c3 of the same thread, and the B fragment
// reads V rows 2t and 2t + 1 to match (tests/test_torch_attention_numerics.py
// emulates these fragments and holds the renumbered product to P @ V).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace tf32mma {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// Every value of T is exact in TF32 (8 significant bits or fewer).
template <typename T>
constexpr bool kExactTf32 = !std::is_same<T, float>::value;

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = rna_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));  // read as TF32
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a @ b, with a split (ab, as) and b as stored: 3 products for fp32 b,
// 2 when b is exact, the small terms first.
template <typename T>
__device__ __forceinline__ void mma_fp32(float c[4], const uint32_t ab[4],
                                         const uint32_t as[4], float b0,
                                         float b1) {
  if constexpr (kExactTf32<T>) {
    mma(c, as, __float_as_uint(b0), __float_as_uint(b1));
    mma(c, ab, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t bb0, bs0, bb1, bs1;
    split(b0, bb0, bs0);
    split(b1, bb1, bs1);
    mma(c, as, bb0, bb1);
    mma(c, ab, bs0, bs1);
    mma(c, ab, bb0, bb1);
  }
}

// Scores of a warp's 16 query rows against 32 keys, s[n] the C fragment of
// keys 8n..8n+7.  qs: the warp's first row of fp32 q in shared memory (row
// stride ldq floats, ldq / 4 odd or = 4 mod 8 for conflict-free reads); ks:
// the 32 key rows of T (stride ldk elements); kd8 head-dim steps of 8.
// QExact: q's values are exact in TF32 (bf16 inputs); then K is too and
// one product suffices.  The small products accumulate apart from the big
// one (3 independent chains per key tile, summed at the end), so the
// tensor cores are not kept waiting on one accumulator.
template <bool QExact, typename T>
__device__ __forceinline__ void warp_scores(float s[4][4], const float* qs,
                                            int ldq, const T* ks, int ldk,
                                            int kd8, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float sa[4][4], sb[4][4];  // a_small * b_big, a_big * b_small
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = sa[n][e] = sb[n][e] = 0.f;
  const float* qa = qs + g * ldq + t;
  const float* qb = qa + 8 * ldq;
  const T* kr = ks + g * ldk + t;
#pragma unroll 2
  for (int kk = 0; kk < kd8; ++kk) {
    const int k0 = kk * 8;
    const float av[4] = {qa[k0], qb[k0], qa[k0 + 4], qb[k0 + 4]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (QExact)
        ab[i] = __float_as_uint(av[i]);
      else
        split(av[i], ab[i], as[i]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const T* kp = kr + n * 8 * ldk + k0;
      const float b0 = to_f32(kp[0]), b1 = to_f32(kp[4]);
      if constexpr (QExact) {
        static_assert(kExactTf32<T>, "exact q comes with exact keys");
        mma(s[n], ab, __float_as_uint(b0), __float_as_uint(b1));
      } else if constexpr (kExactTf32<T>) {
        mma(sa[n], as, __float_as_uint(b0), __float_as_uint(b1));
        mma(s[n], ab, __float_as_uint(b0), __float_as_uint(b1));
      } else {
        uint32_t bb0, bs0, bb1, bs1;
        split(b0, bb0, bs0);
        split(b1, bb1, bs1);
        mma(sa[n], as, bb0, bb1);
        mma(sb[n], ab, bs0, bs1);
        mma(s[n], ab, bb0, bb1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += sa[n][e] + sb[n][e];
}

// o[j] (C fragments of head dims 8j..8j+7, j < nt <= NT) += p @ v, with p
// the 16 x 32 weights in the C layout of warp_scores and v 32 rows of T
// (stride ldv elements, ldv = 4 mod 8 in 4-byte words for conflict-free
// reads).  Keys are renumbered per k step as the header says; p is split.
template <int NT, typename T>
__device__ __forceinline__ void warp_pv(float o[NT][4], const float p[4][4],
                                        const T* vs, int ldv, int nt,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ab[4], as[4];
    split(p[kk][0], ab[0], as[0]);  // row g,     key 2t
    split(p[kk][2], ab[1], as[1]);  // row g + 8, key 2t
    split(p[kk][1], ab[2], as[2]);  // row g,     key 2t + 1
    split(p[kk][3], ab[3], as[3]);  // row g + 8, key 2t + 1
    const T* v0 = vs + (kk * 8 + 2 * t) * ldv + g;
    const T* v1 = v0 + ldv;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) mma_fp32<T>(o[j], ab, as, to_f32(v0[8 * j]),
                              to_f32(v1[8 * j]));
  }
}

// cp.async: 16 (or 4) bytes global -> shared; fill = false writes zeros and
// reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32mma
