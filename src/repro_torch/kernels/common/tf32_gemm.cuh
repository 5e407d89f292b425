// GEMM mainloops on TF32 tensor cores at fp32 accuracy, for the matrix
// products of this package on NVIDIA Hopper (sm_90a): Gemm (mma.sync
// m16n8k8, moe_gmm.cu) and GemmWgmma (wgmma m64n64k8, fused_matmul.cu, at
// the end of this file), which share the split, the stage ring, the
// copies and the promotion below.  It builds on tf32_mma.cuh (the 3xTF32
// split, mma.sync, cp.async) and leaves that header as it is, so the
// attention kernels that include it do not change.
//
// A block computes one BM x BN tile of C = A @ B, A logically [M, K] and B
// [K, N], both read from row-major matrices in device memory.  Each operand
// is either K-contiguous (a memory row is one M or N index, K runs along
// it: fused_matmul's x, moe_gmm's x) or MN-contiguous (a memory row is one
// k: fused_matmul's w [K, N], moe_gmm's w [D, F] read as A = w^T).  Its
// tile lands in shared memory in the same layout at its stored width, so
// an int8 x crosses shared memory at a quarter of fp32's bytes and is
// converted in registers on its way into the A fragment.
//
// Numerics: fp32 with TF32 off, as the reference computes.  An fp32
// operand is split into big = rna(x) and small = x - big (tf32mma::split)
// and each fp32 product is the sum of TF32 products small*big, big*small
// and big*big, added into the fp32 accumulator in that order.  An operand
// whose every value is exact in TF32 (int8, bf16, fp16: 11 significant
// bits or fewer, fp16's subnormals normal in TF32's 8-bit exponent) has no
// small half: 2 products when one side is exact, 1 when both are.
//
// Loads: a ring of STAGES shared-memory stages of BK = 64 along K, filled
// by cp.async while the tensor cores work on an earlier stage.  The copy
// width is chosen per operand by the caller: 16 bytes when the matrix base
// is 16-byte aligned and a memory row is a multiple of 16 bytes, else 4
// bytes when both are multiples of 4, else one element at a time (plain
// loads and shared stores into the same ring).  Past an edge a stage holds
// zeros: K-contiguous tiles zero-fill the K tail and the rows past the
// valid M/N extent, MN-contiguous tiles the rows past K and the columns
// past the valid extent.
//
// Accumulation: the tensor cores add into their fp32 accumulator with
// truncation, so a long chain of MMAs drifts toward zero by about one
// ulp per add: over D = 6144 at 3 products, past the 1e-4 gate
// (kernels/tf32.py models it).  Each stage's MMAs therefore sum into a
// fresh accumulator, 24 adds at most, and the stage's sum is added into
// the block's fp32 total by the CUDA cores with round-to-nearest, as an
// fp32 FMA chain is.
// (A 64-deep stage halves the barriers and promotions of a 32-deep one.)
//
// Bank conflicts: a fragment load reads (index g, k t) for lane = 4g + t.
// K-contiguous rows are padded by 16 bytes (row stride = 4 mod 8 words),
// MN-contiguous rows by 32 bytes (= 8 mod 32 words), so each warp-wide
// load of 1-, 2- or 4-byte elements touches distinct banks or one word.
//
// Warps: WM x WN.  Warp (wm, wn) owns MT = BM / WM / 16 m16 tiles (rows
// wm * BM / WM + 16 i) and NT = BN / WN / 8 n8 tiles, the j-th being tile
// j * WN + wn, so the n8 tiles of a ragged N spread evenly over the WN
// warps of a scheduler.  A caller computes the first NTL of a warp's n8
// tiles (a template argument: no branch in the inner loops), and B rows
// past them are not loaded: moe_gmm computes an expert's rows in steps of
// 8 (times WN), not of the block's tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace tf32gemm {

__device__ __forceinline__ float elem_f32(float x) { return x; }
__device__ __forceinline__ float elem_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float elem_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float elem_f32(int8_t x) {
  // 1.5 * 2^23 + x, exact, less 1.5 * 2^23: two full-rate ops, not a
  // quarter-rate int-to-float conversion
  return __int_as_float(0x4B400000 + x) - 12582912.f;
}

// Every value of T is exact in TF32.
template <typename T>
constexpr bool kExact = !std::is_same<T, float>::value;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Copy width in bytes for a row-major matrix at `base` whose memory rows
// are `row_bytes` long: 16, 4 or 1 (element copies).
inline int copy_width(const void* base, long long row_bytes) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  if ((p & 15u) == 0 && row_bytes % 16 == 0) return 16;
  if ((p & 3u) == 0 && row_bytes % 4 == 0) return 4;
  return 1;
}

// Shared-memory geometry of one operand tile: MN indices x BK along K, at
// stored width, K-contiguous (KC) or MN-contiguous.
template <typename T, bool KC, int MN, int BK>
struct Tile {
  static constexpr int rows = KC ? MN : BK;
  static constexpr int row_bytes = (KC ? BK : MN) * (int)sizeof(T);
  static constexpr int ld = row_bytes + (KC ? 16 : 32);  // bytes
  static constexpr int bytes = rows * ld;
  static_assert(KC ? row_bytes % 32 == 0 : row_bytes % 128 == 0,
                "padding keeps fragment loads conflict-free");

  // element (MN index i, k) of a stage, as fp32
  __device__ static __forceinline__ float at(const unsigned char* s, int i,
                                             int k) {
    const int r = KC ? i : k, c = KC ? k : i;
    return elem_f32(*reinterpret_cast<const T*>(s + r * ld + c * sizeof(T)));
  }
};

// A row-major matrix in device memory, read as tiles of one operand.
struct Src {
  const unsigned char* base;  // the matrix; the harmless source of zero fills
  long long ld;               // bytes between memory rows
  long long origin;           // byte offset of the block's (i0, k = 0)
  int valid;                  // MN indices from i0 that exist
  int width;                  // copy width: 16, 4 or 1
};

// Stage `kt` of an operand: the tile's first TOUCH memory-side rows
// (K-contiguous: the MN indices that are computed, the others never read;
// MN-contiguous: all BK rows) are written, each row holding bytes_valid
// real bytes, zeros after them, and the rows at or past rows_valid all
// zeros.  Rows that are whole in memory and 16-byte copyable take the
// fast path: each thread copies one fixed 16-byte column of every
// THREADS / chunks-per-row-th row, its addresses stepped, not recomputed.
template <typename T, bool KC, int MN, int BK, int THREADS, int TOUCH>
__device__ __forceinline__ void load_stage(unsigned char* s, const Src& src,
                                           int kt, int K, int tid) {
  using L = Tile<T, KC, MN, BK>;
  constexpr int rows_touch = KC ? TOUCH : BK;
  const long long k0 = (long long)kt * BK;
  const unsigned char* g =
      src.base + src.origin + (KC ? k0 * (long long)sizeof(T) : k0 * src.ld);
  const int rows_valid = KC ? src.valid : K - (int)k0;
  const int bytes_valid =
      (KC ? K - (int)k0 : src.valid) * (int)sizeof(T);
  if (src.width == 16 && bytes_valid >= L::row_bytes) {
    constexpr int kCh = L::row_bytes / 16;
    static_assert(THREADS % kCh == 0, "whole rows per pass of the threads");
    constexpr int kRowsPer = THREADS / kCh;
    const int r0 = tid / kCh, c = (tid % kCh) * 16;
    unsigned char* sp = s + r0 * L::ld + c;
    const unsigned char* gp = g + r0 * src.ld + c;
#pragma unroll
    for (int i = 0; i < (rows_touch + kRowsPer - 1) / kRowsPer; ++i) {
      const int r = r0 + i * kRowsPer;
      if (rows_touch % kRowsPer == 0 || r < rows_touch) {
        const bool in = r < rows_valid;
        tf32mma::cp_async16(sp + i * kRowsPer * L::ld,
                            in ? gp + i * kRowsPer * src.ld : src.base, in);
      }
    }
  } else if (src.width == 16) {
    constexpr int kCh = L::row_bytes / 16;
    for (int idx = tid; idx < rows_touch * kCh; idx += THREADS) {
      const int r = idx / kCh, c = (idx - r * kCh) * 16;
      const bool in = r < rows_valid && c < bytes_valid;
      tf32mma::cp_async16(s + r * L::ld + c, in ? g + r * src.ld + c
                                                : src.base, in);
    }
  } else if (src.width == 4) {
    constexpr int kCh = L::row_bytes / 4;
    for (int idx = tid; idx < rows_touch * kCh; idx += THREADS) {
      const int r = idx / kCh, c = (idx - r * kCh) * 4;
      const bool in = r < rows_valid && c < bytes_valid;
      tf32mma::cp_async4(s + r * L::ld + c, in ? g + r * src.ld + c
                                               : src.base, in);
    }
  } else {
    using R = typename std::conditional<
        sizeof(T) == 1, uint8_t,
        typename std::conditional<sizeof(T) == 2, uint16_t,
                                  uint32_t>::type>::type;  // raw bits
    constexpr int kE = L::row_bytes / (int)sizeof(T);
    const int e_valid = bytes_valid / (int)sizeof(T);
    for (int idx = tid; idx < rows_touch * kE; idx += THREADS) {
      const int r = idx / kE, c = idx - r * kE;
      const R v = r < rows_valid && c < e_valid
                      ? reinterpret_cast<const R*>(g + r * src.ld)[c]
                      : R(0);
      reinterpret_cast<R*>(s + r * L::ld)[c] = v;
    }
  }
}

template <typename TA, bool AKC, typename TB, bool BKC, int BM, int BN,
          int WM, int WN, int STAGES>
struct Gemm {
  static constexpr int kBK = 64;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
  using LA = Tile<TA, AKC, BM, kBK>;
  using LB = Tile<TB, BKC, BN, kBK>;
  static constexpr int kStageBytes = LA::bytes + LB::bytes;
  static constexpr int kSmemBytes = STAGES * kStageBytes;
  static_assert(MT >= 1 && NT >= 1 && BM % (16 * WM) == 0 &&
                    BN % (8 * WN) == 0,
                "warp tiles of whole m16 x n8 tiles");
  static_assert(LA::bytes % 16 == 0 && LB::bytes % 16 == 0,
                "16-byte aligned stages");

  // n8 tiles per warp that cover n_live N indices from the block's first
  static __device__ __forceinline__ int tiles_for(int n_live) {
    return min(NT, ((n_live + 7) / 8 + WN - 1) / WN);
  }

  // acc[i][j]: the C fragment of m16 tile i and n8 tile j * WN + wn of this
  // warp, summed over K, for the first NTL of the warp's NT n8 tiles (a
  // compile-time count, so the inner loops have no branch; B rows past
  // them are not loaded).  smem: kSmemBytes of dynamic shared memory.
  template <int NTL>
  __device__ static void run(float (&acc)[MT][NTL][4], unsigned char* smem,
                             const Src& a, const Src& b, int K) {
    static_assert(NTL >= 1 && NTL <= NT, "n8 tiles of the warp");
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const int g = lane >> 2, t = lane & 3;
    const int nk = (K + kBK - 1) / kBK;
    constexpr int b_touch = NTL * WN * 8;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    auto load = [&](int kt) {
      unsigned char* s = smem + (kt % STAGES) * kStageBytes;
      load_stage<TA, AKC, BM, kBK, kThreads, BM>(s, a, kt, K, tid);
      load_stage<TB, BKC, BN, kBK, kThreads, b_touch>(s + LA::bytes, b, kt,
                                                      K, tid);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s);
      tf32mma::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      tf32mma::cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed; stage kt - 1 is free for all
      if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
      tf32mma::cp_async_commit();
      const unsigned char* sa = smem + (kt % STAGES) * kStageBytes;
      const unsigned char* sb = sa + LA::bytes;
      float part[MT][NTL][4];  // this stage's sum, promoted below
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m = wm * (BM / WM) + 16 * i + g;
          const float v[4] = {LA::at(sa, m, kk + t), LA::at(sa, m + 8, kk + t),
                              LA::at(sa, m, kk + t + 4),
                              LA::at(sa, m + 8, kk + t + 4)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kExact<TA>)
              ab[i][e] = __float_as_uint(v[e]);
            else
              tf32mma::split(v[e], ab[i][e], as[i][e]);
          }
        }
        uint32_t bb[NTL][2], bs[NTL][2];
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          const int n = (j * WN + wn) * 8;
          const float b[2] = {LB::at(sb, n + g, kk + t),
                              LB::at(sb, n + g, kk + t + 4)};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kExact<TB>)
              bb[j][e] = __float_as_uint(b[e]);
            else
              tf32mma::split(b[e], bb[j][e], bs[j][e]);
          }
        }
        // each product over every tile before the next product, so that
        // consecutive MMAs are independent and the tensor cores never wait
        // on the one before
        if constexpr (!kExact<TA>) {
#pragma unroll
          for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i)
              tf32mma::mma(part[i][j], as[i], bb[j][0], bb[j][1]);
        }
        if constexpr (!kExact<TB>) {
#pragma unroll
          for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i)
              tf32mma::mma(part[i][j], ab[i], bs[j][0], bs[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            tf32mma::mma(part[i][j], ab[i], bb[j][0], bb[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    tf32mma::cp_async_wait<0>();
  }
};


// ---------------------------------------------------------------------------
// wgmma: the warpgroup's asynchronous MMA, A from registers, B from shared
// memory.  tf32 operands must be K-major in shared memory (wgmma transposes
// 16-bit operands only), so a caller whose B is N-major in memory (w [K, N])
// rewrites each stage as K-major TF32 tiles, big and small, in the
// no-swizzle layout: core matrices of 8 rows x 16 bytes, contiguous.
// ---------------------------------------------------------------------------

// Descriptor of a K-major no-swizzle tile at `tile`: lbo bytes between core
// matrices along K, sbo bytes between 8-row groups along M / N.
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, uint32_t lbo,
                                                uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy stores to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps a register's value where it is, in order, across this point: the
// compiler may not move its uses or reuse it while a wgmma still reads it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (the m64n64 fp32 accumulator, 32 per thread) += a (the m64k8 TF32
// operand, 4 registers per thread) @ the k8 x n64 tile at `desc`.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31},\n"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A block of two warpgroups (256 threads) computes a 128 x 64 tile of
// C = A @ B: A [M, K] K-contiguous at its stored width, its fragments
// upcast (and split, if fp32) in registers, warp w owning rows 16 w ..
// 16 w + 15; B [K, N] N-contiguous, each stage of it split into K-major
// TF32 tiles (big, and small if B is fp32) in shared memory, shared by
// both warpgroups; the products on wgmma m64n64k8.  The split tiles are
// double-buffered: while stage kt's wgmmas run, the threads split stage
// kt + 1.  Same stage ring, copies, edges and per-stage promotion as Gemm.
// acc[4 j + e] is the C fragment of columns 8 j .. 8 j + 7 (e: row g, g,
// g + 8, g + 8 of the warp's 16; column 2 t, 2 t + 1, 2 t, 2 t + 1).
template <typename TA, typename TB, int STAGES>
struct GemmWgmma {
  static constexpr int BM = 128, BN = 64, kBK = 64, kThreads = 256;
  static constexpr int kSteps = kBK / 8;
  using LA = Tile<TA, true, BM, kBK>;
  using LB = Tile<TB, false, BN, kBK>;
  static constexpr int kStageBytes = LA::bytes + LB::bytes;
  static constexpr int kSplitFloats = BN * kBK;  // one K-major TF32 tile
  static constexpr int kSplitTiles = kExact<TB> ? 1 : 2;  // big (, small)
  static constexpr int kSmemBytes =
      STAGES * kStageBytes + 2 * kSplitTiles * kSplitFloats * 4;
  // core matrix (n / 8, k / 4) of a K-major tile: 128 bytes, along K first
  static constexpr uint32_t kLbo = 128, kSbo = 128 * (kBK / 4);
  static_assert(kStageBytes % 16 == 0, "16-byte aligned split tiles");

  // B's stage [k][n] -> K-major TF32 tiles at dst (big, then small); a
  // warp reads 32 columns of one row per load and writes whole 128-byte
  // core matrices
  __device__ static void split_b(float* dst, const unsigned char* sb,
                                 int tid) {
    for (int idx = tid; idx < BN * kBK / 4; idx += kThreads) {
      const int r = idx & 7, nr = (idx >> 3) & (BN / 8 - 1);
      const int kc = idx / BN;
      const int n = nr * 8 + r;
      uint32_t big[4], small[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = LB::at(sb, n, 4 * kc + q);
        if constexpr (kExact<TB>)
          big[q] = __float_as_uint(v);
        else
          tf32mma::split(v, big[q], small[q]);
      }
      const int off = (nr * (kBK / 4) + kc) * 32 + 4 * r;
      *reinterpret_cast<uint4*>(dst + off) =
          make_uint4(big[0], big[1], big[2], big[3]);
      if constexpr (!kExact<TB>)
        *reinterpret_cast<uint4*>(dst + kSplitFloats + off) =
            make_uint4(small[0], small[1], small[2], small[3]);
    }
  }

  __device__ static void run(float (&acc)[32], unsigned char* smem,
                             const Src& a, const Src& b, int K) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int nk = (K + kBK - 1) / kBK;
    float* split = reinterpret_cast<float*>(smem + STAGES * kStageBytes);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;

    auto load = [&](int kt) {
      unsigned char* s = smem + (kt % STAGES) * kStageBytes;
      load_stage<TA, true, BM, kBK, kThreads, BM>(s, a, kt, K, tid);
      load_stage<TB, false, BN, kBK, kThreads, BN>(s + LA::bytes, b, kt, K,
                                                   tid);
    };
    auto stage = [&](int kt) {
      return smem + (kt % STAGES) * kStageBytes;
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s);
      tf32mma::cp_async_commit();
    }
    tf32mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    split_b(split, stage(0) + LA::bytes, tid);
    for (int kt = 0; kt < nk; ++kt) {
      // A's fragments for the stage's 8 k steps (as mma.sync m16n8k8's)
      const unsigned char* sa = stage(kt);
      uint32_t ab[kSteps][4], as[kSteps][4];
      const int m = 16 * warp + g;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const float v[4] = {
            LA::at(sa, m, 8 * s + t), LA::at(sa, m + 8, 8 * s + t),
            LA::at(sa, m, 8 * s + t + 4), LA::at(sa, m + 8, 8 * s + t + 4)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kExact<TA>)
            ab[s][e] = __float_as_uint(v[e]);
          else
            tf32mma::split(v[e], ab[s][e], as[s][e]);
        }
      }
      fence_proxy_async();
      __syncthreads();  // stage kt split and read by all: kt - 1's slot free
      if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
      tf32mma::cp_async_commit();
      const float* bt = split + (kt & 1) * kSplitTiles * kSplitFloats;
      float part[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) part[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const uint64_t db = kmajor_desc(bt + 2 * s * 32, kLbo, kSbo);
        if constexpr (!kExact<TA>) wgmma_m64n64k8(part, as[s], db);
        if constexpr (!kExact<TB>)
          wgmma_m64n64k8(part, ab[s], kmajor_desc(bt + kSplitFloats +
                                                  2 * s * 32, kLbo, kSbo));
        wgmma_m64n64k8(part, ab[s], db);
      }
      wgmma_commit();
      if (kt + 1 < nk) {  // split stage kt + 1 while the tensor cores work
        tf32mma::cp_async_wait<STAGES - 2>();
        __syncthreads();
        split_b(split + ((kt + 1) & 1) * kSplitTiles * kSplitFloats,
                stage(kt + 1) + LA::bytes, tid);
      }
      wgmma_wait_all();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(ab[s][e]);
          if constexpr (!kExact<TA>) fence_operand(as[s][e]);
        }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        fence_operand(part[e]);
        acc[e] += part[e];
      }
    }
    tf32mma::cp_async_wait<0>();
  }
};

}  // namespace tf32gemm
