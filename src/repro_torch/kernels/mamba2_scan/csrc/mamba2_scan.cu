// Mamba2 (SSD) selective scan on NVIDIA Hopper (sm_90a), fp32, in the
// chunked SSD form on the tensor cores.
//
// Replaces repro/kernels/mamba2_scan/kernel.py::mamba2_scan (the Pallas TPU
// kernel) and is the only Mamba2 prefill scan of the port on the card.  It
// computes, for every stream (batch b, head h), what the recurrence
//   h_t = exp(dt_t * a) h_{t-1} + dt_t * b_t (x) x_t      state [N, P]
//   y_t = c_t . h_t                                       y     [P]
// gives from h_0 (zero, or an initial state) over t = 0 .. S-1: y
// [.., S, .., P] and the final state [B*H, N, P].
//
// The chunked form (kernel.py:40-65).  Time is cut into chunks of kQ = 64
// rows; the last may be ragged, its rows past S read as dt = x = b = c = 0,
// which leaves cum and the state as they are.  Per chunk, with cum the
// inclusive cumsum of dt * a restarted at the chunk (a < 0 and dt >= 0,
// so every exponent below is <= 0):
//   L[i, j] = exp(cum_i - cum_j) for j <= i, 0 above the diagonal
//   y       = ((C B^T) . L . dt_j) X  +  (exp(cum_i) C) h_prev
//   h_next  = exp(cum_end) h_prev  +  (B . exp(cum_end - cum_j) dt_j)^T X
// Above the diagonal no exponential is taken; on or below it the exponent
// is clamped at 0 (cum comes from a shuffle scan, so two of its sums may
// be associated differently by an ulp) and taken with __expf (relative
// error ~1e-6 where the factor is not negligible).  The four products
// (C B^T, the masked scores times X, (exp(cum_i) C) h_prev and the decayed
// B^T X) run on the tensor cores in 3xTF32 (common/tf32_mma.cuh: mma.sync
// m16n8k8, each fp32 operand split into a big and a small TF32 half, the
// small terms first), each into a fresh accumulator at most 64 deep (K = N
// > 64 sums 64-deep stages apart and adds them in fp32), because the
// tensor cores' adds truncate.  The state is carried in fp32 in shared
// memory: h_next is one fmaf per element of exp(cum_end), h_prev and the
// product, rounded to nearest; h0 enters there as the first h_prev.
//
// Grid (ceil(P / PT), B * H), one block per SM.  A block owns PT = 64
// channels of one stream (32 when P <= 32, 16 when N > 64, for shared
// memory) and walks its chunks in order, so the state never leaves the
// block and the kernel moves no bytes beyond its operands.  Its 12 warps
// have two roles, handing chunks over through named barriers and two
// stages of shared memory:
// * 4 load warps: for chunk ck, once its cp.async copies have landed
//   (16-byte copies where pointers, strides, P and N allow, else 4-byte
//   ones), the cumsum (a shuffle scan), L . dt_j (16 rows each), exp(cum_i)
//   and the decayed dt_j, then "ready"; then, once the MMA warps are done
//   with chunk ck - 1, the copies of chunk ck + 1, which land while chunk
//   ck runs.
// * 8 MMA warps: warp w < 4 owns row tile w (rows 16w .. 16w+15) and the
//   first half of the channels, warp 7 - w the same rows and the second
//   half, so that each scheduler (warp % 4) runs row tiles w and 3 - w,
//   whose causal parts add up to the same work.  The two warps of a row
//   tile take every other key tile at or below its diagonal for C B^T,
//   multiply by L . dt_j and write the masked scores over it, and meet at a
//   64-thread barrier; then one loop over the chunk's keys, renumbered in
//   each step of 8 (as tf32_mma.cuh's warp_pv does), splits X's fragments
//   once for the scores times X and for the update of the warp's state
//   rows (16w .. 16w+15, and 16w+64 .. when N > 64); then h_next (double-
//   buffered), (exp(cum_i) C) h_prev, "done", and y's store.
//
// Layout.  Every operand is addressed through element strides over
// (batch, head, time), so one entry point reads both layouts without a
// copy: the Pallas layout (x [BH,S,P], dt [BH,S], b/c [BH,S,N], a [BH]:
// B = BH streams of one head each) and the model's (x [B,S,H,P], dt
// [B,S,H], b/c [B,S,N] shared by the H heads of a batch row with head
// stride 0, a [H]).  The innermost (P or N) stride is 1.  y takes x's
// strides; h0 and the final state are [B*H, N, P] contiguous.
//
// What bounds it on this card.  At zamba2-7b's prefill (B = 1, H = 112,
// S = 1024, P = N = 64, b/c shared by the heads) the operands are 61.5 MB
// (x and y 29.4 MB each), 0.0184 ms at 3.35 TB/s.  The chunked form's
// products (the causal half of C B^T, once per batch row, and of the
// scores times X; all of C h_prev and of B^T X) are 2.36 GFLOP, 0.0143 ms
// at 495 TFLOP/s over 3 TF32 products per fp32 product; the recurrence's
// 1.88 GFLOP would take 0.028 ms on the CUDA cores.  So bytes bound it.
// What holds this design back is the mma.sync rate with one block on each
// of 112 SMs: per chunk each scheduler issues ~620 TF32 m16n8k8 MMAs (C B^T
// is computed per head, not once per batch row), and the 16 chunks of a
// stream run in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/tf32_mma.cuh"

namespace {

using tf32mma::cp_async16;
using tf32mma::cp_async4;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait;
using tf32mma::mma;
using tf32mma::split;

constexpr int kQ = 64;         // rows (time steps) per chunk
constexpr int kMmaWarps = 8;   // the products: two per 16 rows of a chunk
constexpr int kLoadWarps = 4;  // the copies, the cumsum and the decays
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kLoadThreads = 32 * kLoadWarps;
constexpr int kThreads = kMmaThreads + kLoadThreads;
constexpr int kStageK = 64;    // the deepest sum one accumulator takes
constexpr unsigned kFull = 0xffffffffu;
// named barriers (0 is __syncthreads)
constexpr int kBarReady = 1;   // + stage: the chunk's operands and decays in
constexpr int kBarFree = 3;    // + stage: the MMA warps are done with the chunk
constexpr int kBarLoad = 5;    // the load warps among themselves
constexpr int kBarPair = 6;    // + row tile: its two MMA warps

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory, in floats.  Row strides = 4 mod 8 (x, b, c) and = 8 mod
// 32 (the state, the decay matrix) make every fragment read below
// conflict-free.
template <int NP, int PT>
struct Layout {
  static constexpr int LX = PT + 4;
  static constexpr int LB = NP + 4;
  static constexpr int LH = PT + 8;
  static constexpr int LL = kQ + 8;
  static constexpr int X = 0;                     // [2][kQ][LX]
  static constexpr int B = X + 2 * kQ * LX;       // [2][kQ][LB]
  static constexpr int C = B + 2 * kQ * LB;       // [2][kQ][LB]
  static constexpr int H = C + 2 * kQ * LB;       // [2][NP][LH]
  static constexpr int LS = H + 2 * NP * LH;      // [2][kQ][LL] L . dt_j,
                                                  // then the masked scores
  static constexpr int DT = LS + 2 * kQ * LL;     // [2][kQ]
  static constexpr int ECUM = DT + 2 * kQ;        // [2][kQ] exp(cum_i)
  static constexpr int WDEC = ECUM + 2 * kQ;      // [2][kQ] decayed dt_j
  static constexpr int EEND = WDEC + 2 * kQ;      // [2] exp(cum_end)
  static constexpr size_t bytes = (EEND + 2) * sizeof(float);
};

// An fp32 accumulator of NT n8 tiles (C fragments) for 3xTF32 products.
template <int NT>
struct Tiles {
  float c[NT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  }
  // tile i += a @ b[i] for i < n (n <= NT, the same in every lane), a and
  // every b[i] already split (b[i]: the big and small halves of rows k and
  // k + 4).  Term by term across the tiles, so that consecutive MMAs go
  // to different tiles; per tile the order is small*big, big*small,
  // big*big, as kernels/tf32.py models it.
  __device__ __forceinline__ void mma3(const uint32_t ab[4],
                                       const uint32_t as[4],
                                       const uint32_t b[][4], int n = NT) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (i < n) mma(c[i], as, b[i][0], b[i][2]);
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (i < n) mma(c[i], ab, b[i][1], b[i][3]);
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (i < n) mma(c[i], ab, b[i][0], b[i][2]);
  }
};

__device__ __forceinline__ void split4(float v0, float v1, float v2,
                                       float v3, uint32_t ab[4],
                                       uint32_t as[4]) {
  split(v0, ab[0], as[0]);
  split(v1, ab[1], as[1]);
  split(v2, ab[2], as[2]);
  split(v3, ab[3], as[3]);
}

// The B fragment of rows k and k + 4 (p[0] and p[k4]) of one n8 tile,
// split.
__device__ __forceinline__ void split_b(const float* p, int k4,
                                        uint32_t b[4]) {
  split(p[0], b[0], b[1]);
  split(p[k4], b[2], b[3]);
}

// acc[nt] += (rows r0 .. r0+15 of A, row stride la, each scaled by
// scale0 / scale1 for rows g / g + 8) @ (K x n8 tiles of B, row stride
// lb), over K = KD in 64-deep stages, each in a fresh accumulator added
// into acc in fp32.  The K loop is unrolled by 2 only: the kernel's code
// has to stay small enough for the instruction cache.
template <int KD, int NT>
__device__ __forceinline__ void rows_times(float acc[][4], const float* a,
                                           int la, float scale0,
                                           float scale1, const float* b,
                                           int lb, int g, int t) {
#pragma unroll
  for (int k0s = 0; k0s < KD; k0s += kStageK) {
    Tiles<NT> part;
    part.zero();
#pragma unroll 2
    for (int k0 = k0s; k0 < k0s + kStageK && k0 < KD; k0 += 8) {
      const float* ap = a + g * la + k0 + t;
      uint32_t ab[4], as[4], bf[NT][4];
      split4(ap[0] * scale0, ap[8 * la] * scale1, ap[4] * scale0,
             ap[8 * la + 4] * scale1, ab, as);
#pragma unroll
      for (int i = 0; i < NT; ++i)
        split_b(b + (k0 + t) * lb + 8 * i + g, 4 * lb, bf[i]);
      part.mma3(ab, as, bf);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part.c[i][e];
  }
}

// NP: N padded (16, 32, 64 or 128); PT: channels per block (16, 32 or 64).
template <int NP, int PT>
__global__ void __launch_bounds__(kThreads, 1)
    mamba2_scan_chunked_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ h0,
        float* __restrict__ y, float* __restrict__ hout, int H, int S, int P,
        int N, int x_sb, int x_sh, int x_st, int dt_sb, int dt_sh, int dt_st,
        int bc_sb, int bc_sh, int bc_st, int a_sb, int a_sh, int vec) {
  using L = Layout<NP, PT>;
  constexpr int LX = L::LX, LB = L::LB, LH = L::LH, LL = L::LL;
  constexpr int NT = PT / 16;              // n8 tiles of a warp's channels
  constexpr int RT = (NP / 16 + 3) / 4;    // state row tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem + L::X;
  float* const bs = smem + L::B;
  float* const cs = smem + L::C;
  float* const hs = smem + L::H;
  float* const lss = smem + L::LS;
  float* const dts = smem + L::DT;
  float* const ecums = smem + L::ECUM;
  float* const wdecs = smem + L::WDEC;
  float* const eends = smem + L::EEND;

  const int stream = blockIdx.y;  // b * H + h
  const int bi = stream / H, hi = stream % H;
  const int p0 = blockIdx.x * PT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nck = (S + kQ - 1) / kQ;

  // h0 (or zeros) into state buffer 0; padded rows and channels stay 0
  for (int idx = tid; idx < NP * PT; idx += kThreads) {
    const int n = idx / PT, pp = idx % PT;
    hs[n * LH + pp] = (h0 != nullptr && n < N && p0 + pp < P)
                          ? h0[((int64_t)stream * N + n) * P + p0 + pp]
                          : 0.f;
  }
  __syncthreads();

  if (warp >= kMmaWarps) {
    // The load warps: for chunk ck, once its copies have landed, its
    // cumsum, L . dt_j and decays, then "ready"; then, once the MMA warps
    // are done with chunk ck - 1, the copies of chunk ck + 1 into its
    // stage, so that they land while chunk ck runs.
    const int lt = tid - kMmaThreads, lw = warp - kMmaWarps;
    const int64_t xoff = (int64_t)bi * x_sb + (int64_t)hi * x_sh;
    const int64_t dtoff = (int64_t)bi * dt_sb + (int64_t)hi * dt_sh;
    const int64_t bcoff = (int64_t)bi * bc_sb + (int64_t)hi * bc_sh;
    const float av = a[(int64_t)bi * a_sb + (int64_t)hi * a_sh];
    // chunk ck's x, b, c and dt into stage ck & 1, rows past S zero-filled
    auto issue = [&](int ck) {
      const int st = ck & 1;
      const int t0 = ck * kQ, tn = min(kQ, S - t0);
      float* xd = xs + st * kQ * LX;
      float* bd = bs + st * kQ * LB;
      float* cd = cs + st * kQ * LB;
      float* dd = dts + st * kQ;
      if (vec) {
#pragma unroll 1
        for (int idx = lt; idx < kQ * (PT / 4); idx += kLoadThreads) {
          const int r = idx / (PT / 4), col = 4 * (idx % (PT / 4));
          const bool in = r < tn && p0 + col < P;
          cp_async16(xd + r * LX + col,
                     in ? x + xoff + (int64_t)(t0 + r) * x_st + p0 + col : x,
                     in);
        }
#pragma unroll 1
        for (int idx = lt; idx < kQ * (NP / 4); idx += kLoadThreads) {
          const int r = idx / (NP / 4), n = 4 * (idx % (NP / 4));
          const bool in = r < tn && n < N;
          const int64_t off = bcoff + (int64_t)(t0 + r) * bc_st + n;
          cp_async16(bd + r * LB + n, in ? bm + off : bm, in);
          cp_async16(cd + r * LB + n, in ? cm + off : cm, in);
        }
      } else {
#pragma unroll 1
        for (int idx = lt; idx < kQ * PT; idx += kLoadThreads) {
          const int r = idx / PT, col = idx % PT;
          const bool in = r < tn && p0 + col < P;
          cp_async4(xd + r * LX + col,
                    in ? x + xoff + (int64_t)(t0 + r) * x_st + p0 + col : x,
                    in);
        }
#pragma unroll 1
        for (int idx = lt; idx < kQ * NP; idx += kLoadThreads) {
          const int r = idx / NP, n = idx % NP;
          const bool in = r < tn && n < N;
          const int64_t off = bcoff + (int64_t)(t0 + r) * bc_st + n;
          cp_async4(bd + r * LB + n, in ? bm + off : bm, in);
          cp_async4(cd + r * LB + n, in ? cm + off : cm, in);
        }
      }
      if (lt < kQ) {
        const bool in = lt < tn;
        cp_async4(dd + lt, in ? dt + dtoff + (int64_t)(t0 + lt) * dt_st : dt,
                  in);
      }
      cp_async_commit();
    };

    if (nck > 0) issue(0);
#pragma unroll 1
    for (int ck = 0; ck < nck; ++ck) {
      const int st = ck & 1;
      const float* dd = dts + st * kQ;
      cp_async_wait<0>();
      bar_sync(kBarLoad, kLoadThreads);  // every load thread's copies landed

      // cum, in every load warp alike: lane l holds rows 2l and 2l + 1; an
      // inclusive shuffle scan of the pair sums, then each row's own sum
      const float dj0 = dd[2 * lane], dj1 = dd[2 * lane + 1];
      const float d0 = dj0 * av, d1 = dj1 * av;
      float run = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, run, off);
        if (lane >= off) run += v;
      }
      float excl = __shfl_up_sync(kFull, run, 1);
      if (lane == 0) excl = 0.f;
      const float cj0 = excl + d0, cj1 = cj0 + d1;
      const float cend = __shfl_sync(kFull, cj1, 31);
      // load warp w writes rows 16w .. 16w+15 of L . dt_j: exp(cum_i -
      // cum_j) dt_j for j <= i, else 0 with no exponential taken
      float* ls = lss + st * kQ * LL;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int i = 16 * lw + r;
        const float ci = __shfl_sync(kFull, (i & 1) ? cj1 : cj0, i >> 1);
        const int j = 2 * lane;
        float2 v;
        v.x = j <= i ? __expf(fminf(ci - cj0, 0.f)) * dj0 : 0.f;
        v.y = j + 1 <= i ? __expf(fminf(ci - cj1, 0.f)) * dj1 : 0.f;
        *reinterpret_cast<float2*>(ls + i * LL + j) = v;
      }
      if (lw == 0) {
        ecums[st * kQ + 2 * lane] = expf(cj0);
        ecums[st * kQ + 2 * lane + 1] = expf(cj1);
        wdecs[st * kQ + 2 * lane] = expf(fminf(cend - cj0, 0.f)) * dj0;
        wdecs[st * kQ + 2 * lane + 1] = expf(fminf(cend - cj1, 0.f)) * dj1;
        if (lane == 31) eends[st] = expf(cend);
      }
      bar_arrive(kBarReady + st, kThreads);
      if (ck + 1 < nck) {
        if (ck >= 1) bar_sync(kBarFree + (st ^ 1), kThreads);
        issue(ck + 1);
      }
    }
    // match the MMA warps' "done" with the last two chunks
#pragma unroll 1
    for (int ck = max(nck - 2, 0); ck < nck; ++ck)
      bar_sync(kBarFree + (ck & 1), kThreads);
  } else {
    // The MMA warps.  Warp w < 4 owns row tile w and the first half of the
    // channels, warp 7 - w row tile w and the second half: a scheduler
    // (warp % 4) then runs row tiles w and 3 - w, whose causal parts add
    // up to the same work.
    const int rt = warp < 4 ? warp : 7 - warp;
    const int ch = warp >> 2;
    const int r0 = 16 * rt;            // this warp's rows in a chunk
    const int c0 = ch * (PT / 2);      // and its channels in the block
    const int nq = rt + 1;             // its key tiles: 8 (ch + 2q), q < nq
    const int64_t xoff = (int64_t)bi * x_sb + (int64_t)hi * x_sh;
#pragma unroll 1
    for (int ck = 0; ck < nck; ++ck) {
      const int st = ck & 1;
      bar_sync(kBarReady + st, kThreads);
      const float* xc = xs + st * kQ * LX;
      const float* bc = bs + st * kQ * LB;
      const float* cc = cs + st * kQ * LB;
      const float* hp = hs + st * NP * LH;   // h_prev
      float* hn = hs + (st ^ 1) * NP * LH;   // h_next
      float* ls = lss + st * kQ * LL;
      const float* ecum = ecums + st * kQ;
      const float* wdec = wdecs + st * kQ;

      // 1. the scores of the warp's rows against the keys at or below
      //    their diagonal (C B^T, 2 (rt + 1) key tiles of 8), masked and
      //    decayed (. L . dt_j), in place of L . dt_j: the two warps of a
      //    row tile take every other key tile, and each reads L where it
      //    writes the scores
      {
        float sc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[q][e] = 0.f;
#pragma unroll
        for (int k0s = 0; k0s < NP; k0s += kStageK) {
          Tiles<4> part;
          part.zero();
#pragma unroll 2
          for (int k0 = k0s; k0 < k0s + kStageK && k0 < NP; k0 += 8) {
            const float* ap = cc + (r0 + g) * LB + k0 + t;
            uint32_t ab[4], as[4], bf[4][4];
            split4(ap[0], ap[8 * LB], ap[4], ap[8 * LB + 4], ab, as);
            // B^T's n8 tile jt, row k, is b[8 jt + g][k]
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (q < nq)
                split_b(bc + (8 * (ch + 2 * q) + g) * LB + k0 + t, 4, bf[q]);
            part.mma3(ab, as, bf, nq);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[q][e] += part.c[q][e];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < nq) {
            const int o = (r0 + g) * LL + 8 * (ch + 2 * q) + 2 * t;
            const float2 l0 = *reinterpret_cast<const float2*>(ls + o);
            const float2 l1 = *reinterpret_cast<const float2*>(ls + o + 8 * LL);
            *reinterpret_cast<float2*>(ls + o) =
                make_float2(sc[q][0] * l0.x, sc[q][1] * l0.y);
            *reinterpret_cast<float2*>(ls + o + 8 * LL) =
                make_float2(sc[q][2] * l1.x, sc[q][3] * l1.y);
          }
        }
        bar_sync(kBarPair + rt, 64);  // both halves of the row tile written
      }

      // 2. over the chunk's keys in steps of 8, renumbered (logical key t
      //    is row 2t, t + 4 is row 2t + 1) in A and B alike, with one split
      //    of X's fragments for both products: y_intra = the masked scores
      //    times X for the warp's rows and channels (keys below its
      //    diagonal), and the update (B . wdec)^T X for its state rows
      Tiles<NT> yi, hu[RT];
      yi.zero();
#pragma unroll
      for (int i = 0; i < RT; ++i) hu[i].zero();
#pragma unroll 2
      for (int kk = 0; kk < kQ / 8; ++kk) {
        const int j0 = 8 * kk + 2 * t;
        uint32_t xb[NT][4];
        const float* xr = xc + j0 * LX + c0 + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) split_b(xr + 8 * nt, LX, xb[nt]);
        if (kk < 2 * nq) {
          const float2 m0 =
              *reinterpret_cast<const float2*>(ls + (r0 + g) * LL + j0);
          const float2 m1 =
              *reinterpret_cast<const float2*>(ls + (r0 + g + 8) * LL + j0);
          uint32_t ab[4], as[4];
          split4(m0.x, m1.x, m0.y, m1.y, ab, as);
          yi.mma3(ab, as, xb);
        }
        const float w0 = wdec[j0], w1 = wdec[j0 + 1];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = rt + 4 * i;
          if (r < NP / 16) {
            const float* bp = bc + j0 * LB + 16 * r + g;
            uint32_t ab[4], as[4];
            split4(bp[0] * w0, bp[8] * w0, bp[LB] * w1, bp[LB + 8] * w1, ab,
                   as);
            hu[i].mma3(ab, as, xb);
          }
        }
      }

      // 3. h_next = exp(cum_end) h_prev + update, in fp32 (the warp's part)
      {
        const float ee = eends[st];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = rt + 4 * i;
          if (r < NP / 16) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = (16 * r + g + 8 * (e >> 1)) * LH + c0 + 8 * nt +
                              2 * t + (e & 1);
                hn[o] = fmaf(ee, hp[o], hu[i].c[nt][e]);
              }
          }
        }
      }

      // 4. y_inter = (exp(cum_i) C) h_prev over K = NP
      float yh[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yh[nt][e] = 0.f;
      rows_times<NP, NT>(yh, cc + r0 * LB, LB, ecum[r0 + g],
                         ecum[r0 + g + 8], hp + c0, LH, g, t);
      // the chunk's stage, decays and h_prev are read: the load warps may
      // refill them (h_prev is next written two chunks on, after "ready")
      bar_arrive(kBarFree + st, kThreads);

      // 5. y = y_intra + y_inter, rows past S and channels past P skipped
      const int t0 = ck * kQ;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (t0 + row < S) {
          float* yr = y + xoff + (int64_t)(t0 + row) * x_st + p0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int p = c0 + 8 * nt + 2 * t;
            const float v0 = yi.c[nt][2 * half] + yh[nt][2 * half];
            const float v1 = yi.c[nt][2 * half + 1] + yh[nt][2 * half + 1];
            if (vec) {
              if (p0 + p < P)
                *reinterpret_cast<float2*>(yr + p) = make_float2(v0, v1);
            } else {
              if (p0 + p < P) yr[p] = v0;
              if (p0 + p + 1 < P) yr[p + 1] = v1;
            }
          }
        }
      }
    }
  }

  __syncthreads();
  const float* hf = hs + (nck & 1) * NP * LH;
  for (int idx = tid; idx < NP * PT; idx += kThreads) {
    const int n = idx / PT, pp = idx % PT;
    if (n < N && p0 + pp < P)
      hout[((int64_t)stream * N + n) * P + p0 + pp] = hf[n * LH + pp];
  }
}

template <int NP, int PT>
cudaError_t launch(const float* x, const float* dt, const float* b,
                   const float* c, const float* a, const float* h0, float* y,
                   float* hout, int B, int H, int S, int P, int N, int x_sb,
                   int x_sh, int x_st, int dt_sb, int dt_sh, int dt_st,
                   int bc_sb, int bc_sh, int bc_st, int a_sb, int a_sh,
                   int vec, cudaStream_t stream) {
  constexpr size_t bytes = Layout<NP, PT>::bytes;
  static bool opted_in = false;  // the dynamic shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_chunked_kernel<NP, PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((P + PT - 1) / PT, B * H);
  mamba2_scan_chunked_kernel<NP, PT><<<grid, kThreads, bytes, stream>>>(
      x, dt, b, c, a, h0, y, hout, H, S, P, N, x_sb, x_sh, x_st, dt_sb,
      dt_sh, dt_st, bc_sb, bc_sh, bc_st, a_sb, a_sh, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// The backward: mamba2_scan_bwd
// ---------------------------------------------------------------------------
//
// Given the cotangents dy (x's layout) and dh_final ([B*H, N, P], may be
// null: zero), it computes dx, ddt, db, dc, da and (when h0 was given)
// dh0 of the recurrence above, with g_t = dL/dh_t walked backwards:
//   g_t   = alpha_{t+1} g_{t+1} + c_t dy_t^T      (g_{S-1} from dh_final)
//   dx_t  = dt_t g_t^T b_t          db_t = dt_t g_t x_t     dc_t = h_t dy_t
//   ddt_t = x_t . (g_t^T b_t) + a alpha_t <g_t, h_{t-1}>
//   da    = sum_t dt_t alpha_t <g_t, h_{t-1}>      dh0 = alpha_0 g_0
// with alpha_t = exp(dt_t a) <= 1 (ref.py's mamba2_scan_bwd_ref is the
// same algorithm in plain PyTorch).
//
// The states are recomputed, never stepped backwards through a decay
// (which would divide by alpha and let an exponent grow): one block owns
// one stream and kBwdCols = 32 state columns (a lane each; warp w holds
// rows w, w + 8, ...), sweeps forward once keeping the state at the start
// of every chunk of Q steps in a scratch of its own, then walks the chunks
// backwards: it recomputes a chunk's Q states from its start into shared
// memory, walks the chunk's steps backwards with g in registers (g and
// the states need no sum across threads), and only then takes the chunk's
// sums from shared memory, each in a fixed order: sx = g^T b and <g,
// h_{t-1}> per step and column (a warp per step), db and dc per step and
// row over the block's columns.  Sums across the blocks of a stream (its
// column tiles) and across the streams that share an operand (b/c across
// the heads, a across the batch rows) are per-block partials that
// mamba2_scan_bwd_reduce_kernel adds in a fixed order, so two calls give the
// same bits: there are no float atomics.
//
// fp32 on the CUDA cores.  What bounds it: at zamba2-7b's training shape
// (B = 4, H = 112, S = 1024, P = N = 64) the state recurrence and its
// sums are ~12 flops per state element and step, 22.5 GFLOP, 0.34 ms at
// 67 TFLOP/s; the bytes, ~1 GB through the scratch of chunk states, 0.3
// ms.  The design spends neither well: one block of 8 warps per SM with
// a barrier per chunk of 8 steps, so latency bounds it.

namespace {

constexpr int kBwdQ = 8;        // steps per chunk (4 for a state of 128 rows)
constexpr int kBwdCols = 32;    // state columns per block: one per lane
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;

struct BwdArgs {
  const float *x, *dt, *b, *c, *a, *h0, *dy, *dhf;
  float *dx, *ddt, *db, *dc, *da, *dh0;
  float *starts, *ddt_part, *db_part, *dc_part, *da_part;  // scratch
  int B, H, S, P, N, NC, NT, na;
  int x_sb, x_sh, x_st, dt_sb, dt_sh, dt_st, bc_sb, bc_sh, bc_st, a_sb,
      a_sh, ddt_sb, ddt_sh, ddt_st;
};

// The chunk length of the backward for a padded state of NP rows: the Q
// states and Q g's of a chunk live in shared memory.
template <int NP>
struct BwdLayout {
  static constexpr int Q = NP <= 64 ? kBwdQ : kBwdQ / 2;
  static constexpr int LC = kBwdCols + 1;           // row stride: no conflicts
  static constexpr int G = 0;                       // [Q][NP][LC] g_t
  static constexpr int HS = G + Q * NP * LC;        // [Q+1][NP][LC] h_{t-1}
  static constexpr int X = HS + (Q + 1) * NP * LC;  // [Q][32]
  static constexpr int DY = X + Q * kBwdCols;       // [Q][32]
  static constexpr int BB = DY + Q * kBwdCols;      // [Q][NP]
  static constexpr int CC = BB + Q * NP;            // [Q][NP]
  static constexpr int DT = CC + Q * NP;            // [Q]
  static constexpr int AL = DT + Q;                 // [Q] alpha
  static constexpr int DA = AL + Q;                 // [kBwdWarps]
  static constexpr size_t bytes = (DA + kBwdWarps) * sizeof(float);
};

template <int NP>
__global__ void __launch_bounds__(kBwdThreads, 1)
    mamba2_scan_bwd_chunk_kernel(BwdArgs g) {
  using L = BwdLayout<NP>;
  constexpr int Q = L::Q, LC = L::LC, R = NP / kBwdWarps;
  extern __shared__ __align__(16) float smem[];
  float* const gs = smem + L::G;
  float* const hs = smem + L::HS;
  float* const xs = smem + L::X;
  float* const dys = smem + L::DY;
  float* const bs = smem + L::BB;
  float* const cs = smem + L::CC;
  float* const dts = smem + L::DT;
  float* const als = smem + L::AL;
  float* const das = smem + L::DA;

  const int stream = blockIdx.y, tile = blockIdx.x;
  const int bi = stream / g.H, hi = stream % g.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = tile * kBwdCols + lane;
  const bool pin = p < g.P;
  const int S = g.S, N = g.N;
  const int blk = stream * g.NT + tile;
  const int64_t xoff = (int64_t)bi * g.x_sb + (int64_t)hi * g.x_sh + p;
  const int64_t dtoff = (int64_t)bi * g.dt_sb + (int64_t)hi * g.dt_sh;
  const int64_t bcoff = (int64_t)bi * g.bc_sb + (int64_t)hi * g.bc_sh;
  const float av = g.a[(int64_t)bi * g.a_sb + (int64_t)hi * g.a_sh];
  float* const starts = g.starts + (int64_t)blk * g.NC * NP * kBwdCols;

  // chunk ck's x (and dy), b (and c), dt and alpha into shared memory;
  // rows past S read as x = dy = b = c = dt = 0, alpha = 1
  auto stage = [&](int ck, bool with_grads) {
    const int t0 = ck * Q;
    for (int i = tid; i < Q * kBwdCols; i += kBwdThreads) {
      const int j = i / kBwdCols, col = tile * kBwdCols + i % kBwdCols;
      const bool in = t0 + j < S && col < g.P;
      const int64_t off = (int64_t)bi * g.x_sb + (int64_t)hi * g.x_sh +
                          (int64_t)(t0 + j) * g.x_st + col;
      xs[i] = in ? g.x[off] : 0.f;
      if (with_grads) dys[i] = in ? g.dy[off] : 0.f;
    }
    for (int i = tid; i < Q * NP; i += kBwdThreads) {
      const int j = i / NP, n = i % NP;
      const bool in = t0 + j < S && n < N;
      const int64_t off = bcoff + (int64_t)(t0 + j) * g.bc_st + n;
      bs[i] = in ? g.b[off] : 0.f;
      if (with_grads) cs[i] = in ? g.c[off] : 0.f;
    }
    if (tid < Q) {
      const bool in = t0 + tid < S;
      const float d = in ? g.dt[dtoff + (int64_t)(t0 + tid) * g.dt_st] : 0.f;
      dts[tid] = d;
      als[tid] = expf(d * av);
    }
  };

  // 1. forward: the state at the start of every chunk, into the scratch
  float h[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = warp + kBwdWarps * i;
    h[i] = (g.h0 != nullptr && pin && n < N)
               ? g.h0[((int64_t)stream * N + n) * g.P + p]
               : 0.f;
  }
#pragma unroll 1
  for (int ck = 0; ck < g.NC; ++ck) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      starts[((int64_t)ck * NP + warp + kBwdWarps * i) * kBwdCols + lane] =
          h[i];
    stage(ck, false);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < Q; ++j) {
      const float dx = dts[j] * xs[j * kBwdCols + lane];
#pragma unroll
      for (int i = 0; i < R; ++i)
        h[i] = fmaf(als[j], h[i], bs[j * NP + warp + kBwdWarps * i] * dx);
    }
    __syncthreads();
  }

  // 2. backward, chunk by chunk from the last
  float gr[R];   // dL/dh_t flowing back into step t from the steps after it
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = warp + kBwdWarps * i;
    gr[i] = (g.dhf != nullptr && pin && n < N)
                ? g.dhf[((int64_t)stream * N + n) * g.P + p]
                : 0.f;
  }
  float da_acc = 0.f;
#pragma unroll 1
  for (int ck = g.NC - 1; ck >= 0; --ck) {
    const int t0 = ck * Q;
    stage(ck, true);
    __syncthreads();
    // the chunk's states h_{t0-1} .. h_{t0+Q-1}, recomputed from its start
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int n = warp + kBwdWarps * i;
      h[i] = starts[((int64_t)ck * NP + n) * kBwdCols + lane];
      hs[n * LC + lane] = h[i];
    }
#pragma unroll 1
    for (int j = 0; j < Q; ++j) {
      const float dx = dts[j] * xs[j * kBwdCols + lane];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = warp + kBwdWarps * i;
        h[i] = fmaf(als[j], h[i], bs[j * NP + n] * dx);
        hs[((j + 1) * NP + n) * LC + lane] = h[i];
      }
    }
    // g_t for the chunk's steps, last first
#pragma unroll 1
    for (int j = Q - 1; j >= 0; --j) {
      const float dyp = dys[j * kBwdCols + lane];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = warp + kBwdWarps * i;
        const float gt = fmaf(cs[j * NP + n], dyp, gr[i]);
        gs[(j * NP + n) * LC + lane] = gt;
        gr[i] = als[j] * gt;
      }
    }
    __syncthreads();
    // per step (a warp each) and column (a lane each): sx = g_t^T b_t, dx,
    // and the step's ddt partial x . sx + a alpha <g_t, h_{t-1}>
    for (int j = warp; j < Q; j += kBwdWarps) {
      float sx = 0.f, gh = 0.f;
#pragma unroll 4
      for (int n = 0; n < NP; ++n) {
        const float gt = gs[(j * NP + n) * LC + lane];
        sx = fmaf(bs[j * NP + n], gt, sx);
        gh = fmaf(gt, hs[(j * NP + n) * LC + lane], gh);
      }
      const int t = t0 + j;
      if (t < S && pin) g.dx[xoff + (int64_t)t * g.x_st] = dts[j] * sx;
      float q = xs[j * kBwdCols + lane] * sx;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        q += __shfl_xor_sync(kFull, q, off);
        gh += __shfl_xor_sync(kFull, gh, off);
      }
      if (t < S && lane == 0)
        g.ddt_part[(int64_t)blk * S + t] = fmaf(av * als[j], gh, q);
      da_acc = fmaf(dts[j] * als[j], gh, da_acc);
    }
    // per step and row: db = dt g_t x_t and dc = h_t dy_t over the block's
    // columns
    for (int i = tid; i < Q * NP; i += kBwdThreads) {
      const int j = i / NP, n = i % NP, t = t0 + j;
      if (t >= S || n >= N) continue;
      const float* gp = gs + (j * NP + n) * LC;
      const float* hp = hs + ((j + 1) * NP + n) * LC;
      float db = 0.f, dc = 0.f;
#pragma unroll 8
      for (int col = 0; col < kBwdCols; ++col) {
        db = fmaf(gp[col], xs[j * kBwdCols + col], db);
        dc = fmaf(hp[col], dys[j * kBwdCols + col], dc);
      }
      const int64_t o = ((int64_t)blk * S + t) * N + n;
      g.db_part[o] = dts[j] * db;
      g.dc_part[o] = dc;
    }
    __syncthreads();
  }
  if (g.dh0 != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int n = warp + kBwdWarps * i;
      if (pin && n < N) g.dh0[((int64_t)stream * N + n) * g.P + p] = gr[i];
    }
  }
  if (lane == 0) das[warp] = da_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) s += das[w];
    g.da_part[blk] = s;
  }
}

// The fixed-order sums: db and dc over the heads that share b/c and the
// column tiles ([B, S, N] contiguous; B counts the b/c streams), ddt over
// the tiles (in dt's layout), da over the streams that share each element
// of a (a contiguous, na elements).
__global__ void mamba2_scan_bwd_reduce_kernel(BwdArgs g) {
  const int64_t nbc = (int64_t)g.B * g.S * g.N;
  const int64_t ndt = (int64_t)g.B * g.H * g.S;
  const int64_t total = nbc + ndt + g.na;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i < nbc) {
      const int n = (int)(i % g.N);
      const int64_t bt = i / g.N;
      const int t = (int)(bt % g.S), bi = (int)(bt / g.S);
      float db = 0.f, dc = 0.f;
      for (int hi = 0; hi < g.H; ++hi)
        for (int tile = 0; tile < g.NT; ++tile) {
          const int64_t o =
              (((int64_t)(bi * g.H + hi) * g.NT + tile) * g.S + t) * g.N + n;
          db += g.db_part[o];
          dc += g.dc_part[o];
        }
      g.db[i] = db;
      g.dc[i] = dc;
    } else if (i < nbc + ndt) {
      const int64_t j = i - nbc;
      const int t = (int)(j % g.S);
      const int stream = (int)(j / g.S);
      float s = 0.f;
      for (int tile = 0; tile < g.NT; ++tile)
        s += g.ddt_part[((int64_t)stream * g.NT + tile) * g.S + t];
      const int bi = stream / g.H, hi = stream % g.H;
      g.ddt[(int64_t)bi * g.ddt_sb + (int64_t)hi * g.ddt_sh +
            (int64_t)t * g.ddt_st] = s;
    } else {
      const int e = (int)(i - nbc - ndt);
      float s = 0.f;
      for (int stream = 0; stream < g.B * g.H; ++stream) {
        const int bi = stream / g.H, hi = stream % g.H;
        if (bi * g.a_sb + hi * g.a_sh != e) continue;
        for (int tile = 0; tile < g.NT; ++tile)
          s += g.da_part[stream * g.NT + tile];
      }
      g.da[e] = s;
    }
  }
}

template <int NP>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = BwdLayout<NP>::bytes;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_bwd_chunk_kernel<NP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(a.NT, a.B * a.H);
  mamba2_scan_bwd_chunk_kernel<NP><<<grid, kBwdThreads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)a.B * a.S * a.N +
                        (int64_t)a.B * a.H * a.S + a.na;
  const int64_t want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  mamba2_scan_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

int bwd_np(int N) { return N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128; }

int bwd_q(int N) { return bwd_np(N) <= 64 ? kBwdQ : kBwdQ / 2; }

}  // namespace

extern "C" {

// fp32 throughout.  x and y share the strides x_sb/x_sh/x_st (batch,
// head, time; the channel stride is 1); dt, b/c and a have their own (a
// head stride of 0 shares an operand across the heads of a batch row).
// h0 may be null (a zero initial state); h0 and hout are [B*H, N, P]
// contiguous.  N <= 128, B * H <= 65535.  dt >= 0 and a <= 0 (dt
// softplus'd, a = -exp(a_log)).  Returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernel does not take, else the
// launch's cudaGetLastError().
int mamba2_scan_fwd(const void* x, const void* dt, const void* b,
                    const void* c, const void* a, const void* h0, void* y,
                    void* hout, int B, int H, int S, int P, int N, int x_sb,
                    int x_sh, int x_st, int dt_sb, int dt_sh, int dt_st,
                    int bc_sb, int bc_sh, int bc_st, int a_sb, int a_sh,
                    void* stream) {
  if (B < 0 || H < 1 || S < 0 || P < 1 || N < 1 || N > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hout);
  // 16-byte copies of x, b, c (and 8-byte stores of y) need every row
  // start on 16 bytes
  const int vec = aligned16(x) && aligned16(b) && aligned16(c) &&
                  aligned16(y) && P % 4 == 0 && N % 4 == 0 &&
                  x_sb % 4 == 0 && x_sh % 4 == 0 && x_st % 4 == 0 &&
                  bc_sb % 4 == 0 && bc_sh % 4 == 0 && bc_st % 4 == 0;
#define MAMBA2_LAUNCH(NP, PT)                                                 \
  launch<NP, PT>(xf, dtf, bf, cf, af, h0f, yf, hf, B, H, S, P, N, x_sb,      \
                 x_sh, x_st, dt_sb, dt_sh, dt_st, bc_sb, bc_sh, bc_st, a_sb, \
                 a_sh, vec, st)
  const bool narrow = P <= 32;
  cudaError_t err;
  if (N <= 16)
    err = narrow ? MAMBA2_LAUNCH(16, 32) : MAMBA2_LAUNCH(16, 64);
  else if (N <= 32)
    err = narrow ? MAMBA2_LAUNCH(32, 32) : MAMBA2_LAUNCH(32, 64);
  else if (N <= 64)
    err = narrow ? MAMBA2_LAUNCH(64, 32) : MAMBA2_LAUNCH(64, 64);
  else  // a larger state leaves shared memory for 16 channels a block
    err = MAMBA2_LAUNCH(128, 16);
#undef MAMBA2_LAUNCH
  return (int)err;
}

// The scratch one backward call needs, in floats: per (stream, column
// tile of 32) the state at the start of every chunk of the backward,
// partials of ddt per step, of db and dc per step and row, and of da.
long long mamba2_scan_bwd_scratch_floats(int B, int H, int S, int P, int N) {
  if (B < 1 || H < 1 || S < 0 || P < 1 || N < 1 || N > 128) return 0;
  const long long nt = (P + kBwdCols - 1) / kBwdCols, q = bwd_q(N);
  const long long nc = (S + q - 1) / q;
  return (long long)B * H * nt *
         (nc * bwd_np(N) * kBwdCols + S * (2LL * N + 1) + 1);
}

// The backward of mamba2_scan_fwd, fp32 throughout.  x, dt, b, c, a and
// h0 as the forward took them (h0 may be null); dy and dx take x's
// strides; ddt has its own (batch, head, time) strides; dh_final may be
// null (zero); dh0 is written when it is not null.  db and dc are [B, S,
// N] contiguous: a b/c head stride of 0 sums them over the H heads that
// share a row.  da is a's shape, contiguous, na elements (a contiguous):
// each element sums the streams that read it.  scratch holds
// mamba2_scan_bwd_scratch_floats(...) floats.  Returns a cudaError_t as
// mamba2_scan_fwd does.
int mamba2_scan_bwd(const void* x, const void* dt, const void* b,
                    const void* c, const void* a, const void* h0,
                    const void* dy, const void* dh_final, void* dx,
                    void* ddt, void* db, void* dc, void* da, void* dh0,
                    void* scratch, int B, int H, int S, int P, int N,
                    int x_sb, int x_sh, int x_st, int dt_sb, int dt_sh,
                    int dt_st, int bc_sb, int bc_sh, int bc_st, int a_sb,
                    int a_sh, int ddt_sb, int ddt_sh, int ddt_st, int na,
                    void* stream) {
  if (B < 0 || H < 1 || S < 0 || P < 1 || N < 1 || N > 128 || na < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  BwdArgs g;
  g.x = static_cast<const float*>(x);
  g.dt = static_cast<const float*>(dt);
  g.b = static_cast<const float*>(b);
  g.c = static_cast<const float*>(c);
  g.a = static_cast<const float*>(a);
  g.h0 = static_cast<const float*>(h0);
  g.dy = static_cast<const float*>(dy);
  g.dhf = static_cast<const float*>(dh_final);
  g.dx = static_cast<float*>(dx);
  g.ddt = static_cast<float*>(ddt);
  g.db = static_cast<float*>(db);
  g.dc = static_cast<float*>(dc);
  g.da = static_cast<float*>(da);
  g.dh0 = static_cast<float*>(dh0);
  g.B = B;
  g.H = H;
  g.S = S;
  g.P = P;
  g.N = N;
  g.NT = (P + kBwdCols - 1) / kBwdCols;
  g.NC = (S + bwd_q(N) - 1) / bwd_q(N);
  g.na = na;
  g.x_sb = x_sb;
  g.x_sh = x_sh;
  g.x_st = x_st;
  g.dt_sb = dt_sb;
  g.dt_sh = dt_sh;
  g.dt_st = dt_st;
  g.bc_sb = bc_sb;
  g.bc_sh = bc_sh;
  g.bc_st = bc_st;
  g.a_sb = a_sb;
  g.a_sh = a_sh;
  g.ddt_sb = ddt_sb;
  g.ddt_sh = ddt_sh;
  g.ddt_st = ddt_st;
  const long long bh = (long long)B * H;
  g.starts = static_cast<float*>(scratch);
  g.ddt_part = g.starts + bh * g.NT * g.NC * bwd_np(N) * kBwdCols;
  g.db_part = g.ddt_part + bh * g.NT * S;
  g.dc_part = g.db_part + bh * g.NT * S * N;
  g.da_part = g.dc_part + bh * g.NT * S * N;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (bwd_np(N)) {
    case 16: return (int)launch_bwd<16>(g, cs);
    case 32: return (int)launch_bwd<32>(g, cs);
    case 64: return (int)launch_bwd<64>(g, cs);
    default: return (int)launch_bwd<128>(g, cs);
  }
}

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
