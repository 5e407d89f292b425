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
// dh0 of the forward above, in the same chunked SSD form transposed
// (ref.py's mamba2_scan_chunked_bwd_ref is this algebra in plain
// PyTorch).  Per chunk of kQ = 64 rows, with e_i = exp(cum_i), E =
// exp(cum_end), w_j = exp(cum_end - cum_j) dt_j, L, Sc = C B^T and M =
// Sc . L . dt_j as in the forward, h the state at the chunk's start and G
// = dL/dh at its end:
//   dL/dh_start = E G + C^T diag(e) dY        (G of the chunk before)
//   dX  = M^T dY + diag(w) B G
//   dM  = dY X^T on and below the diagonal,  dSc = dM . L . dt_j
//   dC  = dSc B + diag(e) dY h^T
//   dB  = dSc^T C + diag(w) X G^T
// and the decays, with R = dM . M, u_i = e_i <C_i, (dY h^T)_i> and V_j =
// <B_j, (X G^T)_j>: D_l, the gradient of cum_l + ... + cum_end, is
//   sum_{k >= l, j < l} R_kj + sum_{k >= l} u_k + sum_{j < l} w_j V_j
//     + E <G, h>,
// which takes R's row and column sums (they enter with opposite signs)
// and the w terms as the rectangle and the prefix in which they do not
// cancel; then ddt_l = a D_l + sum_i (dM . Sc . L)_il + V_l exp(cum_end -
// cum_l), and da sums dt_l D_l over the rows, chunks and streams.
//
// The exponents.  Under the model's decays (dt a down to ~ -40 a step)
// cum reaches the thousands over a chunk, and cum_i - cum_j taken as the
// difference of two cumsums would keep few digits.  So every exponent is
// a sum of terms of one sign (dt >= 0, a <= 0), all <= 0: cum over [0,
// i], cum_end - cum_j over (j, 63], and L through pivots at every kSub =
// 16 rows: for sub-blocks I > J, L_ij = exp(d summed within I up to i and
// over the sub-blocks between) x exp(d summed within J after j), each
// factor <= 1 (one that underflows belongs to a term at least as small);
// in a diagonal sub-block d[j+1] + ... + d[i], down each column.  No
// state is ever stepped backwards through a decay.
//
// Four kernels on the caller's stream, one call (names all hold
// mamba2_scan_bwd):
// 1. mamba2_scan_bwd_exponents_kernel, a block of 64 threads per (stream,
//    chunk): the exponents above, as factors and tables (a warp's shuffle
//    scans, then the diagonal sub-blocks a column a thread), to scratch.
// 2. mamba2_scan_bwd_states_kernel, grid (P tiles of 64, B*H, 2): per
//    stream, the chunks walked in order, h forwards from h0 (h_next = E h
//    + (diag(w) B)^T X) and G = dL/dh backwards from dh_final (G_prev = E
//    G + (diag(e) C)^T dY, and dh0), each chunk's update on the tensor
//    cores and the state kept in registers (one fmaf an element, rounded
//    to nearest), written to scratch at every chunk while the next
//    chunk's operands land.
// 3. mamba2_scan_bwd_chunk_kernel, grid (chunks, head groups, B), 8
//    warps, one block an SM: one chunk of kHeadGroup = 8 heads of a batch
//    row, which share b and c, so b, c and Sc = C B^T are loaded and
//    computed once for the 8 and their db and dc summed in shared memory
//    in a fixed order.  Per head: dM (two warps a 16-row tile, every
//    other key tile, as the forward's scores), dY h^T (warps 0-3) and X
//    G^T (warps 4-7); M, dSc, R and the column sums of dM . Sc . L from
//    dM's fragments; dC (warps 0-3) and dB (warps 4-7, whose causal
//    depths mirror theirs, so each scheduler gets the same work); dX (the
//    forward's pairing of row tiles); R's rectangle sums (row prefixes,
//    then column sums) and, in one warp, ddt and the stream's da for the
//    chunk.  ddt is whole in its block: no reduction.  When P fits one
//    tile, the next head's operands land under this head's products: dy,
//    G and the exponents from its start (double-buffered), x and h once
//    dM and dY h^T, X G^T are done; h, G and the exponents by one bulk
//    copy each (the TMA unit, on an mbarrier; kernel 2 writes the states
//    in this kernel's padded rows), x and dy by cp.async.
// 4. mamba2_scan_bwd_reduce_kernel: db and dc over the head groups, da
//    over the streams and chunks that share each element of a, in a fixed
//    order, so two calls give the same bits: there are no float atomics.
// Every product is 3xTF32 mma.sync (common/tf32_mma.cuh), each into a
// fresh accumulator at most 64 deep, as in the forward, the keys of each
// step of 8 renumbered in A and B alike (logical key t is physical 2t,
// t + 4 is 2t + 1): an operand read along its rows takes one 8-byte load
// per row, one read down its columns is conflict-free.
//
// What bounds it on this card.  At zamba2-7b's training shape (B = 4, H =
// 112, S = 1024, P = N = 64, b/c shared by the heads) the compulsory bytes
// are x, dy and dx (117.4 MB each) and dt, ddt, b, c, db, dc: 0.1075 ms at
// 3.35 TB/s.  The chunked form's products are 26.5 GFLOP, 0.161 ms at 495
// TFLOP/s over 3 TF32 products each (the per-step recurrence's 22.5
// GFLOP would take 0.34 ms on the fp32 CUDA cores), so operations bound
// it.  This design moves more than the compulsory bytes: kernel 2 reads x
// and dy once more and writes the states h and G (117 MB each) that
// kernel 3 reads.  Kernel 3 takes most of the time: with one block of 8
// warps an SM, two warps a scheduler, its chain per head (the products,
// the elementwise pass over dM, the sums and the six barriers between
// them) is bound by latency, at about half the mma.sync rate in its
// product phases.

namespace {

constexpr int kSub = 16;             // rows per pivot of the exponents
constexpr int kNSub = kQ / kSub;     // pivots per chunk
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kHeadGroup = 8;        // heads of a batch row per block of 3
// The exponents of a chunk, per (stream, chunk) in scratch: dt, exp(cum),
// exp(cum_end - cum), w, exp(suf) [kQ] each, erow [kQ][kNSub], E, and L
// on the diagonal sub-blocks [kNSub][kSub][kSub] (0 above the diagonal).
// suf_j is d summed after row j through its sub-block's end, and erow[i]
// [J] = exp(d summed from row i's sub-block start through i + over the
// sub-blocks strictly between J and i's), J below i's sub-block: L_ij =
// erow[i][J] exp(suf_j) off the diagonal sub-blocks, both factors <= 1.
constexpr int kDtAt = 0;
constexpr int kEcumAt = kQ;
constexpr int kErestAt = 2 * kQ;
constexpr int kWAt = 3 * kQ;
constexpr int kEsufAt = 4 * kQ;
constexpr int kErowAt = 5 * kQ;
constexpr int kEndAt = kErowAt + kQ * kNSub;
constexpr int kDiagAt = kEndAt + 4;
constexpr int kExpoFloats = kDiagAt + kNSub * kSub * kSub;
// the exponents kernel's working space after them: d, pre, suf [kQ]
constexpr int kWorkFloats = 3 * kQ;

static_assert(kQ == 4 * kSub && kBwdWarps == 8,
              "two warps per 16-row tile of a chunk");

struct BwdArgs {
  const float *x, *dt, *b, *c, *a, *h0, *dy, *dhf;
  float *dx, *ddt, *db, *dc, *da, *dh0;
  float *hst, *gst, *expo, *da_part, *db_part, *dc_part;  // scratch
  int B, H, S, P, N, NC, NG, na;
  int ls, pz;   // the states' row stride in scratch, the columns written
  int x_sb, x_sh, x_st, dt_sb, dt_sh, dt_st, bc_sb, bc_st, a_sb, a_sh,
      ddt_sb, ddt_sh, ddt_st;
  int vec_x, vec_bc, vec_s;   // 16-byte copies: x and dy, b and c, states
};

struct Expo {
  float *dt, *ecum, *erest, *w, *esuf, *erow, *eend, *diag;
  float *d, *pre, *suf;   // the exponents kernel's only
};

__device__ __forceinline__ Expo expo_at(float* p) {
  return {p + kDtAt,   p + kEcumAt, p + kErestAt, p + kWAt,
          p + kEsufAt, p + kErowAt, p + kEndAt,   p + kDiagAt,
          p + kExpoFloats, p + kExpoFloats + kQ, p + kExpoFloats + 2 * kQ};
}

// One warp: the exponents of the chunk at t0 (tn rows in S) of a stream,
// lane l holding rows 2l and 2l + 1, each sub-block of 16 rows in 8 lanes.
// Rows past S read dt = 0.  Every sum is of terms of one sign.
__device__ void chunk_exponents(const Expo& ex, const float* dt,
                                int64_t dtoff, int dt_st, int t0, int tn,
                                float av, int lane) {
  const int r0 = 2 * lane;
  const float dt0 = r0 < tn ? dt[dtoff + (int64_t)(t0 + r0) * dt_st] : 0.f;
  const float dt1 =
      r0 + 1 < tn ? dt[dtoff + (int64_t)(t0 + r0 + 1) * dt_st] : 0.f;
  const float d0 = dt0 * av, d1 = dt1 * av;
  const int sl = lane & 7;
  // d summed from the sub-block's start through each row, and after each
  // row through the sub-block's end (segmented shuffle scans of the pairs)
  float run = d0 + d1;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float v = __shfl_up_sync(kFull, run, off);
    if (sl >= off) run += v;
  }
  float excl = __shfl_up_sync(kFull, run, 1);
  if (sl == 0) excl = 0.f;
  const float pre0 = excl + d0, pre1 = pre0 + d1;
  float rrun = d0 + d1;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float v = __shfl_down_sync(kFull, rrun, off);
    if (sl + off < 8) rrun += v;
  }
  float rexcl = __shfl_down_sync(kFull, rrun, 1);
  if (sl == 7) rexcl = 0.f;
  const float suf1 = rexcl, suf0 = d1 + rexcl;
  float tot[kNSub];
#pragma unroll
  for (int k = 0; k < kNSub; ++k) tot[k] = __shfl_sync(kFull, pre1, 8 * k + 7);
  const int sb = lane >> 3;
  float before = 0.f, after = 0.f, total = 0.f;
#pragma unroll
  for (int k = 0; k < kNSub; ++k) {
    if (k < sb) before += tot[k];
    total += tot[k];
  }
#pragma unroll
  for (int k = kNSub - 1; k >= 0; --k)
    if (k > sb) after += tot[k];
  ex.d[r0] = d0;
  ex.d[r0 + 1] = d1;
  ex.dt[r0] = dt0;
  ex.dt[r0 + 1] = dt1;
  ex.pre[r0] = pre0;
  ex.pre[r0 + 1] = pre1;
  ex.suf[r0] = suf0;
  ex.suf[r0 + 1] = suf1;
  // exp(cum) is 0 on rows past S: a bulk copy leaves the rows of a ragged
  // chunk's stage as they were, and both of its scales then read 0
  ex.ecum[r0] = r0 < tn ? expf(before + pre0) : 0.f;
  ex.ecum[r0 + 1] = r0 + 1 < tn ? expf(before + pre1) : 0.f;
  const float er0 = expf(suf0 + after), er1 = expf(suf1 + after);
  ex.erest[r0] = er0;
  ex.erest[r0 + 1] = er1;
  ex.w[r0] = er0 * dt0;
  ex.w[r0 + 1] = er1 * dt1;
  ex.esuf[r0] = expf(suf0);
  ex.esuf[r0 + 1] = expf(suf1);
  // erow: the sub-blocks strictly between J and this one, summed from J up
#pragma unroll
  for (int bj = 0; bj < kNSub; ++bj) {
    float mid = 0.f;
#pragma unroll
    for (int k = 0; k < kNSub; ++k)
      if (k > bj && k < sb) mid += tot[k];
    ex.erow[r0 * kNSub + bj] = bj < sb ? expf(pre0 + mid) : 0.f;
    ex.erow[(r0 + 1) * kNSub + bj] = bj < sb ? expf(pre1 + mid) : 0.f;
  }
  if (lane == 0) ex.eend[0] = expf(total);
}

// The diagonal sub-blocks' L, a thread per column j (kNSub * kSub
// threads): d[j+1] + ... + d[i] summed down the column, 0 above the
// diagonal
__device__ void diag_decays(const Expo& ex, int tid) {
  const int sb = tid / kSub, c = tid % kSub;
  float* col = ex.diag + sb * kSub * kSub + c;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    if (r > c) s += ex.d[sb * kSub + r];
    col[r * kSub] = r < c ? 0.f : __expf(s);
  }
}

// acc[i] += A (the warp's 16 rows, K in [k0, k1)) x B (K x n8 tile i) for
// i < nn <= NT, in 3xTF32, one fresh accumulator per stage of at most 64
// along K added into acc in fp32.  fa(k, av) gives the A fragment of the
// 8-step at k (a0..a3), fb(k, i, b0, b1) the B fragment of tile i.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_gemm(float acc[][4], int k0, int k1,
                                          int nn, FA fa, FB fb) {
#pragma unroll 1
  for (int s0 = k0; s0 < k1; s0 += kStageK) {
    Tiles<NT> part;
    part.zero();
    const int s1 = min(s0 + kStageK, k1);
#pragma unroll 2
    for (int k = s0; k < s1; k += 8) {
      float av[4];
      fa(k, av);
      uint32_t ab[4], as[4], bf[NT][4];
      split4(av[0], av[1], av[2], av[3], ab, as);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < nn) {
          float b0, b1;
          fb(k, i, b0, b1);
          split(b0, bf[i][0], bf[i][1]);
          split(b1, bf[i][2], bf[i][3]);
        }
      }
      part.mma3(ab, as, bf, nn);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part.c[i][e];
  }
}

// An A fragment read along its rows, keys renumbered: p at (row g, key
// k + 2t); logical key t is k + 2t, t + 4 is k + 2t + 1, one 8-byte load
// per row
__device__ __forceinline__ void frag_rows(const float* p, int ld, float* av,
                                          float s0 = 1.f, float s1 = 1.f) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * ld);
  av[0] = u.x * s0;
  av[1] = v.x * s1;
  av[2] = u.y * s0;
  av[3] = v.y * s1;
}

// rows r < rn (row stride rs) and columns c < cn of src into dst [R][CW]
// (row stride ls), the rest zero-filled; safe: any valid address
template <int R, int CW>
__device__ __forceinline__ void copy_tile(float* dst, int ls,
                                          const float* src, int64_t rs,
                                          int rn, int cn, int vec, int tid,
                                          const float* safe) {
  if (vec) {
#pragma unroll 1
    for (int idx = tid; idx < R * (CW / 4); idx += kBwdThreads) {
      const int r = idx / (CW / 4), col = 4 * (idx % (CW / 4));
      const bool in = r < rn && col < cn;
      cp_async16(dst + r * ls + col, in ? src + r * rs + col : safe, in);
    }
  } else {
#pragma unroll 1
    for (int idx = tid; idx < R * CW; idx += kBwdThreads) {
      const int r = idx / CW, col = idx % CW;
      const bool in = r < rn && col < cn;
      cp_async4(dst + r * ls + col, in ? src + r * rs + col : safe, in);
    }
  }
}

// Bulk copies (the TMA unit, cp.async.bulk) completing on an mbarrier:
// one instruction moves a contiguous run of bytes (a multiple of 16, both
// ends on 16 bytes) while the issuing warp goes on.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the arrival of this phase, expecting `bytes` of bulk copies; the
// shared memory they overwrite was last read by the generic proxy
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// A block of kExpoThreads per (stream, chunk): the chunk's exponents and
// the diagonal sub-blocks' L, to scratch.
constexpr int kExpoThreads = kNSub * kSub;
__global__ void __launch_bounds__(kExpoThreads)
    mamba2_scan_bwd_exponents_kernel(BwdArgs g) {
  __shared__ __align__(16) float sm[kExpoFloats + kWorkFloats];
  const int ck = blockIdx.x, stream = blockIdx.y, tid = threadIdx.x;
  const int bi = stream / g.H, hi = stream % g.H;
  const int t0 = ck * kQ, tn = min(kQ, g.S - t0);
  const Expo ex = expo_at(sm);
  if (tid < 32)
    chunk_exponents(ex, g.dt,
                    (int64_t)bi * g.dt_sb + (int64_t)hi * g.dt_sh, g.dt_st,
                    t0, tn, g.a[(int64_t)bi * g.a_sb + (int64_t)hi * g.a_sh],
                    tid);
  __syncthreads();
  diag_decays(ex, tid);
  __syncthreads();
  float4* eo = reinterpret_cast<float4*>(
      g.expo + ((int64_t)stream * g.NC + ck) * kExpoFloats);
  for (int i = tid; i < kExpoFloats / 4; i += kExpoThreads)
    eo[i] = reinterpret_cast<const float4*>(sm)[i];
}

// NP: N padded (32, 64 or 128); PT: channels per block (16 or 64).  Row
// strides = 4 mod 32: renumbered fragment reads down a column are
// conflict-free.
constexpr int kWalkStages = 2;
template <int NP, int PT>
struct WalkLayout {
  static constexpr int LX = PT + 4, LB = NP + 4;
  static constexpr int OP = 0;                        // [stage][kQ][LB]
  static constexpr int RHS = OP + kWalkStages * kQ * LB;   // [stage][kQ][LX]
  static constexpr int EX = RHS + kWalkStages * kQ * LX;   // [stage][kDiagAt]
  static constexpr size_t bytes =
      (EX + kWalkStages * kDiagAt) * sizeof(float);
};

// blockIdx.z 0: h forwards from h0 (or 0), h_next = E h + (diag(w) B)^T
// X; 1: G backwards from dh_final (or 0), G_prev = E G + (diag(e) C)^T dY,
// and dh0.  The state stays in the registers of the warps that own its
// tiles (each update one fmaf, rounded to nearest) and is written to
// scratch at every chunk, in kernel 3's row stride; the operands of the
// next two chunks are in flight meanwhile.
template <int NP, int PT>
__global__ void __launch_bounds__(kBwdThreads)
    mamba2_scan_bwd_states_kernel(BwdArgs g) {
  using L = WalkLayout<NP, PT>;
  constexpr int LX = L::LX, LB = L::LB;
  constexpr int NT = PT / 16;                     // n8 tiles of an item
  constexpr int ITEMS = 2 * (NP / 16);            // (row tile, half)
  constexpr int IPW = (ITEMS + kBwdWarps - 1) / kBwdWarps;
  extern __shared__ __align__(16) float smem[];
  const int pt = blockIdx.x, stream = blockIdx.y, dir = blockIdx.z;
  const int bi = stream / g.H, hi = stream % g.H, p0 = pt * PT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int nc = g.NC;
  const float* op = dir ? g.c : g.b;
  const float* rhs = dir ? g.dy : g.x;
  const float* init = dir ? g.dhf : g.h0;
  const int scale_at = dir ? kEcumAt : kWAt;
  const int64_t np = (int64_t)g.N * g.P, nls = (int64_t)g.N * g.ls;
  float* const out = (dir ? g.gst : g.hst) + (int64_t)stream * nc * nls;
  const int pw = min(PT, g.P - p0);               // the block's channels

  float st[IPW][NT][4];
#pragma unroll
  for (int k = 0; k < IPW; ++k)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int it = warp + kBwdWarps * k;
        const int n = 16 * (it >> 1) + gq + 8 * (e >> 1);
        const int p = p0 + (it & 1) * (PT / 2) + 8 * i + 2 * tq + (e & 1);
        st[k][i][e] = (init != nullptr && it < ITEMS && n < g.N && p < g.P)
                          ? init[(int64_t)stream * np + (int64_t)n * g.P + p]
                          : 0.f;
      }

  // chunk ck's operands into stage sg
  auto issue = [&](int ck, int sg) {
    const int t0 = ck * kQ, tn = min(kQ, g.S - t0);
    float* od = smem + L::OP + sg * kQ * LB;
    float* rd = smem + L::RHS + sg * kQ * LX;
    float* ed = smem + L::EX + sg * kDiagAt;
    const float* os = op + (int64_t)bi * g.bc_sb + (int64_t)t0 * g.bc_st;
    const float* rsrc = rhs + (int64_t)bi * g.x_sb + (int64_t)hi * g.x_sh +
                        (int64_t)t0 * g.x_st + p0;
    const float* es = g.expo + ((int64_t)stream * nc + ck) * kExpoFloats;
    copy_tile<kQ, NP>(od, LB, os, g.bc_st, tn, g.N, g.vec_bc, tid, op);
    copy_tile<kQ, PT>(rd, LX, rsrc, g.x_st, tn, pw, g.vec_x, tid, rhs);
    copy_tile<1, kDiagAt>(ed, 0, es, 0, 1, kDiagAt, 1, tid, g.expo);
    cp_async_commit();
  };
  auto chunk_of = [&](int step) { return dir ? nc - 1 - step : step; };

  for (int k = 0; k < kWalkStages - 1 && k < nc; ++k) issue(chunk_of(k), k);
#pragma unroll 1
  for (int step = 0; step < nc; ++step) {
    const int ck = chunk_of(step), sg = step % kWalkStages;
    if (step + 1 < nc)
      cp_async_wait<kWalkStages - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();   // also: every warp is done with stage (step - 1)
    if (step + kWalkStages - 1 < nc)
      issue(chunk_of(step + kWalkStages - 1),
            (step + kWalkStages - 1) % kWalkStages);
    const float* ops = smem + L::OP + sg * kQ * LB;
    const float* rs = smem + L::RHS + sg * kQ * LX;
    const float* scale = smem + L::EX + sg * kDiagAt + scale_at;
    const float ee = smem[L::EX + sg * kDiagAt + kEndAt];
    float* o = out + (int64_t)ck * nls;
#pragma unroll
    for (int k = 0; k < IPW; ++k) {
      const int it = warp + kBwdWarps * k;
      if (it >= ITEMS) continue;
      const int n0 = 16 * (it >> 1), c0 = (it & 1) * (PT / 2);
      // the state at the chunk's start (h) or end (G), to scratch (its
      // columns from P to pz are 0 here: kernel 3 copies whole rows)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + gq + 8 * half;
          const int p = p0 + c0 + 8 * i + 2 * tq;
          if (n >= g.N || p >= g.pz) continue;
          float* q = o + (int64_t)n * g.ls + p;
          if (g.ls % 2 == 0) {
            *reinterpret_cast<float2*>(q) =
                make_float2(st[k][i][2 * half], st[k][i][2 * half + 1]);
          } else {
            q[0] = st[k][i][2 * half];
            if (p + 1 < g.pz) q[1] = st[k][i][2 * half + 1];
          }
        }
      // the chunk's own update, keys renumbered in A and B alike
      float acc[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      warp_gemm<NT>(
          acc, 0, kQ, NT,
          [&](int kk, float* av) {
            const int j = kk + 2 * tq;
            const float s0 = scale[j], s1 = scale[j + 1];
            const float* a = ops + j * LB + n0 + gq;
            av[0] = a[0] * s0;
            av[1] = a[8] * s0;
            av[2] = a[LB] * s1;
            av[3] = a[LB + 8] * s1;
          },
          [&](int kk, int i, float& b0, float& b1) {
            const float* b = rs + (kk + 2 * tq) * LX + c0 + 8 * i + gq;
            b0 = b[0];
            b1 = b[LX];
          });
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[k][i][e] = fmaf(ee, st[k][i][e], acc[i][e]);
    }
  }
  if (dir == 1 && g.dh0 != nullptr) {
#pragma unroll
    for (int k = 0; k < IPW; ++k)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int it = warp + kBwdWarps * k;
          const int n = 16 * (it >> 1) + gq + 8 * (e >> 1);
          const int p = p0 + (it & 1) * (PT / 2) + 8 * i + 2 * tq + (e & 1);
          if (it < ITEMS && n < g.N && p < g.P)
            g.dh0[(int64_t)stream * np + (int64_t)n * g.P + p] = st[k][i][e];
        }
  }
}

template <int NP, int PT>
struct MainLayout {
  // LH = 8 mod 32: a state row is 32-byte aligned in scratch, whence it
  // comes by one bulk copy, and rows read along are conflict-free (N =
  // 128 leaves no room: there the states come by cp.async)
  static constexpr int LX = PT + 4, LB = NP + 4, LM = kQ + 4;
  static constexpr int LH = NP == 128 ? PT + 4 : PT + 8;
  static constexpr int BM = 0;                   // [kQ][LB] b
  static constexpr int CM = BM + kQ * LB;        // [kQ][LB] c
  static constexpr int DBS = CM + kQ * LB;       // [kQ][LB] db, the heads'
  static constexpr int DCS = DBS + kQ * LB;      // [kQ][LB] dc  sums
  static constexpr int X = DCS + kQ * LB;        // [kQ][LX]
  static constexpr int DY = X + kQ * LX;         // [2][kQ][LX] by parity
  static constexpr int HS = DY + 2 * kQ * LX;    // [NP][LH] h at the start
  static constexpr int GS = HS + NP * LH;        // [2][NP][LH] G at the end
  static constexpr int M = GS + 2 * NP * LH;     // [kQ][LM]
  static constexpr int DSC = M + kQ * LM;        // [kQ][LM] dSc, then R
  static constexpr int EX = DSC + kQ * LM;
  static constexpr int UV = EX + 2 * kExpoFloats;   // [2][kQ] u, V
  static constexpr int COLT = UV + 2 * kQ;       // [kNSub][kQ]
  static constexpr int DR = COLT + kNSub * kQ;   // [kQ] R's rectangles
  static constexpr int GH = DR + kQ;             // [kBwdWarps] <G, h>
  static constexpr int MB = GH + kBwdWarps;      // 3 mbarriers: x and h,
                                                 // dy, G, exponents x 2
  static constexpr size_t bytes = (MB + 8) * sizeof(float);
  static_assert(bytes <= 232448, "one block an SM");
};

template <int NP, int PT>
__global__ void __launch_bounds__(kBwdThreads, 1)
    mamba2_scan_bwd_chunk_kernel(BwdArgs g) {
  using L = MainLayout<NP, PT>;
  constexpr int LX = L::LX, LB = L::LB, LM = L::LM, LH = L::LH;
  constexpr int NTN = NP / 8;     // n8 tiles across the state
  constexpr int NTX = PT / 16;    // n8 tiles of half the channels
  extern __shared__ __align__(16) float smem[];
  float* const bs = smem + L::BM;
  float* const cs = smem + L::CM;
  float* const dbs = smem + L::DBS;
  float* const dcs = smem + L::DCS;
  float* const xs = smem + L::X;
  float* const hs = smem + L::HS;
  float* const msm = smem + L::M;
  float* const dscs = smem + L::DSC;
  float* const uvs = smem + L::UV;
  float* const colts = smem + L::COLT;
  float* const drs = smem + L::DR;
  float* const ghs = smem + L::GH;

  const int ck = blockIdx.x, grp = blockIdx.y, bi = blockIdx.z;
  const int h_lo = grp * kHeadGroup, h_hi = min(g.H, h_lo + kHeadGroup);
  const int t0 = ck * kQ, tn = min(kQ, g.S - t0);
  const int npt = (g.P + PT - 1) / PT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // dM, Sc and dX: row tile rt, key (or channel) half ch, as the
  // forward's scores; dY h^T and dC (warps 0-3) or X G^T and dB (4-7):
  // row tile rs
  const int rt = warp < 4 ? warp : 7 - warp;
  const int ch = warp >> 2;
  const int nq = rt + 1;
  const int rs = warp & 3;
  const bool cside = warp < 4;
  // x and dy by cp.async from every thread; h, G (their scratch rows are
  // this kernel's) and the exponents by one bulk copy each from warp 0
  // when P fits one tile (mbarrier 0 for h, 1 + parity for G and the
  // exponents), else by cp.async too
  const bool bulk = npt == 1 && g.ls == LH;
  uint64_t* const mbar = reinterpret_cast<uint64_t*>(smem + L::MB);

  auto load_head = [&](int h, int pt, int parts) {
    const int64_t stream = (int64_t)bi * g.H + h;
    const int p0 = pt * PT;
    const int64_t xoff = (int64_t)bi * g.x_sb + (int64_t)h * g.x_sh +
                         (int64_t)t0 * g.x_st + p0;
    const int64_t soff = (stream * g.NC + ck) * g.N * g.ls + p0;
    const int par = (h - h_lo) & 1;
    float* const dyd = smem + L::DY + par * kQ * LX;
    float* const gd = smem + L::GS + par * NP * LH;
    float* const ed = smem + L::EX + par * kExpoFloats;
    const float* const es = g.expo + (stream * g.NC + ck) * kExpoFloats;
    if (parts & 1)
      copy_tile<kQ, PT>(xs, LX, g.x + xoff, g.x_st, tn, g.P - p0, g.vec_x,
                        tid, g.x);
    if (parts & 2)   // dy, into the buffer of the head's parity
      copy_tile<kQ, PT>(dyd, LX, g.dy + xoff, g.x_st, tn, g.P - p0,
                        g.vec_x, tid, g.dy);
    cp_async_commit();
    if (bulk) {
      if (warp == 0 && lane == 0) {
        const uint32_t rows = 4 * g.N * LH;
        if (parts & 1) {
          mbar_expect(&mbar[0], rows);
          bulk_copy(hs, g.hst + soff, rows, &mbar[0]);
        }
        if (parts & 2) {
          mbar_expect(&mbar[1 + par], rows + 4 * kExpoFloats);
          bulk_copy(gd, g.gst + soff, rows, &mbar[1 + par]);
          bulk_copy(ed, es, 4 * kExpoFloats, &mbar[1 + par]);
        }
      }
      return;
    }
    if (parts & 1)
      copy_tile<NP, PT>(hs, LH, g.hst + soff, g.ls, g.N, g.P - p0, g.vec_s,
                        tid, g.hst);
    if (parts & 2)   // G, into the buffer of the head's parity
      copy_tile<NP, PT>(gd, LH, g.gst + soff, g.ls, g.N, g.P - p0, g.vec_s,
                        tid, g.gst);
    if (parts & 4)   // the exponents, likewise
      copy_tile<1, kExpoFloats>(ed, 0, es, 0, 1, kExpoFloats, 1, tid,
                                g.expo);
    cp_async_commit();
  };

  if (bulk) {   // the state rows past N, which no copy writes, read 0
    for (int i = L::HS; i < L::M; i += kBwdThreads) {
      if (i + tid < L::M) smem[i + tid] = 0.f;
    }
    if (tid == 0) {
      for (int k = 0; k < 3; ++k) mbar_init(&mbar[k]);
      mbar_init_fence();
    }
    __syncthreads();
  }
  {
    const int64_t bcoff = (int64_t)bi * g.bc_sb + (int64_t)t0 * g.bc_st;
    copy_tile<kQ, NP>(bs, LB, g.b + bcoff, g.bc_st, tn, g.N, g.vec_bc, tid,
                      g.b);
    copy_tile<kQ, NP>(cs, LB, g.c + bcoff, g.bc_st, tn, g.N, g.vec_bc, tid,
                      g.c);
    cp_async_commit();
  }
  if (npt == 1) load_head(h_lo, 0, 7);
  cp_async_wait<0>();
  __syncthreads();

  // Sc = C B^T on the warp's key tiles, once for the group's heads
  float sc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[q][e] = 0.f;
  warp_gemm<4>(
      sc, 0, NP, nq,
      [&](int k, float* av) {
        frag_rows(cs + (16 * rt + gq) * LB + k + 2 * tq, LB, av);
      },
      [&](int k, int i, float& b0, float& b1) {
        const float2 u = *reinterpret_cast<const float2*>(
            bs + (8 * (ch + 2 * i) + gq) * LB + k + 2 * tq);
        b0 = u.x;
        b1 = u.y;
      });

#pragma unroll 1
  for (int h = h_lo; h < h_hi; ++h) {
    const int64_t stream = (int64_t)bi * g.H + h;
    const float av = g.a[(int64_t)bi * g.a_sb + (int64_t)h * g.a_sh];
    const bool first = h == h_lo;
    const bool pref = npt == 1 && h + 1 < h_hi;
    const int hh = h - h_lo, par = hh & 1;
    const Expo ex = expo_at(smem + L::EX + par * kExpoFloats);
    const float* const dys = smem + L::DY + par * kQ * LX;
    const float* const gsm = smem + L::GS + par * NP * LH;

    // 1. dM = dY X^T, A12 = dY h^T or X G^T, <G, h>, over the P tiles
    float dm[4][4], a12[NTN][4], gh = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) dm[q][e] = 0.f;
#pragma unroll
    for (int i = 0; i < NTN; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) a12[i][e] = 0.f;
#pragma unroll 1
    for (int pt = 0; pt < npt; ++pt) {
      if (npt > 1) {
        __syncthreads();
        load_head(h, pt, pt == 0 ? 7 : 3);
      }
      cp_async_wait<0>();
      if (bulk) {
        mbar_wait(&mbar[0], hh & 1);
        mbar_wait(&mbar[1 + par], (hh >> 1) & 1);
      }
      __syncthreads();
      // the next head's dy, G and exponents land under this one
      if (pref) load_head(h + 1, 0, 6);
      warp_gemm<4>(
          dm, 0, PT, nq,
          [&](int k, float* a) {
            frag_rows(dys + (16 * rt + gq) * LX + k + 2 * tq, LX, a);
          },
          [&](int k, int i, float& b0, float& b1) {
            const float2 u = *reinterpret_cast<const float2*>(
                xs + (8 * (ch + 2 * i) + gq) * LX + k + 2 * tq);
            b0 = u.x;
            b1 = u.y;
          });
      const float* lhs = cside ? dys : xs;
      const float* rhs = cside ? hs : gsm;
      warp_gemm<NTN>(
          a12, 0, PT, NTN,
          [&](int k, float* a) {
            frag_rows(lhs + (16 * rs + gq) * LX + k + 2 * tq, LX, a);
          },
          [&](int k, int i, float& b0, float& b1) {
            const float2 u = *reinterpret_cast<const float2*>(
                rhs + (8 * i + gq) * LH + k + 2 * tq);
            b0 = u.x;
            b1 = u.y;
          });
#pragma unroll
      for (int idx = tid; idx < NP * PT / 4; idx += kBwdThreads) {
        const int o = (idx / (PT / 4)) * LH + 4 * (idx % (PT / 4));
        const float4 hv = *reinterpret_cast<const float4*>(hs + o);
        const float4 gv = *reinterpret_cast<const float4*>(gsm + o);
        gh = fmaf(hv.x, gv.x, fmaf(hv.y, gv.y, fmaf(hv.z, gv.z,
                                                    fmaf(hv.w, gv.w, gh))));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gh += __shfl_xor_sync(kFull, gh, off);
    if (lane == 0) ghs[warp] = gh;

    // 2. from dM's fragments: M and dSc (0 above the diagonal) into shared
    //    memory, R = dM . M kept, and the column sums of dM . Sc . L.  The
    //    warp's key tile q lies in sub-block q: L from the factors below
    //    the diagonal sub-block, from the table on it (0 above the diagonal)
    float rr[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float col[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * rt + gq + 8 * (e >> 1);
        const int j = 8 * (ch + 2 * q) + 2 * tq + (e & 1);
        rr[q][e] = 0.f;
        if (q < nq) {
          const float l =
              q < rt ? ex.erow[i * kNSub + q] * ex.esuf[j]
                     : ex.diag[(q * kSub + i % kSub) * kSub + j % kSub];
          const float dtj = ex.dt[j];
          const float sl = sc[q][e] * l;
          const float mv = sl * dtj;
          msm[i * LM + j] = mv;
          dscs[i * LM + j] = dm[q][e] * l * dtj;
          rr[q][e] = dm[q][e] * mv;
          col[e & 1] += dm[q][e] * sl;
        }
      }
      if (q < nq) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          float v = col[c2];
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          v += __shfl_xor_sync(kFull, v, 16);
          if (gq == 0) colts[rt * kQ + 8 * (ch + 2 * q) + 2 * tq + c2] = v;
        }
      }
    }
    __syncthreads();
    if (pref) load_head(h + 1, 0, 1);   // x and h are read

    // 3. dC = dSc B + diag(e) dY h^T (warps 0-3) and dB = dSc^T C +
    //    diag(w) X G^T (warps 4-7) over the group's heads, u and V
    {
      float tmp[NTN][4];
#pragma unroll
      for (int i = 0; i < NTN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[i][e] = 0.f;
      if (cside) {
        warp_gemm<NTN>(
            tmp, 0, 16 * (rs + 1), NTN,
            [&](int k, float* a) {
              frag_rows(dscs + (16 * rs + gq) * LM + k + 2 * tq, LM, a);
            },
            [&](int k, int i, float& b0, float& b1) {
              const float* p = bs + (k + 2 * tq) * LB + 8 * i + gq;
              b0 = p[0];
              b1 = p[LB];
            });
      } else {
        warp_gemm<NTN>(
            tmp, 16 * rs, kQ, NTN,
            [&](int k, float* a) {
              const float* p = dscs + (k + 2 * tq) * LM + 16 * rs + gq;
              a[0] = p[0];
              a[1] = p[8];
              a[2] = p[LM];
              a[3] = p[LM + 8];
            },
            [&](int k, int i, float& b0, float& b1) {
              const float* p = cs + (k + 2 * tq) * LB + 8 * i + gq;
              b0 = p[0];
              b1 = p[LB];
            });
      }
      const float* own = cside ? cs : bs;
      const float* scale = cside ? ex.ecum : ex.w;
      float* acc = cside ? dcs : dbs;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * rs + gq + 8 * half;
        const float s = scale[row];
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NTN; ++i)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int o = row * LB + 8 * i + 2 * tq + c2;
            const float a = a12[i][2 * half + c2];
            part = fmaf(own[o], a, part);
            const float v = tmp[i][2 * half + c2] + s * a;
            acc[o] = first ? v : acc[o] + v;
          }
        part += __shfl_xor_sync(kFull, part, 1);
        part += __shfl_xor_sync(kFull, part, 2);
        if (tq == 0) uvs[(cside ? 0 : kQ) + row] = cside ? s * part : part;
      }
    }

    // 4. dX = M^T dY + diag(w) B G over the P tiles
#pragma unroll 1
    for (int pt = 0; pt < npt; ++pt) {
      if (npt > 1) {
        __syncthreads();
        load_head(h, pt, 2);
        cp_async_wait<0>();
        __syncthreads();
      }
      const int c0 = ch * (PT / 2);
      float t1[NTX][4], t2[NTX][4];
#pragma unroll
      for (int i = 0; i < NTX; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) t1[i][e] = t2[i][e] = 0.f;
      warp_gemm<NTX>(
          t1, 16 * rt, kQ, NTX,
          [&](int k, float* a) {
            const float* p = msm + (k + 2 * tq) * LM + 16 * rt + gq;
            a[0] = p[0];
            a[1] = p[8];
            a[2] = p[LM];
            a[3] = p[LM + 8];
          },
          [&](int k, int i, float& b0, float& b1) {
            const float* p = dys + (k + 2 * tq) * LX + c0 + 8 * i + gq;
            b0 = p[0];
            b1 = p[LX];
          });
      const float w0 = ex.w[16 * rt + gq], w1 = ex.w[16 * rt + gq + 8];
      warp_gemm<NTX>(
          t2, 0, NP, NTX,
          [&](int k, float* a) {
            frag_rows(bs + (16 * rt + gq) * LB + k + 2 * tq, LB, a, w0, w1);
          },
          [&](int k, int i, float& b0, float& b1) {
            const float* p = gsm + (k + 2 * tq) * LH + c0 + 8 * i + gq;
            b0 = p[0];
            b1 = p[LH];
          });
      const int p0 = pt * PT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * rt + gq + 8 * half;
        if (row < tn) {
          float* dr = g.dx + (int64_t)bi * g.x_sb + (int64_t)h * g.x_sh +
                      (int64_t)(t0 + row) * g.x_st + p0;
#pragma unroll
          for (int i = 0; i < NTX; ++i) {
            const int p = c0 + 8 * i + 2 * tq;
            const float v0 = t1[i][2 * half] + t2[i][2 * half];
            const float v1 = t1[i][2 * half + 1] + t2[i][2 * half + 1];
            if (g.vec_x) {
              if (p0 + p < g.P)
                *reinterpret_cast<float2*>(dr + p) = make_float2(v0, v1);
            } else {
              if (p0 + p < g.P) dr[p] = v0;
              if (p0 + p + 1 < g.P) dr[p + 1] = v1;
            }
          }
        }
      }
    }
    __syncthreads();

    // 5. R over dSc, its exclusive row prefixes, then per column l the sum
    //    over the rows k >= l: the rectangle k >= l, j < l
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dscs[(16 * rt + gq + 8 * (e >> 1)) * LM + 8 * (ch + 2 * q) +
               2 * tq + (e & 1)] = rr[q][e];
    __syncthreads();
    {
      const int k = tid >> 2, part = tid & 3;
      const bool live = 16 * part <= k;
      float* row = dscs + k * LM + 16 * part;
      float v[16], run = 0.f;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        v[m] = run;
        if (live) run += row[m];
      }
      float incl = run;
      float t = __shfl_up_sync(kFull, incl, 1);
      if (part >= 1) incl += t;
      t = __shfl_up_sync(kFull, incl, 2);
      if (part >= 2) incl += t;
      float off = __shfl_up_sync(kFull, incl, 1);
      if (part == 0) off = 0.f;
      if (live)
#pragma unroll
        for (int m = 0; m < 16; ++m) row[m] = off + v[m];
    }
    __syncthreads();
    {
      const int l = tid >> 2, part = tid & 3;
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < kQ / 4; ++m) {   // rows part, part + 4, ...
        const int k = part + 4 * m;
        const float v = dscs[k * LM + l];
        s += k >= l ? v : 0.f;
      }
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      if (part == 0) drs[l] = s;
    }
    __syncthreads();

    // 6. one warp: D_l, ddt and the stream's da for the chunk
    if (warp == 0) {
      const int l0 = 2 * lane, l1 = l0 + 1;
      const float u0 = uvs[l0], u1 = uvs[l1];
      const float v0 = uvs[kQ + l0], v1 = uvs[kQ + l1];
      float ru = u0 + u1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_down_sync(kFull, ru, off);
        if (lane + off < 32) ru += t;
      }
      float rx = __shfl_down_sync(kFull, ru, 1);
      if (lane == 31) rx = 0.f;
      const float us1 = u1 + rx, us0 = u0 + us1;
      const float wv0 = ex.w[l0] * v0, wv1 = ex.w[l1] * v1;
      float pw = wv0 + wv1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, pw, off);
        if (lane >= off) pw += t;
      }
      float px = __shfl_up_sync(kFull, pw, 1);
      if (lane == 0) px = 0.f;
      float ghsum = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) ghsum += ghs[w];
      const float eg = ex.eend[0] * ghsum;
      const float dd0 = ((drs[l0] + us0) + px) + eg;
      const float dd1 = ((drs[l1] + us1) + (px + wv0)) + eg;
      float ct0 = 0.f, ct1 = 0.f;
#pragma unroll
      for (int r = 0; r < kNSub; ++r) {
        if (r >= l0 / kSub) ct0 += colts[r * kQ + l0];
        if (r >= l1 / kSub) ct1 += colts[r * kQ + l1];
      }
      const int64_t o = (int64_t)bi * g.ddt_sb + (int64_t)h * g.ddt_sh;
      if (l0 < tn)
        g.ddt[o + (int64_t)(t0 + l0) * g.ddt_st] =
            av * dd0 + ct0 + v0 * ex.erest[l0];
      if (l1 < tn)
        g.ddt[o + (int64_t)(t0 + l1) * g.ddt_st] =
            av * dd1 + ct1 + v1 * ex.erest[l1];
      float da = ex.dt[l0] * dd0 + ex.dt[l1] * dd1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da += __shfl_xor_sync(kFull, da, off);
      if (lane == 0) g.da_part[stream * g.NC + ck] = da;
    }
  }

  // the group's db and dc: to db/dc (one group) or to its partials
  __syncthreads();
  const int64_t ooff = g.NG == 1
                           ? (int64_t)bi * g.S * g.N
                           : ((int64_t)bi * g.NG + grp) * g.S * g.N;
  float* dbo = (g.NG == 1 ? g.db : g.db_part) + ooff;
  float* dco = (g.NG == 1 ? g.dc : g.dc_part) + ooff;
#pragma unroll 1
  for (int idx = tid; idx < kQ * NP; idx += kBwdThreads) {
    const int r = idx / NP, n = idx % NP;
    if (r < tn && n < g.N) {
      dbo[(int64_t)(t0 + r) * g.N + n] = dbs[r * LB + n];
      dco[(int64_t)(t0 + r) * g.N + n] = dcs[r * LB + n];
    }
  }
}

// The fixed-order sums: db and dc over the head groups ([B, S, N]
// contiguous; when there is more than one group), a thread an element;
// then da over the streams and chunks that share each element of a (a
// contiguous, na elements), a warp an element, its lanes over the streams
// and the lanes' sums in lane order.
__global__ void mamba2_scan_bwd_reduce_kernel(BwdArgs g) {
  const int64_t nbc = g.NG > 1 ? (int64_t)g.B * g.S * g.N : 0;
  const int64_t sn = (int64_t)g.S * g.N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t gid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t i = gid; i < nbc; i += stride) {
    const int64_t bi = i / sn, r = i - bi * sn;
    float db = 0.f, dc = 0.f;
    for (int grp = 0; grp < g.NG; ++grp) {
      const int64_t o = (bi * g.NG + grp) * sn + r;
      db += g.db_part[o];
      dc += g.dc_part[o];
    }
    g.db[i] = db;
    g.dc[i] = dc;
  }
  const int lane = threadIdx.x & 31;
  for (int64_t e = gid >> 5; e < g.na; e += stride >> 5) {
    float s = 0.f;
    for (int stream = lane; stream < g.B * g.H; stream += 32) {
      const int bi = stream / g.H, hi = stream % g.H;
      if (bi * g.a_sb + hi * g.a_sh != e) continue;
      for (int c = 0; c < g.NC; ++c)
        s += g.da_part[(int64_t)stream * g.NC + c];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      s += __shfl_down_sync(kFull, s, off);
    if (lane == 0) g.da[e] = s;
  }
}

template <int NP, int PT>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr int PW = NP == 128 ? 16 : 64;   // channels per walking block
  constexpr size_t wbytes = WalkLayout<NP, PW>::bytes;
  constexpr size_t mbytes = MainLayout<NP, PT>::bytes;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_bwd_states_kernel<NP, PW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wbytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(mamba2_scan_bwd_chunk_kernel<NP, PT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)mbytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int bh = a.B * a.H;
  mamba2_scan_bwd_exponents_kernel<<<dim3(a.NC, bh), kExpoThreads, 0,
                                     stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g1((a.P + PW - 1) / PW, bh, 2);
  mamba2_scan_bwd_states_kernel<NP, PW>
      <<<g1, kBwdThreads, wbytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3(a.NC, a.NG, a.B);
  mamba2_scan_bwd_chunk_kernel<NP, PT><<<g3, kBwdThreads, mbytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total =
      a.NG > 1 ? (int64_t)a.B * a.S * a.N : 32LL * a.na;
  const int64_t w4 = (total + 255) / 256;
  const int b4 = (int)(w4 < 132 * 16 ? w4 : 132 * 16);
  mamba2_scan_bwd_reduce_kernel<<<b4, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

int bwd_np(int N) { return N <= 32 ? 32 : N <= 64 ? 64 : 128; }

int bwd_pt(int N, int P) {
  return bwd_np(N) == 128 ? 16 : P <= 32 ? 32 : 64;
}

int bwd_groups(int H) { return (H + kHeadGroup - 1) / kHeadGroup; }

long long round4(long long n) { return (n + 3) & ~3LL; }

// The states' row stride in scratch: kernel 3's shared-memory rows (LH,
// so that a state is one bulk copy) when N <= 64, P fits one tile and
// rows of P floats keep 16 bytes, else P
int bwd_ls(int N, int P) {
  return bwd_np(N) <= 64 && P <= bwd_pt(N, P) && P % 4 == 0
             ? bwd_pt(N, P) + 8
             : P;
}

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

// The scratch one backward call needs, in floats: per (stream, chunk)
// the state at its start and the gradient at its end (N x P each), the
// exponents and a partial of da; per (batch row, head group, step, state
// row) partials of db and dc when the heads make more than one group of
// kHeadGroup.  Every part starts on 16 bytes.
long long mamba2_scan_bwd_scratch_floats(int B, int H, int S, int P, int N) {
  if (B < 1 || H < 1 || S < 0 || P < 1 || N < 1 || N > 128) return 0;
  const long long nc = (S + kQ - 1) / kQ, bh = (long long)B * H;
  const long long ng = bwd_groups(H);
  return 2 * round4(bh * nc * N * bwd_ls(N, P)) + bh * nc * kExpoFloats +
         round4(bh * nc) + (ng > 1 ? 2 * round4((long long)B * ng * S * N)
                                   : 0);
}

// The backward of mamba2_scan_fwd, fp32 throughout.  x, dt, b, c, a and
// h0 as the forward took them (h0 may be null; the b/c head stride must
// be 0); dy and dx take x's strides; ddt has its own (batch, head, time)
// strides; dh_final may be null (zero); dh0 is written when it is not
// null.  db and dc are [B, S, N] contiguous, summed over the H heads that
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
  if (B < 0 || H < 1 || S < 0 || P < 1 || N < 1 || N > 128 || na < 1 ||
      bc_sh != 0)
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
  g.NC = (S + kQ - 1) / kQ;
  g.NG = bwd_groups(H);
  g.na = na;
  g.x_sb = x_sb;
  g.x_sh = x_sh;
  g.x_st = x_st;
  g.dt_sb = dt_sb;
  g.dt_sh = dt_sh;
  g.dt_st = dt_st;
  g.bc_sb = bc_sb;
  g.bc_st = bc_st;
  g.a_sb = a_sb;
  g.a_sh = a_sh;
  g.ddt_sb = ddt_sb;
  g.ddt_sh = ddt_sh;
  g.ddt_st = ddt_st;
  const long long bhc = (long long)B * H * g.NC;
  g.ls = bwd_ls(N, P);
  g.pz = g.ls == P ? P : bwd_pt(N, P);
  const long long states = round4(bhc * N * g.ls);
  g.hst = static_cast<float*>(scratch);
  g.gst = g.hst + states;
  g.expo = g.gst + states;
  g.da_part = g.expo + bhc * kExpoFloats;
  g.db_part = g.da_part + round4(bhc);
  g.dc_part = g.db_part + (g.NG > 1 ? round4((long long)B * g.NG * S * N)
                                    : 0);
  g.vec_x = aligned16(x) && aligned16(dy) && aligned16(dx) && P % 4 == 0 &&
            x_sb % 4 == 0 && x_sh % 4 == 0 && x_st % 4 == 0;
  g.vec_bc = aligned16(b) && aligned16(c) && N % 4 == 0 && bc_sb % 4 == 0 &&
             bc_st % 4 == 0;
  g.vec_s = P % 4 == 0 && aligned16(h0) && aligned16(dh_final) &&
            aligned16(dh0);
  if (!aligned16(scratch)) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int np = bwd_np(N), pt = bwd_pt(N, P);
  cudaError_t err;
  if (np == 32)
    err = pt == 32 ? launch_bwd<32, 32>(g, cs) : launch_bwd<32, 64>(g, cs);
  else if (np == 64)
    err = pt == 32 ? launch_bwd<64, 32>(g, cs) : launch_bwd<64, 64>(g, cs);
  else
    err = launch_bwd<128, 16>(g, cs);
  return (int)err;
}

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
