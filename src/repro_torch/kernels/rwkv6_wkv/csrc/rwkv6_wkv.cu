// RWKV6 (Finch) wkv with data-dependent decay on NVIDIA Hopper (sm_90a),
// fp32, in the chunked wkv form on the tensor cores.
//
// Replaces repro/kernels/rwkv6_wkv/kernel.py::rwkv6_wkv (the Pallas TPU
// kernel) and is the only rwkv6 prefill recurrence of the port on the
// card.  It computes, for every stream (batch b, head h), what the
// recurrence
//   y_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)          y     [V]
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t (x) v_t         state [K, V]
// gives from S_0 (zero, or an initial state) over t = 0 .. S-1 (K = V): y
// [.., S, .., K] and the final state [B*H, K, K].
//
// The chunked form.  Time is cut into chunks of kQ = 64 rows from t = 0;
// the last may be ragged, its rows past S read as r = k = v = lw = 0,
// which leaves c and the state as they are.  Per chunk, with c the
// inclusive cumsum of lw restarted at the chunk (summed row by row in
// fp32, so it never rises: lw <= 0, and a positive lw, outside the
// contract, is read as 0) and cx its exclusive form (cx_t = c_{t-1},
// cx_0 = 0), every exponent below is <= 0 by construction:
//   A[t, j]  = sum_k r_t k_j exp(cx_t - c_j)   for j < t,
//              r_t . (u * k_t)                 for j = t (the bonus)
//   y        = A V  +  (r . exp(cx)) h_prev
//   h_next   = exp(c_end) h_prev  +  (k . exp(c_end - c_j))^T V
// A is built in sub-blocks of kSub = 16 rows (the MMA's m16).  A block
// (T, J) left of the diagonal (J < T) goes through the pivot p = c at the
// row before T: A_TJ = r^_T k^_J^T with r^_t = r_t exp(cx_t - p) and
// k^_j = k_j exp(p - c_j), each factor <= 1 times its operand, so a
// factor that underflows belongs to a term at least as small, and the
// 3xTF32 split loses no small half of a term of size 1 (the Pallas
// kernel's k exp(-cumsum) reaches exp(80) at its chunk of 16, and its r
// side then falls to subnormals).  A diagonal sub-block's lower-left
// quadrant (its rows 8 .. 15 against its keys 0 .. 7) goes through the
// pivot at its row 7 the same way; its two 8-row triangles are summed per
// element on the CUDA cores, exp(cx_t - c_j) taken for each (t, j, k).
// The products (r^ k^^T, A V, (r exp(cx)) h_prev and the decayed k^T V)
// run on the tensor cores in 3xTF32 (common/tf32_mma.cuh: mma.sync
// m16n8k8, each fp32 operand split into a big and a small TF32 half, the
// small terms first), each into a fresh accumulator at most 64 deep (K =
// 128 sums two stages apart and adds them in fp32), because the tensor
// cores' adds truncate.  The state is carried in fp32: h_next is one fmaf
// per element of exp(c_end), h_prev and the update, rounded to nearest;
// h0 enters as the first h_prev.  A pad step (k = 0, lw = 0) adds an exact
// 0 to the update and exp(0) = 1 to the decay, so a chunk of padding
// passes the state through bit for bit.
//
// Three kernels on the caller's stream, one call (names all hold
// rwkv6_wkv).  The state column v evolves only with v_t[v], so the V
// columns split into tiles of VT = min(K padded, 64).  Phases 1 and 3 are
// blocks of 8 warps; warp w of phase 3 is (row tile w % 4, column half
// w / 4).
// 1. rwkv6_wkv_chunk_state_kernel, grid (chunks, B*H, V tiles): a chunk's
//    k and lw into shared memory, then its v while c is summed (cp.async,
//    16-byte copies where pointers, strides and K allow, else 4-byte
//    ones); its own update (k . exp(c_end - c_j))^T V and exp(c_end), to
//    scratch.
// 2. rwkv6_wkv_state_pass_kernel, one thread per state element of a
//    stream: walks the chunks in order, writes the state at each chunk's
//    start over that chunk's update (h0, or 0, for the first) and the
//    final state to hout.
// 3. rwkv6_wkv_chunk_out_kernel, two blocks an SM, each walking (stream,
//    chunk, V tile) items: c; A's diagonal blocks (two warps each: the
//    triangles' 7 steps split 4 / 3, the bonus in one and the quadrant in
//    the other), the 12 n8 key tiles left of the diagonal spread over the
//    8 warps (kOffT/J/N: two in the warps with the bonus, one in the
//    others); after a barrier r . exp(cx) in place of r, then y_inter and
//    y_intra = A V for the warp's rows and columns, and y.  Each buffer is
//    refilled with the next item's operands as soon as this item stops
//    reading it (k, lw and u once A is built, r after y_inter, v and
//    h_prev at the end), so the copies run under the products.
//
// Layout.  r, k, v, lw and y are addressed through element strides over
// (batch, head, time), u through (batch, head) strides, so one entry
// point reads both layouts without a copy: the Pallas layout ([BH,S,K],
// u [BH,K]: B = BH streams of one head each) and the model's ([B,S,H,K]
// views of [B,S,d] projections, u [H,K] with batch stride 0).  The
// innermost stride is 1.  h0 and the final state are [B*H, K, K]
// contiguous; the scratch holds one K x K update (then the chunk's
// starting state) and K decays per (stream, chunk).
//
// What bounds it on this card.  At rwkv6-7b's prefill (B = 1, H = 64,
// S = 1024, K = 64) the operands are r, k, v, lw in and y out, 5 x 16.8
// MB, plus the 1.05 MB final state: 85.0 MB, 0.0254 ms at 3.35 TB/s.
// The tensor-core products (A left of the diagonal and in the quadrants,
// the causal part of A V, r h_prev and the update) are 1.58 GFLOP, 0.0096
// ms at 495 TFLOP/s over 3 TF32 products per fp32 product; the
// recurrence's 1.07 GFLOP would take 0.016 ms on the CUDA cores.  So
// bytes bound it.  This design moves more than that: phase 3 reads k, v
// and lw again (50 MB) and the chunk states (16.8 MB) go to scratch and
// back.  What holds it back: phase 3 is bound by the latency of its own
// chain (c, A, the products, barriers between them) at two blocks of 8
// warps an SM, the copies mostly hidden under it; phase 1 moves its 67 MB
// in waves that do not overlap their products; phase 2 is one more pass
// over the chunk states.

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

constexpr int kQ = 64;          // rows (time steps) per chunk
constexpr int kSub = 16;        // rows per sub-block of A (the MMA's m16)
constexpr int kThreads = 256;   // phases 1 and 3: two warps a sub-block
constexpr int kWarps = kThreads / 32;
constexpr int kRowTiles = kWarps / 2;  // sub-blocks of rows in a chunk
constexpr int kStageK = 64;     // the deepest sum one accumulator takes
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;   // phase 2: chunks loaded ahead
constexpr unsigned kFull = 0xffffffffu;

static_assert(kQ == kRowTiles * kSub, "two warps per sub-block of rows");
// Phase 3's blocks of A left of the diagonal, warp by warp: row tile,
// first n8 tile of keys, tiles (row tile T has 2T tiles of keys)
__constant__ int kOffT[kWarps] = {3, 3, 3, 2, 2, 2, 1, 1};
__constant__ int kOffJ[kWarps] = {0, 2, 4, 0, 2, 3, 0, 1};
__constant__ int kOffN[kWarps] = {2, 2, 2, 2, 1, 1, 1, 1};

struct Strides {  // element strides over (batch, head, time)
  int sb, sh, st;
};

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* h0;
  float* y;
  float* hout;
  float* dstate;  // [B*H, NC, K, K]: each chunk's update, then its h_prev
  float* eend;    // [B*H, NC, K]: exp(c_end) of each chunk
  int H, S, K, NC;
  int BH, items;  // streams; (stream, chunk, V tile) items of phase 3
  Strides rs, ks, vs, ws, ys;
  int u_sb, u_sh;
  int vec;        // 16-byte copies and 8-byte stores
};

__device__ __forceinline__ int64_t base(const Strides& s, int bi, int hi,
                                        int t0) {
  return (int64_t)bi * s.sb + (int64_t)hi * s.sh + (int64_t)t0 * s.st;
}

// One (stream, chunk, V tile) item of phase 3: item i is chunk i % NC of
// stream i / NC % BH, V tile i / (NC BH).
struct Item {
  int stream, bi, hi, v0, t0, tn, ck;
};

__device__ __forceinline__ Item item_of(const Args& a, int i, int vt) {
  Item it;
  it.ck = i % a.NC;
  const int rest = i / a.NC;
  it.stream = rest % a.BH;
  it.v0 = rest / a.BH * vt;
  it.bi = it.stream / a.H;
  it.hi = it.stream % a.H;
  it.t0 = it.ck * kQ;
  it.tn = min(kQ, a.S - it.t0);
  return it;
}

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
  __device__ __forceinline__ void add(const Tiles& o) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][e] += o.c[i][e];
  }
  // tile i += a @ b[i] for i < n (n <= NT, the same in every lane), a and
  // every b[i] already split (b[i]: the big and small halves of rows k and
  // k + 4).  Term by term across the tiles; per tile the order is
  // small*big, big*small, big*big, as kernels/tf32.py models it.
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

// Rows t0 .. t0 + kQ - 1 of columns c0 .. c0 + NC - 1 of one operand
// (``src + off`` is row t0, column 0; row stride st) into dst (row stride
// ld), zero-filled past row tn and column K, by NTH threads.
template <int NCOL, int NTH = kThreads>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int64_t off,
                                           int st, int tn, int c0, int K,
                                           int vec, int tid) {
  if (vec) {
    constexpr int NQ = NCOL / 4;
#pragma unroll 1
    for (int idx = tid; idx < kQ * NQ; idx += NTH) {
      const int r = idx / NQ, c = 4 * (idx % NQ);
      const bool in = r < tn && c0 + c < K;
      cp_async16(dst + r * ld + c,
                 in ? src + off + (int64_t)r * st + c0 + c : src, in);
    }
  } else {
#pragma unroll 1
    for (int idx = tid; idx < kQ * NCOL; idx += NTH) {
      const int r = idx / NCOL, c = idx % NCOL;
      const bool in = r < tn && c0 + c < K;
      cp_async4(dst + r * ld + c,
                in ? src + off + (int64_t)r * st + c0 + c : src, in);
    }
  }
}

// cs rows 1 .. kQ hold the chunk's lw; in place, row t + 1 becomes c_t,
// the inclusive cumsum from the chunk's start, summed row by row in fp32
// (so it never rises), and row 0 becomes 0: row t is then cx_t = c_{t-1}.
template <int KP>
__device__ __forceinline__ void chunk_cumsum(float* cs, int ld, int tid) {
  for (int n = tid; n < KP; n += kThreads) {
    float run = 0.f;
    cs[n] = 0.f;
#pragma unroll 8
    for (int t = 1; t <= kQ; ++t) {
      run += fminf(cs[t * ld + n], 0.f);
      cs[t * ld + n] = run;
    }
  }
}

// ---------------------------------------------------------------------------
// Phase 1: each chunk's own state update and decay
// ---------------------------------------------------------------------------

// Shared memory, in floats.  Row strides = 8 mod 32 make the transposed
// A-fragment reads of k and c, and the B-fragment reads of v,
// conflict-free.
template <int KP, int VT>
struct StateSmem {
  static constexpr int LK = KP + 8;
  static constexpr int LV = VT + 8;
  static constexpr int Kk = 0;                    // [kQ][LK] k
  static constexpr int C = Kk + kQ * LK;          // [kQ + 1][LK] cx / c
  static constexpr int V = C + (kQ + 1) * LK;     // [kQ][LV] v
  static constexpr size_t bytes = (V + kQ * LV) * sizeof(float);
};

// KP: K padded (16, 32, 64 or 128); VT: state columns per block.
template <int KP, int VT>
__global__ void __launch_bounds__(kThreads)
    rwkv6_wkv_chunk_state_kernel(Args a) {
  using L = StateSmem<KP, VT>;
  constexpr int LK = L::LK, LV = L::LV, NT = VT / 16;  // a warp's n8 tiles
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem + L::Kk;
  float* const cs = smem + L::C;
  float* const vs = smem + L::V;

  const int ck = blockIdx.x, stream = blockIdx.y, v0 = blockIdx.z * VT;
  const int bi = stream / a.H, hi = stream % a.H;
  const int t0 = ck * kQ, tn = min(kQ, a.S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int K = a.K;

  // k and lw first (the cumsum needs them), v while the cumsum runs
  stage_rows<KP>(ks, LK, a.k, base(a.ks, bi, hi, t0), a.ks.st, tn, 0, K,
                 a.vec, tid);
  stage_rows<KP>(cs + LK, LK, a.lw, base(a.ws, bi, hi, t0), a.ws.st, tn, 0,
                 K, a.vec, tid);
  cp_async_commit();
  stage_rows<VT>(vs, LV, a.v, base(a.vs, bi, hi, t0), a.vs.st, tn, v0, K,
                 a.vec, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  chunk_cumsum<KP>(cs, LK, tid);
  cp_async_wait<0>();
  __syncthreads();

  // the update (k . exp(c_end - c_j))^T V over the chunk's 64 rows: unit
  // (rt, hf) is state rows 16 rt .. 16 rt + 15 and half hf of the columns
  const float* cend = cs + kQ * LK;
  float* ds = a.dstate + ((int64_t)stream * a.NC + ck) * K * K;
#pragma unroll 1
  for (int unit = warp; unit < 2 * (KP / 16); unit += kWarps) {
    const int n0 = 16 * (unit >> 1), c0 = (unit & 1) * (VT / 2);
    const float ce0 = cend[n0 + g], ce1 = cend[n0 + g + 8];
    Tiles<NT> acc;
    acc.zero();
#pragma unroll 2
    for (int j0 = 0; j0 < kQ; j0 += 8) {
      // A[n][j] = k[j][n] exp(c_end[n] - c_j[n]); c_j is cs row j + 1
      const float* kp = ks + (j0 + t) * LK + n0 + g;
      const float* cp = cs + (j0 + t + 1) * LK + n0 + g;
      uint32_t ab[4], as[4], bf[NT][4];
      split4(kp[0] * __expf(ce0 - cp[0]), kp[8] * __expf(ce1 - cp[8]),
             kp[4 * LK] * __expf(ce0 - cp[4 * LK]),
             kp[4 * LK + 8] * __expf(ce1 - cp[4 * LK + 8]), ab, as);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        split_b(vs + (j0 + t) * LV + c0 + 8 * nt + g, 4 * LV, bf[nt]);
      acc.mma3(ab, as, bf);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + g + 8 * half;
      if (n < K) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = v0 + c0 + 8 * nt + 2 * t;
          const float w0 = acc.c[nt][2 * half], w1 = acc.c[nt][2 * half + 1];
          if (a.vec) {
            if (col < K)
              *reinterpret_cast<float2*>(ds + n * K + col) =
                  make_float2(w0, w1);
          } else {
            if (col < K) ds[n * K + col] = w0;
            if (col + 1 < K) ds[n * K + col + 1] = w1;
          }
        }
      }
    }
  }
  if (blockIdx.z == 0) {
    float* ee = a.eend + ((int64_t)stream * a.NC + ck) * K;
    for (int n = tid; n < K; n += kThreads) ee[n] = expf(cend[n]);
  }
}

// ---------------------------------------------------------------------------
// Phase 2: the state carried across chunks, in fp32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
    rwkv6_wkv_state_pass_kernel(const float* __restrict__ h0,
                                float* __restrict__ dstate,
                                const float* __restrict__ eend,
                                float* __restrict__ hout, int K, int NC) {
  const int stream = blockIdx.y;
  const int idx = blockIdx.x * kPassThreads + threadIdx.x;
  const int kk = K * K;
  if (idx >= kk) return;
  const int n = idx / K;
  float h = h0 != nullptr ? h0[(int64_t)stream * kk + idx] : 0.f;
  float* ds = dstate + (int64_t)stream * NC * kk + idx;
  const float* ee = eend + (int64_t)stream * NC * K + n;
#pragma unroll 1
  for (int c0 = 0; c0 < NC; c0 += kPassAhead) {
    float d[kPassAhead], e[kPassAhead];
#pragma unroll
    for (int i = 0; i < kPassAhead; ++i) {
      if (c0 + i < NC) {
        d[i] = ds[(int64_t)(c0 + i) * kk];
        e[i] = ee[(int64_t)(c0 + i) * K];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassAhead; ++i) {
      if (c0 + i < NC) {
        ds[(int64_t)(c0 + i) * kk] = h;  // the chunk's h_prev
        h = fmaf(e[i], h, d[i]);
      }
    }
  }
  hout[(int64_t)stream * kk + idx] = h;
}

// ---------------------------------------------------------------------------
// Phase 3: each chunk's output
// ---------------------------------------------------------------------------

// Shared memory, in floats.  Row strides = 4 mod 8 (r, k, c, A) and = 8
// mod 32 (v, h) make the fragment reads below conflict-free.
template <int KP, int VT>
struct OutSmem {
  static constexpr int LK = KP + 4;
  static constexpr int LV = VT + 8;
  static constexpr int LA = kQ + 4;
  static constexpr int R = 0;                     // [kQ][LK] r
  static constexpr int Kk = R + kQ * LK;          // [kQ][LK] k
  static constexpr int C = Kk + kQ * LK;          // [kQ + 1][LK] cx / c
  static constexpr int V = C + (kQ + 1) * LK;     // [kQ][LV] v
  static constexpr int Hh = V + kQ * LV;          // [KP][LV] h_prev
  static constexpr int A = Hh + KP * LV;          // [kQ][LA] A
  static constexpr int U = A + kQ * LA;           // [KP] u
  static constexpr size_t bytes = (U + KP) * sizeof(float);
};

// CPL channels of row ``row`` of ``m`` (row stride ld) for lane quarter q:
// float4 i of the lane is columns 4 (q + 4 (i + i0)) .. + 3.
template <int CPL>
__device__ __forceinline__ void lane_channels(const float* m, int q, int i0,
                                              float out[CPL]) {
#pragma unroll
  for (int i = 0; i < CPL / 4; ++i) {
    const float4 x =
        *reinterpret_cast<const float4*>(m + 4 * (q + 4 * (i + i0)));
    out[4 * i] = x.x;
    out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z;
    out[4 * i + 3] = x.w;
  }
}

// The two triangles of the diagonal sub-block of rows b0 .. b0 + 15 (rows
// and keys both in b0 .. b0 + 7, or both in b0 + 8 .. b0 + 15) on the CUDA
// cores: A[t][j] = sum_k r_t k_j exp(cx_t - c_j) for j < t, the bonus r_t
// . (u * k_t) at j = t, 0 above the diagonal.  Lane (rp, q) owns rows
// ta = e + rp % 4 and tb = e + 7 - rp % 4 of triangle e = b0 + 8 (rp / 4),
// whose 7 pairs make one per step m (this warp: steps m0 .. m1 - 1, at
// most 4; the bonus when ``bonus``), and a quarter of the channels (in
// groups of at most 16, the partial sums added in A); the four lanes of a
// row pair sum their quarters with two shuffles.
template <int KP>
__device__ __forceinline__ void diag_triangles(
    const float* rs, const float* ks, const float* cs, const float* us,
    float* as, int ld, int la, int b0, int m0, int m1, bool bonus,
    int lane) {
  constexpr int CPL = KP / 4 < 16 ? KP / 4 : 16;  // channels per group
  constexpr int NG = KP / (4 * CPL);              // groups
  const int rp = lane >> 2, q = lane & 3;
  const int e = b0 + 8 * (rp >> 2), rq = rp & 3;
  const int ta = e + rq, tb = e + 7 - rq;
#pragma unroll 1
  for (int gi = 0; gi < NG; ++gi) {
    const int i0 = gi * (CPL / 4);
    float ra[CPL], ca[CPL], rb[CPL], cb[CPL];
    lane_channels<CPL>(rs + ta * ld, q, i0, ra);
    lane_channels<CPL>(cs + ta * ld, q, i0, ca);   // cx_ta
    lane_channels<CPL>(rs + tb * ld, q, i0, rb);
    lane_channels<CPL>(cs + tb * ld, q, i0, cb);
    if (bonus) {
      float uu[CPL], ka[CPL], kb[CPL];
      lane_channels<CPL>(us, q, i0, uu);
      lane_channels<CPL>(ks + ta * ld, q, i0, ka);
      lane_channels<CPL>(ks + tb * ld, q, i0, kb);
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int ch = 0; ch < CPL; ++ch) {
        pa = fmaf(ra[ch] * uu[ch], ka[ch], pa);
        pb = fmaf(rb[ch] * uu[ch], kb[ch], pb);
      }
      pa += __shfl_xor_sync(kFull, pa, 1);
      pa += __shfl_xor_sync(kFull, pa, 2);
      pb += __shfl_xor_sync(kFull, pb, 1);
      pb += __shfl_xor_sync(kFull, pb, 2);
      if (q == 0) {
        as[ta * la + ta] = gi ? as[ta * la + ta] + pa : pa;
        as[tb * la + tb] = gi ? as[tb * la + tb] + pb : pb;
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // step m: row ta against key e + m while m < rq, then row tb
      // against key e + m - rq; cx_t - c_j <= 0 since j <= t - 1
      const int m = m0 + s;
      if (m >= m1) break;
      const bool lo = m < rq;
      const int tt = lo ? ta : tb;
      const int j = e + (lo ? m : m - rq);
      float kj[CPL], cj[CPL];
      lane_channels<CPL>(ks + j * ld, q, i0, kj);
      lane_channels<CPL>(cs + (j + 1) * ld, q, i0, cj);   // c_j
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int ch = 0; ch < CPL; ch += 2) {
        p0 = fmaf((lo ? ra[ch] : rb[ch]) * kj[ch],
                  __expf((lo ? ca[ch] : cb[ch]) - cj[ch]), p0);
        p1 = fmaf((lo ? ra[ch + 1] : rb[ch + 1]) * kj[ch + 1],
                  __expf((lo ? ca[ch + 1] : cb[ch + 1]) - cj[ch + 1]), p1);
      }
      float p = p0 + p1;
      p += __shfl_xor_sync(kFull, p, 1);
      p += __shfl_xor_sync(kFull, p, 2);
      if (q == 0) as[tt * la + j] = gi ? as[tt * la + j] + p : p;
      if (q == 1 && gi == 0) as[j * la + tt] = 0.f;
    }
  }
}

// A of one chunk into as (row stride LA), from r, k, u and cs (cx / c,
// row stride LK) in shared memory, by 8 warps: scores_diag its diagonal
// sub-blocks (0 above the diagonal), scores_left the blocks left of them.
// Warp (rt, hf) as in rwkv6_wkv_chunk_out_kernel.
template <int KP, int LK, int LA>
__device__ __forceinline__ void scores_diag(const float* rs, const float* ks,
                                            const float* cs, const float* us,
                                            float* as, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp % kRowTiles, hf = warp / kRowTiles;
  const int r0 = kSub * rt;
  // 1. A's diagonal block rt: its two triangles per element, steps 0 .. 3
  //    and the bonus in one warp of the pair, steps 4 .. 6 in the other;
  //    and in that other warp its lower-left quadrant (rows r0 + 8 ..
  //    r0 + 15, keys r0 .. r0 + 7) on the tensor cores, through the pivot
  //    p = c_{r0 + 7} (cs row r0 + 8): r^ k^^T over K, the MMA's rows g
  //    zero; the upper-right quadrant 0
  diag_triangles<KP>(rs, ks, cs, us, as, LK, LA, r0, hf ? 4 : 0,
                     hf ? 7 : 4, hf == 0, lane);
  if (hf) {
    const float* pc = cs + (r0 + 8) * LK;
    Tiles<1> acc;
    acc.zero();
#pragma unroll
    for (int k0s = 0; k0s < KP; k0s += kStageK) {
      Tiles<1> part;
      part.zero();
#pragma unroll 2
      for (int k0 = k0s; k0 < k0s + kStageK && k0 < KP; k0 += 8) {
        const float* rp = rs + (r0 + 8 + g) * LK + k0 + t;
        const float* cp = cs + (r0 + 8 + g) * LK + k0 + t;
        const float q0 = pc[k0 + t], q1 = pc[k0 + t + 4];
        uint32_t ab[4], as4[4], bf[1][4];
        split4(0.f, rp[0] * __expf(cp[0] - q0), 0.f,
               rp[4] * __expf(cp[4] - q1), ab, as4);
        const float* kp = ks + (r0 + g) * LK + k0 + t;
        const float* cj = cs + (r0 + g + 1) * LK + k0 + t;
        split(kp[0] * __expf(q0 - cj[0]), bf[0][0], bf[0][1]);
        split(kp[4] * __expf(q1 - cj[4]), bf[0][2], bf[0][3]);
        part.mma3(ab, as4, bf);
      }
      acc.add(part);
    }
    *reinterpret_cast<float2*>(as + (r0 + 8 + g) * LA + r0 + 2 * t) =
        make_float2(acc.c[0][2], acc.c[0][3]);
    *reinterpret_cast<float2*>(as + (r0 + g) * LA + r0 + 8 + 2 * t) =
        make_float2(0.f, 0.f);
  }
}

template <int KP, int LK, int LA>
__device__ __forceinline__ void scores_left(const float* rs, const float* ks,
                                            const float* cs, float* as,
                                            int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // 2. A's blocks left of the diagonal: row tile T against keys 0 ..
  //    16T - 1, 12 n8 tiles of keys in all, through the pivot p =
  //    c_{16T - 1} (cs row 16T): r^ k^^T over K.  Warp w takes row tile
  //    kOffT[w], key tiles kOffJ[w] .. + kOffN[w] - 1: two in the warps
  //    whose diagonal work is the lighter, one in the others
  {
    const int T = kOffT[warp], nj = kOffN[warp];
    const int p0 = kSub * T;
    const int j0 = 8 * kOffJ[warp];
    const float* pc = cs + p0 * LK;
    Tiles<2> acc;
    acc.zero();
#pragma unroll
    for (int k0s = 0; k0s < KP; k0s += kStageK) {
      Tiles<2> part;
      part.zero();
#pragma unroll 2
      for (int k0 = k0s; k0 < k0s + kStageK && k0 < KP; k0 += 8) {
        // r^[t][k] = r[t][k] exp(cx_t[k] - p[k]), t >= 16T
        const float* rp = rs + (p0 + g) * LK + k0 + t;
        const float* cp = cs + (p0 + g) * LK + k0 + t;
        const float q0 = pc[k0 + t], q1 = pc[k0 + t + 4];
        uint32_t ab[4], as4[4], bf[2][4];
        split4(rp[0] * __expf(cp[0] - q0),
               rp[8 * LK] * __expf(cp[8 * LK] - q0),
               rp[4] * __expf(cp[4] - q1),
               rp[8 * LK + 4] * __expf(cp[8 * LK + 4] - q1), ab, as4);
        // k^^T's n8 tile i, row k, is k^[j][k] = k[j][k] exp(p[k] -
        // c_j[k]) with j = j0 + 8i + g < 16T
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i < nj) {
            const float* kp = ks + (j0 + 8 * i + g) * LK + k0 + t;
            const float* cj = cs + (j0 + 8 * i + g + 1) * LK + k0 + t;
            split(kp[0] * __expf(q0 - cj[0]), bf[i][0], bf[i][1]);
            split(kp[4] * __expf(q1 - cj[4]), bf[i][2], bf[i][3]);
          }
        }
        part.mma3(ab, as4, bf, nj);
      }
      acc.add(part);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i < nj) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(as + (p0 + g + 8 * half) * LA + j0 +
                                     8 * i + 2 * t) =
              make_float2(acc.c[i][2 * half], acc.c[i][2 * half + 1]);
      }
    }
  }
}

template <int KP, int LK, int LA>
__device__ __forceinline__ void build_scores(const float* rs, const float* ks,
                                             const float* cs, const float* us,
                                             float* as, int warp, int lane) {
  scores_diag<KP, LK, LA>(rs, ks, cs, us, as, warp, lane);
  scores_left<KP, LK, LA>(rs, ks, cs, as, warp, lane);
}

// Each block walks items blockIdx.x, + gridDim.x, ..., two blocks to an
// SM.  Every buffer is refilled with the next item's operands as soon as
// this item stops reading it: k, lw and u once A is built, r once y_inter
// has read r . exp(cx), v and h_prev at the end; so the copies run under
// the products, and an item waits only on what it reads first.
template <int KP, int VT>
__global__ void __launch_bounds__(kThreads, 2)
    rwkv6_wkv_chunk_out_kernel(Args a) {
  using L = OutSmem<KP, VT>;
  constexpr int LK = L::LK, LV = L::LV, LA = L::LA;
  constexpr int NT = VT / 16;               // a warp's n8 tiles of columns
  extern __shared__ __align__(16) float smem[];
  float* const rs = smem + L::R;
  float* const ks = smem + L::Kk;
  float* const cs = smem + L::C;
  float* const vs = smem + L::V;
  float* const hs = smem + L::Hh;
  float* const as = smem + L::A;
  float* const us = smem + L::U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int K = a.K;
  // warp (rt, hf): rows 16 rt .. 16 rt + 15 of the chunk, half hf of the
  // item's columns; the two warps of a row tile share its A work
  const int rt = warp % kRowTiles, hf = warp / kRowTiles;
  const int r0 = kSub * rt;
  const int c0 = hf * (VT / 2);

  // an item's copies in three groups (each committed, empty past the last
  // item): k, lw and u; r; v and h_prev
  auto issue_kl = [&](int i) {
    if (i < a.items) {
      const Item it = item_of(a, i, VT);
      stage_rows<KP>(ks, LK, a.k, base(a.ks, it.bi, it.hi, it.t0), a.ks.st,
                     it.tn, 0, K, a.vec, tid);
      stage_rows<KP>(cs + LK, LK, a.lw, base(a.ws, it.bi, it.hi, it.t0),
                     a.ws.st, it.tn, 0, K, a.vec, tid);
      const float* ub =
          a.u + (int64_t)it.bi * a.u_sb + (int64_t)it.hi * a.u_sh;
      for (int n = tid; n < KP; n += kThreads)
        cp_async4(us + n, n < K ? ub + n : ub, n < K);
    }
    cp_async_commit();
  };
  auto issue_r = [&](int i) {
    if (i < a.items) {
      const Item it = item_of(a, i, VT);
      stage_rows<KP>(rs, LK, a.r, base(a.rs, it.bi, it.hi, it.t0), a.rs.st,
                     it.tn, 0, K, a.vec, tid);
    }
    cp_async_commit();
  };
  auto issue_vh = [&](int i) {
    if (i < a.items) {
      const Item it = item_of(a, i, VT);
      stage_rows<VT>(vs, LV, a.v, base(a.vs, it.bi, it.hi, it.t0), a.vs.st,
                     it.tn, it.v0, K, a.vec, tid);
      // h_prev: state rows n < K of columns v0 .. v0 + VT - 1 (row
      // stride K)
      const float* hsrc =
          a.dstate + ((int64_t)it.stream * a.NC + it.ck) * K * K;
      if (a.vec) {
        constexpr int NQ = VT / 4;
#pragma unroll 1
        for (int idx = tid; idx < KP * NQ; idx += kThreads) {
          const int n = idx / NQ, c = 4 * (idx % NQ);
          const bool in = n < K && it.v0 + c < K;
          cp_async16(hs + n * LV + c, in ? hsrc + n * K + it.v0 + c : hsrc,
                     in);
        }
      } else {
#pragma unroll 1
        for (int idx = tid; idx < KP * VT; idx += kThreads) {
          const int n = idx / VT, c = idx % VT;
          const bool in = n < K && it.v0 + c < K;
          cp_async4(hs + n * LV + c, in ? hsrc + n * K + it.v0 + c : hsrc,
                    in);
        }
      }
    }
    cp_async_commit();
  };

  int item = blockIdx.x;
  issue_kl(item);
  issue_r(item);
  issue_vh(item);
#pragma unroll 1
  for (; item < a.items; item += gridDim.x) {
    const Item it = item_of(a, item, VT);
    const int v0 = it.v0, bi = it.bi, hi = it.hi, t0 = it.t0, tn = it.tn;
    const int next = item + gridDim.x;
    cp_async_wait<1>();  // k, lw, u and r (v and h_prev may be in flight)
    __syncthreads();
    chunk_cumsum<KP>(cs, LK, tid);
    __syncthreads();

    build_scores<KP, LK, LA>(rs, ks, cs, us, as, warp, lane);
    cp_async_wait<0>();
    __syncthreads();  // every block of A written; v and h_prev landed
    // r . exp(cx) in place of r, each element once
    for (int idx = tid; idx < kQ * KP; idx += kThreads) {
      const int o = (idx / KP) * LK + idx % KP;
      rs[o] *= __expf(cs[o]);
    }
    __syncthreads();  // k, c and u read no more
    issue_kl(next);

    // 3. y_inter = (r . exp(cx)) h_prev over K
    Tiles<NT> yh;
    yh.zero();
#pragma unroll
    for (int k0s = 0; k0s < KP; k0s += kStageK) {
      Tiles<NT> part;
      part.zero();
#pragma unroll 2
      for (int k0 = k0s; k0 < k0s + kStageK && k0 < KP; k0 += 8) {
        const float* rp = rs + (r0 + g) * LK + k0 + t;
        uint32_t ab[4], as4[4], bf[NT][4];
        split4(rp[0], rp[8 * LK], rp[4], rp[8 * LK + 4], ab, as4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          split_b(hs + (k0 + t) * LV + c0 + 8 * nt + g, 4 * LV, bf[nt]);
        part.mma3(ab, as4, bf);
      }
      yh.add(part);
    }

    __syncthreads();  // r . exp(cx) read no more
    issue_r(next);

    // 4. y_intra = A V, keys 0 .. 16 rt + 15
    Tiles<NT> yi;
    yi.zero();
#pragma unroll 2
    for (int j0 = 0; j0 < r0 + kSub; j0 += 8) {
      const float* ap = as + (r0 + g) * LA + j0 + t;
      uint32_t ab[4], as4[4], bf[NT][4];
      split4(ap[0], ap[8 * LA], ap[4], ap[8 * LA + 4], ab, as4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        split_b(vs + (j0 + t) * LV + c0 + 8 * nt + g, 4 * LV, bf[nt]);
      yi.mma3(ab, as4, bf);
    }

    // 5. y = y_intra + y_inter, rows past S and columns past K skipped
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      if (row < tn) {
        float* yr = a.y + base(a.ys, bi, hi, t0 + row);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = v0 + c0 + 8 * nt + 2 * t;
          const float y0 = yi.c[nt][2 * half] + yh.c[nt][2 * half];
          const float y1 = yi.c[nt][2 * half + 1] + yh.c[nt][2 * half + 1];
          if (a.vec) {
            if (col < K)
              *reinterpret_cast<float2*>(yr + col) = make_float2(y0, y1);
          } else {
            if (col < K) yr[col] = y0;
            if (col + 1 < K) yr[col + 1] = y1;
          }
        }
      }
    }
    __syncthreads();  // A, v and h_prev read no more
    issue_vh(next);
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Blocks of ``kernel`` the card holds at once: the grid of a walk over
// items.
template <typename Kernel>
cudaError_t resident(Kernel kernel, size_t bytes, int* blocks,
                     int threads = kThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
  *blocks = sms * per_sm;
  if (err == cudaSuccess && *blocks < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

template <int KP>
cudaError_t launch(Args a, cudaStream_t stream) {
  constexpr int VT = KP < 64 ? KP : 64;
  constexpr size_t state_bytes = StateSmem<KP, VT>::bytes;
  constexpr size_t out_bytes = OutSmem<KP, VT>::bytes;
  // the dynamic shared-memory opt-ins and phase 3's grid, once
  static int out_grid = 0;
  if (out_grid == 0) {
    cudaError_t err =
        opt_in(rwkv6_wkv_chunk_state_kernel<KP, VT>, state_bytes);
    if (err == cudaSuccess)
      err = opt_in(rwkv6_wkv_chunk_out_kernel<KP, VT>, out_bytes);
    if (err == cudaSuccess)
      err = resident(rwkv6_wkv_chunk_out_kernel<KP, VT>, out_bytes,
                     &out_grid);
    if (err != cudaSuccess) {
      out_grid = 0;
      return err;
    }
  }
  const dim3 chunks(a.NC, a.BH, KP / VT);
  a.items = a.NC * a.BH * (KP / VT);
  if (a.items > 0) {
    rwkv6_wkv_chunk_state_kernel<KP, VT>
        <<<chunks, kThreads, state_bytes, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 pass((a.K * a.K + kPassThreads - 1) / kPassThreads, a.BH);
  rwkv6_wkv_state_pass_kernel<<<pass, kPassThreads, 0, stream>>>(
      a.h0, a.dstate, a.eend, a.hout, a.K, a.NC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.items == 0) return err;
  rwkv6_wkv_chunk_out_kernel<KP, VT>
      <<<min(a.items, out_grid), kThreads, out_bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

long long n_chunks(int S) { return ((long long)S + kQ - 1) / kQ; }

}  // namespace

// ---------------------------------------------------------------------------
// The backward: rwkv6_wkv_bwd
// ---------------------------------------------------------------------------
//
// Given the cotangents dy (r's shape) and dh_final ([B*H, K, K], may be
// null: zero), it computes dr, dk, dv, dlw, du and (when dh0 is wanted)
// dh0 of the forward above, in the same chunked form transposed (ref.py's
// rwkv6_wkv_chunked_bwd_ref is this algebra in plain PyTorch).  Per chunk
// of kQ = 64 rows, with c, cx, A, K~ = K exp(c_end - c) and R~ = R exp(cx)
// as in the forward, h the state at the chunk's start and G = dL/dh at its
// end:
//   dL/dh_start = exp(c_end) G + R~^T dY          (G of the chunk before)
//   dA = dY V^T on and below the diagonal
//   dV = A^T dY + K~ G
//   dR = exp(cx) (dY h^T) + [dA through the decays] K + u k_t dA_tt
//   dK = exp(c_end - c) (V G^T) + [dA^T through the decays] R + u r_t dA_tt
//   du = sum_t dA_tt r_t k_t
//   dlw_s = [lw_s <= 0] (sum_{t > s > j} T_tj + sum_{t > s} (R~ . dY h^T)_t
//           + exp(c_end) rowsum(h . G) + sum_{j < s} (K~ . V G^T)_j)
// with T_tjk = dA_tj r_tk k_jk exp(cx_tk - c_jk) for j < t (the chain rule
// through the min is the live bit).  The A terms go through pivots as A's
// own blocks do, every exponent <= 0: row block T (16 rows) against the
// keys before it through p = c_{16T - 1} (dR), key block J against the
// rows after it through p' = c_{16J + 15} (dK), each a product on the
// tensor cores; the pairs inside a diagonal sub-block per element.  No
// state is stepped backwards through a decay: the states h are the
// forward's (its scratch, kept for the backward), G is walked backwards.
//
// The rectangle sum_{t > s > j} T_tj is never taken as the difference of
// two cumsums (sum_{t > s} r dR_A - sum_{j >= s} k dK_A): under a strong
// decay the pairs t = j + 1 enter both at full size while the rectangle is
// exp(-5) smaller, so the difference would keep few of its digits.  For s
// in sub-block b it is summed from parts in which no pair enters twice:
// the pairs inside b (its two 8-row triangles per element; its lower-left
// quadrant, through the pivot c at its row 7, as an exclusive scan of the
// quadrant's keys before s or rows after s), the rows of b after s against
// the keys before b (rho = r dR^L, a suffix within b), the keys of b before
// s against the rows after b (kappa = k dK^B, a prefix within b), and the
// rows after b against the keys before b, read off the dR product's
// accumulator after the first 16 b keys (its rows' sums of r^ . acc).
//
// Three kernels on the caller's stream, one call (names all hold
// rwkv6_wkv_bwd):
// 1. rwkv6_wkv_bwd_states_kernel, a block per (64 state columns, stream):
//    the chunks walked backwards from dh_final, each chunk's R~^T dY on
//    the tensor cores and G in registers (one fmaf an element), written to
//    scratch before each step, dh0 at the end; the next chunk's r, lw and
//    dy land in a second stage while one is computed.
// 2. rwkv6_wkv_bwd_chunk_kernel, one block of 16 warps an SM walking
//    (stream, chunk, column tile) items with every operand of the item in
//    shared memory (225 KB at K = 64).  Two groups of 8 warps run the
//    independent phases side by side: A's diagonal sub-blocks and K~ G |
//    dA = dY V^T and A's blocks left of the diagonal (named barriers: dV
//    waits for A, the diagonal pass for dA only); dV = A^T dY + K~ G | the
//    diagonal triangles per element (a thread per (sub-block, 8-row half,
//    channel)), the bonus and du; then every warp the column products dY
//    h^T and V G^T of its quarter of the channels; then dR and dK of one
//    row / key tile on that quarter (so that every warp's pivot products
//    are 48 rows deep), with the quadrants, and rho and kappa left for dlw;
//    then dlw (group 0), while group 1 has issued the next item's copies
//    and sums its cumsum.  The next item's v, dy, h and G copies are issued
//    once the column products have read this item's, so they land under
//    dR and dK.  K <= 64 is one column tile; K = 128 takes tiles of 32
//    columns, and dr, dk, dlw become per-tile partials (all linear in the
//    tile's columns), the per-element parts then in a per-block global
//    work area.
// 3. rwkv6_wkv_bwd_reduce_kernel: du over the chunks, tiles and the
//    streams that share each row of u (8 lanes an element, fixed shares
//    and a fixed shuffle tree), and (K > 64) dr, dk, dlw over the tiles, in
//    a fixed order, so two calls give the same bits: there are no float
//    atomics.
// Every product is 3xTF32 mma.sync (common/tf32_mma.cuh), each into a
// fresh accumulator at most 64 deep, as in the forward.  Every kernel sums
// c row by row as the forward does, so the forward's states, G and the
// gradients all read the same exponents.
//
// What bounds it on this card.  At rwkv6-7b's training shape (B = 4, H =
// 64, S = 1024, K = 64) the compulsory bytes are r, k, v, lw, dy in and
// dr, dk, dv, dlw out, 9 x 67.1 MB: 0.180 ms at 3.35 TB/s.  The chunked
// form's products (A, dA and A^T dY on the causal pairs, dR's and dK's
// pivot products on the pairs below the diagonal, R~^T dY, K~ G, dY h^T
// and V G^T) are 13.98 GFLOP, 0.085 ms at 495 TFLOP/s over 3 TF32 products
// each; the per-step recurrence's 12.9 GFLOP would take 0.19 ms on the fp32
// CUDA cores.  So bytes bound it.  This design moves more than that:
// kernel 1 reads r, lw and dy once more and writes G (67 MB), and kernel 2
// reads the forward's states h and G (67 MB each).  Kernel 2 takes most of
// the time: one block an SM (its operands fill shared memory, so nothing
// is double-buffered across items), bound by the latency of each phase's
// chain (products, the per-element triangles, the epilogues' exponentials
// and scans) and by the skew at its three full barriers.

namespace {

constexpr int kBwdThreads = 2 * kThreads;  // kernel 2: two groups of 8 warps
constexpr int kTri = kSub / 2;  // rows of a diagonal sub-block's triangles
constexpr int kWorkBlocksPerSm = 2;   // K = 128: kernel 2's work areas an SM

template <int KP>
struct BwdTile {  // state columns of one item of kernel 2
  static constexpr int VT = KP <= 64 ? KP : 32;
};

struct BwdArgs {
  const float *r, *k, *v, *lw, *u, *dy, *dhf;
  const float *hst, *eend;  // the forward's scratch: h_prev, exp(c_end)
  float *dr, *dk, *dv, *dlw, *du, *dh0;
  float* gst;      // [B*H, NC, K, K]: R~^T dY of each chunk, then its G
  float* du_part;  // [items, K]
  float* part;     // NT > 1: [NT, 3, B*H, S, K] partials of dr, dk, dlw
  float* work;     // K = 128: per block, dR's and dK's diagonal parts and
                   // dlw's rectangle inside the diagonal sub-blocks
  int H, S, K, NC, NT, nu, BH, items;
  Strides rs, ks, vs, ws, os;
  int u_sb, u_sh;
  int vec;
};

// Kernel 2's shared memory, in floats.  Row strides = 4 mod 8 (r, k, c,
// v, dy, h, G, dA) make the fragment reads along rows conflict-free; A is
// read down its columns (8 mod 32).  Once dV has read A, its buffer holds
// the sums dlw takes from the products (ATOT, BTOT, DSNAP).  K <= 64
// keeps the diagonal parts in shared memory too (RD, KD, DG).
template <int KP, int VT>
struct BwdSmem {
  static constexpr int LK = KP + 4;
  static constexpr int LV = VT + 4;
  static constexpr int LA = kQ + 8;
  static constexpr int LD = kQ + 4;
  static constexpr bool kWorkInSmem = KP <= 64;
  static constexpr int R = 0;                      // [kQ][LK] r
  static constexpr int Kk = R + kQ * LK;           // [kQ][LK] k
  static constexpr int C = Kk + kQ * LK;           // [kQ + 1][LK] cx / c
  static constexpr int V = C + (kQ + 1) * LK;      // [kQ][LV] v
  static constexpr int DY = V + kQ * LV;           // [kQ][LV] dy
  static constexpr int Hh = DY + kQ * LV;          // [KP][LV] h
  static constexpr int G = Hh + KP * LV;           // [KP][LV] G
  static constexpr int A = G + KP * LV;            // [kQ][LA] A
  static constexpr int ATOT = A;                   // then [4][KP]
  static constexpr int BTOT = ATOT + 4 * KP;       //      [4][KP]
  static constexpr int DSNAP = BTOT + 4 * KP;      //      [3][KP]
  static constexpr int DA = A + kQ * LA;           // [kQ][LD] dA
  static constexpr int U = DA + kQ * LD;           // [KP] u
  static constexpr int E = U + KP;                 // [KP] exp(c_end) <h, G>
  static constexpr int DU = E + KP;                // [4][KP]
  static constexpr int LIVE = DU + 4 * KP;         // [2][KP] 64-bit masks
  static constexpr int RD = LIVE + 4 * KP;         // [kQ][LK] (KP <= 64)
  static constexpr int KD = RD + kQ * LK;          // [kQ][LK] (KP <= 64)
  static constexpr int DG = KD + kQ * LK;          // [kQ][LK] (KP <= 64)
  static constexpr int end = kWorkInSmem ? DG + kQ * LK : RD;
  static constexpr size_t bytes = end * sizeof(float);
  static constexpr int work = 3 * kQ * LK;         // a block's global work
  static_assert(11 * KP <= kQ * LA, "dlw's sums fit in A's buffer");
};

static_assert(BwdSmem<64, 64>::bytes <= 232448 &&
                  BwdSmem<128, 32>::bytes <= 232448,
              "kernel 2's operands fit in one block's shared memory");
static_assert(BwdTile<128>::VT <= kStageK, "dY's products in one stage");

// Rows n < KP of state columns v0 .. v0 + VT - 1 of a K x K state (row
// stride K) into dst (row stride ld), zero-filled past row or column K, by
// NTH threads.
template <int KP, int VT, int NTH>
__device__ __forceinline__ void stage_state(float* dst, int ld,
                                            const float* src, int K, int v0,
                                            int vec, int tid) {
  if (vec) {
    constexpr int NQ = VT / 4;
#pragma unroll 1
    for (int idx = tid; idx < KP * NQ; idx += NTH) {
      const int n = idx / NQ, c = 4 * (idx % NQ);
      const bool in = n < K && v0 + c < K;
      cp_async16(dst + n * ld + c, in ? src + n * K + v0 + c : src, in);
    }
  } else {
#pragma unroll 1
    for (int idx = tid; idx < KP * VT; idx += NTH) {
      const int n = idx / VT, c = idx % VT;
      const bool in = n < K && v0 + c < K;
      cp_async4(dst + n * ld + c, in ? src + n * K + v0 + c : src, in);
    }
  }
}

// chunk_cumsum (row by row, as the forward and kernel 1 sum it, so that
// every kernel reads the same c) by nth threads, and per channel n the
// mask of rows t with lw_t <= 0 (bit t of live[n]): the chain rule through
// min(lw, 0).
template <int KP>
__device__ __forceinline__ void chunk_cumsum_live(float* cs, int ld,
                                                  uint64_t* live, int tid,
                                                  int nth) {
  for (int n = tid; n < KP; n += nth) {
    float run = 0.f;
    uint64_t bits = 0;
    cs[n] = 0.f;
#pragma unroll 8
    for (int t = 1; t <= kQ; ++t) {
      const float lw = cs[t * ld + n];
      bits |= (uint64_t)(lw <= 0.f) << (t - 1);
      run += fminf(lw, 0.f);
      cs[t * ld + n] = run;
    }
    live[n] = bits;
  }
}

// Named barriers (0 is __syncthreads): bar_sync waits until n threads have
// reached barrier id; bar_arrive counts this warp in and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
constexpr int kDuLanes = 8;    // kernel 3: lanes that sum an element of du
constexpr int kBarScores = 1;  // kernel 2: A written (group 1 arrives)
constexpr int kBarGroup1 = 2;  // kernel 2: group 1 alone

// Kernel 1: per (column tile of VS, stream) block, the chunks walked
// backwards from dh_final: each chunk's R~^T dY on the tensor cores, and G
// = dL/dh at the chunk's end carried in registers (G_prev = exp(c_end) G
// + R~^T dY, one fmaf an element, rounded to nearest), written to scratch
// before each step; dh0 at the end.  A chunk's r, lw and dy land (two
// stages) while the chunk after it in the walk is computed.  Warp unit
// (rt, hf): state rows 16 rt .. 16 rt + 15, half hf of the columns.
template <int KP, int VS>
__global__ void __launch_bounds__(kThreads)
    rwkv6_wkv_bwd_states_kernel(BwdArgs a) {
  using L = StateSmem<KP, VS>;
  constexpr int LK = L::LK, LV = L::LV, NT = VS / 16;  // a warp's n8 tiles
  constexpr int STAGE = L::bytes / sizeof(float);
  constexpr int UNITS = 2 * (KP / 16);
  constexpr int UPW = UNITS > kWarps ? UNITS / kWarps : 1;  // units a warp
  extern __shared__ __align__(16) float smem[];
  const int stream = blockIdx.y, v0 = blockIdx.x * VS;
  const int bi = stream / a.H, hi = stream % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int K = a.K;

  auto stage = [&](int ck) {
    if (ck >= 0) {
      float* const base_s = smem + (ck & 1) * STAGE;
      const int t0 = ck * kQ, tn = min(kQ, a.S - t0);
      stage_rows<KP>(base_s + L::Kk, LK, a.r, base(a.rs, bi, hi, t0),
                     a.rs.st, tn, 0, K, a.vec, tid);
      stage_rows<KP>(base_s + L::C + LK, LK, a.lw, base(a.ws, bi, hi, t0),
                     a.ws.st, tn, 0, K, a.vec, tid);
      stage_rows<VS>(base_s + L::V, LV, a.dy, base(a.os, bi, hi, t0),
                     a.os.st, tn, v0, K, a.vec, tid);
    }
    cp_async_commit();
  };

  // G of the warp's units, from dh_final (or 0)
  Tiles<NT> gr[UPW];
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    gr[u].zero();
    const int unit = warp + kWarps * u;
    if (unit < UNITS && a.dhf != nullptr) {
      const int n0 = 16 * (unit >> 1), c0 = (unit & 1) * (VS / 2);
      const float* src = a.dhf + (int64_t)stream * K * K;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + g + 8 * (e >> 1);
          const int col = v0 + c0 + 8 * nt + 2 * t + (e & 1);
          if (n < K && col < K) gr[u].c[nt][e] = src[n * K + col];
        }
    }
  }

  stage(a.NC - 1);
#pragma unroll 1
  for (int ck = a.NC - 1; ck >= 0; --ck) {
    float* const rs = smem + (ck & 1) * STAGE + L::Kk;
    float* const cs = smem + (ck & 1) * STAGE + L::C;
    float* const ds = smem + (ck & 1) * STAGE + L::V;
    stage(ck - 1);        // the next chunk of the walk, into the other stage
    cp_async_wait<1>();
    __syncthreads();
    chunk_cumsum<KP>(cs, LK, tid);
    __syncthreads();
    float* const gout = a.gst + ((int64_t)stream * a.NC + ck) * K * K;
    const float* const ee = a.eend + ((int64_t)stream * a.NC + ck) * K;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + kWarps * u;
      if (unit >= UNITS) continue;
      const int n0 = 16 * (unit >> 1), c0 = (unit & 1) * (VS / 2);
      // (r . exp(cx))^T dY over the chunk's 64 rows: A[n][j] = r[j][n]
      // exp(cx_j[n]), cx_j is cs row j
      Tiles<NT> z;
      z.zero();
#pragma unroll 2
      for (int j0 = 0; j0 < kQ; j0 += 8) {
        const float* rp = rs + (j0 + t) * LK + n0 + g;
        const float* cp = cs + (j0 + t) * LK + n0 + g;
        uint32_t ab[4], sa[4], bf[NT][4];
        split4(rp[0] * __expf(cp[0]), rp[8] * __expf(cp[8]),
               rp[4 * LK] * __expf(cp[4 * LK]),
               rp[4 * LK + 8] * __expf(cp[4 * LK + 8]), ab, sa);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          split_b(ds + (j0 + t) * LV + c0 + 8 * nt + g, 4 * LV, bf[nt]);
        z.mma3(ab, sa, bf);
      }
      // G at the chunk's end to scratch, then the chunk's start
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + g + 8 * half;
        const float e = n < K ? ee[n] : 1.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = v0 + c0 + 8 * nt + 2 * t;
          float& w0 = gr[u].c[nt][2 * half];
          float& w1 = gr[u].c[nt][2 * half + 1];
          if (n < K) {
            if (a.vec) {
              if (col < K)
                *reinterpret_cast<float2*>(gout + n * K + col) =
                    make_float2(w0, w1);
            } else {
              if (col < K) gout[n * K + col] = w0;
              if (col + 1 < K) gout[n * K + col + 1] = w1;
            }
          }
          w0 = fmaf(e, w0, z.c[nt][2 * half]);
          w1 = fmaf(e, w1, z.c[nt][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // this stage read no more: the walk's next-but-one
  }
  if (a.dh0 != nullptr) {
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + kWarps * u;
      if (unit >= UNITS) continue;
      const int n0 = 16 * (unit >> 1), c0 = (unit & 1) * (VS / 2);
      float* dst = a.dh0 + (int64_t)stream * K * K;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + g + 8 * (e >> 1);
          const int col = v0 + c0 + 8 * nt + 2 * t + (e & 1);
          if (n < K && col < K) dst[n * K + col] = gr[u].c[nt][e];
        }
    }
  }
}

// The column sums of r^ . acc over the warp's 16 rows (r^_t = r_t
// exp(cx_t - p), p the row tile's pivot, cs row pr) into dst[n], for
// dlw's rectangle: lanes of one column sum their rows by shuffles.
template <int NTC, int LK>
__device__ __forceinline__ void rows_sum(const Tiles<NTC>& acc,
                                         const float* rs, const float* cs,
                                         int r0, int pr, int n0, float* dst,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = (r0 + g + 8 * (e >> 1)) * LK + col + (e & 1);
      s[e & 1] = fmaf(rs[o] * __expf(cs[o] - cs[pr * LK + col + (e & 1)]),
                      acc.c[nt][e], s[e & 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] += __shfl_xor_sync(kFull, s[i], 4);
      s[i] += __shfl_xor_sync(kFull, s[i], 8);
      s[i] += __shfl_xor_sync(kFull, s[i], 16);
    }
    if (g == 0) {
      dst[col] = s[0];
      dst[col + 1] = s[1];
    }
  }
}

// The column sums of the C fragments' values x[nt][e] over the warp's 16
// rows into dst[n].
template <int NTC>
__device__ __forceinline__ void cols_sum(const float x[NTC][4], int n0,
                                         float* dst, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt) {
    float s[2] = {x[nt][0] + x[nt][2], x[nt][1] + x[nt][3]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] += __shfl_xor_sync(kFull, s[i], 4);
      s[i] += __shfl_xor_sync(kFull, s[i], 8);
      s[i] += __shfl_xor_sync(kFull, s[i], 16);
    }
    if (g == 0) {
      dst[n0 + 8 * nt + 2 * t] = s[0];
      dst[n0 + 8 * nt + 2 * t + 1] = s[1];
    }
  }
}

// Kernel 2: each block walks items blockIdx.x, + gridDim.x, ...: item i is
// chunk i % NC of stream i / NC % BH, column tile i / (NC BH).  Two groups
// of 8 warps run the independent phases side by side: A | dA, dV | the
// diagonal sub-blocks, dR | dK; then dlw with every thread, while the next
// item's operands land (its copies are issued once dR and dK have read
// this item's).
template <int KP, int VT>
__global__ void __launch_bounds__(kBwdThreads, 1)
    rwkv6_wkv_bwd_chunk_kernel(BwdArgs a) {
  using L = BwdSmem<KP, VT>;
  constexpr int LK = L::LK, LV = L::LV, LA = L::LA, LD = L::LD;
  constexpr int NTV = VT / 16;  // n8 tiles in half the item's columns
  // dR's and dK's channels in NQ slices of NCH: warp (grp, rt, hf) takes
  // dR of rows rt and dK of keys rt on slice 2 hf + grp, so that every
  // warp's pivot products are 48 rows deep
  constexpr int NQ = KP / 8 < 4 ? KP / 8 : 4;
  constexpr int NCH = KP / NQ;
  constexpr int NTC = NCH / 8;
  extern __shared__ __align__(16) float smem[];
  float* const rs = smem + L::R;
  float* const ks = smem + L::Kk;
  float* const cs = smem + L::C;
  float* const vs = smem + L::V;
  float* const dys = smem + L::DY;
  float* const hs = smem + L::Hh;
  float* const gs = smem + L::G;
  float* const as = smem + L::A;
  float* const atot = smem + L::ATOT;
  float* const btot = smem + L::BTOT;
  float* const dsnap = smem + L::DSNAP;
  float* const das = smem + L::DA;
  float* const us = smem + L::U;
  float* const es = smem + L::E;
  float* const dus = smem + L::DU;
  uint64_t* const lives = reinterpret_cast<uint64_t*>(smem + L::LIVE);
  // the diagonal sub-blocks' parts of dR and dK (then a + rho and b +
  // kappa), and dlw's rectangle inside them
  float* const rd =
      L::kWorkInSmem ? smem + L::RD : a.work + (int64_t)blockIdx.x * L::work;
  float* const kd = rd + kQ * LK;
  float* const dg = rd + 2 * kQ * LK;
  const float* const ce = cs + kQ * LK;  // c_end
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / kWarps, gw = warp % kWarps, gtid = tid % kThreads;
  const int K = a.K;
  // warp gw of a group: row (or key) tile rt, half hf of the columns
  const int rt = gw % kRowTiles, hf = gw / kRowTiles;
  const int r0 = kSub * rt;
  const int slice = 2 * hf + grp, n0 = slice * NCH;

  // an item's operands in two sets of copies, each group issuing its
  // share (gtid): v and dy (group 0) and h and G (group 1), which dV, the
  // diagonal sub-blocks and the column products of phase 2 read; then r,
  // k, lw and u (group 1), which phase 3 reads too.  Rows past S read as r
  // = k = v = dy = lw = 0.
  auto issue = [&](int i, bool state) {
    if (i < a.items) {
      const int ck = i % a.NC, rest = i / a.NC;
      const int stream = rest % a.BH, v0 = rest / a.BH * VT;
      const int bi = stream / a.H, hi = stream % a.H;
      const int t0 = ck * kQ, tn = min(kQ, a.S - t0);
      const int64_t so = ((int64_t)stream * a.NC + ck) * K * K;
      if (state && grp == 0) {
        stage_rows<VT, kThreads>(vs, LV, a.v, base(a.vs, bi, hi, t0),
                                 a.vs.st, tn, v0, K, a.vec, gtid);
        stage_rows<VT, kThreads>(dys, LV, a.dy, base(a.os, bi, hi, t0),
                                 a.os.st, tn, v0, K, a.vec, gtid);
      } else if (state) {
        stage_state<KP, VT, kThreads>(hs, LV, a.hst + so, K, v0, a.vec,
                                      gtid);
        stage_state<KP, VT, kThreads>(gs, LV, a.gst + so, K, v0, a.vec,
                                      gtid);
      } else if (grp == 1) {
        stage_rows<KP, kThreads>(cs + LK, LK, a.lw, base(a.ws, bi, hi, t0),
                                 a.ws.st, tn, 0, K, a.vec, gtid);
        cp_async_commit();
        stage_rows<KP, kThreads>(rs, LK, a.r, base(a.rs, bi, hi, t0),
                                 a.rs.st, tn, 0, K, a.vec, gtid);
        stage_rows<KP, kThreads>(ks, LK, a.k, base(a.ks, bi, hi, t0),
                                 a.ks.st, tn, 0, K, a.vec, gtid);
        const float* ub =
            a.u + (int64_t)bi * a.u_sb + (int64_t)hi * a.u_sh;
        for (int n = gtid; n < KP; n += kThreads)
          cp_async4(us + n, n < K ? ub + n : ub, n < K);
      }
    }
    cp_async_commit();
  };
  // group 1: once an item's lw has landed (its r, k and u may be in
  // flight), its cumsum and live masks into set ``par``
  auto cumsum = [&](int par) {
    cp_async_wait<1>();
    bar_sync(kBarGroup1, kThreads);
    chunk_cumsum_live<KP>(cs, LK, lives + par * KP, gtid, kThreads);
  };

  issue(blockIdx.x, true);
  issue(blockIdx.x, false);
  if (grp == 1 && (int)blockIdx.x < a.items) cumsum(0);
  int par = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < a.items;
       item += gridDim.x, par ^= 1) {
    const int ck = item % a.NC, rest = item / a.NC;
    const int stream = rest % a.BH, tile = rest / a.BH;
    const int bi = stream / a.H, hi = stream % a.H;
    const int v0 = tile * VT, t0 = ck * kQ, tn = min(kQ, a.S - t0);
    // dr, dk (which 0, 1) and dlw (2) of the item's row ``row``
    auto grad_row = [&](int which, int row) -> float* {
      if (a.NT == 1)
        return (which == 0 ? a.dr : which == 1 ? a.dk : a.dlw) +
               base(a.os, bi, hi, t0 + row);
      return a.part +
             ((((int64_t)tile * 3 + which) * a.BH + stream) * a.S + t0 +
              row) * K;
    };
    cp_async_wait<0>();
    __syncthreads();  // the operands and the cumsum in; the last dlw done

    // dV's K~ G (rows rt, half hf of the item's columns), group 0's in
    // phase 1 to even out the phases' work
    const int c0 = hf * (VT / 2);
    Tiles<NTV> kg;
    if (grp == 0) {
      // 1a. A's diagonal sub-blocks, as the forward builds them; K~ G over
      //     the state rows, in 64-deep stages
      scores_diag<KP, LK, LA>(rs, ks, cs, us, as, gw, lane);
      kg.zero();
#pragma unroll
      for (int k0s = 0; k0s < KP; k0s += kStageK) {
        Tiles<NTV> part;
        part.zero();
#pragma unroll 2
        for (int k0 = k0s; k0 < k0s + kStageK && k0 < KP; k0 += 8) {
          // K~[j][k] = k[j][k] exp(c_end[k] - c_j[k]); c_j is cs row j + 1
          const float* kp = ks + (r0 + g) * LK + k0 + t;
          const float* cp = cs + (r0 + g + 1) * LK + k0 + t;
          const float e0 = ce[k0 + t], e1 = ce[k0 + t + 4];
          uint32_t ab[4], sa[4], bf[NTV][4];
          split4(kp[0] * __expf(e0 - cp[0]),
                 kp[8 * LK] * __expf(e0 - cp[8 * LK]),
                 kp[4] * __expf(e1 - cp[4]),
                 kp[8 * LK + 4] * __expf(e1 - cp[8 * LK + 4]), ab, sa);
#pragma unroll
          for (int nt = 0; nt < NTV; ++nt)
            split_b(gs + (k0 + t) * LV + c0 + 8 * nt + g, 4 * LV, bf[nt]);
          part.mma3(ab, sa, bf);
        }
        kg.add(part);
      }
    } else {
      // 1b. dA = dY V^T, row tile rt against n8 key tiles hf (rt + 1) ..
      //     hf (rt + 1) + rt (its keys at or left of its diagonal, half to
      //     each warp of the pair); then A's blocks left of the diagonal
      const int kt0 = hf * (rt + 1), nk = rt + 1;
      Tiles<4> acc;
      acc.zero();
#pragma unroll 2
      for (int k0 = 0; k0 < VT; k0 += 8) {
        const float* dp = dys + (r0 + g) * LV + k0 + t;
        uint32_t ab[4], sa[4], bf[4][4];
        split4(dp[0], dp[8 * LV], dp[4], dp[8 * LV + 4], ab, sa);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < nk) split_b(vs + (8 * (kt0 + i) + g) * LV + k0 + t, 4, bf[i]);
        acc.mma3(ab, sa, bf, nk);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nk) {
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(das + (r0 + g + 8 * half) * LD +
                                       8 * (kt0 + i) + 2 * t) =
                make_float2(acc.c[i][2 * half], acc.c[i][2 * half + 1]);
        }
      }
      scores_left<KP, LK, LA>(rs, ks, cs, as, gw, lane);
      bar_arrive(kBarScores, kBwdThreads);  // A written
      bar_sync(kBarGroup1, kThreads);       // dA written
    }
    if (grp == 0) bar_sync(kBarScores, kBwdThreads);

    // the products over the item's columns on the warp's slice of the
    // channels, dY h^T (dR, rows rt) and V G^T (dK, keys rt): taken at the
    // end of phase 2, so that v, dy, h and G are free for the next item's
    // copies while phase 3 runs
    Tiles<NTC> ph, pg;
    auto column_products = [&]() {
      ph.zero();
      pg.zero();
      if (slice >= NQ) return;
#pragma unroll 2
      for (int k0 = 0; k0 < VT; k0 += 8) {
        uint32_t ab[4], sa[4], bf[NTC][4];
        const float* dp = dys + (r0 + g) * LV + k0 + t;
        split4(dp[0], dp[8 * LV], dp[4], dp[8 * LV + 4], ab, sa);
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt)
          split_b(hs + (n0 + 8 * nt + g) * LV + k0 + t, 4, bf[nt]);
        ph.mma3(ab, sa, bf);
        const float* vp = vs + (r0 + g) * LV + k0 + t;
        split4(vp[0], vp[8 * LV], vp[4], vp[8 * LV + 4], ab, sa);
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt)
          split_b(gs + (n0 + 8 * nt + g) * LV + k0 + t, 4, bf[nt]);
        pg.mma3(ab, sa, bf);
      }
    };
    if (grp == 0) {
      // 2a. dV = A^T dY + K~ G for rows rt and half hf of the columns
      Tiles<NTV> aa;   // A^T dY over the rows t >= r0
      aa.zero();
#pragma unroll 2
      for (int q0 = r0; q0 < kQ; q0 += 8) {
        const float* ap = as + (q0 + t) * LA + r0 + g;
        uint32_t ab[4], sa[4], bf[NTV][4];
        split4(ap[0], ap[8], ap[4 * LA], ap[4 * LA + 8], ab, sa);
#pragma unroll
        for (int nt = 0; nt < NTV; ++nt)
          split_b(dys + (q0 + t) * LV + c0 + 8 * nt + g, 4 * LV, bf[nt]);
        aa.mma3(ab, sa, bf);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row < tn) {
          float* o = a.dv + base(a.os, bi, hi, t0 + row);
#pragma unroll
          for (int nt = 0; nt < NTV; ++nt) {
            const int col = v0 + c0 + 8 * nt + 2 * t;
            const float d0 = aa.c[nt][2 * half] + kg.c[nt][2 * half];
            const float d1 = aa.c[nt][2 * half + 1] + kg.c[nt][2 * half + 1];
            if (a.vec) {
              if (col < K)
                *reinterpret_cast<float2*>(o + col) = make_float2(d0, d1);
            } else {
              if (col < K) o[col] = d0;
              if (col + 1 < K) o[col + 1] = d1;
            }
          }
        }
      }
      column_products();
    } else {
      // 2b. the diagonal sub-blocks' triangles per element, thread
      //     (sub-block b, channel n): T_tj = dA_tj r_t k_j exp(cx_t - c_j)
      //     for j < t in one 8-row half of b, into dR, dK and the
      //     rectangle sum_{t > s > j} T_tj; the bonus and du
#pragma unroll 1
      for (int idx = gtid; idx < 4 * KP; idx += kThreads) {
        const int b0 = kSub * (idx / KP), n = idx % KP;
        // cx of the sub-block's rows and c of its last: c_j = cx[j + 1]
        float rr[kSub], kv[kSub], cx[kSub + 1];
        float dr[kSub], dk[kSub], rect[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          rr[i] = rs[(b0 + i) * LK + n];
          kv[i] = ks[(b0 + i) * LK + n];
          cx[i] = cs[(b0 + i) * LK + n];
          dr[i] = dk[i] = rect[i] = 0.f;
        }
        cx[kSub] = cs[(b0 + kSub) * LK + n];
        const float un = us[n];
        float du = 0.f;
#pragma unroll
        for (int ti = 0; ti < kSub; ++ti) {
          const float* dap = das + (b0 + ti) * LD + b0;
          float pre = 0.f;  // sum_{j' <= j} T_{ti j'}
#pragma unroll
          for (int j = ti & ~(kTri - 1); j < ti; ++j) {
            const float de = dap[j] * __expf(cx[ti] - cx[j + 1]);
            dr[ti] = fmaf(de, kv[j], dr[ti]);
            dk[j] = fmaf(de, rr[ti], dk[j]);
            pre = fmaf(de * kv[j], rr[ti], pre);
            if (j + 1 < ti) rect[j + 1] += pre;
          }
          const float dd = dap[ti];
          dr[ti] = fmaf(dd * un, kv[ti], dr[ti]);
          dk[ti] = fmaf(dd * un, rr[ti], dk[ti]);
          du = fmaf(dd * rr[ti], kv[ti], du);
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          rd[(b0 + i) * LK + n] = dr[i];
          kd[(b0 + i) * LK + n] = dk[i];
          dg[(b0 + i) * LK + n] = rect[i];
        }
        dus[idx] = du;
      }
      // exp(c_end) rowsum(h . G) over the item's columns
      for (int n = gtid; n < KP; n += kThreads) {
        float s = 0.f;
#pragma unroll 4
        for (int c = 0; c < VT; ++c) s = fmaf(hs[n * LV + c], gs[n * LV + c], s);
        es[n] =
            n < K ? a.eend[((int64_t)stream * a.NC + ck) * K + n] * s : 0.f;
      }
      column_products();
    }
    __syncthreads();  // A, v, dy, h, G read no more: A's buffer takes
                      // dlw's sums, the others the next item's copies
    issue(item + gridDim.x, true);

    if (slice < NQ) {
      // 3a. dR of rows rt: dY h^T (phase 2's), then dA against
      //     the keys before the row tile through p = c_{r0 - 1} (cs row
      //     r0), and the diagonal parts; a + rho in place of the latter
      {
        const Tiles<NTC>& ah = ph;
        Tiles<NTC> al;
        al.zero();
        float pn[NTC];
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt)
          pn[nt] = cs[r0 * LK + n0 + 8 * nt + g];
#pragma unroll 1
        for (int j0 = 0; j0 < r0; j0 += 8) {
          const float* dp = das + (r0 + g) * LD + j0 + t;
          uint32_t ab[4], sa[4], bf[NTC][4];
          split4(dp[0], dp[8 * LD], dp[4], dp[8 * LD + 4], ab, sa);
#pragma unroll
          for (int nt = 0; nt < NTC; ++nt) {
            // k^[j][n] = k[j][n] exp(p[n] - c_j[n])
            const int o = (j0 + t) * LK + n0 + 8 * nt + g;
            split(ks[o] * __expf(pn[nt] - cs[o + LK]), bf[nt][0], bf[nt][1]);
            split(ks[o + 4 * LK] * __expf(pn[nt] - cs[o + 5 * LK]),
                  bf[nt][2], bf[nt][3]);
          }
          al.mma3(ab, sa, bf);
          // after the first 16 bs keys, bs < rt: the rows after sub-block
          // bs against the keys before it, for dlw's rectangle there
          if ((j0 & 15) == 8 && j0 + 8 < r0)
            rows_sum<NTC, LK>(al, rs, cs, r0, r0, n0,
                              dsnap + KP * (rt == 2 ? 0 : j0 == 8 ? 1 : 2),
                              lane);
        }
        // the diagonal sub-block's lower-left quadrant, its rows r0 + 8 ..
        // against its keys r0 .. r0 + 7 through q = c_{r0 + 7} (cs row r0
        // + 8); the MMA's rows g zero
        const float* qc = cs + (r0 + kTri) * LK;
        Tiles<NTC> aq;
        aq.zero();
        {
          const float* dp = das + (r0 + kTri + g) * LD + r0 + t;
          uint32_t ab[4], sa[4], bf[NTC][4];
          split4(0.f, dp[0], 0.f, dp[4], ab, sa);
#pragma unroll
          for (int nt = 0; nt < NTC; ++nt) {
            const int o = (r0 + t) * LK + n0 + 8 * nt + g;
            const float q = qc[n0 + 8 * nt + g];
            split(ks[o] * __expf(q - cs[o + LK]), bf[nt][0], bf[nt][1]);
            split(ks[o + 4 * LK] * __expf(q - cs[o + 5 * LK]), bf[nt][2],
                  bf[nt][3]);
          }
          aq.mma3(ab, sa, bf);
        }
        float xa[NTC][4];
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt) {
          const int col = n0 + 8 * nt + 2 * t;
          float out[4], rq[2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = (r0 + g + 8 * (e >> 1)) * LK + col + (e & 1);
            const float hp = __expf(cs[o]) * ah.c[nt][e];
            const float lp =
                rt ? __expf(cs[o] - cs[r0 * LK + col + (e & 1)]) * al.c[nt][e]
                   : 0.f;
            out[e] = hp + lp + rd[o];
            if (e >= 2) {
              const float qp = __expf(cs[o] - qc[col + (e & 1)]) * aq.c[nt][e];
              out[e] += qp;
              rq[e & 1] = rs[o] * qp;
            }
            xa[nt][e] = rs[o] * hp;          // (R~ . dY h^T)_t
            rd[o] = xa[nt][e] + rs[o] * lp;  // ... + rho_t
          }
          // the quadrant's part of the rectangle at rows s = r0 + 8 + g:
          // its rows after s, sum_{g' > g} r . dR_q of row g'
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = __shfl_down_sync(kFull, rq[i], 4);
            if (g == kTri - 1) v = 0.f;
#pragma unroll
            for (int d = 1; d < kTri; d *= 2) {
              const float w = __shfl_down_sync(kFull, v, 4 * d);
              if (g + d < kTri) v += w;
            }
            dg[(r0 + kTri + g) * LK + col + i] += v;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + g + 8 * half;
            if (row < tn) {
              float* o = grad_row(0, row);
              if (a.vec) {
                if (col < K)
                  *reinterpret_cast<float2*>(o + col) =
                      make_float2(out[2 * half], out[2 * half + 1]);
              } else {
                if (col < K) o[col] = out[2 * half];
                if (col + 1 < K) o[col + 1] = out[2 * half + 1];
              }
            }
          }
        }
        cols_sum<NTC>(xa, n0, atot + KP * rt, lane);
      }
      // 3b. dK of keys rt: V G^T (phase 2's), then dA^T against
      //     the rows after the key tile through p' = c_{r0 + 15} (cs row
      //     r0 + 16), and the diagonal parts; b + kappa in place of the
      //     latter
      {
        const int pr = r0 + kSub;
        const Tiles<NTC>& ag = pg;
        Tiles<NTC> ab2;
        ab2.zero();
        float qn[NTC];
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt)
          qn[nt] = cs[pr * LK + n0 + 8 * nt + g];
#pragma unroll 1
        for (int q0 = pr; q0 < kQ; q0 += 8) {
          const float* dp = das + (q0 + t) * LD + r0 + g;
          uint32_t ab[4], sa[4], bf[NTC][4];
          split4(dp[0], dp[8], dp[4 * LD], dp[4 * LD + 8], ab, sa);
#pragma unroll
          for (int nt = 0; nt < NTC; ++nt) {
            // r^[t][n] = r[t][n] exp(cx_t[n] - p'[n]); cx_t is cs row t
            const int o = (q0 + t) * LK + n0 + 8 * nt + g;
            split(rs[o] * __expf(cs[o] - qn[nt]), bf[nt][0], bf[nt][1]);
            split(rs[o + 4 * LK] * __expf(cs[o + 4 * LK] - qn[nt]),
                  bf[nt][2], bf[nt][3]);
          }
          ab2.mma3(ab, sa, bf);
        }
        // the diagonal sub-block's lower-left quadrant, its keys r0 .. r0
        // + 7 against its rows r0 + 8 .. through q = c_{r0 + 7} (cs row r0
        // + 8); the MMA's rows g + 8 zero
        const float* qc = cs + (r0 + kTri) * LK;
        Tiles<NTC> bq;
        bq.zero();
        {
          const float* dp = das + (r0 + kTri + t) * LD + r0 + g;
          uint32_t ab[4], sa[4], bf[NTC][4];
          split4(dp[0], 0.f, dp[4 * LD], 0.f, ab, sa);
#pragma unroll
          for (int nt = 0; nt < NTC; ++nt) {
            const int o = (r0 + kTri + t) * LK + n0 + 8 * nt + g;
            const float q = qc[n0 + 8 * nt + g];
            split(rs[o] * __expf(cs[o] - q), bf[nt][0], bf[nt][1]);
            split(rs[o + 4 * LK] * __expf(cs[o + 4 * LK] - q), bf[nt][2],
                  bf[nt][3]);
          }
          bq.mma3(ab, sa, bf);
        }
        float xb[NTC][4];
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt) {
          const int col = n0 + 8 * nt + 2 * t;
          float out[4], kq[2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = col + (e & 1);
            const int o = (r0 + g + 8 * (e >> 1)) * LK + n;
            const float gp = __expf(ce[n] - cs[o + LK]) * ag.c[nt][e];
            const float bp =
                rt < kRowTiles - 1
                    ? __expf(cs[pr * LK + n] - cs[o + LK]) * ab2.c[nt][e]
                    : 0.f;
            out[e] = gp + bp + kd[o];
            if (e < 2) {
              const float qp = __expf(qc[n] - cs[o + LK]) * bq.c[nt][e];
              out[e] += qp;
              kq[e] = ks[o] * qp;
            }
            xb[nt][e] = ks[o] * gp;          // (K~ . V G^T)_j
            kd[o] = xb[nt][e] + ks[o] * bp;  // ... + kappa_j
          }
          // the quadrant's part of the rectangle at rows s = r0 + g: its
          // keys before s, sum_{g' < g} k . dK_q of row g'
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = __shfl_up_sync(kFull, kq[i], 4);
            if (g == 0) v = 0.f;
#pragma unroll
            for (int d = 1; d < kTri; d *= 2) {
              const float w = __shfl_up_sync(kFull, v, 4 * d);
              if (g >= d) v += w;
            }
            dg[(r0 + g) * LK + col + i] += v;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + g + 8 * half;
            if (row < tn) {
              float* o = grad_row(1, row);
              if (a.vec) {
                if (col < K)
                  *reinterpret_cast<float2*>(o + col) =
                      make_float2(out[2 * half], out[2 * half + 1]);
              } else {
                if (col < K) o[col] = out[2 * half];
                if (col + 1 < K) o[col + 1] = out[2 * half + 1];
              }
            }
          }
        }
        cols_sum<NTC>(xb, n0, btot + KP * rt, lane);
      }
    }
    __syncthreads();  // r, k, c read no more
    if (grp == 1) {  // the next item's r, k, lw, u and its cumsum
      const int next = item + gridDim.x;
      issue(next, false);
      if (next < a.items) cumsum(par ^ 1);
      continue;
    }

    // 4. dlw, group 0, thread (sub-block b, channel n): within b the suffix of rd
    //    (a + rho) and the prefix of kd (b + kappa); the sub-blocks' sums
    //    of a after b and of b before it; the rows after b against the
    //    keys before it; exp(c_end) <h, G>; the pairs inside b
#pragma unroll 1
    for (int idx = gtid; idx < 4 * KP; idx += kThreads) {
      const int b = idx / KP, n = idx % KP, b0 = kSub * b;
      float rest_sum = es[n];
      for (int bb = b + 1; bb < kRowTiles; ++bb) rest_sum += atot[bb * KP + n];
      for (int bb = 0; bb < b; ++bb) rest_sum += btot[bb * KP + n];
      if (b == 1) rest_sum += dsnap[n] + dsnap[KP + n];
      if (b == 2) rest_sum += dsnap[2 * KP + n];
      float out[kSub];
      float run = 0.f;
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        out[i] = run;
        run += rd[(b0 + i) * LK + n];
      }
      run = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        out[i] += run;
        run += kd[(b0 + i) * LK + n];
      }
      const uint64_t live = lives[par * KP + n] >> b0;
      if (n < K) {
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          if (b0 + i < tn)
            grad_row(2, b0 + i)[n] =
                (live >> i) & 1 ? out[i] + rest_sum + dg[(b0 + i) * LK + n]
                                : 0.f;
        }
      }
    }
    for (int n = gtid; n < K && n < KP; n += kThreads)
      a.du_part[(int64_t)item * K + n] =
          dus[n] + dus[KP + n] + dus[2 * KP + n] + dus[3 * KP + n];
  }
}

// Kernel 3, the fixed-order sums: du over the chunks, tiles and the
// streams that share each row of u (u contiguous, nu rows of K); with
// more than one column tile, dr, dk and dlw over the tiles (in the
// gradients' layout).
__global__ void rwkv6_wkv_bwd_reduce_kernel(BwdArgs g) {
  const int64_t nrk = g.NT > 1 ? (int64_t)g.BH * g.S * g.K : 0;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t i = first; i < 3 * nrk; i += step) {
    const int which = (int)(i / nrk);
    const int64_t e = i % nrk;
    const int n = (int)(e % g.K);
    const int64_t st = e / g.K;
    const int t = (int)(st % g.S), stream = (int)(st / g.S);
    float s = 0.f;
    for (int tile = 0; tile < g.NT; ++tile)
      s += g.part[((int64_t)tile * 3 + which) * nrk + e];
    float* out = which == 0 ? g.dr : which == 1 ? g.dk : g.dlw;
    out[base(g.os, stream / g.H, stream % g.H, t) + n] = s;
  }
  // du: kDuLanes lanes an element, lane p summing the partials p, p +
  // kDuLanes, ... of its (stream, tile, chunk) sequence, the lanes' sums
  // then added by a fixed shuffle tree
  const int64_t ndu = (int64_t)g.nu * g.K * kDuLanes;
  const int64_t ndu_warps = (ndu + 31) / 32 * 32;  // whole warps
  for (int64_t i = first; i < ndu_warps; i += step) {
    const int64_t e = i / kDuLanes;
    const int lane_p = (int)(i % kDuLanes);
    float s = 0.f;
    if (i < ndu) {
      const int row = (int)(e / g.K), n = (int)(e % g.K);
      int c = 0;
      // the streams (bi, hi) with bi u_sb + hi u_sh = row K, in order
      for (int bi = 0; bi < g.BH / g.H; ++bi) {
        const int64_t rem = (int64_t)row * g.K - (int64_t)bi * g.u_sb;
        int h0 = 0, h1 = g.H;
        if (g.u_sh != 0) {
          if (rem < 0 || rem % g.u_sh != 0 || rem / g.u_sh >= g.H) continue;
          h0 = (int)(rem / g.u_sh);
          h1 = h0 + 1;
        } else if (rem != 0) {
          continue;
        }
        for (int hi = h0; hi < h1; ++hi)
          for (int tile = 0; tile < g.NT; ++tile)
            for (int ck = 0; ck < g.NC; ++ck, ++c)
              if (c % kDuLanes == lane_p)
                s += g.du_part[(((int64_t)tile * g.BH + bi * g.H + hi) *
                                    g.NC + ck) * g.K + n];
      }
    }
#pragma unroll
    for (int d = 1; d < kDuLanes; d *= 2) s += __shfl_xor_sync(kFull, s, d);
    if (i < ndu && lane_p == 0) g.du[e] = s;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <int KP>
cudaError_t launch_bwd(BwdArgs a, cudaStream_t stream) {
  constexpr int VT = BwdTile<KP>::VT;
  constexpr int VS = KP < 64 ? KP : 64;  // kernel 1's column tiles
  constexpr size_t sbytes = 2 * StateSmem<KP, VS>::bytes;
  constexpr size_t cbytes = BwdSmem<KP, VT>::bytes;
  // the dynamic shared-memory opt-ins and kernel 2's grid, once
  static int grid = 0;
  if (grid == 0) {
    cudaError_t err = opt_in(rwkv6_wkv_bwd_states_kernel<KP, VS>, sbytes);
    if (err == cudaSuccess)
      err = opt_in(rwkv6_wkv_bwd_chunk_kernel<KP, VT>, cbytes);
    if (err == cudaSuccess)
      err = resident(rwkv6_wkv_bwd_chunk_kernel<KP, VT>, cbytes, &grid,
                     kBwdThreads);
    if (err != cudaSuccess) {
      grid = 0;
      return err;
    }
    if (!BwdSmem<KP, VT>::kWorkInSmem)
      grid = min(grid, kWorkBlocksPerSm * sm_count());
  }
  rwkv6_wkv_bwd_states_kernel<KP, VS>
      <<<dim3(KP / VS, a.BH), kThreads, sbytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.items > 0) {
    rwkv6_wkv_bwd_chunk_kernel<KP, VT>
        <<<min(a.items, grid), kBwdThreads, cbytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t nrk = a.NT > 1 ? (int64_t)a.BH * a.S * a.K : 0;
  const int64_t ndu = (int64_t)a.nu * a.K * kDuLanes;
  const int64_t want = ((3 * nrk > ndu ? 3 * nrk : ndu) + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  rwkv6_wkv_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

int bwd_kp(int K) { return K <= 16 ? 16 : K <= 32 ? 32 : K <= 64 ? 64 : 128; }

int bwd_vt(int K) { return bwd_kp(K) <= 64 ? bwd_kp(K) : BwdTile<128>::VT; }

long long round4(long long n) { return (n + 3) / 4 * 4; }

// The backward's scratch, in floats, part by part (each a multiple of 4
// floats, so every part starts on 16 bytes): G of every chunk, du's
// partials per item, dr/dk/dlw's partials per column tile (K > 64), the
// global work areas (K > 64).
struct BwdScratch {
  long long gst, du_part, part, work;
};

BwdScratch bwd_scratch(int B, int H, int S, int K) {
  const long long bh = (long long)B * H, nc = n_chunks(S);
  const long long nt = (K + bwd_vt(K) - 1) / bwd_vt(K);
  BwdScratch s;
  s.gst = round4(bh * nc * K * K);
  s.du_part = round4(bh * nc * nt * K);
  s.part = nt > 1 ? round4(3 * nt * bh * S * K) : 0;
  s.work = bwd_kp(K) > 64 ? (long long)kWorkBlocksPerSm * sm_count() *
                                BwdSmem<128, BwdTile<128>::VT>::work
                          : 0;
  return s;
}

}  // namespace

extern "C" {

// The scratch one call needs, in floats: a K x K update and K decays per
// (stream, chunk of 64 steps).
long long rwkv6_wkv_scratch_floats(int B, int H, int S, int K) {
  if (B < 1 || H < 1 || S < 0 || K < 1) return 0;
  return (long long)B * H * n_chunks(S) * ((long long)K * K + K);
}

// fp32 throughout.  r, k, v, lw and y each have (batch, head, time)
// strides (the channel stride is 1); u has (batch, head) strides (a batch
// stride of 0 shares u across the batch rows).  lw <= 0 (a positive lw is
// read as 0).  h0 may be null (a zero initial state); h0 and hout are
// [B*H, K, K] contiguous.  scratch holds rwkv6_wkv_scratch_floats(...)
// floats, 16-byte aligned.  K <= 128, B * H <= 65535.  Returns a
// cudaError_t: cudaErrorInvalidValue for shapes the kernel does not take,
// else the launches' cudaGetLastError().
int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* h0, void* y,
                  void* hout, void* scratch, int B, int H, int S, int K,
                  int r_sb, int r_sh, int r_st, int k_sb, int k_sh, int k_st,
                  int v_sb, int v_sh, int v_st, int w_sb, int w_sh, int w_st,
                  int y_sb, int y_sh, int y_st, int u_sb, int u_sh,
                  void* stream) {
  if (B < 0 || H < 1 || S < 0 || K < 1 || K > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535 || n_chunks(S) * B * H * 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (S > 0 && (scratch == nullptr || !aligned16(scratch)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lw = static_cast<const float*>(lw);
  a.u = static_cast<const float*>(u);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.hout = static_cast<float*>(hout);
  a.H = H;
  a.S = S;
  a.K = K;
  a.NC = (int)n_chunks(S);
  a.dstate = static_cast<float*>(scratch);
  a.eend = a.dstate + (long long)B * H * a.NC * K * K;
  a.rs = {r_sb, r_sh, r_st};
  a.ks = {k_sb, k_sh, k_st};
  a.vs = {v_sb, v_sh, v_st};
  a.ws = {w_sb, w_sh, w_st};
  a.ys = {y_sb, y_sh, y_st};
  a.u_sb = u_sb;
  a.u_sh = u_sh;
  // 16-byte copies of r, k, v, lw and the chunk states, and 8-byte stores
  // of y and the updates, need every row start on 16 bytes
  bool vec = K % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(v) &&
             aligned16(lw) && aligned16(y);
  const int strides[] = {r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh,
                         v_st, w_sb, w_sh, w_st, y_sb, y_sh, y_st};
  for (int s : strides) vec = vec && s % 4 == 0;
  a.vec = vec;
  a.BH = B * H;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (K <= 16)
    err = launch<16>(a, cs);
  else if (K <= 32)
    err = launch<32>(a, cs);
  else if (K <= 64)
    err = launch<64>(a, cs);
  else
    err = launch<128>(a, cs);
  return (int)err;
}

// The scratch one backward call needs, in floats: G at the end of every
// chunk (K x K per stream and chunk of 64 steps), du's partials per
// (stream, chunk, column tile), and for K > 64 the partials of dr, dk and
// dlw per column tile of 32 and the main kernel's global work areas.
long long rwkv6_wkv_bwd_scratch_floats(int B, int H, int S, int K) {
  if (B < 1 || H < 1 || S < 0 || K < 1 || K > 128) return 0;
  const BwdScratch s = bwd_scratch(B, H, S, K);
  return s.gst + s.du_part + s.part + s.work;
}

// The backward of rwkv6_wkv_fwd, fp32 throughout.  r, k, v, lw and u as
// the forward took them; fwd_scratch is the forward call's scratch, as it
// left it (each chunk's starting state and exp(c_end)); dy and the
// gradients dr, dk, dv and dlw share the (batch, head, time) strides
// o_sb/o_sh/o_st (the channel stride is 1); dh_final may be null (zero);
// dh0 is written when it is not null; du is u's shape, contiguous, nu rows
// of K (u contiguous with row stride K).  scratch holds
// rwkv6_wkv_bwd_scratch_floats(...) floats, 16-byte aligned.  Returns a
// cudaError_t as rwkv6_wkv_fwd does.
int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* fwd_scratch,
                  const void* dy, const void* dh_final, void* dr, void* dk,
                  void* dv, void* dlw, void* du, void* dh0, void* scratch,
                  int B, int H, int S, int K, int r_sb, int r_sh, int r_st,
                  int k_sb, int k_sh, int k_st, int v_sb, int v_sh, int v_st,
                  int w_sb, int w_sh, int w_st, int o_sb, int o_sh, int o_st,
                  int u_sb, int u_sh, int nu, void* stream) {
  if (B < 0 || H < 1 || S < 0 || K < 1 || K > 128 || nu < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535 || n_chunks(S) * B * H * 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (scratch == nullptr || !aligned16(scratch) ||
      (S > 0 && (fwd_scratch == nullptr || !aligned16(fwd_scratch))))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lw = static_cast<const float*>(lw);
  a.u = static_cast<const float*>(u);
  a.dy = static_cast<const float*>(dy);
  a.dhf = static_cast<const float*>(dh_final);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dlw = static_cast<float*>(dlw);
  a.du = static_cast<float*>(du);
  a.dh0 = static_cast<float*>(dh0);
  a.H = H;
  a.S = S;
  a.K = K;
  a.NC = (int)n_chunks(S);
  a.NT = (K + bwd_vt(K) - 1) / bwd_vt(K);
  a.nu = nu;
  a.BH = B * H;
  a.items = a.NC * a.BH * a.NT;
  a.rs = {r_sb, r_sh, r_st};
  a.ks = {k_sb, k_sh, k_st};
  a.vs = {v_sb, v_sh, v_st};
  a.ws = {w_sb, w_sh, w_st};
  a.os = {o_sb, o_sh, o_st};
  a.u_sb = u_sb;
  a.u_sh = u_sh;
  // the forward's scratch as rwkv6_wkv_fwd lays it out
  a.hst = static_cast<const float*>(fwd_scratch);
  a.eend = a.hst + (long long)a.BH * a.NC * K * K;
  const BwdScratch s = bwd_scratch(B, H, S, K);
  a.gst = static_cast<float*>(scratch);
  a.du_part = a.gst + s.gst;
  a.part = a.du_part + s.du_part;
  a.work = a.part + s.part;
  // 16-byte copies of the operands and the states, and 8-byte stores of
  // the gradients, need every row start on 16 bytes
  bool vec = K % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(v) &&
             aligned16(lw) && aligned16(dy) && aligned16(dr) &&
             aligned16(dk) && aligned16(dv) && aligned16(dlw);
  const int strides[] = {r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh,
                         v_st, w_sb, w_sh, w_st, o_sb, o_sh, o_st};
  for (int st : strides) vec = vec && st % 4 == 0;
  a.vec = vec;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (bwd_kp(K)) {
    case 16: return (int)launch_bwd<16>(a, cs);
    case 32: return (int)launch_bwd<32>(a, cs);
    case 64: return (int)launch_bwd<64>(a, cs);
    default: return (int)launch_bwd<128>(a, cs);
  }
}

const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
