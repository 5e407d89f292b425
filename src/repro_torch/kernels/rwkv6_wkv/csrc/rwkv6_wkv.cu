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
// ld), zero-filled past row tn and column K.
template <int NCOL>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int64_t off,
                                           int st, int tn, int c0, int K,
                                           int vec, int tid) {
  if (vec) {
    constexpr int NQ = NCOL / 4;
#pragma unroll 1
    for (int idx = tid; idx < kQ * NQ; idx += kThreads) {
      const int r = idx / NQ, c = 4 * (idx % NQ);
      const bool in = r < tn && c0 + c < K;
      cp_async16(dst + r * ld + c,
                 in ? src + off + (int64_t)r * st + c0 + c : src, in);
    }
  } else {
#pragma unroll 1
    for (int idx = tid; idx < kQ * NCOL; idx += kThreads) {
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
cudaError_t resident(Kernel kernel, size_t bytes, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
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
// null: zero), it computes dr, dk, dv, dlw, du and (when h0 was given)
// dh0 of the recurrence above, with w_t = exp(min(lw_t, 0)) and g_t =
// dL/dS_t walked backwards:
//   dr_t    = S_{t-1} dy_t + u k_t (v_t . dy_t)
//   dk_t    = g_t v_t + r_t u (v_t . dy_t)
//   dv_t    = g_t^T k_t + dy_t (r_t . u k_t)
//   dlw_t   = w_t rowsum(g_t . S_{t-1})   (0 where lw_t > 0: the min)
//   du      = sum_t r_t k_t (v_t . dy_t)
//   g_{t-1} = diag(w_t) g_t + r_t dy_t^T   (g_{S-1} = dh_final), dh0 = g_{-1}
// (ref.py's rwkv6_wkv_bwd_ref is the same algorithm in plain PyTorch).
//
// The states are recomputed, never stepped backwards through a decay
// (which would divide by w and let an exponent grow): one block owns one
// stream and kBwdCols = 32 state columns v (a lane each; warp w holds
// rows k = w, w + 8, ...), sweeps forward once keeping the state at the
// start of every chunk of Q steps in a scratch of its own, then walks the
// chunks backwards: it recomputes a chunk's states from its start into
// shared memory, walks the chunk's steps backwards with g in registers
// (neither needs a sum across threads), and only then takes the chunk's
// sums from shared memory, each in a fixed order: dv per step and column
// (a warp per step), dr, dk and dlw per step and row over the block's
// columns.  Sums across the blocks of a stream (its column tiles) and
// across the streams that share u (the batch rows) are per-block partials
// that rwkv6_wkv_bwd_reduce_kernel adds in a fixed order, so two calls
// give the same bits: there are no float atomics.
//
// fp32 on the CUDA cores.  What bounds it: at rwkv6-7b's training shape
// (B = 4, H = 64, S = 1024, K = 64) the recurrence and its sums are ~12
// flops per state element and step, 12.9 GFLOP, 0.19 ms at 67 TFLOP/s;
// the bytes, ~0.8 GB with the scratch of chunk states, 0.24 ms.  The
// design spends neither well: one block of 8 warps per SM with a barrier
// per chunk of 8 steps, so latency bounds it.

namespace {

constexpr int kBwdQ = 8;        // steps per chunk (4 for a state of 128 rows)
constexpr int kBwdCols = 32;    // state columns per block: one per lane
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;

struct BwdArgs {
  const float *r, *k, *v, *lw, *u, *h0, *dy, *dhf;
  float *dr, *dk, *dv, *dlw, *du, *dh0;
  float *starts, *dr_part, *dk_part, *dlw_part, *du_part;  // scratch
  int B, H, S, K, NC, NT, nu;
  Strides rs, ks, vs, ws, os;   // os: dy and the [.., S, .., K] gradients
  int u_sb, u_sh;
};

// The chunk length of the backward for KP padded rows: a chunk's Q states
// and Q g's live in shared memory.
template <int KP>
struct BwdSmem {
  static constexpr int Q = KP <= 64 ? kBwdQ : kBwdQ / 2;
  static constexpr int LC = kBwdCols + 1;           // row stride: no conflicts
  static constexpr int G = 0;                       // [Q][KP][LC] g_t
  static constexpr int HS = G + Q * KP * LC;        // [Q][KP][LC] S_{t-1}
  static constexpr int V = HS + Q * KP * LC;        // [Q][32] v
  static constexpr int DY = V + Q * kBwdCols;       // [Q][32] dy
  static constexpr int R = DY + Q * kBwdCols;       // [Q][KP] r
  static constexpr int Kk = R + Q * KP;             // [Q][KP] k
  static constexpr int W = Kk + Q * KP;             // [Q][KP] w
  static constexpr int LIVE = W + Q * KP;           // [Q][KP] lw <= 0
  static constexpr int U = LIVE + Q * KP;           // [KP] u
  static constexpr int VDY = U + KP;                // [Q] v . dy (the tile)
  static constexpr int RUK = VDY + Q;               // [Q] r . u k (all rows)
  static constexpr size_t bytes = (RUK + Q) * sizeof(float);
};

__device__ __forceinline__ int64_t at(const Strides& s, int bi, int hi,
                                      int t) {
  return (int64_t)bi * s.sb + (int64_t)hi * s.sh + (int64_t)t * s.st;
}

template <int KP>
__global__ void __launch_bounds__(kBwdThreads, 1)
    rwkv6_wkv_bwd_chunk_kernel(BwdArgs g) {
  using L = BwdSmem<KP>;
  constexpr int Q = L::Q, LC = L::LC, R = KP / kBwdWarps;
  extern __shared__ __align__(16) float smem[];
  float* const gs = smem + L::G;
  float* const hs = smem + L::HS;
  float* const vs = smem + L::V;
  float* const dys = smem + L::DY;
  float* const rs = smem + L::R;
  float* const ks = smem + L::Kk;
  float* const wsm = smem + L::W;
  float* const lives = smem + L::LIVE;
  float* const us = smem + L::U;
  float* const vdys = smem + L::VDY;
  float* const ruks = smem + L::RUK;

  const int stream = blockIdx.y, tile = blockIdx.x;
  const int bi = stream / g.H, hi = stream % g.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tile * kBwdCols + lane;
  const bool cin = col < g.K;
  const int S = g.S, K = g.K;
  const int blk = stream * g.NT + tile;
  float* const starts = g.starts + (int64_t)blk * g.NC * KP * kBwdCols;

  for (int i = tid; i < KP; i += kBwdThreads)
    us[i] = i < K ? g.u[(int64_t)bi * g.u_sb + (int64_t)hi * g.u_sh + i]
                  : 0.f;

  // chunk ck's operands into shared memory; rows past S read as r = k =
  // v = dy = 0 and lw = 0 (w = 1)
  auto stage = [&](int ck, bool with_grads) {
    const int t0 = ck * Q;
    for (int i = tid; i < Q * kBwdCols; i += kBwdThreads) {
      const int j = i / kBwdCols, c = tile * kBwdCols + i % kBwdCols;
      const bool in = t0 + j < S && c < K;
      vs[i] = in ? g.v[at(g.vs, bi, hi, t0 + j) + c] : 0.f;
      if (with_grads) dys[i] = in ? g.dy[at(g.os, bi, hi, t0 + j) + c] : 0.f;
    }
    for (int i = tid; i < Q * KP; i += kBwdThreads) {
      const int j = i / KP, n = i % KP;
      const bool in = t0 + j < S && n < K;
      const float lw = in ? g.lw[at(g.ws, bi, hi, t0 + j) + n] : 0.f;
      ks[i] = in ? g.k[at(g.ks, bi, hi, t0 + j) + n] : 0.f;
      wsm[i] = expf(fminf(lw, 0.f));
      if (with_grads) {
        rs[i] = in ? g.r[at(g.rs, bi, hi, t0 + j) + n] : 0.f;
        lives[i] = lw <= 0.f ? 1.f : 0.f;
      }
    }
  };

  // 1. forward: the state at the start of every chunk, into the scratch
  float h[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = warp + kBwdWarps * i;
    h[i] = (g.h0 != nullptr && cin && n < K)
               ? g.h0[((int64_t)stream * K + n) * K + col]
               : 0.f;
  }
#pragma unroll 1
  for (int ck = 0; ck < g.NC; ++ck) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      starts[((int64_t)ck * KP + warp + kBwdWarps * i) * kBwdCols + lane] =
          h[i];
    stage(ck, false);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < Q; ++j) {
      const float vv = vs[j * kBwdCols + lane];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = warp + kBwdWarps * i;
        h[i] = fmaf(wsm[j * KP + n], h[i], ks[j * KP + n] * vv);
      }
    }
    __syncthreads();
  }

  // 2. backward, chunk by chunk from the last
  float gr[R];   // g_t = dL/dS_t for the step about to be walked
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = warp + kBwdWarps * i;
    gr[i] = (g.dhf != nullptr && cin && n < K)
                ? g.dhf[((int64_t)stream * K + n) * K + col]
                : 0.f;
  }
  float du_acc = 0.f;   // thread n < K: du's partial for row n
#pragma unroll 1
  for (int ck = g.NC - 1; ck >= 0; --ck) {
    const int t0 = ck * Q;
    stage(ck, true);
    __syncthreads();
    // the per-step sums the others need: v . dy over the block's columns
    // (warp j) and r . u k over every row (warp j too)
    for (int j = warp; j < Q; j += kBwdWarps) {
      float vd = vs[j * kBwdCols + lane] * dys[j * kBwdCols + lane];
      float ruk = 0.f;
      for (int n = lane; n < KP; n += 32)
        ruk = fmaf(rs[j * KP + n] * us[n], ks[j * KP + n], ruk);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vd += __shfl_xor_sync(kFull, vd, off);
        ruk += __shfl_xor_sync(kFull, ruk, off);
      }
      if (lane == 0) {
        vdys[j] = vd;
        ruks[j] = ruk;
      }
    }
    // the chunk's states S_{t0-1} .. S_{t0+Q-2}, recomputed from its start
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int n = warp + kBwdWarps * i;
      h[i] = starts[((int64_t)ck * KP + n) * kBwdCols + lane];
      hs[n * LC + lane] = h[i];
    }
#pragma unroll 1
    for (int j = 0; j + 1 < Q; ++j) {
      const float vv = vs[j * kBwdCols + lane];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = warp + kBwdWarps * i;
        h[i] = fmaf(wsm[j * KP + n], h[i], ks[j * KP + n] * vv);
        hs[((j + 1) * KP + n) * LC + lane] = h[i];
      }
    }
    // g_t for the chunk's steps, last first
#pragma unroll 1
    for (int j = Q - 1; j >= 0; --j) {
      const float dyv = dys[j * kBwdCols + lane];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = warp + kBwdWarps * i;
        gs[(j * KP + n) * LC + lane] = gr[i];
        gr[i] = fmaf(wsm[j * KP + n], gr[i], rs[j * KP + n] * dyv);
      }
    }
    __syncthreads();
    // per step (a warp each) and column (a lane each): dv, complete
    for (int j = warp; j < Q; j += kBwdWarps) {
      float dv = 0.f;
#pragma unroll 4
      for (int n = 0; n < KP; ++n)
        dv = fmaf(ks[j * KP + n], gs[(j * KP + n) * LC + lane], dv);
      const int t = t0 + j;
      if (t < S && cin)
        g.dv[at(g.os, bi, hi, t) + col] =
            fmaf(dys[j * kBwdCols + lane], ruks[j], dv);
    }
    // per step and row over the block's columns: dr, dk and dlw
    for (int i = tid; i < Q * KP; i += kBwdThreads) {
      const int j = i / KP, n = i % KP, t = t0 + j;
      if (t >= S || n >= K) continue;
      const float* gp = gs + (j * KP + n) * LC;
      const float* hp = hs + (j * KP + n) * LC;
      float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll 8
      for (int c = 0; c < kBwdCols; ++c) {
        dr = fmaf(hp[c], dys[j * kBwdCols + c], dr);
        dk = fmaf(gp[c], vs[j * kBwdCols + c], dk);
        dw = fmaf(gp[c], hp[c], dw);
      }
      const float uvd = us[n] * vdys[j];
      const int64_t o = ((int64_t)blk * S + t) * K + n;
      g.dr_part[o] = fmaf(uvd, ks[i], dr);
      g.dk_part[o] = fmaf(uvd, rs[i], dk);
      g.dlw_part[o] = wsm[i] * dw * lives[i];
    }
    if (tid < K) {
#pragma unroll 1
      for (int j = Q - 1; j >= 0; --j)
        du_acc = fmaf(rs[j * KP + tid] * ks[j * KP + tid], vdys[j], du_acc);
    }
    __syncthreads();
  }
  if (g.dh0 != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int n = warp + kBwdWarps * i;
      if (cin && n < K) g.dh0[((int64_t)stream * K + n) * K + col] = gr[i];
    }
  }
  if (tid < K) g.du_part[(int64_t)blk * K + tid] = du_acc;
}

// The fixed-order sums: dr, dk and dlw over the column tiles (in the
// gradients' layout), du over the tiles and the streams that share each
// row of u (u contiguous, nu rows of K).
__global__ void rwkv6_wkv_bwd_reduce_kernel(BwdArgs g) {
  const int64_t nrk = (int64_t)g.B * g.H * g.S * g.K;
  const int64_t total = nrk + (int64_t)g.nu * g.K;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i < nrk) {
      const int n = (int)(i % g.K);
      const int64_t st = i / g.K;
      const int t = (int)(st % g.S), stream = (int)(st / g.S);
      float dr = 0.f, dk = 0.f, dw = 0.f;
      for (int tile = 0; tile < g.NT; ++tile) {
        const int64_t o =
            (((int64_t)stream * g.NT + tile) * g.S + t) * g.K + n;
        dr += g.dr_part[o];
        dk += g.dk_part[o];
        dw += g.dlw_part[o];
      }
      const int64_t o = at(g.os, stream / g.H, stream % g.H, t) + n;
      g.dr[o] = dr;
      g.dk[o] = dk;
      g.dlw[o] = dw;
    } else {
      const int64_t e = i - nrk;
      const int row = (int)(e / g.K), n = (int)(e % g.K);
      float s = 0.f;
      for (int stream = 0; stream < g.B * g.H; ++stream) {
        const int bi = stream / g.H, hi = stream % g.H;
        if ((int64_t)bi * g.u_sb + (int64_t)hi * g.u_sh != (int64_t)row * g.K)
          continue;
        for (int tile = 0; tile < g.NT; ++tile)
          s += g.du_part[((int64_t)stream * g.NT + tile) * g.K + n];
      }
      g.du[e] = s;
    }
  }
}

template <int KP>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = BwdSmem<KP>::bytes;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_wkv_bwd_chunk_kernel<KP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(a.NT, a.B * a.H);
  rwkv6_wkv_bwd_chunk_kernel<KP><<<grid, kBwdThreads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)a.B * a.H * a.S * a.K + (int64_t)a.nu * a.K;
  const int64_t want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  rwkv6_wkv_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

int bwd_kp(int K) { return K <= 16 ? 16 : K <= 32 ? 32 : K <= 64 ? 64 : 128; }

int bwd_q(int K) { return bwd_kp(K) <= 64 ? kBwdQ : kBwdQ / 2; }

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

// The scratch one backward call needs, in floats: per (stream, column
// tile of 32) the state at the start of every chunk of the backward,
// partials of dr, dk and dlw per step and row, and of du per row.
long long rwkv6_wkv_bwd_scratch_floats(int B, int H, int S, int K) {
  if (B < 1 || H < 1 || S < 0 || K < 1 || K > 128) return 0;
  const long long nt = (K + kBwdCols - 1) / kBwdCols, q = bwd_q(K);
  const long long nc = (S + q - 1) / q;
  return (long long)B * H * nt *
         (nc * bwd_kp(K) * kBwdCols + 3LL * S * K + K);
}

// The backward of rwkv6_wkv_fwd, fp32 throughout.  r, k, v, lw, u and h0
// as the forward took them (h0 may be null); dy and the gradients dr, dk,
// dv and dlw share the (batch, head, time) strides o_sb/o_sh/o_st (the
// channel stride is 1); dh_final may be null (zero); dh0 is written when
// it is not null; du is u's shape, contiguous, nu rows of K (u contiguous
// with row stride K).  scratch holds rwkv6_wkv_bwd_scratch_floats(...)
// floats.  Returns a cudaError_t as rwkv6_wkv_fwd does.
int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* h0,
                  const void* dy, const void* dh_final, void* dr, void* dk,
                  void* dv, void* dlw, void* du, void* dh0, void* scratch,
                  int B, int H, int S, int K, int r_sb, int r_sh, int r_st,
                  int k_sb, int k_sh, int k_st, int v_sb, int v_sh, int v_st,
                  int w_sb, int w_sh, int w_st, int o_sb, int o_sh, int o_st,
                  int u_sb, int u_sh, int nu, void* stream) {
  if (B < 0 || H < 1 || S < 0 || K < 1 || K > 128 || nu < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lw = static_cast<const float*>(lw);
  a.u = static_cast<const float*>(u);
  a.h0 = static_cast<const float*>(h0);
  a.dy = static_cast<const float*>(dy);
  a.dhf = static_cast<const float*>(dh_final);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dlw = static_cast<float*>(dlw);
  a.du = static_cast<float*>(du);
  a.dh0 = static_cast<float*>(dh0);
  a.B = B;
  a.H = H;
  a.S = S;
  a.K = K;
  a.NT = (K + kBwdCols - 1) / kBwdCols;
  a.NC = (S + bwd_q(K) - 1) / bwd_q(K);
  a.nu = nu;
  a.rs = {r_sb, r_sh, r_st};
  a.ks = {k_sb, k_sh, k_st};
  a.vs = {v_sb, v_sh, v_st};
  a.ws = {w_sb, w_sh, w_st};
  a.os = {o_sb, o_sh, o_st};
  a.u_sb = u_sb;
  a.u_sh = u_sh;
  const long long bh = (long long)B * H;
  a.starts = static_cast<float*>(scratch);
  a.dr_part = a.starts + bh * a.NT * a.NC * bwd_kp(K) * kBwdCols;
  a.dk_part = a.dr_part + bh * a.NT * S * K;
  a.dlw_part = a.dk_part + bh * a.NT * S * K;
  a.du_part = a.dlw_part + bh * a.NT * S * K;
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
