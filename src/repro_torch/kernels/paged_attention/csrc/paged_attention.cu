// Paged decode attention for NVIDIA Hopper (sm_90a): fp32, int8 and
// fp8_e4m3 pools.
//
// Replaces repro/kernels/paged_attention/kernel.py::paged_decode_attention
// (the Pallas TPU kernel, both its fp32 and its quantized=True branch).
// 1..S query rows per slot attend to the slot's block-paged KV ring, read
// in place through the page table:
//   q          [B, S, H, dh]               fp32
//   pool_k/v   [num_pages + 1, P, Hkv, dh] fp32, int8 or fp8_e4m3
//                                          (last row = trash page)
//   k/v_scale  [num_pages + 1, Hkv]        fp32, 8-bit pools only
//   page_table [B, nb] int32, cache_len [B] int32 (incl. the newest query)
//   out        [B, S, H, dh]               fp32
// Requires dh % 4 == 0, dh <= 256, P a power of two <= 64.
//
// Rows: a kv head's S*G query rows (G = H / Hkv) are grouped [S, G] as in
// the Pallas kernel (row i is query i / G, head kh * G + i % G), so GQA
// needs no KV repeat, and cut into tiles of 64.
// Mask: t = cache_len[b] - 1; row i sits at qpos = t - (S - 1) + i / G;
// ring offset r holds token u = t - floormod(t - r, R), R = nb * P (C's %
// truncates: ((x % R) + R) % R).  Valid iff u >= 0 && u <= qpos, and
// u > qpos - window with a window.  A page whose id is the trash id, or on
// which no row of the tile has a valid position, is skipped.
// 8-bit pools: the K page scale multiplies the score after the 1/sqrt(dh)
// scale and before the softcap; the V page scale multiplies the weights in
// the PV product only, never the denominator l.  No page is dequantized in
// memory.
//
// What bounds it on this card.  The bytes are the live pages at stored
// width (sum_b live_pages_b * P * Hkv * dh * e * 2, e = 4 or 1, + two
// scales per 8-bit page) plus q and out; the work is 4 * dh flops per
// (query head, row, valid position).  At S = 1 decode that is far below
// the ops:byte ridge: bytes bound it.  At the fused chunk's S = 32 (64 rows
// per kv head) fp32 FMAs on the CUDA cores would take longer than the
// bytes (0.0144 against 0.0107 ms at internlm2's shape), so the products go
// to the tensor cores as 3xTF32 (2 products for 8-bit pools, whose codes
// are exact in TF32; common/tf32_mma.cuh), which puts the bound back on the
// bytes.  The first version of this kernel walked a slot's whole page table
// in one block (64 blocks at the main shape, each a serial chain of up to
// 64 unoverlapped page loads) and left 7 of 8 warps idle at S = 1.  This
// design:
//   - splits the ring across blocks (flash-decoding): grid (B, Hkv *
//     row_tiles, n_splits), n_splits = ceil(nb * P / 128), each block 128
//     ring positions (8 pages at P = 16);
//   - stages each 32-position step of K and V with cp.async (16-byte units;
//     4-byte units for 8-bit rows whose width is not a multiple of 16
//     bytes) into a 2-stage ring, so the next step's loads overlap this
//     step's math; a skipped page is zero-filled without a read, a step
//     whose pages are all skipped is neither loaded nor computed, a block
//     with no live page reads no q and exits;
//   - S*G >= 16 rows (the tile path, paged_attention_tile_kernel): 4 warps
//     x 16 rows, scores and PV on m16n8k8 TF32 tensor cores with the
//     weights kept in registers;
//   - S*G < 16 rows (the GEMV path, paged_attention_gemv_kernel, bytes-
//     bound): fp32 CUDA cores, each warp on its 8 positions of every step
//     (4 lanes per position for the scores, then lanes across head dims
//     for PV) with its own online softmax, so a step has no barrier
//     between phases; the 4 warps' partials merge once at the end.
// A block writes its partial (running max m, denominator l, unnormalised
// acc) to fp32 scratch (sized by paged_attention_scratch_floats, allocated
// by the caller); paged_attention_combine_kernel (a second launch,
// one warp per row) merges the splits with the log-sum-exp rule.  One
// call is one kernel when n_splits == 1 (the block writes out directly)
// and two otherwise.  A split with no valid position for a row writes
// l = 0 and no acc; the combine skips it, so a row with no valid position
// anywhere comes out 0 / max(0, 1e-30) = 0 exactly.  The running max
// starts at -1e30 and masked scores never raise it.  Scores are kept in
// base 2 (x log2 e, after the softcap) so every exponential is one exp2f.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;   // rows per block on the tile path
constexpr int kStep = 32;       // ring positions per pipeline step
constexpr int kSplit = 128;     // ring positions per block
constexpr int kSteps = kSplit / kStep;
constexpr int kGemvRows = 16;   // S*G below this: the GEMV path
constexpr int kStages = 2;      // K/V ring depth
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPageSize = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // scores in base 2: exp2f

static_assert(kSplit == kThreads && kStep == 32,
              "one thread per position of a split, one warp per step");

struct Params {
  const float* q;
  const void* pool_k;
  const void* pool_v;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* cache_len;
  float* out;
  float2* part_ml;  // [B, Hkv, row_tiles * 64, n_splits] (m base 2, l)
  float* part_acc;  // [B, Hkv, row_tiles * 64, n_splits, dh]
  int S, H, Hkv, dh, P, nb, trash, window, row_tiles, n_splits;
  int ld;           // stage row stride, elements
  float softcap, scale;
};

// Absolute token held at ring offset r, or a negative value if never written.
__device__ __forceinline__ int ring_token(int t, int r, int ring) {
  const int x = t - r;
  return t - ((x % ring) + ring) % ring;
}

__device__ __forceinline__ bool position_valid(int u, int qpos, int window) {
  return u >= 0 && u <= qpos && (window <= 0 || u > qpos - window);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Four consecutive elements (aligned to 4) as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  __nv_fp8x4_e4m3 v;
  v.__x = *reinterpret_cast<const __nv_fp8x4_storage_t*>(p);
  return static_cast<float4>(v);
}

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

// Per-position facts of a block's split, in shared memory.
struct Meta {
  int u[kSplit];        // ring token (negative: never written / past ring)
  int pid[kSplit];      // page id (trash past the ring)
  float ksc[kSplit];    // 8-bit pools: the position's page scales
  float vsc[kSplit];
  unsigned valid[kSteps];  // per step: positions valid for some row
  unsigned live[kSteps];   // per step: positions on a live page
};

// Shared-memory layout, bytes: Meta, q rows (fp32, stride ldq), the 2-stage
// K/V ring (T, stride ld), and the GEMV path's per-warp partials (acc, m, l).
struct Smem {
  size_t q, stage, red, total;
  __host__ __device__ Smem(bool tile, int esize, int dh, int ld, int rows) {
    const int dh8 = (dh + 7) & ~7;
    q = align16(sizeof(Meta));
    const size_t qbytes = tile ? sizeof(float) * kTileRows * (dh8 + 4)
                               : sizeof(float) * rows * dh;
    stage = q + align16(qbytes);
    red = stage + align16((size_t)kStages * 2 * kStep * ld * esize);
    total = red + (tile ? 0 : sizeof(float) * kWarps * rows * (dh + 2));
  }
};

// The split's per-position facts for the tile of rows [row0, row0 + rows).
// The union of the rows' valid tokens is one interval: u >= 0, u <= the
// last row's qpos and, with a window, u > the first row's qpos - window.
template <bool kQuant>
__device__ void setup_split(const Params& p, Meta& M, int b, int kh,
                            int split, int row0, int rows, int t) {
  const int G = p.H / p.Hkv;
  const int ring = p.nb * p.P;
  const int qlo = t - (p.S - 1) + row0 / G;
  const int qhi = t - (p.S - 1) + (row0 + rows - 1) / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = split * kSplit + tid;
  int u = -1, pid = p.trash;
  bool any = false;
  if (pos < ring) {
    pid = p.page_table[(int64_t)b * p.nb + pos / p.P];
    u = ring_token(t, pos, ring);
    any = pid != p.trash && u >= 0 && u <= qhi &&
          (p.window <= 0 || u > qlo - p.window);
  }
  M.u[tid] = u;
  M.pid[tid] = pid;
  if (kQuant) {
    const bool real = pid != p.trash;  // the trash page is never read
    M.ksc[tid] = real ? p.k_scale[(int64_t)pid * p.Hkv + kh] : 0.f;
    M.vsc[tid] = real ? p.v_scale[(int64_t)pid * p.Hkv + kh] : 0.f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, any);
  if (lane == 0) M.valid[warp] = ballot;
  __syncthreads();
  // a page is live when any of its positions is: expand to its positions
  unsigned live;
  if (p.P >= 64) {  // a page spans two steps
    live = (M.valid[warp] | M.valid[warp ^ 1]) ? 0xffffffffu : 0u;
  } else if (p.P == 32) {
    live = M.valid[warp] ? 0xffffffffu : 0u;
  } else {
    const int first = lane & ~(p.P - 1);
    const unsigned page_bits = ((1u << p.P) - 1u) << first;
    live = __ballot_sync(0xffffffffu, (M.valid[warp] & page_bits) != 0);
  }
  if (lane == 0) M.live[warp] = live;
  __syncthreads();
}

// Issue the cp.async copies of step s's K and V rows (32 positions, rows of
// dh elements of T at stride ld) into one stage, zero-filling positions on
// skipped pages; always commits one group.
template <typename T>
__device__ void issue_step(const Params& p, const Meta& M, T* kst, T* vst,
                           int s, int kh) {
  const unsigned live = M.live[s];
  if (live) {
    const T* pk = static_cast<const T*>(p.pool_k);
    const T* pv = static_cast<const T*>(p.pool_v);
    const int row_bytes = p.dh * (int)sizeof(T);
    const bool wide = row_bytes % 16 == 0;
    const int unit = wide ? 16 : 4;
    const int units = row_bytes / unit;
    for (int idx = threadIdx.x; idx < kStep * units; idx += kThreads) {
      const int r = idx / units, c = idx - r * units;
      const int ps = s * kStep + r;
      const bool on = (live >> r) & 1u;
      const int64_t off =
          on ? (((int64_t)M.pid[ps] * p.P + (ps & (p.P - 1))) * p.Hkv + kh) *
                   p.dh
             : 0;
      const char* gk = reinterpret_cast<const char*>(pk + off) + unit * c;
      const char* gv = reinterpret_cast<const char*>(pv + off) + unit * c;
      char* sk = reinterpret_cast<char*>(kst + r * p.ld) + unit * c;
      char* sv = reinterpret_cast<char*>(vst + r * p.ld) + unit * c;
      if (wide) {
        cp_async16(sk, gk, on);
        cp_async16(sv, gv, on);
      } else {
        cp_async4(sk, gk, on);
        cp_async4(sv, gv, on);
      }
    }
  }
  cp_async_commit();
}

// Walk a block's steps through an NST-stage cp.async ring: each step's K
// and V rows are issued NST - 1 steps ahead (one commit group per step),
// and body(s, ks, vs, live) runs on a step with a live page once its rows
// have landed, between two barriers.
template <int NST, typename T, typename Body>
__device__ __forceinline__ void walk_steps(const Params& p, const Meta& M,
                                           T* st, int steps, int kh,
                                           Body&& body) {
  const int stage = 2 * kStep * p.ld;
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < steps)
      issue_step<T>(p, M, st + i * stage, st + i * stage + kStep * p.ld, i,
                    kh);
    else
      cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int next = s + NST - 1;
    if (next < steps) {
      T* nk = st + (next % NST) * stage;
      issue_step<T>(p, M, nk, nk + kStep * p.ld, next, kh);
    } else {
      cp_async_commit();
    }
    cp_async_wait<NST - 1>();
    __syncthreads();
    const T* ks = st + (s % NST) * stage;
    if (M.live[s]) body(s, ks, ks + kStep * p.ld, M.live[s]);
    __syncthreads();
  }
}

__device__ __forceinline__ int num_steps(const Params& p, int split) {
  const int left = p.nb * p.P - split * kSplit;
  return min(kSteps, (left + kStep - 1) / kStep);
}

// Where a row's partial of one split lies: part_ml[i] holds (m, l), and
// part_acc[i * dh ..] its acc when l > 0.
__device__ __forceinline__ size_t partial_index(const Params& p, int b,
                                                int kh, int rt, int r,
                                                int split) {
  return ((((size_t)b * p.Hkv + kh) * p.row_tiles + rt) * kTileRows + r) *
             p.n_splits + split;
}

// A block none of whose steps holds a live page: its rows' results are
// empty (0 with one split; m = -1e30, l = 0 and no acc otherwise).
__device__ void write_empty(const Params& p, int b, int kh, int rt,
                            int split, int rows) {
  const int G = p.H / p.Hkv, dh4 = p.dh >> 2;
  if (p.n_splits > 1) {
    for (int r = threadIdx.x; r < rows; r += kThreads)
      p.part_ml[partial_index(p, b, kh, rt, r, split)] =
          make_float2(kNegInf, 0.f);
    return;
  }
  for (int idx = threadIdx.x; idx < rows * dh4; idx += kThreads) {
    const int r = idx / dh4, c = idx - r * dh4, i = rt * kTileRows + r;
    reinterpret_cast<float4*>(
        p.out + (((int64_t)b * p.S + i / G) * p.H + kh * G + i % G) *
                    p.dh)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ bool any_live(const Meta& M) {
  return (M.live[0] | M.live[1] | M.live[2] | M.live[3]) != 0u;
}

// ---------------------------------------------------------------------------
// The tile path: S*G >= 16 rows, scores and PV on tensor cores.
// NT: n-tiles of 8 head dims the accumulator holds (dh <= 8 * NT).
// ---------------------------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_tile_kernel(const Params p) {
  constexpr bool kQuant = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y / p.row_tiles, rt = blockIdx.y % p.row_tiles;
  const int split = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int row0 = rt * kTileRows;
  const int rows = min(kTileRows, p.S * G - row0);
  const int dh8 = (p.dh + 7) & ~7, ldq = dh8 + 4;
  const Smem L(true, sizeof(T), p.dh, p.ld, rows);
  Meta& M = *reinterpret_cast<Meta*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + L.q);
  T* st = reinterpret_cast<T*>(smem_raw + L.stage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int t = p.cache_len[b] - 1;
  setup_split<kQuant>(p, M, b, kh, split, row0, rows, t);
  if (!any_live(M)) {
    write_empty(p, b, kh, rt, split, rows);
    return;
  }

  // q tile, fp32, by cp.async in the first step's group; zeros past
  // `rows` and past dh (to dh8)
  const int c8 = dh8 >> 2;
  for (int idx = tid; idx < kTileRows * c8; idx += kThreads) {
    const int r = idx / c8, c = idx - r * c8;
    const int i = row0 + min(r, rows - 1);
    const bool in = r < rows && 4 * c < p.dh;
    cp_async16(q_s + r * ldq + 4 * c,
               p.q + (((int64_t)b * p.S + i / G) * p.H + kh * G + i % G) *
                             p.dh + (in ? 4 * c : 0),
               in);
  }
  if (dh8 != p.dh)  // the last k step reads 4 head dims past dh: zeros
    for (int r = tid; r < kStages * 2 * kStep; r += kThreads)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[r * p.ld + p.dh + e] = T(0.f);

  const bool warp_live = warp * 16 < rows;
  const int qa = t - (p.S - 1) + (row0 + warp * 16 + g) / G;  // row g
  const int qb = t - (p.S - 1) + (row0 + warp * 16 + g + 8) / G;
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const float kInvalid = __int_as_float(0xff800000);  // -inf: masked score

  walk_steps<kStages>(p, M, st, num_steps(p, split), kh,
                      [&](int s, const T* ks, const T* vs, unsigned live) {
    if (!warp_live) return;
    float sc[4][4];
    warp_scores<false, T>(sc, q_s + warp * 16 * ldq, ldq, ks, p.ld,
                          dh8 >> 3, lane);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = n * 8 + 2 * t4 + (e & 1);
        const int ps = s * kStep + pos;
        const bool ok = ((live >> pos) & 1u) &&
                        position_valid(M.u[ps], e < 2 ? qa : qb, p.window);
        float x = sc[n][e] * p.scale;
        if (kQuant) x *= M.ksc[ps];  // dequant K: before the softcap
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        sc[n][e] = ok ? x * kLog2e : kInvalid;  // base-2 units
        if (e < 2)
          mx_a = fmaxf(mx_a, sc[n][e]);
        else
          mx_b = fmaxf(mx_b, sc[n][e]);
      }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        float w = x == kInvalid ? 0.f : exp2f(x - (e < 2 ? mn_a : mn_b));
        if (e < 2)
          sum_a += w;
        else
          sum_b += w;
        // dequant V: the page's scale enters the product, not l
        if (kQuant) w *= M.vsc[s * kStep + n * 8 + 2 * t4 + (e & 1)];
        sc[n][e] = w;
      }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    if (__any_sync(0xffffffffu, corr_a != 1.f || corr_b != 1.f)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // a running max moved
        o[j][0] *= corr_a;
        o[j][1] *= corr_a;
        o[j][2] *= corr_b;
        o[j][3] *= corr_b;
      }
    }
    warp_pv<NT, T>(o, sc, vs, p.ld, dh8 >> 3, lane);
  });

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + 8 * half;
    if (r >= rows) continue;
    const float m = half ? m_b : m_a, l = half ? l_b : l_a;
    float* dst;
    float mul = 1.f;
    if (p.n_splits == 1) {
      const int i = row0 + r;
      dst = p.out + (((int64_t)b * p.S + i / G) * p.H + kh * G + i % G) *
                        p.dh;
      mul = 1.f / fmaxf(l, 1e-30f);
    } else {
      const size_t pi = partial_index(p, b, kh, rt, r, split);
      if (t4 == 0) p.part_ml[pi] = make_float2(m, l);
      if (!(l > 0.f)) continue;
      dst = p.part_acc + pi * p.dh;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t4;
      if (c < p.dh)
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(o[j][2 * half] * mul, o[j][2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// The GEMV path: S*G < 16 rows, fp32 CUDA cores, bytes-bound.  Each warp
// owns 8 positions of every step (4 lanes per position for the scores) and
// keeps its own online softmax and accumulator over them, so a step needs
// no barrier between its phases; the 4 warps' partials are merged once at
// the end with the log-sum-exp rule.
// RMAX >= rows; NJ: 128-wide head-dim chunks per lane in PV (dh <= 128 NJ).
// ---------------------------------------------------------------------------
template <typename T, int RMAX, int NJ>
__global__ void __launch_bounds__(kThreads)
    paged_attention_gemv_kernel(const Params p) {
  constexpr bool kQuant = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int rows = p.S * G;  // < kGemvRows: one row tile
  const int dh = p.dh, dh4 = dh >> 2;
  const Smem L(false, sizeof(T), dh, p.ld, rows);
  Meta& M = *reinterpret_cast<Meta*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + L.q);     // [rows][dh]
  T* st = reinterpret_cast<T*>(smem_raw + L.stage);
  float* red = reinterpret_cast<float*>(smem_raw + L.red);   // [4][rows][dh]
  float* m_w = red + kWarps * rows * dh;                     // [4][rows]
  float* l_w = m_w + kWarps * rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int t = p.cache_len[b] - 1;
  setup_split<kQuant>(p, M, b, kh, split, 0, rows, t);
  if (!any_live(M)) {
    write_empty(p, b, kh, 0, split, rows);
    return;
  }
  for (int idx = tid; idx < rows * dh4; idx += kThreads) {  // q: group 0
    const int r = idx / dh4, c = idx - r * dh4;
    cp_async16(q_s + r * dh + 4 * c,
               p.q + (((int64_t)b * p.S + r / G) * p.H + kh * G + r % G) *
                             dh + 4 * c,
               true);
  }
  const int qpos0 = t - (p.S - 1);

  float m_r[RMAX], l_r[RMAX];
  float4 acc[RMAX][NJ];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float kInvalid = __int_as_float(0xff800000);
  const int pa = tid >> 2, ca = tid & 3;  // scores: position, quarter of dh

  walk_steps<kStages>(p, M, st, num_steps(p, split), kh,
                      [&](int s, const T* ks, const T* vs, unsigned live) {
    float d[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) d[r] = 0.f;
    const T* kr = ks + pa * p.ld;
    for (int c = ca; c < dh4; c += 4) {
      const float4 kv = load4(kr + 4 * c);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < rows)
          d[r] = dot4(reinterpret_cast<const float4*>(q_s + r * dh)[c], kv,
                      d[r]);
    }
    const int ps = s * kStep + pa;
    const bool on = (live >> pa) & 1u;
    const int u = M.u[ps];
    float w[RMAX], corr[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
      float x = kInvalid;
      if (r < rows && on && position_valid(u, qpos0 + r / G, p.window)) {
        x = d[r] * p.scale;
        if (kQuant) x *= M.ksc[ps];  // dequant K: before the softcap
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        x *= kLog2e;
      }
      // the warp's 8 positions sit in lane bits 2..4
      float mx = fmaxf(kNegInf, x);
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float mn = fmaxf(m_r[r], mx);
      corr[r] = exp2f(m_r[r] - mn);
      m_r[r] = mn;
      w[r] = x == kInvalid ? 0.f : exp2f(x - mn);
      float sum = w[r];
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      l_r[r] = l_r[r] * corr[r] + sum;
      // dequant V: the page's scale enters the product, not l
      if (kQuant) w[r] *= M.vsc[ps];
    }
    // acc = acc * corr + w @ V over the warp's positions, lanes on dh
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[r][j].x *= corr[r];
        acc[r][j].y *= corr[r];
        acc[r][j].z *= corr[r];
        acc[r][j].w *= corr[r];
      }
#pragma unroll 2
    for (int pp = 0; pp < 8; ++pp) {
      const T* vr = vs + (8 * warp + pp) * p.ld;
      float4 vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < dh4 ? load4(vr + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const float wp = __shfl_sync(0xffffffffu, w[r], 4 * pp);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[r][j].x = fmaf(wp, vv[j].x, acc[r][j].x);
          acc[r][j].y = fmaf(wp, vv[j].y, acc[r][j].y);
          acc[r][j].z = fmaf(wp, vv[j].z, acc[r][j].z);
          acc[r][j].w = fmaf(wp, vv[j].w, acc[r][j].w);
        }
      }
    }
  });

  // merge the 4 warps' partials, one writer per (row, 4 head dims)
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < dh4)
        reinterpret_cast<float4*>(red + (warp * rows + r) * dh)[c] =
            acc[r][j];
    }
    if (lane == 0) {
      m_w[warp * rows + r] = m_r[r];
      l_w[warp * rows + r] = l_r[r];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * dh4; idx += kThreads) {
    const int r = idx / dh4, c = idx - r * dh4;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (l_w[w * rows + r] > 0.f) m = fmaxf(m, m_w[w * rows + r]);
    float l = 0.f;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = l_w[w * rows + r];
      if (!(lw > 0.f)) continue;  // no valid position in this warp's share
      const float f = exp2f(m_w[w * rows + r] - m);
      const float4 x =
          reinterpret_cast<const float4*>(red + (w * rows + r) * dh)[c];
      l += f * lw;
      v.x = fmaf(f, x.x, v.x);
      v.y = fmaf(f, x.y, v.y);
      v.z = fmaf(f, x.z, v.z);
      v.w = fmaf(f, x.w, v.w);
    }
    float4* dst;
    if (p.n_splits == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      v = make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv);
      dst = reinterpret_cast<float4*>(
          p.out + (((int64_t)b * p.S + r / G) * p.H + kh * G + r % G) * dh);
    } else {
      const size_t pi = partial_index(p, b, kh, 0, r, split);
      if (c == 0) p.part_ml[pi] = make_float2(m, l);
      if (!(l > 0.f)) continue;
      dst = reinterpret_cast<float4*>(p.part_acc + pi * dh);
    }
    dst[c] = v;
  }
}

// ---------------------------------------------------------------------------
// The split combine: one warp per row, the log-sum-exp rule over the
// splits with l > 0.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    paged_attention_combine_kernel(const Params p, int B) {
  const int G = p.H / p.Hkv;
  const int rows = p.S * G;
  const int64_t gw = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (int64_t)B * p.Hkv * rows) return;
  const int i = (int)(gw % rows);
  const int64_t bk = gw / rows;
  const int kh = (int)(bk % p.Hkv), b = (int)(bk / p.Hkv);
  const size_t base = partial_index(p, b, kh, i / kTileRows, i % kTileRows, 0);
  float M = kNegInf;
  for (int sp = 0; sp < p.n_splits; ++sp) {
    const float2 ml = p.part_ml[base + sp];
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
  const int dh4 = p.dh >> 2;
  float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
  float l = 0.f;
  for (int sp = 0; sp < p.n_splits; ++sp) {
    const float2 ml = p.part_ml[base + sp];
    if (!(ml.y > 0.f)) continue;  // no valid position: acc never written
    const float w = exp2f(ml.x - M);
    l += w * ml.y;
    const float4* a =
        reinterpret_cast<const float4*>(p.part_acc + (base + sp) * p.dh);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
      if (c < dh4) {
        const float4 x = a[c];
        acc[j].x = fmaf(w, x.x, acc[j].x);
        acc[j].y = fmaf(w, x.y, acc[j].y);
        acc[j].z = fmaf(w, x.z, acc[j].z);
        acc[j].w = fmaf(w, x.w, acc[j].w);
      }
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float4* o = reinterpret_cast<float4*>(
      p.out + (((int64_t)b * p.S + i / G) * p.H + kh * G + i % G) * p.dh);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = lane + 32 * j;
    if (c < dh4)
      o[c] = make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv,
                         acc[j].w * inv);
  }
}

// Stage row strides, in elements of T: fp32 rows of dh8 + 4 words (= 4
// mod 8: the tile path's fragment reads hit 32 distinct banks), 8-bit rows
// of roundup(dh8, 32) + 16 bytes (= 16 mod 32).
int stage_ld(int esize, int dh) {
  const int dh8 = (dh + 7) & ~7;
  if (esize == 1) return ((dh8 + 31) & ~31) + 16;
  return dh8 + 4;
}

// Launch one instantiation, opting in to its dynamic shared memory once.
template <auto Kernel>
cudaError_t launch_kernel(dim3 grid, size_t smem, cudaStream_t st,
                          const Params& p) {
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  Kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int B, const Params& p0, cudaStream_t st) {
  Params p = p0;
  const int rows = p.S * (p.H / p.Hkv);
  const bool tile = rows >= kGemvRows;
  p.ld = stage_ld(sizeof(T), p.dh);
  const size_t smem = Smem(tile, sizeof(T), p.dh, p.ld, rows).total;
  const dim3 grid(B, p.Hkv * p.row_tiles, p.n_splits);
  cudaError_t e;
  if (tile) {
    e = p.dh <= 128
            ? launch_kernel<paged_attention_tile_kernel<T, 16>>(grid, smem,
                                                                st, p)
            : launch_kernel<paged_attention_tile_kernel<T, 32>>(grid, smem,
                                                                st, p);
  } else {
#define PA_GEMV(r)                                                    \
  e = p.dh <= 128 ? launch_kernel<paged_attention_gemv_kernel<T, r, 1>>( \
                        grid, smem, st, p)                            \
                  : launch_kernel<paged_attention_gemv_kernel<T, r, 2>>( \
                        grid, smem, st, p)
    if (rows <= 2)
      PA_GEMV(2);
    else if (rows <= 4)
      PA_GEMV(4);
    else
      PA_GEMV(16);
#undef PA_GEMV
  }
  if (e != cudaSuccess || p.n_splits == 1) return e;
  const int64_t warps = (int64_t)B * p.Hkv * rows;
  const dim3 cgrid((unsigned)((warps + kWarps - 1) / kWarps));
  paged_attention_combine_kernel<<<cgrid, kThreads, 0, st>>>(p, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of fp32 scratch one call needs, 0 when the ring is one split
// (the blocks then write out directly).  The call cuts a slot's ring into
// n_splits = ceil(nb * P / 128) blocks; with more than one, the scratch
// holds the splits' (m, l) pairs ([B, Hkv, row_tiles * 64, n_splits]
// float2, row_tiles = ceil(S * H / Hkv / 64)) and then their acc rows (the
// same rows x dh floats).  Shapes only: the caller reads no cache length.
long long paged_attention_scratch_floats(int B, int S, int H, int Hkv,
                                         int dh, int P, int nb) {
  if (B < 1 || S < 1 || Hkv < 1 || H < Hkv || dh < 1 || P < 1 || nb < 1)
    return 0;
  const long long n_splits = ((long long)nb * P + kSplit - 1) / kSplit;
  if (n_splits == 1) return 0;
  const long long row_tiles = (S * (H / Hkv) + kTileRows - 1) / kTileRows;
  return (long long)B * Hkv * row_tiles * kTileRows * n_splits * (dh + 2);
}

// Pool element types (kv_dtype): 0 fp32 (scales must be null), 1 int8,
// 2 fp8_e4m3 (both need k_scale and v_scale).  scratch holds
// paged_attention_scratch_floats(...) floats, 16-byte aligned, and may be
// null when that is 0.
// Returns a cudaError_t: cudaErrorInvalidValue for a dtype code or shapes
// the kernel does not take, else the launches' cudaGetLastError().
// window <= 0: no window; softcap <= 0: no softcap.  npg counts pool rows
// including the trash page.
int paged_attention_fwd(const float* q, const void* pool_k,
                        const void* pool_v, const float* k_scale,
                        const float* v_scale, const int* page_table,
                        const int* cache_len, float* out, float* scratch,
                        int B, int S, int H, int Hkv, int dh, int P, int nb,
                        int npg, int kv_dtype, int window, float softcap,
                        float scale, void* stream) {
  if (B < 0 || S < 1 || Hkv < 1 || H % Hkv != 0 || dh < 4 || dh % 4 != 0 ||
      dh > kMaxHeadDim || P < 1 || P > kMaxPageSize || (P & (P - 1)) != 0 ||
      nb < 1 || npg < 1)
    return (int)cudaErrorInvalidValue;
  const bool scaled = k_scale != nullptr && v_scale != nullptr;
  if (kv_dtype == 0 ? (k_scale != nullptr || v_scale != nullptr)
                    : (kv_dtype == 1 || kv_dtype == 2) ? !scaled : true)
    return (int)cudaErrorInvalidValue;
  const long long ring = (long long)nb * P;
  if (ring > (1 << 30)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int n_splits = (int)((ring + kSplit - 1) / kSplit);
  if (n_splits > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int row_tiles = (S * (H / Hkv) + kTileRows - 1) / kTileRows;
  if ((long long)Hkv * row_tiles > 65535 || n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  // the (m, l) pairs, then the acc rows: their offset is a multiple of 128
  // floats (row_tiles * 64 rows of pairs), so float4 reads stay aligned
  const size_t pairs = (size_t)B * Hkv * row_tiles * kTileRows * n_splits;
  float* part_acc = n_splits > 1 ? scratch + 2 * pairs : nullptr;
  Params p{q,        pool_k,   pool_v, k_scale, v_scale, page_table,
           cache_len, out,     reinterpret_cast<float2*>(scratch),
           part_acc, S,        H,      Hkv,     dh,      P,
           nb,       npg - 1,  window, row_tiles, n_splits, 0,
           softcap,  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 1) return (int)dispatch<int8_t>(B, p, st);
  if (kv_dtype == 2) return (int)dispatch<__nv_fp8_e4m3>(B, p, st);
  return (int)dispatch<float>(B, p, st);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
