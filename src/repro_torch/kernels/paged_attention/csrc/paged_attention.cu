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
// 8-bit pools: the element type is a template parameter.  Pages are staged
// in shared memory as stored (1 byte per element) and converted to fp32
// four at a time where the score and PV loops read them.  The page's two
// scales are read once per page, after the skip test, and folded in where
// the reference folds them: the K scale multiplies the score after the
// 1/sqrt(dh) scale and before the softcap; the V scale multiplies the
// page's weights in the PV update of the accumulator only, never the
// denominator l (scaling l too would cancel the fold).  No page is ever
// dequantized in memory.
//
// Grid (B, Hkv, row_tiles).  One block owns one slot, one kv head and a
// tile of at most 64 of its S*G query rows, grouped [Hkv, S, G] as in the
// Pallas kernel (row i of a kv head is query i / G, head kh * G + i % G), so
// GQA needs no KV repeat.  The block loops over the slot's nb pages in
// order, loading its own page ids and cache length.  A page whose id is
// the trash id, or on which no row of the tile has a valid position, is
// skipped (the skip test follows the per-row mask).  Otherwise its K and V
// rows for the block's kv head ([P, dh], stride Hkv * dh in the pool) are
// staged in shared memory, and each warp updates its 8 rows in three
// phases: (A) scores for all 8 rows at once (lanes split positions x rows,
// 4-element loads) -> scale (x K scale) -> softcap tanh(s / c) * c -> mask;
// (B) the online softmax in fp32, four lanes per row (masked scores never
// raise the running max above -1e30's floor, masked weights are exactly
// 0); (C) the PV update for all 8 rows at once (weights x V scale), each
// lane owning 4 contiguous head dims per 128.  The output divides by
// max(l, 1e-30), so a row with nothing valid is exactly 0.
//
// Mask: t = cache_len[b] - 1; query row position qpos = t - (S - 1) + i / G;
// ring offset r holds absolute token u = t - floormod(t - r, R), R = nb * P,
// written as ((x % R) + R) % R because C's % truncates.  Valid iff
// u >= 0 && u <= qpos, and u > qpos - window when there is a window.
//
// What bounds it on this card: reading the live K/V pages.  The bytes a
// call must move are sum_b live_pages_b * P * Hkv * (dh * e + 4) * 2, with
// e = 4 bytes per element for fp32 pools and 1 for 8-bit ones (+4: the
// scale; fp32 pools have none), plus q and the output; the arithmetic is
// 4 * dh flops per (query head, row, valid position), on the fp32 CUDA
// cores.  At decode shapes (S = 1) that is far below the card's ops:byte
// ridge, so the kernel is memory bound; at the fused chunk's S = 32 rows
// per slot the fp32 arithmetic is of the same order as the fp32 bytes and
// bounds the 8-bit call, whose bytes are a quarter.  This version is right
// and simple: one block per (slot, kv head), page loads not overlapped with
// the math.  A later PR
// makes it fast by
//   - splitting the page loop across blocks (flash-decoding), so short
//     batches fill all 132 SMs;
//   - double-buffering page loads with cp.async / TMA, in place of the
//     TPU's manual DMA ring, so loads overlap the math;
//   - running the S*G x dh score and PV tiles on tensor cores (mma).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kRowsPerWarp = kTileRows / kWarps;  // 8
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPageSize = 64;
constexpr float kNegInf = -1e30f;

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

// Four consecutive pool elements (aligned to 4 elements) as fp32, and the
// unit a page row is copied in: 4 elements, 16 bytes for fp32, 4 for 8-bit.
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
template <typename T>
using Unit4 =
    typename std::conditional<sizeof(T) == 4, float4, uint32_t>::type;

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

// Shared-memory layout, in bytes.  q rows (fp32) and K rows (element type T)
// are padded to dh + 4 elements: 4-element units stay aligned, and
// consecutive K rows start 4 banks apart (fp32) or 1 bank apart (8-bit), so
// the score loop's lanes, one K row each, read distinct banks.
template <typename T>
struct Smem {
  int ld, sp;
  size_t q, k, v, w, c, l, total;
  __host__ __device__ Smem(int dh, int P)
      : ld(dh + 4), sp(P + 4),
        q(0),
        k(q + align16(sizeof(float) * kTileRows * (dh + 4))),
        v(k + align16(sizeof(T) * P * (dh + 4))),
        w(v + align16(sizeof(T) * P * dh)),
        c(w + align16(sizeof(float) * kTileRows * (P + 4))),
        l(c + sizeof(float) * kTileRows),
        total(l + sizeof(float) * kTileRows) {}
};

// T: pool element type (float, int8_t, __nv_fp8_e4m3; 8-bit pools carry
// k_scale / v_scale).
// NJ: 128-wide head-dim chunks per lane in the PV phase (dh <= 128 * NJ).
// RPL: rows each lane scores in phase A, 8 / (32 / min(P, 32)) capped to
// [1, 8], a constant so no issue slot goes to a row the lane never has.
template <typename T, int NJ, int RPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ cache_len,
                       float* __restrict__ out,
                       int S, int H, int Hkv, int dh, int P, int nb, int trash,
                       int window, float softcap, float scale) {
  constexpr bool kQuant = !std::is_same<T, float>::value;
  using Unit = Unit4<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> L(dh, P);
  float* q_s = reinterpret_cast<float*>(smem_raw + L.q);  // [kTileRows][ld]
  T* k_s = reinterpret_cast<T*>(smem_raw + L.k);          // [P][ld]  K page
  T* v_s = reinterpret_cast<T*>(smem_raw + L.v);          // [P][dh]  V page
  float* w_s = reinterpret_cast<float*>(smem_raw + L.w);  // [kTileRows][sp]
  float* c_s = reinterpret_cast<float*>(smem_raw + L.c);  // rescale per row
  float* l_s = reinterpret_cast<float*>(smem_raw + L.l);  // denominators
  const float kInvalid = __int_as_float(0xff800000);  // -inf: masked score

  const int G = H / Hkv;
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.z * kTileRows;
  const int rows = min(kTileRows, S * G - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;  // this warp's rows: wrow .. wrow+7
  const int dh4 = dh >> 2;

  for (int idx = threadIdx.x; idx < rows * dh4; idx += kThreads) {
    const int r = idx / dh4, c = idx - r * dh4;
    const int i = row0 + r;
    const int s = i / G, h = kh * G + i % G;
    reinterpret_cast<float4*>(q_s + r * L.ld)[c] =
        reinterpret_cast<const float4*>(q + (((int64_t)b * S + s) * H + h) * dh)[c];
  }

  const int t = cache_len[b] - 1;
  const int ring = nb * P;
  const int qpos0 = t - (S - 1);

  // phase A lanes: PP positions x RPP rows per pass; each lane scores RPL
  // of the warp's 8 rows at one position per pass
  constexpr int RPP = kRowsPerWarp / RPL;
  const int PP = P < 32 ? P : 32;
  const int pl = lane % PP, rl = lane / PP;
  const bool warp_live = wrow < rows;  // warp-uniform: any row of its 8
  // phase B lanes: four per row
  const int br = wrow + (lane >> 2), bs = lane & 3;
  float m_row = kNegInf, l_row = 0.f;  // online-softmax state of row br
  float acc[kRowsPerWarp][4 * NJ];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) acc[r][e] = 0.f;

  for (int j = 0; j < nb; ++j) {
    const int pid = page_table[(int64_t)b * nb + j];
    if (pid == trash) continue;  // uniform across the block
    bool any = false;
    for (int idx = threadIdx.x; idx < rows * P; idx += kThreads) {
      const int r = idx / P, p = idx - r * P;
      const int qpos = qpos0 + (row0 + r) / G;
      any |= position_valid(ring_token(t, j * P + p, ring), qpos, window);
    }
    // also orders the previous page's reads before this page's loads
    if (!__syncthreads_or(any)) continue;

    const T* kp = pool_k + ((int64_t)pid * P * Hkv + kh) * dh;
    const T* vp = pool_v + ((int64_t)pid * P * Hkv + kh) * dh;
    for (int idx = threadIdx.x; idx < P * dh4; idx += kThreads) {
      const int p = idx / dh4, c = idx - p * dh4;
      const int64_t off = (int64_t)p * Hkv * dh;
      reinterpret_cast<Unit*>(k_s + p * L.ld)[c] =
          reinterpret_cast<const Unit*>(kp + off)[c];
      reinterpret_cast<Unit*>(v_s + p * dh)[c] =
          reinterpret_cast<const Unit*>(vp + off)[c];
    }
    // this page's scales (8-bit pools), one read each per block
    float ksc = 1.f, vsc = 1.f;
    if (kQuant) {
      ksc = k_scale[(int64_t)pid * Hkv + kh];
      vsc = v_scale[(int64_t)pid * Hkv + kh];
    }
    __syncthreads();

    // (A) masked scores of the warp's rows
    if (warp_live && rl < RPP) {
      for (int p0 = 0; p0 < P; p0 += PP) {
        const int p = p0 + pl;
        const T* kr = k_s + p * L.ld;
        float dot[RPL];
#pragma unroll
        for (int i = 0; i < RPL; ++i) dot[i] = 0.f;
        for (int c = 0; c < dh4; ++c) {
          const float4 kv = load4(kr + 4 * c);
#pragma unroll
          for (int i = 0; i < RPL; ++i)
            dot[i] = dot4(reinterpret_cast<const float4*>(
                              q_s + (wrow + rl + RPP * i) * L.ld)[c],
                          kv, dot[i]);
        }
        const int u = ring_token(t, j * P + p, ring);
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          const int r = wrow + rl + RPP * i;
          if (r < rows) {
            float sc = kInvalid;
            if (position_valid(u, qpos0 + (row0 + r) / G, window)) {
              sc = dot[i] * scale;
              if (kQuant) sc *= ksc;  // dequant K: before the softcap
              if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
            }
            w_s[r * L.sp + p] = sc;
          }
        }
      }
    }
    __syncwarp();

    // (B) online softmax: row br's running max, weights and denominator
    {
      const bool live = br < rows;
      float mloc = kNegInf;
      if (live)
        for (int p = bs; p < P; p += 4) mloc = fmaxf(mloc, w_s[br * L.sp + p]);
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      const float m_new = fmaxf(m_row, mloc);
      float lsum = 0.f;
      if (live)
        for (int p = bs; p < P; p += 4) {
          const float sc = w_s[br * L.sp + p];
          const float w = (sc == kInvalid) ? 0.f : expf(sc - m_new);
          w_s[br * L.sp + p] = w;
          lsum += w;
        }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const float corr = expf(m_row - m_new);
      l_row = l_row * corr + lsum;
      m_row = m_new;
      if (bs == 0 && live) c_s[br] = corr;
    }
    __syncwarp();

    // (C) acc = acc * corr + w @ V for the warp's rows
    if (!warp_live) continue;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (wrow + r < rows) {
        const float corr = c_s[wrow + r];
#pragma unroll
        for (int e = 0; e < 4 * NJ; ++e) acc[r][e] *= corr;
      }
    }
    for (int p = 0; p < P; ++p) {
      float4 vv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = lane + 32 * jj;
        vv[jj] = c < dh4 ? load4(v_s + p * dh + 4 * c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (wrow + r < rows) {
          // dequant V: the page's scale enters the accumulator, not l
          const float w = kQuant ? w_s[(wrow + r) * L.sp + p] * vsc
                                 : w_s[(wrow + r) * L.sp + p];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            acc[r][4 * jj + 0] = fmaf(w, vv[jj].x, acc[r][4 * jj + 0]);
            acc[r][4 * jj + 1] = fmaf(w, vv[jj].y, acc[r][4 * jj + 1]);
            acc[r][4 * jj + 2] = fmaf(w, vv[jj].z, acc[r][4 * jj + 2]);
            acc[r][4 * jj + 3] = fmaf(w, vv[jj].w, acc[r][4 * jj + 3]);
          }
        }
      }
    }
  }

  if (bs == 0 && br < rows) l_s[br] = l_row;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = wrow + r;
    if (rr < rows) {
      const int i = row0 + rr;
      const int s = i / G, h = kh * G + i % G;
      float4* o = reinterpret_cast<float4*>(
          out + (((int64_t)b * S + s) * H + h) * dh);
      const float inv = 1.f / fmaxf(l_s[rr], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = lane + 32 * jj;
        if (c < dh4)
          o[c] = make_float4(acc[r][4 * jj] * inv, acc[r][4 * jj + 1] * inv,
                             acc[r][4 * jj + 2] * inv, acc[r][4 * jj + 3] * inv);
      }
    }
  }
}

template <typename T, int NJ, int RPL>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* q,
                   const void* pool_k, const void* pool_v,
                   const float* k_scale, const float* v_scale,
                   const int* page_table, const int* cache_len, float* out,
                   int S, int H, int Hkv, int dh, int P, int nb, int trash,
                   int window, float softcap, float scale) {
  const size_t smem = Smem<T>(dh, P).total;
  static size_t configured = 48 * 1024;  // dynamic smem allowed so far
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, NJ, RPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  paged_attention_kernel<T, NJ, RPL><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      k_scale, v_scale, page_table, cache_len, out, S, H, Hkv, dh, P, nb,
      trash, window, softcap, scale);
  return cudaGetLastError();
}

// The (NJ, RPL) specialisation for this head dim and page size.
template <typename T>
cudaError_t dispatch(dim3 grid, cudaStream_t st, const float* q,
                     const void* pool_k, const void* pool_v,
                     const float* k_scale, const float* v_scale,
                     const int* page_table, const int* cache_len, float* out,
                     int S, int H, int Hkv, int dh, int P, int nb, int trash,
                     int window, float softcap, float scale) {
  const int rpl = P >= 32 ? 8 : P == 16 ? 4 : P == 8 ? 2 : 1;
#define PA_LAUNCH(nj, r)                                                   \
  return launch<T, nj, r>(grid, st, q, pool_k, pool_v, k_scale, v_scale,  \
                          page_table, cache_len, out, S, H, Hkv, dh, P,   \
                          nb, trash, window, softcap, scale)
  if (dh <= 128) {
    if (rpl == 8) PA_LAUNCH(1, 8);
    if (rpl == 4) PA_LAUNCH(1, 4);
    if (rpl == 2) PA_LAUNCH(1, 2);
    PA_LAUNCH(1, 1);
  }
  if (rpl == 8) PA_LAUNCH(2, 8);
  if (rpl == 4) PA_LAUNCH(2, 4);
  if (rpl == 2) PA_LAUNCH(2, 2);
  PA_LAUNCH(2, 1);
#undef PA_LAUNCH
}

}  // namespace

extern "C" {

// Pool element types (kv_dtype): 0 fp32 (scales must be null), 1 int8,
// 2 fp8_e4m3 (both need k_scale and v_scale).
// Returns a cudaError_t: cudaErrorInvalidValue for a dtype code or shapes
// the kernel does not take, else the launch's cudaGetLastError().
// window <= 0: no window; softcap <= 0: no softcap.  npg counts pool rows
// including the trash page.
int paged_attention_fwd(const float* q, const void* pool_k,
                        const void* pool_v, const float* k_scale,
                        const float* v_scale, const int* page_table,
                        const int* cache_len, float* out, int B, int S, int H,
                        int Hkv, int dh, int P, int nb, int npg, int kv_dtype,
                        int window, float softcap, float scale, void* stream) {
  if (B < 0 || S < 1 || Hkv < 1 || H % Hkv != 0 || dh < 4 || dh % 4 != 0 ||
      dh > kMaxHeadDim || P < 1 || P > kMaxPageSize || (P & (P - 1)) != 0 ||
      nb < 1 || npg < 1)
    return (int)cudaErrorInvalidValue;
  const bool scaled = k_scale != nullptr && v_scale != nullptr;
  if (kv_dtype == 0 ? (k_scale != nullptr || v_scale != nullptr)
                    : (kv_dtype == 1 || kv_dtype == 2) ? !scaled : true)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int row_tiles = (S * (H / Hkv) + kTileRows - 1) / kTileRows;
  if (Hkv > 65535 || row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv, row_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int trash = npg - 1;
#define PA_DISPATCH(T)                                                     \
  return (int)dispatch<T>(grid, st, q, pool_k, pool_v, k_scale, v_scale,  \
                          page_table, cache_len, out, S, H, Hkv, dh, P,   \
                          nb, trash, window, softcap, scale)
  if (kv_dtype == 1) PA_DISPATCH(int8_t);
  if (kv_dtype == 2) PA_DISPATCH(__nv_fp8_e4m3);
  PA_DISPATCH(float);
#undef PA_DISPATCH
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
