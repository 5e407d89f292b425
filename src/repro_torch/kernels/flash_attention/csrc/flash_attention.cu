// Blockwise (flash) attention forward on NVIDIA Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas TPU kernel).  For each batch b and query head h:
//   out[b, h] = softmax(mask(softcap(q[b, h] @ k[b, kvh]^T * scale))) @ v[b, kvh]
//   q    [B, H, Sq, dh]     float or bf16
//   k, v [B, Hkv, Skv, dh]  same type;  kvh = h / (H / Hkv)  (GQA)
//   out  [B, H, Sq, dh]     q's type; the softmax and every sum in fp32
// Query i sits at key position i: the causal mask keeps cols <= rows, a
// window keeps cols > rows - window.  The softcap comes before the mask,
// and the mask is the finite -1e30 of the Pallas kernel, with its
// arithmetic: a row that sees no valid key in a tile while its running
// max is still -1e30 takes p = exp(0) = 1 on that tile's masked columns,
// and the first tile with a valid key wipes them out (corr = exp(-1e30 -
// m) = 0), exactly as in the Pallas kernel.  Keys past Skv (the ragged
// last tile) take no part at all: p = 0 and no share of the max.
//
// What bounds it on this card: operations.  At the main path's shape
// (internlm2 prefill: B = 1, H = 16, Hkv = 8, dh = 128, causal, S = 1024)
// the live scores need 4 * H * S(S+1)/2 * dh = 4.3 GFLOP against 25 MB of
// q, k, v and out (0.0075 ms at 3.35 TB/s).  On the fp32 CUDA cores that
// is 0.064 ms at 67 TFLOP/s, and the first version of this kernel ran at
// ~10 TFLOP/s: a 4 x 4 register tile fed 2 shared loads per 16 FMAs, K
// staged by scalar transposed stores with 8-way bank conflicts, no overlap
// of loads with math, and one 120 KB block per SM.  This design runs both
// products on the tensor cores (mma.sync m16n8k8 TF32, common/tf32_mma.cuh)
// at fp32 accuracy: fp32 operands are split into two TF32 halves and each
// product is 3 TF32 products (3 x 4.3 GFLOP at 495 TFLOP/s = 0.026 ms);
// bf16 values are exact in TF32, so QK^T takes 1 product and PV 2 (the
// weights split, V not).  The weights never leave registers (the score
// fragment is reused as the A fragment with the keys renumbered).
//
// Grid: one block of 4 warps per (64 query rows, b, h), 1-D, block L on
// head L % (B H).  Causal query tiles differ in work up to n_qt-fold, so
// the longer half is issued first, longest first, then the shorter half
// shortest first: a wave that puts blocks k and k + 132 on one SM pairs a
// long tile with a short one, and the last blocks to start are short.  Each
// warp owns 16 query rows (q in shared memory as fp32) and their running
// max, denominator and output fragments.  The block walks the KV tiles of
// 32 keys that the causal or window structure does not mask for every row
// of the block (the Pallas kernel's `needed` rule), staged with 16-byte
// cp.async copies into a 2-stage ring whose padded rows (= 16 mod 32
// bytes past the data) the fragments read without bank conflicts; rows
// past Skv are zero-filled.  Shared memory: 101 KB at dh = 128 in fp32
// (2 blocks per SM), 69 KB in bf16, 200 KB at dh = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 32;  // keys per KV tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // scores in base 2: exp2f

// KV stage row stride in elements: dh plus padding to = 16 mod 32 bytes.
template <typename T, int DH>
constexpr int kv_ld() {
  return (((DH * (int)sizeof(T) + 31) & ~31) + 16) / (int)sizeof(T);
}

template <typename T, int DH>
struct Smem {
  static constexpr int ldq = DH + 4;  // fp32 q rows: = 4 mod 8 words
  static constexpr int ld = kv_ld<T, DH>();
  static constexpr size_t q_bytes = sizeof(float) * kBQ * ldq;
  static constexpr size_t bytes = q_bytes + sizeof(T) * 2 * 2 * kBK * ld;
};

__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int Hkv, int Sq, int Skv, int causal,
                           int window, float softcap, float scale, int n_qt) {
  using L = Smem<T, DH>;
  constexpr int NT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  T* st = reinterpret_cast<T*>(smem_raw + L::q_bytes);

  // issue order: the longer half of the query tiles longest first, then
  // the shorter half shortest first, so that the blocks a wave pairs on
  // one SM sum to about the same work
  const int BH = gridDim.x / n_qt;
  const int row = blockIdx.x / BH, half = (n_qt + 1) / 2;
  const int qt = row < half ? n_qt - 1 - row : row - half;
  const int bh = blockIdx.x % BH;  // b * H + h
  const int b = bh / H;
  const int kvh = (bh % H) / (H / Hkv);
  const int q_lo = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const T* qb = q + (size_t)bh * Sq * DH;
  const T* kb = k + (size_t)(b * Hkv + kvh) * Skv * DH;
  const T* vb = v + (size_t)(b * Hkv + kvh) * Skv * DH;

  constexpr int C4 = DH / 4;
#pragma unroll 8  // the loads of 8 iterations in flight at once
  for (int idx = tid; idx < kBQ * C4; idx += kThreads) {
    const int r = idx / C4, c = idx - r * C4;
    const int gr = q_lo + r;
    *reinterpret_cast<float4*>(q_s + r * L::ldq + 4 * c) =
        gr < Sq ? load4f(qb + (size_t)gr * DH + 4 * c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the KV tiles some row of the block needs
  const int q_hi = min(Sq, q_lo + kBQ) - 1;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int x = q_lo - window - kBK + 1;  // needed: kt * kBK > x
    kt_begin = x < 0 ? 0 : x / kBK + 1;
  }
  const int n_tiles = kt_end - kt_begin;

  constexpr int kUnits = DH * (int)sizeof(T) / 16;  // 16-byte units per row
  constexpr int kStageElems = 2 * kBK * L::ld;
  auto issue = [&](int i) {
    const int k_lo = (kt_begin + i) * kBK;
    T* ks = st + (i & 1) * kStageElems;
    T* vs = ks + kBK * L::ld;
    for (int idx = tid; idx < kBK * kUnits; idx += kThreads) {
      const int r = idx / kUnits, c = idx - r * kUnits;
      const bool in = k_lo + r < Skv;
      const size_t off = in ? (size_t)(k_lo + r) * DH : 0;
      cp_async16(reinterpret_cast<char*>(ks + r * L::ld) + 16 * c,
                 reinterpret_cast<const char*>(kb + off) + 16 * c, in);
      cp_async16(reinterpret_cast<char*>(vs + r * L::ld) + 16 * c,
                 reinterpret_cast<const char*>(vb + off) + 16 * c, in);
    }
    cp_async_commit();
  };

  const bool warp_live = q_lo + warp * 16 < Sq;
  const int ra = q_lo + warp * 16 + g, rb = ra + 8;
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  if (n_tiles > 0) issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles)
      issue(i + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (warp_live) {
      const T* ks = st + (i & 1) * kStageElems;
      const T* vs = ks + kBK * L::ld;
      const int k_lo = (kt_begin + i) * kBK;
      float sc[4][4];
      warp_scores<kExactTf32<T>, T>(sc, q_s + warp * 16 * L::ldq, L::ldq,
                                    ks, L::ld, NT, lane);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k_lo + n * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? ra : rb;
          float x = sc[n][e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          bool ok = col < Skv;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          sc[n][e] = ok ? x * kLog2e : kNegInf;  // base-2 units
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
          const int col = k_lo + n * 8 + 2 * t4 + (e & 1);
          const float p =
              col < Skv ? exp2f(sc[n][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          sc[n][e] = p;
          if (e < 2)
            sum_a += p;
          else
            sum_b += p;
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
      warp_pv<NT, T>(o, sc, vs, L::ld, NT, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
    T* orow = out + ((size_t)bh * Sq + row) * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(orow + 8 * j, o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Sq, int Skv, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = Smem<T, DH>::bytes;
  static bool opted_in = false;  // the dynamic shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_kernel<T, DH><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Sq, Skv,
      causal, window, softcap, scale, n_qt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Sq, int Skv, int dh,
                     int causal, int window, float softcap, float scale,
                     cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                           softcap, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                           softcap, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                           softcap, scale, st);
    case 112:
      return launch<T, 112>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                            softcap, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                            softcap, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                            softcap, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Element types (dtype): 0 float, 1 bf16 (q, k, v and out share it).
// dh is 16, 32, 64, 112, 128 or 256; window <= 0 means none, softcap <= 0
// none.
// Returns a cudaError_t: cudaErrorInvalidValue for a dtype code or
// shapes the kernel does not take, else the launch's cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Hkv, int Sq, int Skv,
                        int dh, int dtype, int causal, int window,
                        float softcap, float scale, void* stream) {
  if (B < 0 || H < 1 || Hkv < 1 || H % Hkv || Sq < 0 || Skv < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Sq, Skv, dh,
                                        causal, window, softcap, scale, st);
  return (int)dispatch<float>(q, k, v, out, B, H, Hkv, Sq, Skv, dh, causal,
                              window, softcap, scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
