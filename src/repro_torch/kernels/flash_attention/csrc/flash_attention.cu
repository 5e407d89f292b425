// Blockwise (flash) attention forward on NVIDIA Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas TPU kernel).  For each batch b and query head h:
//   out[b, h] = softmax(mask(softcap(q[b, h] @ k[b, kvh]^T * scale))) @ v[b, kvh]
//   q    [B, H, Sq, dh]     float or bf16
//   k, v [B, Hkv, Skv, dh]  same type;  kvh = h / (H / Hkv)  (GQA)
//   out  [B, H, Sq, dh]     q's type; every product and the softmax in fp32
// Query i sits at key position i: the causal mask keeps cols <= rows, a
// window keeps cols > rows - window.  The softcap comes before the mask,
// and the mask is the finite -1e30 of the Pallas kernel, with its
// arithmetic: a row that sees no valid key in a tile while its running
// max is still -1e30 takes p = exp(0) = 1 on that tile's masked columns,
// and the first tile with a valid key wipes them out (corr = exp(-1e30 -
// m) = 0), exactly as in the Pallas kernel.  Keys past Skv (the ragged
// last tile) take no part at all: p = 0 and no share of the max.
//
// Grid (ceil(Sq / 64), B * H).  One block of 256 threads owns 64 query
// rows of one (b, h), held in shared memory (transposed, fp32) for the
// whole KV walk.  It walks the KV tiles of 64 keys in order and skips a
// tile that the causal or window structure masks for every row of the
// block (the Pallas kernel's `needed` rule).  For each tile it stages K
// (transposed) and V in shared memory as fp32, and each thread computes a
// 4 x 4 register tile of scores (rows ty*4.., keys tx*4..; one float4 of
// Q and one of K per depth step feed 16 FMAs).  The running max and
// denominator of its 4 rows are reduced over the 16 lanes that share the
// rows with warp shuffles; the probabilities go back to shared memory
// (transposed) and each thread accumulates its 4 rows x dh/16 output
// dims in registers, in fp32 (read from V as float4s, float2s or, at
// dh = 112, zamba2's head dim, one float at a time).  Rows and keys past Sq and Skv are
// bounds-checked: no length needs to divide the tile.  The shared memory
// (120 KB at dh = 128, 217 KB at dh = 256) is dynamic, after the opt-in.
//
// What bounds it on this card: operations.  At the main path's shape
// (internlm2 prefill: B = 1, H = 16, Hkv = 8, dh = 128, causal, S = 1024)
// the live scores need 4 * H * S(S+1)/2 * dh = 4.3 GFLOP, 0.064 ms at
// the 67 TFLOP/s fp32 CUDA-core rate, against 25 MB of q, k, v and out,
// 0.0075 ms at 3.35 TB/s.  This version is right and simple: fp32 FMAs on
// CUDA cores, plain loads with no cp.async or TMA pipeline, one block per
// SM at dh = 128, and full 64 x 64 tiles on the causal diagonal.  A later
// PR makes it fast with wgmma tiles fed by TMA (bf16, or TF32 where the
// caller accepts another numeric result), warp specialisation and a
// split over KV for short query counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kLd = kBQ + 4;     // leading dim of the transposed tiles
constexpr float kNegInf = -1e30f;

static_assert(kBQ == kBK, "the transposed tiles share one leading dim");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory layout, in floats: Qs[DH][kLd], Ks[DH][kLd], Vs[kBK][DH],
// Pt[kBK][kLd] (probabilities, key-major).
template <int DH>
struct Smem {
  static constexpr int q = DH * kLd;
  static constexpr int k = DH * kLd;
  static constexpr int v = kBK * DH;
  static constexpr int p = kBK * kLd;
  static constexpr size_t bytes = sizeof(float) * (q + k + v + p);
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int Hkv, int Sq, int Skv, int causal,
                           int window, float softcap, float scale) {
  constexpr int DPT = DH / 16;  // output dims per thread
  // dims per vector load of V: 4, 2 or 1 (DH = 112: DPT = 7, scalar)
  constexpr int VEC = DPT % 4 == 0 ? 4 : DPT % 2 == 0 ? 2 : 1;
  constexpr int NV = DPT / VEC;  // vector loads per V row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<DH>::q;
  float* Vs = Ks + Smem<DH>::k;
  float* Pt = Vs + Smem<DH>::v;

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int kvh = (bh % H) / (H / Hkv);
  const int q_lo = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx*4.. / output dims
  const int ty = tid / 16;  // query rows ty*4..

  const T* qb = q + (size_t)bh * Sq * DH;
  const T* kb = k + (size_t)(b * Hkv + kvh) * Skv * DH;
  const T* vb = v + (size_t)(b * Hkv + kvh) * Skv * DH;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    const int gr = q_lo + r;
    Qs[d * kLd + r] = gr < Sq ? to_float(qb[(size_t)gr * DH + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int nkt = (Skv + kBK - 1) / kBK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k_lo = kt * kBK;
    bool needed = true;
    if (causal) needed = k_lo <= q_lo + kBQ - 1;
    if (window > 0) needed = needed && (k_lo + kBK - 1 > q_lo - window);
    if (!needed) continue;  // the same for the whole block

    __syncthreads();  // the last tile's readers are done with Ks, Vs, Pt
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int c = idx / DH, d = idx % DH;
      const int gc = k_lo + c;
      const bool in = gc < Skv;
      Ks[d * kLd + c] = in ? to_float(kb[(size_t)gc * DH + d]) : 0.f;
      Vs[c * DH + d] = in ? to_float(vb[(size_t)gc * DH + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * kLd + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // scale, softcap, mask, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_lo + tx * 4 + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = col < Skv;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_lo + tx * 4 + j;
        const float p = col < Skv ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kLd + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int kmax = min(kBK, Skv - k_lo);
    for (int c = 0; c < kmax; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[c * kLd + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vrow = Vs + c * DH + tx * VEC;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + n * 16 * VEC);
          vv[0] = t.x;
          vv[1] = t.y;
          vv[2] = t.z;
          vv[3] = t.w;
        } else if constexpr (VEC == 2) {
          const float2 t = *reinterpret_cast<const float2*>(vrow + n * 16 * VEC);
          vv[0] = t.x;
          vv[1] = t.y;
        } else {
          vv[0] = vrow[n * 16];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][n * VEC + e] = fmaf(pv[i], vv[e], acc[i][n * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * Sq + row) * DH;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[n * 16 * VEC + tx * VEC + e] =
            from_float<T>(acc[i][n * VEC + e] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Sq, int Skv, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = Smem<DH>::bytes;
  static bool opted_in = false;  // the dynamic shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Sq, Skv,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Sq, int Skv, int dh,
                     int causal, int window, float softcap, float scale,
                     cudaStream_t st) {
  switch (dh) {
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
// dh is 32, 64, 112, 128 or 256; window <= 0 means none, softcap <= 0
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
