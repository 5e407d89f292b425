// Grouped per-expert matmul for MoE FFNs on NVIDIA Hopper (sm_90a).
//
// Replaces repro/kernels/moe_gmm/kernel.py::moe_gmm (the Pallas TPU
// kernel).  For each group g and expert e:
//   out[g, e] = x[g, e] @ w[e]
//   x          [G, E, C, D]   float or bf16 (C = capacity rows per expert)
//   w          [E, D, F]      same type, shared by all groups
//   row_counts [G, E] int32   optional: rows >= row_counts[g, e] are padding
//   out        [G, E, C, F]   x's type; fp32 accumulation
// Rows at or past the count are written as exactly 0, as the oracle
// (ref.py::moe_gmm_ref) does.  The Pallas kernel skips only the tiles
// whose first row is past the count and computes the other padding rows;
// both agree inside the MoE layer, where padding rows of x are 0.
//
// Grid (ceil(F / 128), ceil(C / 64), G * E).  One block of 256 threads
// owns a 64 x 128 output tile of one (group, expert).  A block whose first
// row is at or past the count writes zeros and does no K loop (the TPU
// kernel's tile skip).  Otherwise it walks D in steps of 16: the x tile
// (64 x 16, stored transposed so a thread reads its 4 rows as one float4)
// and the w tile (16 x 128) are staged in shared memory as fp32, the next
// step's tiles are loaded into registers while this step's are used, and
// each thread keeps a 4 x 8 register micro-tile (rows ty*4.., columns
// tx*4.. and 64+tx*4.., so a warp's float4 reads of the w tile hit 32
// distinct banks).  Rows past the count are loaded as 0 and never read
// from memory.  Every edge is bounds-checked: C, D and F need not divide
// the tile.
//
// What bounds it on this card: operations.  At the main path's shape
// (dbrx: E = 16, C = 80, D = 6144, F = 10752; about 60 of the 80 rows of
// an expert are live at capacity factor 1.25) a call does
// 2 * sum(counts) * D * F flops (~130 GFLOP, ~1.9 ms at the 67 TFLOP/s
// fp32 CUDA-core rate) against ~4.3 GB of x, live expert weights and
// output (~1.3 ms at 3.35 TB/s).  Each output is one fp32 FMA chain in k
// order.  This version is right and simple: fp32 FMAs on CUDA cores, no
// cp.async or TMA pipeline, and a 64-row tile that wastes most of a
// second tile when a count lies just above 64.  A later PR makes it fast
// with bf16 / TF32 wgmma tiles fed by TMA (a different numeric result for
// fp32, so only where the caller asks for it), a ragged row tiling, and a
// persistent grid over (expert, tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;        // rows of the output tile
constexpr int kBN = 128;       // columns of the output tile
constexpr int kBK = 16;        // depth of one K step
constexpr int kPadA = 4;       // keeps float4 reads aligned, spreads banks
constexpr int kTM = 4;         // micro-tile rows per thread
constexpr int kTN = 8;         // micro-tile columns per thread
constexpr int kALoads = kBM * kBK / kThreads;   // 4
constexpr int kBLoads = kBK * kBN / kThreads;   // 8

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

// Column of micro-tile column j of thread tx inside the 128-wide tile.
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ row_counts, T* __restrict__ out,
                   int E, int C, int D, int F) {
  const int ge = blockIdx.z;  // group * E + expert
  const int e = ge % E;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  int count = row_counts != nullptr ? row_counts[ge] : C;
  count = count < 0 ? 0 : (count > C ? C : count);

  const T* xb = x + (size_t)ge * C * D;
  const T* wb = w + (size_t)e * D * F;
  T* ob = out + (size_t)ge * C * F;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  if (m0 < count) {
    __shared__ __align__(16) float As[kBK][kBM + kPadA];
    __shared__ __align__(16) float Bs[kBK][kBN];
    float ra[kALoads];
    float rb[kBLoads];

    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < kALoads; ++i) {
        const int idx = tid + i * kThreads;
        const int gm = m0 + idx / kBK;
        const int gk = k0 + idx % kBK;
        ra[i] = (gm < count && gk < D) ? to_float(xb[(size_t)gm * D + gk])
                                       : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBLoads; ++i) {
        const int idx = tid + i * kThreads;
        const int gk = k0 + idx / kBN;
        const int gn = n0 + idx % kBN;
        rb[i] = (gk < D && gn < F) ? to_float(wb[(size_t)gk * F + gn]) : 0.f;
      }
    };

    load(0);
    for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
      for (int i = 0; i < kALoads; ++i) {
        const int idx = tid + i * kThreads;
        As[idx % kBK][idx / kBK] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < kBLoads; ++i) {
        const int idx = tid + i * kThreads;
        Bs[idx / kBN][idx % kBN] = rb[i];
      }
      __syncthreads();
      if (k0 + kBK < D) load(k0 + kBK);  // in flight during the FMAs below
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        const float av[kTM] = {a.x, a.y, a.z, a.w};
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue (also the whole work of a skipped tile): rows past the count
  // are written as 0.
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= C) continue;
    const bool live = gm < count;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tile_col(tx, j);
      if (gn < F)
        ob[(size_t)gm * F + gn] = from_float<T>(live ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* row_counts,
                   void* out, int G, int E, int C, int D, int F,
                   cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, G * E);
  moe_gmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), row_counts,
      static_cast<T*>(out), E, C, D, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Element types (dtype): 0 float, 1 bf16 (x, w and out share it).
// row_counts may be null (every row is live).  Returns a cudaError_t:
// cudaErrorInvalidValue for a dtype code or shapes the kernel does not
// take, else the launch's cudaGetLastError().
int moe_gmm_fwd(const void* x, const void* w, const int* row_counts,
                void* out, int G, int E, int C, int D, int F, int dtype,
                void* stream) {
  if (G < 0 || E < 0 || C < 0 || D < 0 || F < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E > 65535 || (C + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || E == 0 || C == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, row_counts, out, G, E, C, D, F,
                                      st);
  return (int)launch<float>(x, w, row_counts, out, G, E, C, D, F, st);
}

const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
