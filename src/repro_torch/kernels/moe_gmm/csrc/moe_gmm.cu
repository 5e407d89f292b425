// Grouped per-expert matmul for MoE FFNs on NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/moe_gmm/kernel.py:49 (moe_gmm, the Pallas TPU
// kernel; its body _kernel at :24).  For each group g and expert e:
//   out[g, e] = x[g, e] @ w[e]
//   x          [G, E, C, D]   float or bf16 (C = capacity rows per expert)
//   w          [E, D, F]      same type, shared by all groups
//   row_counts [G, E] int32   optional: rows >= row_counts[g, e] are padding
//   out        [G, E, C, F]   x's type; fp32 accumulation
// Rows at or past the count are written as exactly 0, as the oracle
// (ref.py::moe_gmm_ref) does.  The Pallas kernel skips only the tiles
// whose first row is past the count and computes the other padding rows;
// both agree inside the MoE layer, where padding rows of x are 0.  The
// kernel reads row_counts itself; the host never does.
//
// What bounds it on this card: bytes.  At the main path's shape (dbrx
// gate/up: E = 16, C = 80, D = 6144, F = 10752, 978 live rows) a call
// needs x, the live experts' w and the output, 4.32 GB (1.29 ms at 3.35
// TB/s), and 2 * sum(counts) * D * F = 129 GFLOP, which at 3 TF32 products
// per fp32 product on the tensor cores take 0.78 ms at 495 TFLOP/s (1.93
// ms on the fp32 CUDA cores).  So each live expert's w must stream from
// device memory once, with the products hidden under the stream.
//
// Design (common/tf32_gemm.cuh): the product is computed transposed,
// out^T = w^T x^T, so that F is the tensor cores' M side and the expert's
// rows their N side, in n8 tiles that the 2 warps along the rows take in
// turn, so a pass computes its live rows rounded up to 16: an expert with
// 65-80 live rows computes 80, not two tiles of 64.  One block of 256
// threads (4 x 2 warps) per (group, expert, 128-column F tile) covers
// every live row of
// that expert, so each w tile is read from device memory once per pass;
// an expert with more than 128 live rows takes further passes over the
// same F tile, 128 rows each.  The block reads its count: rows in
// [count, ceil16(count)) are zero-filled copies, the n8 tiles past them
// are neither loaded nor computed, and a block whose count is 0 writes zeros
// and reads no w.  Products: mma.sync m16n8k8 TF32 with fp32
// accumulation (common/tf32_gemm.cuh, Gemm), 3 TF32 products per fp32
// product for fp32 (3xTF32, fp32 accuracy), 1 for bf16 (exact in TF32),
// each 64-deep stage summed apart and promoted into the fp32 total.
// mma.sync, not wgmma: the expert's live rows are the MMA's N side, which
// wgmma fixes in the instruction (m64nNk8) and mma.sync steps by 8 at run
// time, and the bound here is bytes, not the tensor rate.  Loads: a
// 3-stage ring of 64-deep K stages (204 KB in fp32, one block per SM; 108
// KB in bf16) filled by 16-byte cp.async where D and F allow, else 4-byte
// or element copies.  Grid (ceil(F / 128), G * E): consecutive blocks
// share one expert's x (from L2) and stream disjoint columns of its w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/tf32_gemm.cuh"

namespace {

using namespace tf32gemm;

constexpr int kBF = 128;    // F columns per block (the MMA's M side)
constexpr int kBR = 128;    // expert rows per pass (the MMA's N side)
constexpr int kRowStep = 16;  // rows computed per pass: n8 tiles x kWN
constexpr int kWM = 4;      // warps along F
constexpr int kWN = 2;      // warps along rows
constexpr int kStages = 3;
constexpr int kThreads = 32 * kWM * kWN;

template <typename T>
using Mainloop = Gemm<T, false, T, true, kBF, kBR, kWM, kWN, kStages>;

// One pass: up to kBR live rows of one expert (from ob, its first output
// row) against a kBF-column tile of its w, with ntl n8 tiles per warp (a
// compile-time NTL from 1 up to the mainloop's NT, chosen at run time).
template <typename T, int NTL>
__device__ __forceinline__ void pass(int ntl, unsigned char* smem,
                                     const Src& w, const Src& x, T* ob,
                                     int rows, int f0, int D, int F) {
  using G = Mainloop<T>;
  if constexpr (NTL < G::NT) {
    if (ntl > NTL) {
      pass<T, NTL + 1>(ntl, smem, w, x, ob, rows, f0, D, F);
      return;
    }
  }
  float acc[G::MT][NTL][4];
  G::template run<NTL>(acc, smem, w, x, D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kWM, wn = warp / kWM;
  const int g = lane >> 2, t = lane & 3;
  // C fragment element q of (m16 tile i, n8 tile j): column f = g (+8),
  // row 2t (+1)
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = f0 + wm * (kBF / kWM) + 16 * i + g + 8 * (q >> 1);
        const int r = (j * kWN + wn) * 8 + 2 * t + (q & 1);
        if (r < rows && f < F)
          ob[(size_t)r * F + f] = from_f32<T>(acc[i][j][q]);
      }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_gmm_kernel(Src w, Src x, const int* __restrict__ row_counts,
                   T* __restrict__ out, int E, int C, int D, int F) {
  using G = Mainloop<T>;
  static_assert(kRowStep == 8 * kWN && G::kThreads == kThreads,
                "the mainloop's n8 tiles and thread count");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ge = blockIdx.y;  // group * E + expert
  const int e = ge % E;
  const int f0 = blockIdx.x * kBF;
  int count = row_counts != nullptr ? row_counts[ge] : C;
  count = count < 0 ? 0 : (count > C ? C : count);
  T* ob = out + (size_t)ge * C * F;

  w.origin = (long long)e * D * w.ld + (long long)f0 * sizeof(T);
  w.valid = F - f0;
  for (int r0 = 0; r0 < count; r0 += kBR) {
    const int rows = min(kBR, count - r0);
    x.origin = ((long long)ge * C + r0) * x.ld;
    x.valid = rows;
    pass<T, 1>(G::tiles_for(rows), smem, w, x, ob + (size_t)r0 * F, rows, f0,
               D, F);
    __syncthreads();  // the next pass refills the ring
  }
  // rows at or past the count: exactly 0
  const int cols = min(kBF, F - f0);
  for (int idx = threadIdx.x; idx < (C - count) * cols; idx += kThreads) {
    const int r = count + idx / cols, c = idx % cols;
    ob[(size_t)r * F + f0 + c] = from_f32<T>(0.f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* row_counts,
                   void* out, int G, int E, int C, int D, int F,
                   cudaStream_t stream) {
  using M = Mainloop<T>;
  static bool opted_in = false;  // the dynamic shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        M::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const long long w_ld = (long long)F * sizeof(T);
  const long long x_ld = (long long)D * sizeof(T);
  const Src ws{static_cast<const unsigned char*>(w), w_ld, 0, 0,
               copy_width(w, w_ld)};
  const Src xs{static_cast<const unsigned char*>(x), x_ld, 0, 0,
               copy_width(x, x_ld)};
  const dim3 grid((F + kBF - 1) / kBF, G * E);
  moe_gmm_kernel<T><<<grid, M::kThreads, M::kSmemBytes, stream>>>(
      ws, xs, row_counts, static_cast<T*>(out), E, C, D, F);
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
  if ((long long)G * E > 65535) return (int)cudaErrorInvalidValue;
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
