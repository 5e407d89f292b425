// Matmul with fused data preparation on NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/fused_matmul/kernel.py:58 (fused_matmul, the
// Pallas TPU kernel; its body _kernel at :29).  It computes
//   out = x_scale * (f32(x) @ f32(w))      fp32 accumulation
//   x        [M, K]  int8, bf16, fp16 or fp32
//   w        [K, N]  fp32 or bf16
//   x_scale  [M, 1]  fp32, optional (per-row dequantization scale)
//   out      [M, N]  fp32 or bf16, written once
// which is the reference's (x_scale * f32(x)) @ f32(w) with the row scale
// moved past the sum (the same function, rounded in another order; the
// CPU emulation in tests/test_torch_tf32_gemm.py holds both orders to
// float64).  The "data preparation" is fused: x crosses device and shared
// memory at its stored width (int8: a quarter of fp32's bytes) and is
// upcast in registers between the shared tile and the tensor-core
// fragment, so the prepared x exists in neither memory.  That is the
// paper's fused case (§5.2, fig11); the plain version (ref.py::matmul1)
// materializes the prepared x first.
//
// What bounds it on this card: operations.  A call moves M*K*sizeof(x) +
// 4*M + K*N*sizeof(w) + M*N*sizeof(out) bytes (9n^2 + 4n for fig11's int8
// x, fp32 w and out) and does 2*M*N*K flops, 2n/9 flop per byte against a
// TF32 ridge of 495 TFLOP/s / 3.35 TB/s = 148 at one product.  With x
// exact in TF32 (int8, bf16, fp16) and w split, each fp32 product is 2
// TF32 products: 0.0087 ms at fig11's n = 1024 (2.15 GFLOP x 2 at 495
// TFLOP/s), 0.069 ms at n = 2048; fp32 x takes 3 products, bf16 w with an
// exact x 1.  On the fp32 CUDA cores (67 TFLOP/s) the bound was 0.032 and
// 0.256 ms.
//
// Design (common/tf32_gemm.cuh, GemmWgmma): the products run on the
// tensor cores as wgmma m64n64k8 TF32 with fp32 accumulation, 3xTF32
// where an operand is fp32.  wgmma reads tf32 B only K-major from shared
// memory, and w is N-major ([K, N]), so each stage of w, after its
// cp.async copy lands, is split into big and small TF32 halves and
// written K-major (no-swizzle core matrices of 8 rows x 16 bytes) by all
// threads, double-buffered so that stage kt + 1 is split while stage kt's
// wgmmas run.  x is wgmma's A operand from registers: its stage stays at
// stored width in shared memory and each warp upcasts (and, for fp32 x,
// splits) its 16 rows x 8 k fragments in registers.  One block of two
// warpgroups (256 threads) owns a 128 x 64 output tile, each warpgroup 64
// rows against the shared w tile, and walks K in stages of 64 through a
// 3-stage cp.async ring (16-byte copies where the base and row length
// allow, else 4-byte or element copies; ragged edges zero-filled): 148 KB
// of shared memory with int8 x, 220 KB with fp32 x, one block per SM.
// Each stage's wgmmas sum into a fresh accumulator, added into the fp32
// total after the stage (the tensor cores' adds truncate).  Grid
// (ceil(N / 64), ceil(M / 128)): at fig11's n = 1024, 128 blocks on the
// 132 SMs (4 idle; a split of K would need a second pass over an fp32
// partial buffer); at n = 2048, 512 blocks, about 4 per SM in turn.
// Epilogue: the row scale, one multiply per output, then the store in
// the output's type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/tf32_gemm.cuh"

namespace {

using namespace tf32gemm;

constexpr int kStages = 3;

template <typename XT, typename WT>
using Mainloop = GemmWgmma<XT, WT, kStages>;
constexpr int kBM = 128;   // rows of the output tile (x rows)
constexpr int kBN = 64;    // columns of the output tile (w columns)
constexpr int kThreads = 256;

template <typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(kThreads)
    fused_matmul_kernel(Src x, Src w, const float* __restrict__ x_scale,
                        OT* __restrict__ out, int M, int N, int K) {
  using G = Mainloop<XT, WT>;
  static_assert(G::BM == kBM && G::BN == kBN && G::kThreads == kThreads,
                "one tile");
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  x.origin = (long long)m0 * x.ld;
  x.valid = M - m0;
  w.origin = (long long)n0 * sizeof(WT);
  w.valid = N - n0;
  float acc[32];  // columns past N compute zeros
  G::run(acc, smem, x, w, K);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the warp's 16
    const int m = m0 + 16 * warp + g + 8 * h;
    if (m >= M) continue;
    const float sc = x_scale != nullptr ? x_scale[m] : 1.f;
    OT* orow = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n < N) orow[n] = from_f32<OT>(sc * acc[4 * j + 2 * h]);
      if (n + 1 < N) orow[n + 1] = from_f32<OT>(sc * acc[4 * j + 2 * h + 1]);
    }
  }
}

template <typename XT, typename WT, typename OT>
cudaError_t launch(const void* x, const void* w, const float* x_scale,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  using G = Mainloop<XT, WT>;
  static bool opted_in = false;  // the dynamic shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_matmul_kernel<XT, WT, OT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const long long x_ld = (long long)K * sizeof(XT);
  const long long w_ld = (long long)N * sizeof(WT);
  const Src xs{static_cast<const unsigned char*>(x), x_ld, 0, 0,
               copy_width(x, x_ld)};
  const Src ws{static_cast<const unsigned char*>(w), w_ld, 0, 0,
               copy_width(w, w_ld)};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fused_matmul_kernel<XT, WT, OT><<<grid, G::kThreads, G::kSmemBytes,
                                    stream>>>(
      xs, ws, x_scale, static_cast<OT*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename XT, typename WT>
cudaError_t launch_out(const void* x, const void* w, const float* x_scale,
                       void* out, int M, int N, int K, int out_dtype,
                       cudaStream_t stream) {
  if (out_dtype == 1)
    return launch<XT, WT, __nv_bfloat16>(x, w, x_scale, out, M, N, K, stream);
  return launch<XT, WT, float>(x, w, x_scale, out, M, N, K, stream);
}

template <typename XT>
cudaError_t launch_w(const void* x, const void* w, const float* x_scale,
                     void* out, int M, int N, int K, int w_dtype,
                     int out_dtype, cudaStream_t stream) {
  if (w_dtype == 1)
    return launch_out<XT, __nv_bfloat16>(x, w, x_scale, out, M, N, K,
                                         out_dtype, stream);
  return launch_out<XT, float>(x, w, x_scale, out, M, N, K, out_dtype,
                               stream);
}

}  // namespace

extern "C" {

// Element types: x_dtype 0 float, 1 bf16, 2 fp16, 3 int8; w_dtype 0 float,
// 1 bf16; out_dtype 0 float, 1 bf16.  x_scale may be null (no row scale).
// Every pointer is row-major and contiguous.  Returns a cudaError_t:
// cudaErrorInvalidValue for a dtype code or shapes the kernel does not
// take, else the launch's cudaGetLastError().
int fused_matmul_fwd(const void* x, const void* w, const float* x_scale,
                     void* out, int M, int N, int K, int x_dtype, int w_dtype,
                     int out_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || x_dtype < 0 || x_dtype > 3 || w_dtype < 0 ||
      w_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 1:
      return (int)launch_w<__nv_bfloat16>(x, w, x_scale, out, M, N, K,
                                          w_dtype, out_dtype, st);
    case 2:
      return (int)launch_w<__half>(x, w, x_scale, out, M, N, K, w_dtype,
                                   out_dtype, st);
    case 3:
      return (int)launch_w<int8_t>(x, w, x_scale, out, M, N, K, w_dtype,
                                   out_dtype, st);
    default:
      return (int)launch_w<float>(x, w, x_scale, out, M, N, K, w_dtype,
                                  out_dtype, st);
  }
}

const char* fused_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
