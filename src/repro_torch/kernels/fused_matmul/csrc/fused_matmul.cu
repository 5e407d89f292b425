// Matmul with fused data preparation on NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/fused_matmul/kernel.py:58 (fused_matmul, the
// Pallas TPU kernel; its body _kernel at :29).  It computes
//   out = (x_scale * f32(x)) @ f32(w)      fp32 accumulation
//   x        [M, K]  int8, bf16, fp16 or fp32
//   w        [K, N]  fp32 or bf16
//   x_scale  [M, 1]  fp32, optional (per-row dequantization scale)
//   out      [M, N]  fp32 or bf16, written once
// The "data preparation" (upcast to fp32 and the row scale) happens per
// tile, on its way from device memory into shared memory, inside the
// kernel that consumes the tile: the prepared x never reaches device
// memory.  That is the paper's fused case (§5.2, fig11); the plain
// version (ref.py::matmul1) materializes the prepared x first.
//
// Grid (ceil(N / 128), ceil(M / 64)).  One block of 256 threads owns a
// 64 x 128 output tile and walks K in steps of 16 (the loop takes the
// place of the Pallas grid's sequential K dimension and its acc_ref
// scratch; the sum stays in registers).  Each step, the x tile (64 x 16
// at its stored width: 64 to 256 sixteen-byte loads) and the w tile
// (16 x 128: 256 or 512 sixteen-byte loads) are read into registers one
// step ahead, converted to fp32 (x also times its row's scale) and stored
// in shared memory, x transposed so that a thread reads its 4 rows as one
// float4.  Each thread keeps a 4 x 8 register micro-tile (rows ty*4..,
// columns tx*4.. and 64+tx*4..) and runs fp32 FMAs on the CUDA cores, one
// chain per output in k order: no TF32, bf16 or int8 tensor-core path,
// because the reference computes in fp32.  Ragged M, N and K edges are
// masked: a load past an edge reads 0, a store past it is dropped.
// Sixteen-byte loads need a 16-byte-aligned base and a row length that is
// a multiple of the chunk (K for x, N for w); otherwise the same chunks
// are read element by element.
//
// What bounds it on this card: operations, for square n >~ 90.  A call
// moves M*K*sizeof(x) + 4*M + K*N*sizeof(w) + M*N*sizeof(out) bytes
// (9n^2 + 4n for int8 x, fp32 w and out) and does 2*M*N*K flops, an
// intensity of 2n/9 flop per byte against the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20.  At fig11's n = 1024 the bound is
// 0.032 ms (2.15 GFLOP); the bytes alone take 0.0028 ms.  This version
// is right and simple: fp32 FMAs from shared memory with register
// prefetch, no cp.async or TMA pipeline, 128 blocks at n = 1024 (one per
// SM, 8 warps each).  Fusion saves the prepared matrix's write and read
// (8n^2 bytes), a few microseconds at n = 1024: on this card only a
// fast product makes that visible.  A later version runs the product
// on tensor cores (wgmma fed by TMA, where the caller accepts TF32 or
// bf16 numerics) with a persistent grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// Raw bits of one element, zero-extended to 32 bits.
__device__ __forceinline__ uint32_t raw_bits(int8_t v) {
  return static_cast<uint8_t>(v);
}
__device__ __forceinline__ uint32_t raw_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t raw_bits(__half v) {
  return __half_as_ushort(v);
}
__device__ __forceinline__ uint32_t raw_bits(float v) {
  return __float_as_uint(v);
}

// Element j (of 4 / sizeof(T)) of a 32-bit word, as fp32: the upcast.
template <typename T>
__device__ __forceinline__ float word_elem(uint32_t w, int j);
template <>
__device__ __forceinline__ float word_elem<int8_t>(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xffu));
}
template <>
__device__ __forceinline__ float word_elem<__nv_bfloat16>(uint32_t w, int j) {
  return __uint_as_float(j == 0 ? (w << 16) : (w & 0xffff0000u));
}
template <>
__device__ __forceinline__ float word_elem<__half>(uint32_t w, int j) {
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(j == 0 ? (w & 0xffffu) : (w >> 16))));
}
template <>
__device__ __forceinline__ float word_elem<float>(uint32_t w, int) {
  return __uint_as_float(w);
}

// One 16-byte chunk: elements [col, col + 16 / sizeof(T)) of row `row` of
// a row-major [rows, cols] matrix, at stored width.  Elements past an
// edge read as 0 (all-zero bits are 0 in every type here).
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ p, int row,
                                            int col, int rows, int cols,
                                            bool vec) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kPer = 4 / sizeof(T);  // elements per 32-bit word
  if (row >= rows || col >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const T* src = p + (size_t)row * cols + col;
  if (vec && col + kE <= cols)
    return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kE; ++j)
    if (col + j < cols)
      w[j / kPer] |= raw_bits(src[j]) << (8 * sizeof(T) * (j % kPer));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The chunk's elements as fp32, times `scale`.
template <typename T>
__device__ __forceinline__ void unpack(uint4 raw, float scale,
                                       float (&out)[16 / sizeof(T)]) {
  constexpr int kPer = 4 / sizeof(T);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j)
    out[j] = word_elem<T>(w[j / kPer], j % kPer) * scale;
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

template <typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(kThreads)
    fused_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                        const float* __restrict__ x_scale,
                        OT* __restrict__ out, int M, int N, int K,
                        bool vec_x, bool vec_w) {
  constexpr int kEX = 16 / sizeof(XT);             // x elements per chunk
  constexpr int kXChunks = kBM * kBK / kEX;        // 64 .. 256
  constexpr int kXRowChunks = kBK / kEX;           // chunks per tile row
  constexpr int kEW = 16 / sizeof(WT);             // w elements per chunk
  constexpr int kWRowChunks = kBN / kEW;           // 32 or 16
  constexpr int kWLoads = kBK * kWRowChunks / kThreads;  // 2 or 1
  static_assert(kXChunks <= kThreads, "one x chunk per thread at most");
  static_assert(kWLoads * kThreads == kBK * kWRowChunks, "w chunks");

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // This thread's x chunk: a fixed tile row and column range for every
  // K step, so its row scale is read once.
  const bool loads_x = tid < kXChunks;
  const int xr = tid / kXRowChunks;
  const int xc = (tid % kXRowChunks) * kEX;
  float scale = 1.f;
  if (loads_x && x_scale != nullptr && m0 + xr < M) scale = x_scale[m0 + xr];

  __shared__ __align__(16) float As[kBK][kBM + kPadA];
  __shared__ __align__(16) float Bs[kBK][kBN];
  uint4 rx = make_uint4(0u, 0u, 0u, 0u);
  uint4 rw[kWLoads];

  auto load = [&](int k0) {
    if (loads_x) rx = load_chunk<XT>(x, m0 + xr, k0 + xc, M, K, vec_x);
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kThreads;
      rw[i] = load_chunk<WT>(w, k0 + idx / kWRowChunks,
                             n0 + (idx % kWRowChunks) * kEW, K, N, vec_w);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    // the fused prep: upcast and row scale on the way into shared memory
    if (loads_x) {
      float v[kEX];
      unpack<XT>(rx, scale, v);
#pragma unroll
      for (int j = 0; j < kEX; ++j) As[xc + j][xr] = v[j];
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kThreads;
      float v[kEW];
      unpack<WT>(rw[i], 1.f, v);
      float* dst = &Bs[idx / kWRowChunks][(idx % kWRowChunks) * kEW];
#pragma unroll
      for (int j = 0; j < kEW; j += 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);  // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tile_col(tx, j);
      if (gn < N) out[(size_t)gm * N + gn] = from_float<OT>(acc[i][j]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename XT, typename WT, typename OT>
cudaError_t launch(const void* x, const void* w, const float* x_scale,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const bool vec_x = aligned16(x) && K % (16 / (int)sizeof(XT)) == 0;
  const bool vec_w = aligned16(w) && N % (16 / (int)sizeof(WT)) == 0;
  fused_matmul_kernel<XT, WT, OT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), x_scale,
      static_cast<OT*>(out), M, N, K, vec_x, vec_w);
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
