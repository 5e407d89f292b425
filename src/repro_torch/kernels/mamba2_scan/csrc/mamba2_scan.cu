// Mamba2 (SSD) selective scan on NVIDIA Hopper (sm_90a), fp32.
//
// Replaces repro/kernels/mamba2_scan/kernel.py::mamba2_scan (the Pallas TPU
// kernel) and is the only Mamba2 prefill scan of the port on the card.  For
// every stream (batch b, head h) it runs the recurrence
//   h_t = exp(dt_t * a) h_{t-1} + dt_t * b_t (x) x_t      state [N, P]
//   y_t = c_t . h_t                                       y     [P]
// from h_0 (zero, or an initial state) over t = 0 .. S-1, and returns y
// [.., S, .., P] and the final state [B*H, N, P].  The Pallas kernel
// computes the same thing in its chunked SSD form (two MXU products per
// chunk, the state in VMEM between chunks); this version runs the plain
// recurrence with the state in registers, which needs no chunk size: any
// S, every edge bounds-checked.
//
// Layout.  Every operand is addressed through element strides over
// (batch, head, time), so one entry point reads both layouts without a
// copy: the Pallas layout (x [BH,S,P], dt [BH,S], b/c [BH,S,N], a [BH]:
// B = BH streams of one head each) and the model's (x [B,S,H,P], dt
// [B,S,H], b/c [B,S,N] shared by the H heads of a batch row with head
// stride 0, a [H]).  The innermost (P or N) stride is 1.  y takes x's
// strides; h0 and the final state are [B*H, N, P] contiguous.
//
// Grid (ceil(P / 32), B * H), 128 threads.  A block owns 32 channels p of
// one stream.  Lane l of warp w holds channel w * 8 + l / 4 and a quarter
// of the state rows: n = 16 j + 4 (l % 4) + i for i < 4, so four lanes side
// by side share one channel and read b/c as float4s that a quarter warp
// takes in one transaction.  N is padded with zero rows to 16, 32, 64 or
// 128 (a template parameter), so each thread keeps N/4 state values in
// registers.  Time runs in stages of 32 steps: x, b, c and dt of a stage
// (rows past S read as x = b = c = dt = 0, which leaves the state as it
// is) are staged in shared memory with exp(dt * a) computed once per step,
// and the next stage's loads are issued into registers before this
// stage's steps run; then every thread runs the 32 steps on its registers, y is reduced over
// the four lanes of a channel with two shuffles and staged in shared
// memory, and the stage's y rows are written out coalesced.
//
// What bounds it on this card: operations.  At zamba2-7b's prefill (B = 1,
// H = 112, S = 1024, P = N = 64) the recurrence needs 4 * BH * S * N * P =
// 1.9 GFLOP (a multiply and an add for the state, a multiply and an add
// for y), 0.028 ms at the 67 TFLOP/s fp32 CUDA-core rate, against 61 MB
// (x, y, b, c, dt, the state), 0.018 ms at 3.35 TB/s.  This version is
// right and simple: each stream's 1024 steps run in order, with 224
// blocks for 132 SMs, 4 warps each.  A
// later PR makes it fast with the chunked SSD form on tensor cores (the
// intra-chunk products as wgmma tiles) and a cp.async / TMA ring.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPT = 32;  // channels p per block
constexpr int kT = 32;   // time steps per stage

// NPT: state rows per thread; NP = 4 * NPT rows staged (N padded).
template <int NPT>
__global__ void __launch_bounds__(kThreads)
    mamba2_scan_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ bm,
                       const float* __restrict__ cm,
                       const float* __restrict__ a,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ hout, int H, int S, int P, int N,
                       int x_sb, int x_sh, int x_st, int dt_sb, int dt_sh,
                       int dt_st, int bc_sb, int bc_sh, int bc_st, int a_sb,
                       int a_sh) {
  constexpr int NP = 4 * NPT;
  static_assert(NPT % 4 == 0, "float4 reads of b and c");
  __shared__ __align__(16) float xs[kT][kPT];
  __shared__ __align__(16) float bs[kT][NP];
  __shared__ __align__(16) float cs[kT][NP];
  __shared__ __align__(16) float ys[kT][kPT];
  __shared__ float dts[kT];
  __shared__ float das[kT];

  const int stream = blockIdx.y;  // b * H + h
  const int bi = stream / H, hi = stream % H;
  const int p0 = blockIdx.x * kPT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int pl = warp * 8 + (lane >> 2);  // this thread's channel, local
  const int ng = lane & 3;                // its quarter of the state rows
  const int p = p0 + pl;

  const int64_t xoff = (int64_t)bi * x_sb + (int64_t)hi * x_sh;
  const int64_t dtoff = (int64_t)bi * dt_sb + (int64_t)hi * dt_sh;
  const int64_t bcoff = (int64_t)bi * bc_sb + (int64_t)hi * bc_sh;
  const float av = a[(int64_t)bi * a_sb + (int64_t)hi * a_sh];

  float h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = (j / 4) * 16 + ng * 4 + (j % 4);
    h[j] = (h0 != nullptr && n < N && p < P)
               ? h0[((int64_t)stream * N + n) * P + p]
               : 0.f;
  }

  // stage loads go through registers: the next stage's loads are issued
  // before this stage's steps run, so their latency hides behind them
  constexpr int XL = kT * kPT / kThreads;  // x values per thread per stage
  constexpr int BL = kT * NP / kThreads;   // b (and c) values per thread
  float xr[XL], br[BL], cr[BL], dr = 0.f;
  auto load = [&](int t0) {
    const int tn = min(kT, S - t0);
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * kThreads;
      const int t = idx / kPT, pp = idx % kPT;
      xr[i] = (t < tn && p0 + pp < P)
                  ? x[xoff + (int64_t)(t0 + t) * x_st + p0 + pp]
                  : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BL; ++i) {
      const int idx = tid + i * kThreads;
      const int t = idx / NP, n = idx % NP;
      const bool in = t < tn && n < N;
      const int64_t off = bcoff + (int64_t)(t0 + t) * bc_st + n;
      br[i] = in ? bm[off] : 0.f;
      cr[i] = in ? cm[off] : 0.f;
    }
    if (tid < kT) dr = tid < tn ? dt[dtoff + (int64_t)(t0 + tid) * dt_st] : 0.f;
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tn = min(kT, S - t0);
    __syncthreads();  // the last stage's readers are done
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int idx = tid + i * kThreads;
      xs[idx / kPT][idx % kPT] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < BL; ++i) {
      const int idx = tid + i * kThreads;
      bs[idx / NP][idx % NP] = br[i];
      cs[idx / NP][idx % NP] = cr[i];
    }
    if (tid < kT) {
      dts[tid] = dr;
      das[tid] = expf(dr * av);
    }
    __syncthreads();
    if (t0 + kT < S) load(t0 + kT);

#pragma unroll 4
    for (int t = 0; t < tn; ++t) {
      const float u = dts[t] * xs[t][pl];
      const float da = das[t];
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int q = 0; q < NPT / 4; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(&bs[t][q * 16 + ng * 4]);
        const float4 cv = *reinterpret_cast<const float4*>(&cs[t][q * 16 + ng * 4]);
        h[4 * q + 0] = fmaf(da, h[4 * q + 0], bv.x * u);
        h[4 * q + 1] = fmaf(da, h[4 * q + 1], bv.y * u);
        h[4 * q + 2] = fmaf(da, h[4 * q + 2], bv.z * u);
        h[4 * q + 3] = fmaf(da, h[4 * q + 3], bv.w * u);
        y0 = fmaf(cv.x, h[4 * q + 0], y0);
        y1 = fmaf(cv.y, h[4 * q + 1], y1);
        y0 = fmaf(cv.z, h[4 * q + 2], y0);
        y1 = fmaf(cv.w, h[4 * q + 3], y1);
      }
      float yp = y0 + y1;
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (ng == 0) ys[t][pl] = yp;
    }
    __syncthreads();
    for (int idx = tid; idx < tn * kPT; idx += kThreads) {
      const int t = idx / kPT, pp = idx % kPT;
      if (p0 + pp < P) y[xoff + (int64_t)(t0 + t) * x_st + p0 + pp] = ys[t][pp];
    }
  }

  if (p < P) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = (j / 4) * 16 + ng * 4 + (j % 4);
      if (n < N) hout[((int64_t)stream * N + n) * P + p] = h[j];
    }
  }
}

template <int NPT>
cudaError_t launch(const float* x, const float* dt, const float* b,
                   const float* c, const float* a, const float* h0, float* y,
                   float* hout, int B, int H, int S, int P, int N, int x_sb,
                   int x_sh, int x_st, int dt_sb, int dt_sh, int dt_st,
                   int bc_sb, int bc_sh, int bc_st, int a_sb, int a_sh,
                   cudaStream_t stream) {
  const dim3 grid((P + kPT - 1) / kPT, B * H);
  mamba2_scan_kernel<NPT><<<grid, kThreads, 0, stream>>>(
      x, dt, b, c, a, h0, y, hout, H, S, P, N, x_sb, x_sh, x_st, dt_sb,
      dt_sh, dt_st, bc_sb, bc_sh, bc_st, a_sb, a_sh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 throughout.  x and y share the strides x_sb/x_sh/x_st (batch,
// head, time; the channel stride is 1); dt, b/c and a have their own (a
// head stride of 0 shares an operand across the heads of a batch row).
// h0 may be null (a zero initial state); h0 and hout are [B*H, N, P]
// contiguous.  N <= 128, B * H <= 65535.  Returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernel does not take, else the
// launch's cudaGetLastError().
int mamba2_scan_fwd(const void* x, const void* dt, const void* b,
                    const void* c, const void* a, const void* h0, void* y,
                    void* hout, int B, int H, int S, int P, int N, int x_sb,
                    int x_sh, int x_st, int dt_sb, int dt_sh, int dt_st,
                    int bc_sb, int bc_sh, int bc_st, int a_sb, int a_sh,
                    void* stream) {
  if (B < 0 || H < 1 || S < 0 || P < 1 || N < 1 || N > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hout);
#define MAMBA2_LAUNCH(NPT)                                                    \
  launch<NPT>(xf, dtf, bf, cf, af, h0f, yf, hf, B, H, S, P, N, x_sb, x_sh,   \
              x_st, dt_sb, dt_sh, dt_st, bc_sb, bc_sh, bc_st, a_sb, a_sh, st)
  cudaError_t err;
  if (N <= 16)
    err = MAMBA2_LAUNCH(4);
  else if (N <= 32)
    err = MAMBA2_LAUNCH(8);
  else if (N <= 64)
    err = MAMBA2_LAUNCH(16);
  else
    err = MAMBA2_LAUNCH(32);
#undef MAMBA2_LAUNCH
  return (int)err;
}

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
