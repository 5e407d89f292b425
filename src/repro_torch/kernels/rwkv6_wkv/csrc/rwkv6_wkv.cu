// RWKV6 (Finch) wkv with data-dependent decay on NVIDIA Hopper (sm_90a),
// fp32.
//
// Replaces repro/kernels/rwkv6_wkv/kernel.py::rwkv6_wkv (the Pallas TPU
// kernel) and is the only rwkv6 prefill recurrence of the port on the
// card.  For every stream (batch b, head h) it runs
//   y_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)          y     [V]
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t (x) v_t         state [K, V]
// from S_0 (zero, or an initial state) over t = 0 .. S-1 (K = V), and
// returns y [.., S, .., K] and the final state [B*H, K, K].  The Pallas
// kernel computes the same thing in a factored chunk form (chunks of 16,
// k scaled by exp(-cumsum(lw)), up to exp(80) before it cancels); this
// version runs the per-step recurrence, as the oracle does, so no factor
// leaves fp32's range: any S, every edge bounds-checked.
//
// Layout.  r, k, v, lw and y are addressed through element strides over
// (batch, head, time), u through (batch, head) strides, so one entry
// point reads both layouts without a copy: the Pallas layout ([BH,S,K],
// u [BH,K]: B = BH streams of one head each) and the model's ([B,S,H,K]
// views of [B,S,d] projections, u [H,K] with batch stride 0).  The
// innermost stride is 1.  h0 and the final state are [B*H, K, K]
// contiguous.
//
// Grid (ceil(K / 16), B * H), 64 threads.  The column S[:, v] evolves
// only with v_t[v], and y_t[v] reads only that column, so a block owns 16
// columns of one stream.  Lane l of warp w holds column w * 8 + l / 4 and
// a quarter of the rows: n = 16 j + 4 (l % 4) + i for i < 4, so four lanes
// side by side share one column and read r, k and exp(lw) as float4s that
// a quarter warp takes in one transaction.  K is padded with zero rows to
// 16, 32, 64 or 128 (a template parameter), so each thread keeps K/4
// state values and its K/4 entries of u in registers.  Time runs in
// stages of 16 steps (8 at K > 64): r, k, lw and the block's v columns of
// the next stage are copied into the other half of a double buffer in
// shared memory with cp.async (4 bytes each, zero-filled past S and K)
// while this stage runs; exp(lw) is taken once per step and row in
// shared memory, then every thread runs the steps on its registers, y is
// reduced over the four lanes of a column with two shuffles and staged in
// shared memory, and the stage's y rows are written out coalesced.  A pad
// step (k = 0, lw = 0) gives exp(0) = 1 and k v = 0, so the state passes
// through it bit for bit.
//
// What bounds it on this card: bytes.  At rwkv6-7b's prefill (B = 1,
// H = 64, S = 1024, K = 64) it moves r, k, v, lw in and y out, 5 x 16.8
// MB, plus the 1.05 MB final state: 85.0 MB, 0.0254 ms at 3.35 TB/s,
// against 4 * BH * S * K^2 = 1.07 GFLOP, 0.016 ms at the 67 TFLOP/s fp32
// CUDA-core rate.  This version is right and simple: each stream's 1024
// steps run in order, with 256 blocks of 2 warps for 132 SMs and 4 fp32
// operations per state element and step (k v, the bonus, y and the
// update).  A later PR makes it fast with the chunked form on tensor
// cores (the intra-chunk products as wgmma tiles, the state carried in
// fp32 between chunks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kVT = 16;  // state columns v per block

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;  // 0: nothing read, the word zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// NPT: state rows per thread; KP = 4 * NPT rows staged (K padded).
template <int NPT>
__global__ void __launch_bounds__(kThreads)
    rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u,
                     const float* __restrict__ h0, float* __restrict__ y,
                     float* __restrict__ hout, int H, int S, int K, int r_sb,
                     int r_sh, int r_st, int k_sb, int k_sh, int k_st,
                     int v_sb, int v_sh, int v_st, int w_sb, int w_sh,
                     int w_st, int y_sb, int y_sh, int y_st, int u_sb,
                     int u_sh) {
  constexpr int KP = 4 * NPT;
  constexpr int kT = KP > 64 ? 8 : 16;  // time steps per stage
  static_assert(NPT % 4 == 0, "float4 reads of r, k and w");
  __shared__ __align__(16) float rs[2][kT][KP];
  __shared__ __align__(16) float ks[2][kT][KP];
  __shared__ __align__(16) float ws[2][kT][KP];
  __shared__ float vs[2][kT][kVT];
  __shared__ float ys[kT][kVT];

  const int stream = blockIdx.y;  // b * H + h
  const int bi = stream / H, hi = stream % H;
  const int v0 = blockIdx.x * kVT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cl = warp * 8 + (lane >> 2);  // this thread's column, local
  const int ng = lane & 3;                // its quarter of the rows
  const int col = v0 + cl;

  const float* rb = r + (int64_t)bi * r_sb + (int64_t)hi * r_sh;
  const float* kb = k + (int64_t)bi * k_sb + (int64_t)hi * k_sh;
  const float* vb = v + (int64_t)bi * v_sb + (int64_t)hi * v_sh;
  const float* wb = lw + (int64_t)bi * w_sb + (int64_t)hi * w_sh;
  float* yb = y + (int64_t)bi * y_sb + (int64_t)hi * y_sh;
  const float* ub = u + (int64_t)bi * u_sb + (int64_t)hi * u_sh;

  float h[NPT], uu[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = (j / 4) * 16 + ng * 4 + (j % 4);
    uu[j] = n < K ? ub[n] : 0.f;
    h[j] = (h0 != nullptr && n < K && col < K)
               ? h0[((int64_t)stream * K + n) * K + col]
               : 0.f;
  }

  // one stage's copies into buffer ``buf``: rows past S and K read as 0
  auto load = [&](int t0, int buf) {
    for (int idx = tid; idx < kT * KP; idx += kThreads) {
      const int t = idx / KP, n = idx % KP;
      const bool in = t0 + t < S && n < K;
      const int64_t tt = in ? (int64_t)(t0 + t) : 0;
      const int nn = in ? n : 0;
      cp_async4(&rs[buf][t][n], rb + tt * r_st + nn, in);
      cp_async4(&ks[buf][t][n], kb + tt * k_st + nn, in);
      cp_async4(&ws[buf][t][n], wb + tt * w_st + nn, in);
    }
    for (int idx = tid; idx < kT * kVT; idx += kThreads) {
      const int t = idx / kVT, c = idx % kVT;
      const bool in = t0 + t < S && v0 + c < K;
      const int64_t tt = in ? (int64_t)(t0 + t) : 0;
      cp_async4(&vs[buf][t][c], vb + tt * v_st + (in ? v0 + c : 0), in);
    }
    cp_async_commit();
  };

  if (S > 0) load(0, 0);
  for (int t0 = 0, buf = 0; t0 < S; t0 += kT, buf ^= 1) {
    const int tn = min(kT, S - t0);
    if (t0 + kT < S) {
      load(t0 + kT, buf ^ 1);  // its buffer's readers passed the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the decay, once per step and row
    for (int idx = tid; idx < kT * KP; idx += kThreads) {
      float* w = &ws[buf][idx / KP][idx % KP];
      *w = expf(*w);
    }
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < tn; ++t) {
      const float vv = vs[buf][t][cl];
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int q = 0; q < NPT / 4; ++q) {
        const int n = q * 16 + ng * 4;
        const float4 rv = *reinterpret_cast<const float4*>(&rs[buf][t][n]);
        const float4 kv = *reinterpret_cast<const float4*>(&ks[buf][t][n]);
        const float4 wv = *reinterpret_cast<const float4*>(&ws[buf][t][n]);
        const float a0 = kv.x * vv, a1 = kv.y * vv;
        const float a2 = kv.z * vv, a3 = kv.w * vv;
        y0 = fmaf(rv.x, fmaf(uu[4 * q + 0], a0, h[4 * q + 0]), y0);
        y1 = fmaf(rv.y, fmaf(uu[4 * q + 1], a1, h[4 * q + 1]), y1);
        y0 = fmaf(rv.z, fmaf(uu[4 * q + 2], a2, h[4 * q + 2]), y0);
        y1 = fmaf(rv.w, fmaf(uu[4 * q + 3], a3, h[4 * q + 3]), y1);
        h[4 * q + 0] = fmaf(wv.x, h[4 * q + 0], a0);
        h[4 * q + 1] = fmaf(wv.y, h[4 * q + 1], a1);
        h[4 * q + 2] = fmaf(wv.z, h[4 * q + 2], a2);
        h[4 * q + 3] = fmaf(wv.w, h[4 * q + 3], a3);
      }
      float yp = y0 + y1;
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (ng == 0) ys[t][cl] = yp;
    }
    __syncthreads();  // ys complete; this buffer free for the next load
    for (int idx = tid; idx < tn * kVT; idx += kThreads) {
      const int t = idx / kVT, c = idx % kVT;
      if (v0 + c < K) yb[(int64_t)(t0 + t) * y_st + v0 + c] = ys[t][c];
    }
  }

  if (col < K) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = (j / 4) * 16 + ng * 4 + (j % 4);
      if (n < K) hout[((int64_t)stream * K + n) * K + col] = h[j];
    }
  }
}

template <int NPT>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* u, const float* h0,
                   float* y, float* hout, int B, int H, int S, int K,
                   const int* st, cudaStream_t stream) {
  const dim3 grid((K + kVT - 1) / kVT, B * H);
  rwkv6_wkv_kernel<NPT><<<grid, kThreads, 0, stream>>>(
      r, k, v, lw, u, h0, y, hout, H, S, K, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], st[15], st[16]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 throughout.  r, k, v, lw and y each have (batch, head, time)
// strides (the channel stride is 1); u has (batch, head) strides (a batch
// stride of 0 shares u across the batch rows).  h0 may be null (a zero
// initial state); h0 and hout are [B*H, K, K] contiguous.  K <= 128,
// B * H <= 65535.  Returns a cudaError_t: cudaErrorInvalidValue for
// shapes the kernel does not take, else the launch's cudaGetLastError().
int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* h0, void* y,
                  void* hout, int B, int H, int S, int K, int r_sb, int r_sh,
                  int r_st, int k_sb, int k_sh, int k_st, int v_sb, int v_sh,
                  int v_st, int w_sb, int w_sh, int w_st, int y_sb, int y_sh,
                  int y_st, int u_sb, int u_sh, void* stream) {
  if (B < 0 || H < 1 || S < 0 || K < 1 || K > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int st[17] = {r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                      w_sb, w_sh, w_st, y_sb, y_sh, y_st, u_sb, u_sh};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hout);
  cudaError_t err;
  if (K <= 16)
    err = launch<4>(rf, kf, vf, wf, uf, h0f, yf, hf, B, H, S, K, st, cs);
  else if (K <= 32)
    err = launch<8>(rf, kf, vf, wf, uf, h0f, yf, hf, B, H, S, K, st, cs);
  else if (K <= 64)
    err = launch<16>(rf, kf, vf, wf, uf, h0f, yf, hf, B, H, S, K, st, cs);
  else
    err = launch<32>(rf, kf, vf, wf, uf, h0f, yf, hf, B, H, S, K, st, cs);
  return (int)err;
}

const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
