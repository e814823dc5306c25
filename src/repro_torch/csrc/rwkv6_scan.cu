// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/rwkv6_scan/kernel.py:
//   wkv6_bh (_wkv6_kernel)  -> wkv6_kernel
//
// Per (batch, head), with key/value width N and a per-channel decay w_t:
//   y_t[i]   = sum_j r_t[j] * (S[j, i] + u[j] * k_t[j] * v_t[i])
//   S[j, i] <- w_t[j] * S[j, i] + k_t[j] * v_t[i]
//
// Layout: r, k, v, y [B, T, H, N] row-major in T (float32 or bfloat16);
// w [B, T, H, N] float32 (a decay of 0.9975 rounded to bf16 is 0.99609 or
// 1.0, and 1.0 never decays); u [H, N] in r's type; state in / out
// [B, H, N, N] float32 (key x value).  N <= 64.
//
// What bounds it on an H100: bytes at decode, the sequential dependence at
// prefill.  A launch must read r, k, v, w once and the state once, and
// write y and the state once.  The recurrence needs 5 flops per state
// element per step (y: one FMA; S: one mul and one FMA) plus O(N) for the
// bonus v_i * sum_j r_j u_j k_j; this kernel spends 7, as it recomputes
// u_j k_j v_i inside the N^2 loop.  At decode (T = 1, batch 16, 32 heads
// of 64) that is 16.8 MB of state in and out, ~5 us at 3.35 TB/s.  At
// prefill (batch 1) only 32 blocks exist and the T steps run one after
// another in each.
//
// Design (that of RWKV-6's own CUDA kernel, wkv6_cuda.cu in BlinkDL's
// RWKV-LM): one block per (batch, head) and one thread per value channel
// i; thread i keeps column S[:, i] in registers for the whole scan.  Steps
// are staged CH at a time: the block loads r_t, k_t, w_t for CH steps into
// shared memory (one coalesced row per step), then each thread runs the CH
// steps from there, reading its own v_t[i] and writing its own y_t[i].
// The recurrence is computed as it is written, not in the TPU's chunked
// matmul form, which divides by cumulative decays (k / prod w) and
// overflows when decays are strong.  N is padded to NM (8, 16, 32 or 64)
// with zero r, k so the padded channels add exact zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 16;
// under training the state entering every chunk of SAVE_EVERY steps goes
// out (s_mid, [ceil(T / 64) - 1, B * H, N, N]) for rwkv6_chunk_bwd.cu
constexpr int SAVE_EVERY = 64;
static_assert(SAVE_EVERY % CH == 0, "states are saved between stages");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16(x);
}

template <typename T, int NM>
__global__ void __launch_bounds__(NM)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const T* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out,
            float* __restrict__ s_mid, int t_len, int h, int n) {
  __shared__ float sr[CH][NM], sk[CH][NM], sw[CH][NM], su[NM];
  const int i = threadIdx.x;
  const bool live = i < n;
  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const size_t row = (size_t)h * n;                    // stride of t
  const size_t base = (size_t)b * t_len * row + (size_t)hh * n;
  const size_t sbase = ((size_t)b * h + hh) * n * n;

  float S[NM];
#pragma unroll
  for (int j = 0; j < NM; ++j)
    S[j] = (live && j < n) ? s0[sbase + (size_t)j * n + i] : 0.0f;
  su[i] = live ? to_f(u[(size_t)hh * n + i]) : 0.0f;

  for (int t0 = 0; t0 < t_len; t0 += CH) {
    const int cn = min(CH, t_len - t0);
    if (s_mid != nullptr && live && t0 > 0 && t0 % SAVE_EVERY == 0) {
      float* dst = s_mid + ((size_t)(t0 / SAVE_EVERY - 1) * gridDim.x +
                            blockIdx.x) * n * n;
#pragma unroll
      for (int j = 0; j < NM; ++j)
        if (j < n) dst[(size_t)j * n + i] = S[j];
    }
    __syncthreads();                  // the previous chunk is consumed
    for (int c = 0; c < CH; ++c) {
      const bool ok = live && c < cn;
      const size_t off = base + (size_t)(t0 + c) * row + i;
      sr[c][i] = ok ? to_f(r[off]) : 0.0f;
      sk[c][i] = ok ? to_f(k[off]) : 0.0f;
      sw[c][i] = ok ? w[off] : 1.0f;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const size_t off = base + (size_t)(t0 + c) * row + i;
      const float vi = live ? to_f(v[off]) : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NM; ++j) {
        const float kv = sk[c][j] * vi;
        acc += sr[c][j] * (S[j] + su[j] * kv);
        S[j] = S[j] * sw[c][j] + kv;
      }
      if (live) y[off] = from_f<T>(acc);
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NM; ++j)
      if (j < n) s_out[sbase + (size_t)j * n + i] = S[j];
  }
}

template <typename T, int NM>
int launch_n(const void* r, const void* k, const void* v, const float* w,
             const void* u, const float* s0, void* y, float* s_out,
             float* s_mid, int b, int t_len, int h, int n,
             cudaStream_t stream) {
  wkv6_kernel<T, NM><<<b * h, NM, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, (const T*)u, s0, (T*)y,
      s_out, s_mid, t_len, h, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const void* u, const float* s0, void* y, float* s_out,
           float* s_mid, int b, int t_len, int h, int n, cudaStream_t s) {
  if (n <= 8)
    return launch_n<T, 8>(r, k, v, w, u, s0, y, s_out, s_mid, b, t_len, h, n, s);
  if (n <= 16)
    return launch_n<T, 16>(r, k, v, w, u, s0, y, s_out, s_mid, b, t_len, h, n, s);
  if (n <= 32)
    return launch_n<T, 32>(r, k, v, w, u, s0, y, s_out, s_mid, b, t_len, h, n, s);
  return launch_n<T, 64>(r, k, v, w, u, s0, y, s_out, s_mid, b, t_len, h, n, s);
}

}  // namespace

// dtype (of r, k, v, u, y): 0 float32, 1 bfloat16.  All tensors packed.
// s_mid: null, or (ceil(T / 64) - 1) * B * H * N * N float32 for the states
// entering each chunk of 64 steps after the first.  Returns a cudaError_t
// (0 on success); 1 (cudaErrorInvalidValue) for shapes the kernel does not
// take (N > 64).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* w, const void* u, const float* s0,
                        void* y, float* s_out, int b, int t_len, int h, int n,
                        int dtype, void* stream, float* s_mid) {
  if (n < 1 || n > 64 || h < 1 || t_len < 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, y, s_out, s_mid, b, t_len, h, n,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, s_mid, b, t_len,
                                 h, n, s);
  return (int)cudaErrorInvalidValue;
}
