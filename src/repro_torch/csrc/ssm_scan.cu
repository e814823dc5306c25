// Mamba-2 SSD recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/ssm_scan/kernel.py:
//   ssd_bh (_ssd_kernel)  -> ssd_kernel
//
// Per (batch, head h), with head dim P and state dim N:
//   a_t = exp(dt_t * A_h)
//   S   <- a_t * S + (dt_t * x_t) B_t^T          (S in R^{P x N})
//   y_t = S C_t + D_h * x_t
//
// Layout: x, y [B, T, H, P] (x float32 or bfloat16, y in x's type); dt
// [B, T, H] float32; A, D [H] float32; Bm, Cm [B, T, N] in x's type, one
// group shared by every head and indexed by batch (as the JAX BlockSpec
// does); state in / out [B, H, P, N] float32.  x, Bm and Cm are read
// through their batch and time strides (their last dims packed), so the
// model's slices of its conv output go in without copies.  P, N <= 64.
//
// What bounds it on an H100: bytes at decode, the sequential dependence at
// prefill.  A launch must read x, dt, B, C and the state once and write y
// and the state once; ~5 flops per state element per step.  At decode (T =
// 1, batch 16, 64 heads of 64 x 64) that is 16.8 MB of state in and out,
// ~5 us at 3.35 TB/s.
//
// Design: one block per (batch, head) and one thread per head-dim row p;
// thread p keeps row S[p, :] in registers for the whole scan.  The state
// tile goes in and out through shared memory so that its reads and writes
// are coalesced.  Steps are staged CH at a time: the block loads B_t, C_t
// (shared by the heads) and dt_t for CH steps into shared memory, then each
// thread runs the CH steps, reading its own x_t[p] and writing its own
// y_t[p].  a_t = exp(dt_t * A_h) and the D x skip are computed in float32
// (the JAX Pallas wrapper adds the skip in y's type; the plain version, the
// yardstick, adds it in float32).  The TPU's chunked matmul form is not
// carried over: T = 1 on every decode step.  P and N are padded to PM and
// NM (8, 16, 32 or 64) with zero B, C, so padded entries add exact zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CH = 16;
// under training the state entering every chunk of SAVE_EVERY steps goes
// out (s_mid, [ceil(T / 64) - 1, B * H, P, N]) for ssm_chunk_bwd.cu
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

template <typename T, int PM, int NM>
__global__ void __launch_bounds__(PM)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ D,
           const float* __restrict__ s0, T* __restrict__ y,
           float* __restrict__ s_out, float* __restrict__ s_mid, int t_len,
           int h, int p, int n,
           long long x_sb, long long x_st, long long b_sb, long long b_st,
           long long c_sb, long long c_st) {
  __shared__ float sb[CH][NM], sc[CH][NM], sdt[CH];
  __shared__ float tile[PM][NM + 1];
  const int i = threadIdx.x;
  const bool live = i < p;
  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const size_t sbase = ((size_t)b * h + hh) * p * n;

  // state in: coalesced through shared memory
  for (int e = i; e < PM * NM; e += PM) {
    const int pr = e / NM, nc = e % NM;
    tile[pr][nc] = (pr < p && nc < n) ? s0[sbase + (size_t)pr * n + nc] : 0.0f;
  }
  __syncthreads();
  float S[NM];
#pragma unroll
  for (int j = 0; j < NM; ++j) S[j] = tile[i][j];

  const float a_h = A[hh], d_h = D[hh];
  const T* xb = x + (size_t)b * x_sb + (size_t)hh * p + i;
  T* yb = y + ((size_t)b * t_len * h + hh) * p + i;
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  const float* db = dt + (size_t)b * t_len * h + hh;

  for (int t0 = 0; t0 < t_len; t0 += CH) {
    const int cn = min(CH, t_len - t0);
    if (s_mid != nullptr && live && t0 > 0 && t0 % SAVE_EVERY == 0) {
      float* dst = s_mid + ((size_t)(t0 / SAVE_EVERY - 1) * gridDim.x +
                            blockIdx.x) * p * n + (size_t)i * n;
#pragma unroll
      for (int j = 0; j < NM; ++j)
        if (j < n) dst[j] = S[j];
    }
    __syncthreads();                  // the previous chunk is consumed
    for (int e = i; e < CH * NM; e += PM) {
      const int c = e / NM, j = e % NM;
      const bool ok = c < cn && j < n;
      sb[c][j] = ok ? to_f(bb[(size_t)(t0 + c) * b_st + j]) : 0.0f;
      sc[c][j] = ok ? to_f(cb[(size_t)(t0 + c) * c_st + j]) : 0.0f;
    }
    for (int c = i; c < CH; c += PM)
      sdt[c] = c < cn ? db[(size_t)(t0 + c) * h] : 0.0f;
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const float xi = live ? to_f(xb[(size_t)(t0 + c) * x_st]) : 0.0f;
      const float d_t = sdt[c];
      const float a_t = expf(d_t * a_h);
      const float dx = d_t * xi;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NM; ++j) {
        S[j] = S[j] * a_t + dx * sb[c][j];
        acc += S[j] * sc[c][j];
      }
      if (live) yb[(size_t)(t0 + c) * h * p] = from_f<T>(acc + d_h * xi);
    }
  }
  // state out: coalesced through shared memory
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NM; ++j) tile[i][j] = S[j];
  __syncthreads();
  for (int e = i; e < PM * NM; e += PM) {
    const int pr = e / NM, nc = e % NM;
    if (pr < p && nc < n) s_out[sbase + (size_t)pr * n + nc] = tile[pr][nc];
  }
}

struct Args {
  const void *x, *bm, *cm;
  const float *dt, *a, *d, *s0;
  void* y;
  float *s_out, *s_mid;
  int b, t_len, h, p, n;
  long long x_sb, x_st, b_sb, b_st, c_sb, c_st;
};

template <typename T, int PM, int NM>
int launch_pn(const Args& g, cudaStream_t stream) {
  ssd_kernel<T, PM, NM><<<g.b * g.h, PM, 0, stream>>>(
      (const T*)g.x, g.dt, g.a, (const T*)g.bm, (const T*)g.cm, g.d, g.s0,
      (T*)g.y, g.s_out, g.s_mid, g.t_len, g.h, g.p, g.n, g.x_sb, g.x_st, g.b_sb,
      g.b_st, g.c_sb, g.c_st);
  return (int)cudaGetLastError();
}

template <typename T, int PM>
int launch_p(const Args& g, cudaStream_t s) {
  if (g.n <= 8) return launch_pn<T, PM, 8>(g, s);
  if (g.n <= 16) return launch_pn<T, PM, 16>(g, s);
  if (g.n <= 32) return launch_pn<T, PM, 32>(g, s);
  return launch_pn<T, PM, 64>(g, s);
}

template <typename T>
int launch(const Args& g, cudaStream_t s) {
  if (g.p <= 8) return launch_p<T, 8>(g, s);
  if (g.p <= 16) return launch_p<T, 16>(g, s);
  if (g.p <= 32) return launch_p<T, 32>(g, s);
  return launch_p<T, 64>(g, s);
}

}  // namespace

// dtype (of x, Bm, Cm, y): 0 float32, 1 bfloat16; strides in elements.
// s_mid: null, or (ceil(T / 64) - 1) * B * H * P * N float32 for the states
// entering each chunk of 64 steps after the first.  Returns a cudaError_t
// (0 on success); 1 (cudaErrorInvalidValue) for shapes the kernel does not
// take (P or N > 64).
extern "C" int ssd_fwd(const void* x, const float* dt, const float* a,
                       const void* bm, const void* cm, const float* d,
                       const float* s0, void* y, float* s_out, int b,
                       int t_len, int h, int p, int n, long long x_sb,
                       long long x_st, long long b_sb, long long b_st,
                       long long c_sb, long long c_st, int dtype,
                       void* stream, float* s_mid) {
  if (p < 1 || p > 64 || n < 1 || n > 64 || h < 1 || t_len < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const Args g{x, bm, cm, dt, a, d, s0, y, s_out, s_mid, b, t_len, h, p, n,
               x_sb, x_st, b_sb, b_st, c_sb, c_st};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(g, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, s);
  return (int)cudaErrorInvalidValue;
}
