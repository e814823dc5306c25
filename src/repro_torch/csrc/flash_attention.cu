// Blocked causal / non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention/kernel.py:
//   flash_attention_bhsd (_fa_kernel)  -> fa_kernel
// and implements what that path drops: q_offset and logits_soft_cap.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, Hkv, D], out [B, Sq, H, D], row-major
// (the public layout of the port's wrapper, read in place: no transpose or
// padding copy).  GQA: head h reads kv head h / (H / Hkv).
//
// What bounds it on an H100: at the prefill shapes of the main path
// (smollm-135m, 16 prompts x 276 positions, 9 heads of 64) a launch does
// ~1.4 GFLOP of causal QK^T and PV over ~14 MB of q/k/v/out in bf16, which
// would take ~1.4 us at the bf16 tensor-core peak and ~4 us at the memory
// rate: bytes bound it.  This first kernel runs the products on the CUDA
// cores in float32 (FMA loops, no mma), so its float32 instruction rate
// bounds it, far above that bound.
// What the design does: the TPU's sequential kv grid dimension becomes a
// loop inside the block; one block per (query tile of BQ rows, b * H + h);
// K and V tiles of BK keys are staged in shared memory as float32 (K rows
// padded by one word, so the 32 lanes reading 32 keys hit 32 banks); each
// warp owns BQ / 8 query rows, a lane scores one key of the tile and holds
// D / 32 output columns; the online softmax (running max m, sum l) lives in
// registers; tiles above the causal diagonal are never loaded.  Float32
// accumulation, output in q's dtype, l floored at 1e-30 (rows with no key
// give 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per tile (one per lane)
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;
constexpr int MAX_D = 128;
constexpr int COLS = MAX_D / 32;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
          int seq_k, int h, int hkv, int d, int causal, int q_offset,
          float scale, float cap) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][d]
  float* ks = qs + BQ * d;                 // [BK][d + 1]
  float* vs = ks + BK * (d + 1);           // [BK][d]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const size_t q_row = (size_t)h * d, kv_row = (size_t)hkv * d;
  const T* qb = q + ((size_t)b * sq) * q_row + (size_t)hh * d;
  const T* kb = k + ((size_t)b * sk) * kv_row + (size_t)kvh * d;
  const T* vb = v + ((size_t)b * sk) * kv_row + (size_t)kvh * d;

  for (int e = tid; e < BQ * d; e += WARPS * 32) {
    const int r = e / d, c = e % d;
    qs[e] = (q0 + r < sq) ? to_f(qb[(size_t)(q0 + r) * q_row + c]) : 0.0f;
  }
  float m[ROWS], l[ROWS], acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;
  }
  // keys a causal tile can see: < last query row's position + 1
  int k_end = seq_k < sk ? seq_k : sk;
  if (causal) {
    const long long last = (long long)min(q0 + BQ, sq) - 1 + q_offset;
    if (last + 1 < k_end) k_end = (int)(last + 1 > 0 ? last + 1 : 0);
  }
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * d; e += WARPS * 32) {
      const int r = e / d, c = e % d;
      const bool in = k0 + r < k_end;
      const size_t off = (size_t)(k0 + r) * kv_row + c;
      ks[r * (d + 1) + c] = in ? to_f(kb[off]) : 0.0f;
      vs[r * d + c] = in ? to_f(vb[off]) : 0.0f;
    }
    __syncthreads();
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {       // unrolled: acc stays in registers
      const int row = warp * ROWS + r, qi = q0 + row;
      const bool keep = qi < sq && kj < k_end
                        && (!causal || qi + q_offset >= kj);
      float s = -INFINITY;
      if (keep) {
        float dot = 0.0f;
        const float* qr = qs + row * d;
        const float* kr = ks + lane * (d + 1);
        for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
        s = dot * scale;
        if (cap > 0.0f) s = cap * tanhf(s / cap);
      }
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = keep ? expf(s - m_new) : 0.0f;
      const float corr = (m[r] == m_new) ? 1.0f : expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] *= corr;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(~0u, p, j);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int col = lane + 32 * c;
          if (col < d) acc[r][c] += pj * vs[j * d + col];
        }
      }
      m[r] = m_new;
    }
  }
  T* ob = out + ((size_t)b * sq) * q_row + (size_t)hh * d;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = lane + 32 * c;
      if (qi < sq && col < d)
        ob[(size_t)qi * q_row + col] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int seq_k, int h, int hkv, int d, int causal,
           int q_offset, float scale, float cap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * d + (size_t)BK * (d + 1)
                                       + (size_t)BK * d);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, b * h);
  fa_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, seq_k, h, hkv,
      d, causal, q_offset, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success);
// 1 (cudaErrorInvalidValue) for shapes the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int sk, int seq_k, int h, int hkv, int d,
                                   int causal, int q_offset, float scale,
                                   float cap, int dtype, void* stream) {
  if (d < 1 || d > MAX_D || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, sq, sk, seq_k, h, hkv, d, causal,
                         q_offset, scale, cap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, seq_k, h, hkv, d,
                                 causal, q_offset, scale, cap, s);
  return (int)cudaErrorInvalidValue;
}
