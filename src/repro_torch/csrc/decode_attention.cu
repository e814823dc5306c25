// Single-query flash-decode against a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/decode_attention/kernel.py:
//   decode_attention_bhd (_dec_kernel)  -> da_kernel
//
// Layout: q [B, 1, H, D] and out [B, 1, H, D] row-major; k/v [B, Sk, Hkv, D]
// with the batch and sequence strides given in elements (head and feature
// dims packed), so one layer's slice of a batched cache [..., L, S, Hkv, D]
// is read in place.  valid_len [B] int32: keys at or beyond it are skipped;
// valid_len 0 gives zeros.  GQA: the block of kv head g serves query heads
// g * G .. g * G + G - 1 (G = H / Hkv), so each key is read once for all of
// them.
//
// What bounds it on an H100: bytes.  A launch reads each valid key and
// value once (main path, smollm-135m: 256 sequences x ~270 positions x 3 kv
// heads x 64 x 2 B x 2 = ~53 MB) against ~6 flops per byte, so the bound is
// ~16 us at 3.35 TB/s.  What the design does: one block per (sequence, kv
// head), its 8 warps splitting the keys round-robin, so 8 key rows are in
// flight per block and 768 blocks cover the card; a warp reads a key and a
// value row with its 32 lanes on consecutive features (coalesced), scores
// all G heads with a shuffle reduction, and keeps an online softmax per head
// in float32 registers; the 8 warps' partial (m, l, acc) are merged once in
// shared memory.  The TPU's split into blk_k-sized grid steps and its
// padding of Sk to a block multiple are not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_D = 128;
constexpr int COLS = MAX_D / 32;
constexpr int MAX_G = 8;

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <typename T, int G>
__global__ void __launch_bounds__(WARPS * 32)
da_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ valid_len,
          T* __restrict__ out, int sk, int h, int hkv, int d,
          long long k_sb, long long k_ss, long long v_sb, long long v_ss,
          float scale) {
  __shared__ float part_m[WARPS][G], part_l[WARPS][G];
  __shared__ float part_acc[WARPS][G][MAX_D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / hkv, g0 = blockIdx.x % hkv;
  int valid = valid_len[b];
  valid = valid < sk ? valid : sk;
  const T* qb = q + ((size_t)b * h + (size_t)g0 * G) * d;
  const T* kb = k + (size_t)b * k_sb + (size_t)g0 * d;
  const T* vb = v + (size_t)b * v_sb + (size_t)g0 * d;

  float qv[G][COLS], acc[G][COLS], m[G], l[G];
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
    for (int c = 0; c < COLS; ++c) {
      const int col = lane + 32 * c;
      qv[g][c] = col < d ? to_f(qb[(size_t)g * d + col]) : 0.0f;
      acc[g][c] = 0.0f;
    }
  }
  for (int j = warp; j < valid; j += WARPS) {
    float kr[COLS], vr[COLS];
    for (int c = 0; c < COLS; ++c) {
      const int col = lane + 32 * c;
      kr[c] = col < d ? to_f(kb[(size_t)j * k_ss + col]) : 0.0f;
      vr[c] = col < d ? to_f(vb[(size_t)j * v_ss + col]) : 0.0f;
    }
    for (int g = 0; g < G; ++g) {
      float dot = 0.0f;
      for (int c = 0; c < COLS; ++c) dot += qv[g][c] * kr[c];
      const float s = warp_sum(dot) * scale;
      const float m_new = fmaxf(m[g], s);
      const float corr = (m[g] == m_new) ? 1.0f : expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
      for (int c = 0; c < COLS; ++c) acc[g][c] = acc[g][c] * corr + p * vr[c];
      m[g] = m_new;
    }
  }
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      part_m[warp][g] = m[g];
      part_l[warp][g] = l[g];
    }
    for (int c = 0; c < COLS; ++c) {
      const int col = lane + 32 * c;
      if (col < d) part_acc[warp][g][col] = acc[g][c];
    }
  }
  __syncthreads();
  // merge the warps' partial softmaxes: thread t writes (g, col) pairs
  T* ob = out + ((size_t)b * h + (size_t)g0 * G) * d;
  for (int e = threadIdx.x; e < G * d; e += WARPS * 32) {
    const int g = e / d, col = e % d;
    float mx = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, part_m[w][g]);
    float lsum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int w = 0; w < WARPS; ++w) {
        if (part_m[w][g] == -INFINITY) continue;
        const float f = expf(part_m[w][g] - mx);
        lsum += part_l[w][g] * f;
        o += part_acc[w][g][col] * f;
      }
    }
    ob[(size_t)g * d + col] = from_f<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G>
int launch_g(const void* q, const void* k, const void* v, const int* vl,
             void* out, int b, int sk, int h, int hkv, int d, long long k_sb,
             long long k_ss, long long v_sb, long long v_ss, float scale,
             cudaStream_t stream) {
  da_kernel<T, G><<<b * hkv, WARPS * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, vl, (T*)out, sk, h, hkv, d,
      k_sb, k_ss, v_sb, v_ss, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int g, const void* q, const void* k, const void* v, const int* vl,
           void* out, int b, int sk, int h, int hkv, int d, long long k_sb,
           long long k_ss, long long v_sb, long long v_ss, float scale,
           cudaStream_t s) {
  switch (g) {
#define DA_CASE(G)                                                         \
  case G:                                                                  \
    return launch_g<T, G>(q, k, v, vl, out, b, sk, h, hkv, d, k_sb, k_ss,  \
                          v_sb, v_ss, scale, s);
    DA_CASE(1) DA_CASE(2) DA_CASE(3) DA_CASE(4)
    DA_CASE(5) DA_CASE(6) DA_CASE(7) DA_CASE(8)
#undef DA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; strides in elements.  Returns a cudaError_t
// (0 on success); 1 (cudaErrorInvalidValue) for shapes the kernel does not
// take (D > 128, H / Hkv > 8).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* valid_len,
                                    void* out, int b, int sk, int h, int hkv,
                                    int d, long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss,
                                    float scale, int dtype, void* stream) {
  if (d < 1 || d > MAX_D || hkv < 1 || h % hkv != 0 || h / hkv > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = h / hkv;
  if (dtype == 0)
    return launch<float>(g, q, k, v, valid_len, out, b, sk, h, hkv, d, k_sb,
                         k_ss, v_sb, v_ss, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, q, k, v, valid_len, out, b, sk, h, hkv,
                                 d, k_sb, k_ss, v_sb, v_ss, scale, s);
  return (int)cudaErrorInvalidValue;
}
