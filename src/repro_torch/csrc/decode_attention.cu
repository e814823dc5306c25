// Single-query flash-decode against a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/decode_attention/kernel.py:
//   decode_attention_bhd (_dec_kernel)  -> da_kernel (+ da_combine when the
//                                          keys are split across blocks)
//
// Layout: q [B, 1, H, D] and out [B, 1, H, D] row-major; k/v [B, Sk, Hkv, D]
// with the batch and sequence strides given in elements (head and feature
// dims packed), so one layer's slice of a batched cache [..., L, S, Hkv, D]
// is read in place.  valid_len [B] int32: keys at or beyond it are skipped;
// valid_len 0 gives zeros.  When the lse pointer is given, each (b, h)
// row's float32 natural-log logsumexp of its scaled scores is stored there
// too ([B, H]; -inf for a row with no key): the partial that the
// sequence-sharded decode (parallel/dist_attention.py) combines across
// ranks.  GQA: the block of kv head g serves query heads g * G .. g * G +
// G - 1 (G = H / Hkv), so each key is read once for all of them.  Rows of D * sizeof(T) bytes, a multiple of 16.
//
// What bounds it on an H100: bytes.  A launch reads each valid key and
// value once (main path, smollm-135m: 256 sequences x ~270 positions x 3 kv
// heads x 64 x 2 B x 2 = ~33 MB) at ~6 flops per byte, far below the
// card's ~295 flops per byte ridge, so tensor cores buy nothing and the
// bound is ~10 us at 3.35 TB/s.  The design keeps bytes in flight:
//  - one block per (sequence, kv head) and, when B * Hkv is below two
//    blocks per SM, per split of the key axis (flash-decoding: da_combine
//    then merges the splits' (m, l, acc));
//  - the block's W warps (W <= 4, as many as fit ~110 KB of shared memory)
//    take tiles of TK = 32 keys round robin; each warp streams its tiles
//    through its own two-stage ring in shared memory with 16-byte cp.async
//    (the next tile in flight while this one is computed), K and V rows
//    padded by 16 bytes so the lanes reading 8 rows hit distinct banks;
//  - a lane scores one key of the tile for all G heads (q, pre-scaled into
//    the log2 domain, is broadcast from shared memory), then one warp max
//    and one rescale per head per tile, not per key; P stays float32 and
//    goes through shared memory to the PV loop, where a lane owns pairs of
//    output columns and reads V rows as 4- or 8-byte vectors; the models'
//    head dims (64, 128) are compile-time constants, so these loops unroll;
//  - l is kept per lane and summed once; the warps' partial softmaxes are
//    merged once in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;
constexpr int MAX_G = 8;
constexpr int TK = 32;              // keys per tile: one per lane
constexpr int STAGES = 2;           // ring stages per warp
constexpr int MAX_WARPS = 4;
constexpr int SMEM_TARGET = 110 * 1024;   // per block, bounds the warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The natural-log logsumexp of a row from its running max (log2 domain)
// and sum of exp2 terms: -inf for a row with no key.
__device__ __forceinline__ float row_lse(float mx, float lsum) {
  return mx == -INFINITY ? -INFINITY : mx * LN2 + logf(lsum);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T as floats (8 bf16 or 4 float32)
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint8_t* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ static float2 pair(const uint8_t* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static float to(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint8_t* p, float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static float2 pair(const uint8_t* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static __nv_bfloat16 to(float x) { return __float2bfloat16(x); }
};

// Issue the copies of one tile (keys [k0, k0 + n) of K and V, rows past n
// zero-filled) into a stage: K rows then V rows, each rowb bytes apart.
template <typename T>
__device__ __forceinline__ void issue_tile(uint8_t* ks, uint8_t* vs,
                                           const T* kb, const T* vb,
                                           long long k_ss, long long v_ss,
                                           int k0, int n, int chunks,
                                           int rowb, int lane) {
  constexpr int E = 16 / sizeof(T);
  for (int e = lane; e < TK * chunks; e += 32) {
    const int r = e / chunks, c = e % chunks;
    const bool in = r < n;
    const size_t kr = in ? (size_t)(k0 + r) : 0;
    cp_async16(ks + r * rowb + c * 16, kb + kr * k_ss + c * E, in);
    cp_async16(vs + r * rowb + c * 16, vb + kr * v_ss + c * E, in);
  }
}

// DT: the head dim when fixed at compile time (the models' 64 and 128, so
// the per-key loops unroll), 0 to take d at run time.
template <typename T, int G, int DT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
da_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ valid_len,
          T* __restrict__ out, float* __restrict__ part_ml,
          float* __restrict__ part_acc, float* __restrict__ lse, int sk,
          int h, int hkv, int d_arg,
          long long k_sb, long long k_ss, long long v_sb, long long v_ss,
          float scale_log2) {
  const int d = DT > 0 ? DT : d_arg;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  const int chunks = d * (int)sizeof(T) / 16, rowb = d * (int)sizeof(T) + 16;
  const int pairs = d >> 1;
  float* qs = reinterpret_cast<float*>(smem);              // [G][d]
  float* ps = qs + G * d;                                  // [nw][G][TK]
  uint8_t* ring = reinterpret_cast<uint8_t*>(ps + nw * G * TK);
  uint8_t* mine = ring + (size_t)warp * STAGES * 2 * TK * rowb;
  float* pw = ps + warp * G * TK;

  const int bh = blockIdx.x, b = bh / hkv, g0 = bh % hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  int valid = valid_len[b];
  valid = valid < sk ? (valid > 0 ? valid : 0) : sk;
  const int chunk = ((valid + nsplit - 1) / nsplit + TK - 1) / TK * TK;
  const int lo = split * chunk;
  const int hi = min(lo + chunk, valid);
  const int n_tiles = hi > lo ? (hi - lo + TK - 1) / TK : 0;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + nw - 1) / nw : 0;
  const T* kb = k + (size_t)b * k_sb + (size_t)g0 * d;
  const T* vb = v + (size_t)b * v_sb + (size_t)g0 * d;

  auto stage_k = [&](int s) { return mine + (size_t)s * 2 * TK * rowb; };
  auto tile_k0 = [&](int i) { return lo + (warp + i * nw) * TK; };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < my_tiles)
      issue_tile<T>(stage_k(i), stage_k(i) + TK * rowb, kb, vb, k_ss, v_ss,
                    tile_k0(i), min(TK, hi - tile_k0(i)), chunks, rowb,
                    lane);
    cp_async_commit();
  }
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(
      q + ((size_t)b * h + (size_t)g0 * G) * d);
  for (int e = threadIdx.x; e < G * chunks; e += blockDim.x) {
    float f[Vec<T>::N];
    Vec<T>::load(qb + e * 16, f);
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i)
      qs[e * Vec<T>::N + i] = f[i] * scale_log2;
  }
  __syncthreads();

  float m[G], l[G], acc[G][2][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[g][c][0] = acc[g][c][1] = 0.0f;
  }
  for (int i = 0; i < my_tiles; ++i) {
    if (i + STAGES - 1 < my_tiles) {
      const int k1 = tile_k0(i + STAGES - 1);
      uint8_t* s = stage_k((i + STAGES - 1) % STAGES);
      issue_tile<T>(s, s + TK * rowb, kb, vb, k_ss, v_ss, k1,
                    min(TK, hi - k1), chunks, rowb, lane);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int k0 = tile_k0(i), n = min(TK, hi - k0);
    const uint8_t* ks = stage_k(i % STAGES);
    const uint8_t* vs = ks + TK * rowb;
    // scores: lane j scores key k0 + j for every head
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.0f;
    const uint8_t* kr = ks + lane * rowb;
#pragma unroll
    for (int c = 0; c < chunks; ++c) {
      float kf[Vec<T>::N];
      Vec<T>::load(kr + c * 16, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * d + c * Vec<T>::N;
#pragma unroll
        for (int e = 0; e < Vec<T>::N; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qg + e);
          sc[g] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2]
                   + qv.w * kf[e + 3];
        }
      }
    }
    // one max and one rescale per head per tile
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = lane < n ? sc[g] : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(s));   // finite: n >= 1
      const float corr = exp2f(m[g] - m_new);
      const float p = exp2f(s - m_new);
      l[g] = l[g] * corr + p;
      acc[g][0][0] *= corr;
      acc[g][0][1] *= corr;
      acc[g][1][0] *= corr;
      acc[g][1][1] *= corr;
      m[g] = m_new;
      pw[g * TK + lane] = p;
    }
    __syncwarp();
    // PV: lane owns column pairs lane and lane + 32; rows past n are zeros
    for (int j = 0; j < n; j += 4) {
      float4 pj[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        pj[g] = *reinterpret_cast<const float4*>(pw + g * TK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint8_t* vr = vs + (j + jj) * rowb;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int pi = lane + 32 * c;
          if (pi < pairs) {
            const float2 vv = Vec<T>::pair(vr + pi * 2 * sizeof(T));
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float p = jj == 0 ? pj[g].x : jj == 1 ? pj[g].y
                              : jj == 2 ? pj[g].z : pj[g].w;
              acc[g][c][0] += p * vv.x;
              acc[g][c][1] += p * vv.y;
            }
          }
        }
      }
    }
    __syncwarp();   // this stage is refilled STAGES tiles on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int g = 0; g < G; ++g) l[g] = warp_sum(l[g]);
  __syncthreads();   // the ring is reused for the warps' partials
  float* wm = reinterpret_cast<float*>(ring);     // [nw][G]
  float* wl = wm + nw * G;                        // [nw][G]
  float* wa = wl + nw * G;                        // [nw][G][d]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int pi = lane + 32 * c;
      if (pi < pairs) {
        wa[(warp * G + g) * d + 2 * pi] = acc[g][c][0];
        wa[(warp * G + g) * d + 2 * pi + 1] = acc[g][c][1];
      }
    }
  }
  __syncthreads();
  const size_t row = ((size_t)bh * nsplit + split) * G;
  for (int e = threadIdx.x; e < G * d; e += blockDim.x) {
    const int g = e / d, col = e % d;
    float mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lsum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int w = 0; w < nw; ++w) {
        const float f = exp2f(wm[w * G + g] - mx);
        lsum += wl[w * G + g] * f;
        o += wa[(w * G + g) * d + col] * f;
      }
    }
    if (nsplit == 1) {
      out[((size_t)b * h + (size_t)g0 * G + g) * d + col] =
          Vec<T>::to(o / fmaxf(lsum, 1e-30f));
      if (lse != nullptr && col == 0)
        lse[(size_t)b * h + (size_t)g0 * G + g] = row_lse(mx, lsum);
    } else {
      if (col == 0) {
        part_ml[(row + g) * 2] = mx;
        part_ml[(row + g) * 2 + 1] = lsum;
      }
      part_acc[(row + g) * d + col] = o;
    }
  }
}

// Merge the splits' partial softmaxes of one (sequence, kv head).
template <typename T>
__global__ void da_combine(const float* __restrict__ part_ml,
                           const float* __restrict__ part_acc,
                           T* __restrict__ out, float* __restrict__ lse,
                           int hkv, int g_size, int d, int nsplit) {
  const int bh = blockIdx.x, b = bh / hkv, g0 = bh % hkv;
  const int h = hkv * g_size;
  for (int e = threadIdx.x; e < g_size * d; e += blockDim.x) {
    const int g = e / d, col = e % d;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, part_ml[(((size_t)bh * nsplit + s) * g_size + g) * 2]);
    float lsum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int s = 0; s < nsplit; ++s) {
        const size_t r = ((size_t)bh * nsplit + s) * g_size + g;
        const float f = exp2f(part_ml[r * 2] - mx);
        lsum += part_ml[r * 2 + 1] * f;
        o += part_acc[r * d + col] * f;
      }
    }
    out[((size_t)b * h + (size_t)g0 * g_size + g) * d + col] =
        Vec<T>::to(o / fmaxf(lsum, 1e-30f));
    if (lse != nullptr && col == 0)
      lse[(size_t)b * h + (size_t)g0 * g_size + g] = row_lse(mx, lsum);
  }
}

// Warps per block: up to MAX_WARPS, as many as SMEM_TARGET holds.
template <typename T, int G>
int warps_for(int d) {
  const int per_warp = STAGES * 2 * TK * (d * (int)sizeof(T) + 16)
                       + G * TK * 4;
  const int w = SMEM_TARGET / per_warp;
  return w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
}

template <typename T, int G, int DT>
int launch_d(const void* q, const void* k, const void* v, const int* vl,
             void* out, float* part_ml, float* part_acc, float* lse, int b,
             int sk, int h, int hkv, int d, long long k_sb, long long k_ss,
             long long v_sb, long long v_ss, float scale, int nsplit,
             cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(   // once per instance
      da_kernel<T, G, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      227 * 1024);
  if (attr != cudaSuccess) return (int)attr;
  const int nw = warps_for<T, G>(d);
  const size_t smem = sizeof(float) * ((size_t)G * d + (size_t)nw * G * TK)
                      + (size_t)nw * STAGES * 2 * TK
                            * (d * sizeof(T) + 16);
  dim3 grid(b * hkv, nsplit);
  da_kernel<T, G, DT><<<grid, nw * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, vl, (T*)out, part_ml, part_acc,
      lse, sk, h, hkv, d, k_sb, k_ss, v_sb, v_ss, scale * LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  da_combine<T><<<b * hkv, 128, 0, stream>>>(part_ml, part_acc, (T*)out,
                                            lse, hkv, G, d, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_g(const void* q, const void* k, const void* v, const int* vl,
             void* out, float* part_ml, float* part_acc, float* lse, int b,
             int sk, int h, int hkv, int d, long long k_sb, long long k_ss,
             long long v_sb, long long v_ss, float scale, int nsplit,
             cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {   // the models' bf16 head dims
    if (d == 64)
      return launch_d<T, G, 64>(q, k, v, vl, out, part_ml, part_acc, lse, b,
                                sk, h, hkv, d, k_sb, k_ss, v_sb, v_ss, scale,
                                nsplit, stream);
    if (d == 128)
      return launch_d<T, G, 128>(q, k, v, vl, out, part_ml, part_acc, lse, b,
                                 sk, h, hkv, d, k_sb, k_ss, v_sb, v_ss, scale,
                                 nsplit, stream);
  }
  return launch_d<T, G, 0>(q, k, v, vl, out, part_ml, part_acc, lse, b, sk,
                           h, hkv, d, k_sb, k_ss, v_sb, v_ss, scale, nsplit,
                           stream);
}

template <typename T>
int launch(int g, const void* q, const void* k, const void* v, const int* vl,
           void* out, float* part_ml, float* part_acc, float* lse, int b,
           int sk, int h, int hkv, int d, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, float scale, int nsplit,
           cudaStream_t s) {
  switch (g) {
#define DA_CASE(G)                                                         \
  case G:                                                                  \
    return launch_g<T, G>(q, k, v, vl, out, part_ml, part_acc, lse, b, sk, \
                          h, hkv, d, k_sb, k_ss, v_sb, v_ss, scale, nsplit,  \
                          s);
    DA_CASE(1) DA_CASE(2) DA_CASE(3) DA_CASE(4)
    DA_CASE(5) DA_CASE(6) DA_CASE(7) DA_CASE(8)
#undef DA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; strides in elements.  nsplit > 1 splits
// the key axis over that many blocks per (sequence, kv head), with scratch
// part_ml [B * Hkv * nsplit * G * 2] and part_acc [B * Hkv * nsplit * G * D]
// float32 (unused, may be null, when nsplit is 1).  lse [B * H] float32,
// or null: each row's natural-log logsumexp (-inf for no key).  Returns a
// cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for shapes the kernel does not
// take (D > 128, D * sizeof(T) not a multiple of 16, H / Hkv > 8).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* valid_len,
                                    void* out, float* part_ml,
                                    float* part_acc, float* lse, int b,
                                    int sk, int h, int hkv, int d,
                                    long long k_sb,
                                    long long k_ss, long long v_sb,
                                    long long v_ss, float scale, int nsplit,
                                    int dtype, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (d < 1 || d > MAX_D || (d * es) % 16 != 0 || hkv < 1 || h % hkv != 0
      || h / hkv > MAX_G || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = h / hkv;
  if (dtype == 0)
    return launch<float>(g, q, k, v, valid_len, out, part_ml, part_acc, lse,
                         b, sk, h, hkv, d, k_sb, k_ss, v_sb, v_ss, scale,
                         nsplit, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, q, k, v, valid_len, out, part_ml,
                                 part_acc, lse, b, sk, h, hkv, d, k_sb, k_ss,
                                 v_sb, v_ss, scale, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
