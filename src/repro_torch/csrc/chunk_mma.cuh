// Shared pieces of the chunked scan kernels (ssm_chunk.cu, rwkv6_chunk.cu):
// warp-level bf16 tensor-core products (mma.sync m16n8k16, float32
// accumulation) on 64 x 64 tiles in shared memory, the three-piece split
// of float32 operands, and the flags that carry a state from one chunk's
// block to the next.
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16): lane l, g = l / 4, c = l % 4.
//   A (16 x 16, row-major): a0 (row g, cols 2c, 2c+1), a1 (row g+8),
//     a2 (row g, cols 2c+8, 2c+9), a3 (row g+8, cols 2c+8, 2c+9);
//   B (16 x 8, k x n): b0 (rows k = 2c, 2c+1, col n = g), b1 (k + 8);
//   C (16 x 8): c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8).
// Two C tiles side by side (cols 0-7 and 8-15) are one A fragment, so a
// product's result feeds the next product from registers.
//
// Tiles: 64 rows of 64 values, rows packed, with the 16-byte chunks of a
// bf16 row (32-byte pairs of a float32 row) XOR-swizzled by row % 8, so
// that the 8 rows an ldmatrix phase or a fragment load touches fall in
// distinct banks.  An index helper maps (row, col) to the element.
//
// Three pieces: a float32 value a is hi + mid + lo, each a bf16 (hi =
// bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid)); each difference
// is exact, and a - hi - mid - lo is within 2^-24 |a| or so.  A product
// with one bf16 operand (exact) and one split operand takes three mma
// (each partial product is exact in float32); a product of two split
// operands takes six (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid: the
// terms left out are below 2^-24 of the product).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks: built with -DCHUNK_PROF, thread 0 of each of the first
// 4096 blocks writes the global timer at mark k after a barrier, and
// chunk_prof_read copies the marks out; otherwise a mark is nothing.
#ifdef CHUNK_PROF
__device__ long long chunk_prof[4096][16];
#define CHUNK_MARK(k)                                                     \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0 && blockIdx.x < 4096) {                          \
      long long t_;                                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      chunk_prof[blockIdx.x][k] = t_;                                     \
    }                                                                     \
  } while (0)
extern "C" int chunk_prof_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, chunk_prof, sizeof(chunk_prof));
}
#else
#define CHUNK_MARK(k) \
  do {                \
  } while (0)
#endif

namespace chunk {

constexpr int L = 64;                  // chunk length = tile rows and cols
constexpr int TILE = L * L;            // elements per tile

// bf16 tile [64][64]: 8 chunks of 8 per row, chunk index ^= row % 8
__device__ __forceinline__ int bi(int r, int c) {
  return r * L + (c ^ ((r & 7) << 3));
}
// float32 tile [64][64]: pairs of 8-float groups, group index ^= row % 8
__device__ __forceinline__ int fi(int r, int c) {
  return r * L + (c ^ ((r & 7) << 3));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a * b
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x0, x1) -> three bf16x2 pieces, x0 in the low half
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = pack(h);
  mid = pack(m);
  lo = pack(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// A fragments (hi, mid, lo) of rows m0.. of a float32 tile, k cols k0..
// (k0 a multiple of 16); ``get(r, c)`` returns the float2 at (r, c..c+1)
template <typename Get>
__device__ __forceinline__ void a_split(uint32_t a[3][4], int m0, int k0,
                                        int lane, Get get) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  const float2 v0 = get(m0 + g, k0 + c), v1 = get(m0 + g + 8, k0 + c);
  const float2 v2 = get(m0 + g, k0 + c + 8), v3 = get(m0 + g + 8, k0 + c + 8);
  split3(v0.x, v0.y, a[0][0], a[1][0], a[2][0]);
  split3(v1.x, v1.y, a[0][1], a[1][1], a[2][1]);
  split3(v2.x, v2.y, a[0][2], a[1][2], a[2][2]);
  split3(v3.x, v3.y, a[0][3], a[1][3], a[2][3]);
}

// A fragments (hi, mid, lo) from two C tiles held in registers (cols
// 16 kk .. 16 kk + 15 of a 16-row strip)
__device__ __forceinline__ void a_split_acc(uint32_t a[3][4],
                                            const float c0[4],
                                            const float c1[4]) {
  split3(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split3(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split3(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split3(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

// lane's ldmatrix row address for an A fragment (rows m0.., cols k0..)
// of a bf16 tile stored [m][k]
__device__ __forceinline__ const __nv_bfloat16* a_addr(
    const __nv_bfloat16* t, int m0, int k0, int lane) {
  return t + bi(m0 + (lane & 15), k0 + ((lane >> 4) << 3));
}
// ... of a bf16 tile stored [k][m] (ldsm_x4_t)
__device__ __forceinline__ const __nv_bfloat16* at_addr(
    const __nv_bfloat16* t, int m0, int k0, int lane) {
  const int q = lane >> 3;
  return t + bi(k0 + (lane & 7) + ((q >> 1) << 3), m0 + ((q & 1) << 3));
}
// B fragments of two n tiles (cols n0.., n0 + 8..; k rows k0..): regs
// b0, b1 of tile n0, then b0, b1 of tile n0 + 8.  Tile stored [n][k]:
__device__ __forceinline__ const __nv_bfloat16* b_addr(
    const __nv_bfloat16* t, int n0, int k0, int lane) {
  return t + bi(n0 + (lane & 7) + ((lane >> 4) << 3),
                k0 + (((lane >> 3) & 1) << 3));
}
// ... tile stored [k][n] (ldsm_x4_t):
__device__ __forceinline__ const __nv_bfloat16* bt_addr(
    const __nv_bfloat16* t, int n0, int k0, int lane) {
  return t + bi(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                n0 + ((lane >> 4) << 3));
}

// the chunk-order ticket: blocks take chunks in the order of their
// tickets, chunk-major, so the block that a chunk waits for has started.
// The block that takes the last ticket (every other block has taken its
// own) sets the counter back to 0 for the next launch.
__device__ __forceinline__ int take_ticket(int* counter) {
  __shared__ int tk;
  if (threadIdx.x == 0) {
    tk = atomicAdd(counter, 1);
    if (tk == (int)gridDim.x - 1) atomicExch(counter, 0);
  }
  __syncthreads();
  return tk;
}
// wait for the predecessor's flag, then lower it: its one reader has it,
// so every flag is 0 again when the launch ends (the wrapper zeroes its
// flags once, not per call).  A wait of more than 2^24 polls, seconds, is
// a fault: the kernel traps, and the launch reports an error instead of
// hanging the card.
__device__ __forceinline__ void wait_flag(int* f) {
  if (threadIdx.x == 0) {
    int v;
    for (int it = 0;; ++it) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v) : "l"(f) : "memory");
      if (v != 0) break;
      if (it > (1 << 24)) __trap();
      __nanosleep(64);
    }
    *f = 0;
  }
  __syncthreads();
}
// the 16 KB float32 state tile at s into L2, one 128-byte line per thread
__device__ __forceinline__ void prefetch_state(const float* s) {
  if (threadIdx.x < 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(s + 32 * threadIdx.x));
}
// every thread has written its part of the state: make it visible, then
// raise the flag
__device__ __forceinline__ void raise_flag(int* f) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(f), "r"(1)
                 : "memory");
}

// ---------------------------------------------------------------------
// The backward kernels' pieces (rwkv6_chunk_bwd.cu, ssm_chunk_bwd.cu).
// Float tiles there are [64][LD] with a padded row, read through getters.

constexpr int LD = L + 1;              // padded float row
constexpr int FT = L * LD;             // floats per padded tile
__device__ __forceinline__ int ti(int r, int c) { return r * LD + c; }

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

// acc (a 16 x 32 block at rows m0.., cols n0.. of a 64 x 64 product) +=
// sum_{k < 64} A(m, k) B(k, n), both operands float32 read through the
// getters ga(m, k), gb(k, n) and split into three bf16 pieces each (six
// mma per tile, as in the forward kernels: float32 accuracy on the tensor
// cores).  acc[jn][e] is element (m0 + g + 8 (e / 2), n0 + 8 jn + 2 (lane %
// 4) + e % 2) with g = lane / 4.
template <class GA, class GB>
__device__ __forceinline__ void mm6(float (&acc)[4][4], int m0, int n0,
                                    int lane, GA ga, GB gb) {
  const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll 1
  for (int k0 = 0; k0 < L; k0 += 16) {
    uint32_t a3[3][4];
    a_split(a3, m0, k0, lane, [&](int rr, int c) {
      return make_float2(ga(rr, c), ga(rr, c + 1));
    });
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int nn = n0 + 8 * jn + g;
      uint32_t b0[3], b1[3];
      split3(gb(k0 + cq, nn), gb(k0 + cq + 1, nn), b0[0], b0[1], b0[2]);
      split3(gb(k0 + cq + 8, nn), gb(k0 + cq + 9, nn), b1[0], b1[1], b1[2]);
      mma(acc[jn], a3[0], b0[0], b1[0]);
      mma(acc[jn], a3[0], b0[1], b1[1]);
      mma(acc[jn], a3[1], b0[0], b1[0]);
      mma(acc[jn], a3[0], b0[2], b1[2]);
      mma(acc[jn], a3[2], b0[0], b1[0]);
      mma(acc[jn], a3[1], b0[1], b1[1]);
    }
  }
}
__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.0f;
}
// f(row, col, value) for each element of acc
template <class F>
__device__ __forceinline__ void each_acc(float (&acc)[4][4], int m0,
                                         int n0, int lane, F f) {
  const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(m0 + g + ((e >> 1) << 3), n0 + 8 * jn + cq + (e & 1), acc[jn][e]);
}

// the sum over a block's threads, in a fixed order; red holds 8 floats
// (8 warps); the result is in thread 0
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();
  return s;
}

// out[q * I + i] = sum_{g < G} in[(q * G + g) * I + i], g in order: the
// second stage of a deterministic sum over heads or over (batch, chunk)
__global__ void group_sum_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int G,
                                 long long I, long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long q = e / I, i = e % I;
    const float* src = in + q * G * I + i;
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s += src[g * I];
    out[e] = s;
  }
}
inline int group_sum(const float* in, float* out, int nq, int G,
                     long long I, cudaStream_t stream) {
  const long long total = (long long)nq * I;
  if (total == 0) return 0;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                     : 4096);
  group_sum_kernel<<<blocks, 256, 0, stream>>>(in, out, G, I, total);
  return (int)cudaGetLastError();
}

}  // namespace chunk
