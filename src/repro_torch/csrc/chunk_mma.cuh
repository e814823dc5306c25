// Shared pieces of the chunked scan kernels (ssm_chunk.cu, rwkv6_chunk.cu)
// and their backward (ssm_chunk_bwd.cu, rwkv6_chunk_bwd.cu): warp-level
// bf16 tensor-core products (mma.sync m16n8k16, float32 accumulation) on
// 64 x 64 tiles in shared memory, the three-piece split of float32
// operands, and the flags that carry a state from one chunk's block to the
// next.
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
// chunk_prof_read copies the marks out; otherwise a mark is nothing.  The
// backward kernels, whose phases repeat (a block of ssm_chunk_bwd.cu takes
// several heads), sum each phase's time instead: CHUNK_PHASE_START sets
// slot 0 (and the running mark, slot 15) to the timer and zeroes the
// rest; CHUNK_PHASE(k) adds the time since the last phase mark to slot k.
#ifdef CHUNK_PROF
__device__ long long chunk_prof[4096][16];
__device__ __forceinline__ long long chunk_timer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define CHUNK_MARK(k)                                                     \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0 && blockIdx.x < 4096)                            \
      chunk_prof[blockIdx.x][k] = chunk_timer();                          \
  } while (0)
#define CHUNK_PHASE_START                                                 \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0 && blockIdx.x < 4096) {                          \
      const long long t_ = chunk_timer();                                 \
      for (int k_ = 1; k_ < 15; ++k_) chunk_prof[blockIdx.x][k_] = 0;     \
      chunk_prof[blockIdx.x][0] = chunk_prof[blockIdx.x][15] = t_;        \
    }                                                                     \
  } while (0)
#define CHUNK_PHASE(k)                                                    \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0 && blockIdx.x < 4096) {                          \
      const long long t_ = chunk_timer();                                 \
      chunk_prof[blockIdx.x][k] += t_ - chunk_prof[blockIdx.x][15];       \
      chunk_prof[blockIdx.x][15] = t_;                                    \
    }                                                                     \
  } while (0)
extern "C" int chunk_prof_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, chunk_prof, sizeof(chunk_prof));
}
#else
#define CHUNK_MARK(k) \
  do {                \
  } while (0)
#define CHUNK_PHASE_START \
  do {                    \
  } while (0)
#define CHUNK_PHASE(k) \
  do {                 \
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
// Their tiles are bf16 (the bf16 route's inputs) or float32 (the float32
// route's inputs, and sums, states and decays), both in the swizzled
// layout above, and a product takes the fewest mma that keep float32 sums:
// one for two bf16 tiles, three where one operand is float32 (split in
// three pieces), six where both are.

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
// (a, b) to dst[0], dst[1]; dst[1] only when it is in (two == true)
__device__ __forceinline__ void store2(float* dst, bool two, float a,
                                       float b) {
  if (two && !(reinterpret_cast<uintptr_t>(dst) & 7))
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  else {
    dst[0] = a;
    if (two) dst[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, bool two, float a,
                                       float b) {
  if (two && !(reinterpret_cast<uintptr_t>(dst) & 3))
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  else {
    dst[0] = __float2bfloat16(a);
    if (two) dst[1] = __float2bfloat16(b);
  }
}

// bf16 pieces of an operand of type T
template <typename T> struct Pieces { static constexpr int n = 3; };
template <> struct Pieces<__nv_bfloat16> { static constexpr int n = 1; };

__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
// one float (zero when !in), without waiting for it
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}
// a [64][64] tile of T from rows src + r * stride (r < rows, columns c <
// cols; zeros elsewhere): 16-byte cp.async when vec (src and stride
// 16-byte aligned; the caller waits), else element loads
template <typename T, int NT>
__device__ __forceinline__ void load_tile(T* tile, const T* src,
                                          long long stride, int rows,
                                          int cols, bool vec) {
  if (vec) {
    constexpr int per = 16 / sizeof(T), cpr = L / per;
    for (int e = threadIdx.x; e < L * cpr; e += NT) {
      const int r = e / cpr, c = (e % cpr) * per;
      const int nb = r < rows ? min(max(cols - c, 0), per) * (int)sizeof(T)
                              : 0;
      cp_async_n(tile + bi(r, c), nb ? src + r * stride + c : src, nb);
    }
  } else {
    for (int e = threadIdx.x; e < TILE; e += NT) {
      const int r = e >> 6, c = e & 63;
      tile[bi(r, c)] = r < rows && c < cols ? src[r * stride + c]
                                            : from_f<T>(0.0f);
    }
  }
}

// the 8 values at (r, c .. c + 7) of a tile (c a multiple of 8: one
// 16-byte chunk of a bf16 row, two of a float32 row) as floats
__device__ __forceinline__ void ld8(float* o, const __nv_bfloat16* t, int r,
                                    int c) {
  const uint4 raw = *reinterpret_cast<const uint4*>(t + bi(r, c));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    o[2 * e] = f.x;
    o[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void ld8(float* o, const float* t, int r,
                                    int c) {
  const float4 a = *reinterpret_cast<const float4*>(t + fi(r, c));
  const float4 b = *reinterpret_cast<const float4*>(t + fi(r, c) + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ float2 f2at(const float* t, int r, int c) {
  return *reinterpret_cast<const float2*>(t + fi(r, c));
}
// B fragments (hi, mid, lo) of the n tiles n0, n0 + 8 (k rows k0..):
// b[q][0..1] tile n0, b[q][2..3] tile n0 + 8; get(k, n) returns the float2
// at (k, n), (k + 1, n)
template <typename Get>
__device__ __forceinline__ void b_split(uint32_t b[3][4], int n0, int k0,
                                        int lane, Get get) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int jt = 0; jt < 2; ++jt) {
    const float2 v0 = get(k0 + c, n0 + 8 * jt + g);
    const float2 v1 = get(k0 + c + 8, n0 + 8 * jt + g);
    split3(v0.x, v0.y, b[0][2 * jt], b[1][2 * jt], b[2][2 * jt]);
    split3(v1.x, v1.y, b[0][2 * jt + 1], b[1][2 * jt + 1],
           b[2][2 * jt + 1]);
  }
}

// B fragments as b_split's in P pieces: three, or one with each pair
// rounded to bf16 (a float32 operand of a product that only feeds a bf16
// result)
template <int P, typename Get>
__device__ __forceinline__ void b_pieces(uint32_t (&b)[P][4], int n0, int k0,
                                         int lane, Get get) {
  if constexpr (P == 3) {
    b_split(b, n0, k0, lane, get);
  } else {
    const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const float2 v0 = get(k0 + c, n0 + 8 * jt + g);
      const float2 v1 = get(k0 + c + 8, n0 + 8 * jt + g);
      b[0][2 * jt] = pack(__floats2bfloat162_rn(v0.x, v0.y));
      b[0][2 * jt + 1] = pack(__floats2bfloat162_rn(v1.x, v1.y));
    }
  }
}

// A fragments of rows m0.., k cols k0.. of a tile stored [m][k] ...
__device__ __forceinline__ void frag_a(uint32_t (&a)[1][4],
                                       const __nv_bfloat16* t, int m0,
                                       int k0, int lane) {
  ldsm_x4(a[0], a_addr(t, m0, k0, lane));
}
__device__ __forceinline__ void frag_a(uint32_t (&a)[3][4], const float* t,
                                       int m0, int k0, int lane) {
  a_split(a, m0, k0, lane, [&](int r, int c) { return f2at(t, r, c); });
}
// ... of a float32 tile stored [k][m]
__device__ __forceinline__ void frag_at(uint32_t (&a)[3][4], const float* t,
                                        int m0, int k0, int lane) {
  a_split(a, m0, k0, lane, [&](int r, int c) {
    return make_float2(t[fi(c, r)], t[fi(c + 1, r)]);
  });
}
// B fragments of the n tiles n0, n0 + 8, k rows k0.., of a tile stored
// [n][k] ...
__device__ __forceinline__ void frag_b(uint32_t (&b)[1][4],
                                       const __nv_bfloat16* t, int n0,
                                       int k0, int lane) {
  ldsm_x4(b[0], b_addr(t, n0, k0, lane));
}
__device__ __forceinline__ void frag_b(uint32_t (&b)[3][4], const float* t,
                                       int n0, int k0, int lane) {
  b_split(b, n0, k0, lane, [&](int k, int n) { return f2at(t, n, k); });
}
// ... stored [k][n]
__device__ __forceinline__ void frag_bt(uint32_t (&b)[1][4],
                                        const __nv_bfloat16* t, int n0,
                                        int k0, int lane) {
  ldsm_x4_t(b[0], bt_addr(t, n0, k0, lane));
}
__device__ __forceinline__ void frag_bt(uint32_t (&b)[3][4], const float* t,
                                        int n0, int k0, int lane) {
  b_split(b, n0, k0, lane, [&](int k, int n) {
    return make_float2(t[fi(k, n)], t[fi(k + 1, n)]);
  });
}

// d += A B for one n tile (o = 0: tile n0, o = 2: tile n0 + 8), operands
// in PA and PB pieces: the products of pieces down to 2^-24 of the result
template <int PA, int PB>
__device__ __forceinline__ void mma_p(float d[4], const uint32_t (&a)[PA][4],
                                      const uint32_t (&b)[PB][4], int o) {
  if constexpr (PA == 1 && PB == 1) {
    mma(d, a[0], b[0][o], b[0][o + 1]);
  } else if constexpr (PB == 1) {
#pragma unroll
    for (int q = PA - 1; q >= 0; --q) mma(d, a[q], b[0][o], b[0][o + 1]);
  } else if constexpr (PA == 1) {
#pragma unroll
    for (int q = PB - 1; q >= 0; --q) mma(d, a[0], b[q][o], b[q][o + 1]);
  } else {
    mma(d, a[1], b[1][o], b[1][o + 1]);
    mma(d, a[2], b[0][o], b[0][o + 1]);
    mma(d, a[0], b[2][o], b[2][o + 1]);
    mma(d, a[1], b[0][o], b[0][o + 1]);
    mma(d, a[0], b[1][o], b[1][o + 1]);
    mma(d, a[0], b[0][o], b[0][o + 1]);
  }
}

// acc (rows m0.., cols n0 .. n0 + 31 as four n tiles of 8) += sum over the
// k steps k0 = k_lo, k_lo + 16, .. < k_hi of A B; fa(a, k0) gives the A
// fragments, fb(b, k0, nn) the B fragments of the tiles nn, nn + 8.
// acc[jn][e] is element (m0 + g + 8 (e / 2), n0 + 8 jn + 2 (lane % 4) +
// e % 2) with g = lane / 4.
template <int PA, int PB, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[4][4], int n0, int k_lo,
                                   int k_hi, FA fa, FB fb) {
#pragma unroll 1
  for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
    uint32_t a[PA][4];
    fa(a, k0);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b[PB][4];
      fb(b, k0, n0 + 16 * jp);
      mma_p<PA, PB>(acc[2 * jp], a, b, 0);
      mma_p<PA, PB>(acc[2 * jp + 1], a, b, 2);
    }
  }
}
__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.0f;
}
// f(row, col, value) for each element of acc (reference to the value)
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
// c[jn][e % 2] += f(row, col) * acc[jn][e] and r[e / 2] += the same: a
// weighted column and row sum of acc's elements (indices fixed at compile
// time, so the sums stay in registers)
template <class F>
__device__ __forceinline__ void col_sums(float (&c)[4][2],
                                         const float (&acc)[4][4], int m0,
                                         int n0, int lane, F f) {
  const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[jn][e & 1] += f(m0 + g + ((e >> 1) << 3), n0 + 8 * jn + cq + (e & 1)) *
                      acc[jn][e];
}
template <class F>
__device__ __forceinline__ void row_sums(float (&r)[2],
                                         const float (&acc)[4][4], int m0,
                                         int n0, int lane, F f) {
  const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e >> 1] += f(m0 + g + ((e >> 1) << 3), n0 + 8 * jn + cq + (e & 1)) *
                   acc[jn][e];
}
// per-row sums of a 16 x 32 block held as acc (v[0]: row m0 + g, v[1]:
// row m0 + g + 8), folded over the four lanes of a row in a fixed order;
// lanes with lane % 4 == 0 hold them
__device__ __forceinline__ void fold_rows(float (&v)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] += __shfl_xor_sync(~0u, v[h], 1);
    v[h] += __shfl_xor_sync(~0u, v[h], 2);
  }
}
// per-column sums (c[jn][e % 2] the column n0 + 8 jn + 2 (lane % 4) + e %
// 2) folded over the 8 row groups; lanes 0-3 hold them
__device__ __forceinline__ void fold_cols(float (&c)[4][2]) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        c[jn][e] += __shfl_xor_sync(~0u, c[jn][e], o);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
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
