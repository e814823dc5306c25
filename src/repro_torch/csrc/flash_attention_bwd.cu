// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the blocked
// online-softmax forward (csrc/flash_attention.cu) from the saved q, k, v,
// out and the forward's logsumexp.
//
// Replaces no Pallas kernel: the TPU path has no flash backward kernel.  Its
// counterpart is the custom VJP of repro/models/layers.py,
// _blocked_attention_core's _core_bwd, "the TPU flash-bwd dataflow in XLA
// form", which the port runs as these kernels on the card (its plain copy
// is kernels/flash_attention/ref.py blocked_bwd_ref).
//
// Layout: q [B, Sq, H, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, Dv], out / dout
// [B, Sq, H, Dv], lse [B, H, Sq] float32 (natural log; +inf for a row with
// no key), dq / dk / dv like q / k / v, in q's dtype (bfloat16 or float32).
// GQA: head h reads kv head h / (H / Hkv).
//
// Math (per query row i, key j, with s the scaled, soft-capped score):
//   p = exp(s - lse_i), masked to 0 (keys at or past seq_k_valid, above the
//   causal diagonal shifted by q_offset); delta_i = sum_c dout_ic out_ic;
//   ds = p (dp - delta_i) with dp = dout_i . v_j, times 1 - (s / cap)^2 under
//   a soft cap; dv_j = sum_i p dout_i; dk_j = scale sum_i ds q_i; dq_i =
//   scale sum_j ds k_j.
//
// Three kernels a dtype, no atomics: every output element has one owner, so
// a step repeats bit for bit (the restart check of the training loop needs
// that).
//   fa_bwd_delta_kernel  delta [B, H, Sq] float32, one warp a row;
//   dk / dv kernel       one block per (64-key block, b * Hkv + kv head):
//                        it walks the group's query heads and the query
//                        blocks that can see its keys, recomputes S and P,
//                        forms dP and dS, and keeps dK, dV in registers;
//   dq kernel            one block per (b * H + h, 64-row query block):
//                        it walks its key blocks and keeps dQ in registers.
// Both recompute S = Q K^T and dP = dO V^T: 7 D multiply-adds per visible
// (row, key) pair are computed, against 5 D for the backward's own products
// (S, dP, dV, dK, dQ).  One kernel with dQ summed across key blocks would
// compute 5 D, but by atomics (an order that changes from run to run) or a
// second pass over a [B, H, Sq, Sk / 64, D] float32 buffer; two kernels keep
// one owner per element for 40% more products.
//
// What bounds it on an H100: operations.  At smollm-135m's training shape
// ([8, 2048, 9 / 3, 64] causal bf16) one backward does 5 x 2 x 64 flops on
// each of the 8 x 9 x 2048 x 2049 / 2 visible pairs, 97 GFLOP, over 101 MB
// of q, k, v, out, dout, dq, dk, dv and lse: 0.098 ms at the 989 TFLOP/s
// bf16 tensor-core peak against 0.030 ms at the memory rate.  The kernels
// compute 7 D a pair on whole 64 x 64 tiles (the diagonal tiles in full):
// 140 GFLOP, 0.14 ms at the peak.  At deepseek-v2-lite's ([4, 4096, 16,
// 192 / 128]) products over D take 2 x 192 flops a pair and those over Dv
// 2 x 128: 2 (3 x 192 + 2 x 128) x 537 M pairs, 0.89 TFLOP, 0.90 ms.
//
// bfloat16, fa_bwd_dkdv_wgmma_kernel<D, DV> / fa_bwd_dq_wgmma_kernel<D, DV>,
// (D, Dv) in {(64, 64), (80, 80), (128, 128)}, and their two-warpgroup
// forms at (192, 128) (below): every product on the tensor
// cores, wgmma m64nNk16 with float32 accumulators, one warpgroup (128
// threads) a block.  One thread starts every copy by TMA (hopper_mma.cuh:
// 4-D tensor maps of q, k, v and dout, passed by value as __grid_constant__
// parameters) into the 128-byte swizzle wgmma reads; rows past Sq or Sk
// arrive as zeros, as do the columns past 80 of D = 80, which takes two
// 64-column atoms as the forward does.
//   dk / dv: the block's K and V tiles (64 keys) are loaded once and stay;
//   the Q and dO tiles of each (head, query block) it visits come through a
//   ring of two stages, the next pair in flight while this one is computed,
//   and each row's lse (log2 domain) and delta through a double buffer in
//   shared memory, one value a thread.  S^T = K Q^T and dP^T = V dO^T are
//   wgmma SS (both operands K-major, as the forward's S = Q K^T); P^T and
//   dS^T are formed on the accumulator fragments in registers, with the
//   masks only in the tiles that straddle seq_k_valid or the causal
//   diagonal, rounded to bf16 and packed into A fragments (as the forward
//   packs P); dV += P^T dO and dK += dS^T Q are wgmma RS with dO and Q read
//   MN-major from the tiles already in shared memory (N = 64, or 128 at D =
//   80 and 128, the columns past 80 zeros).  Blocks with the most query
//   blocks to visit (the first keys, under causal) are launched first.
//   dq: Q and dO stay; the K and V tiles come through a two-stage ring.  S
//   = Q K^T and dP = dO V^T are SS; dS is formed in registers from the
//   row's lse and delta (two rows a thread, held in registers) and dQ += dS
//   K is RS with K read MN-major.  The last query blocks (the most keys,
//   under causal) are launched first.
//   Rounding: P and dS go to bf16 before the products, as the forward
//   rounds P before PV; _core_bwd keeps them in float32.  The sums are
//   float32 and each gradient is rounded to bf16 once.
//   Sizes: shared memory is one resident pair of tiles and two streamed
//   pairs, 3 x 16 KB + 1 KB at D = 64, 3 x 32 KB + 1 KB at D = 80 and 128
//   (two blocks an SM).  Registers: dK and dV take DP / 2 + DVP / 2
//   float32 accumulators a thread (64 at D = 64, 128 at D = 80 and 128),
//   S^T and dP^T 32 each, their packed bf16 fragments 16 each (ptxas's
//   counts are on chip_smoke.py's ptxas line).
//   MLA's (192, 128) (deepseek-v2's training attention): one warpgroup
//   would need 96 + 64 accumulators for dK and dV besides S^T and dP^T,
//   and its tiles (K 24 KB + V 16 KB resident, two streamed pairs) hold
//   one block an SM, four warps.  So both kernels take two warpgroups a
//   block (eight warps an SM), with the same tiles, TMA ring and rounding:
//   fa_bwd_dkdv_wgmma2_kernel splits the products by gradient (warpgroup
//   0: S^T, P^T, dV += P^T dO; warpgroup 1: dP^T, dS^T from P^T handed
//   over through shared memory, dK += dS^T Q, wgmma N = 192), and
//   fa_bwd_dq_wgmma2_kernel gives each warpgroup one of two adjacent query
//   blocks on shared K / V tiles.  Both meet at named barriers.
//
// float32, fa_bwd_dkdv_kernel<float, DP> / fa_bwd_dq_kernel<float, DP> (Dv
// <= D <= 128, D padded to DP = 16, 32, 64 or 128: the smoke models, whose
// card == CPU checks hold at 1e-5): every product stays IEEE float32 FFMA
// on the CUDA cores.  wgmma has no float32 mode, only TF32, which keeps
// about three decimal digits and would break those checks; the float32
// shapes are small, so the FFMA kernels' floor (the 67 TFLOP/s FFMA peak)
// costs little.  Register blocking, as the float32 forward: 256 threads,
// (ty, tx) = (tid / 16, tid % 16).  S and dP: thread (ty, tx) holds rows ty
// + 16 i and keys tx + 16 j (i, j < 4), reading four Q / dO rows (a
// broadcast over the 16 lanes of a row group) and four K / V rows as float4
// per four steps of D.  The dk / dv (dq) sums: thread (ty, tx) holds keys
// (rows) ty + 16 j and the columns of a 16-lane group (CPT = DP / 16 each),
// reading P^T and dS^T (dS) as float4 along the rows (keys) from shared
// memory.  Rows are DP + 4 floats (an odd number of 16-byte chunks), so the
// 16 rows of a K load fall in distinct bank quads.  Shared memory: Q, dO,
// K, V tiles of 64 x (DP + 4) floats and P^T, dS^T of 64 x 68: 104 KB at DP
// = 64, 168 KB at DP = 128; tiles are loaded synchronously.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"   // wgmma, descriptors, mbarriers, TMA, tensor maps

namespace {

constexpr int MAX_D = 128;
constexpr int BT = 64;               // query rows and keys a tile
constexpr int NT = 256;              // threads a block
constexpr int SLD = BT + 4;          // P^T / dS row stride in floats
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct BwdShape {
  static constexpr int LD = DP + 4;
  static constexpr int TILE = BT * LD;
  static constexpr int SMEM = (4 * TILE + 2 * BT * SLD + 2 * BT) * 4;
  static constexpr int CPT = DP / 16;            // columns a thread
  static constexpr int CW = CPT < 4 ? CPT : 4;   // ... of them adjacent
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// Rows [row0, row0 + BT) of one head (src: its row 0, rows `stride`
// elements apart) as float32 into a tile of LD-float rows; rows at or past
// `rows` arrive as zeros, columns past d are left as they are (zeroed once
// by zero_pad).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int row0, int rows,
                                          int d) {
  constexpr int LD = BwdShape<DP>::LD;
  for (int e = threadIdx.x; e < BT * d; e += NT) {
    const int r = e / d, c = e - r * d;
    dst[r * LD + c] = row0 + r < rows
                          ? to_f(src[(size_t)(row0 + r) * stride + c])
                          : 0.0f;
  }
}

// Columns [d, DP) of `n` consecutive tiles starting at `tile` set to 0.
template <int DP>
__device__ __forceinline__ void zero_pad(float* tile, int n, int d) {
  constexpr int LD = BwdShape<DP>::LD;
  if (d < DP)
    for (int e = threadIdx.x; e < n * BT * (DP - d); e += NT)
      tile[(e / (DP - d)) * LD + d + e % (DP - d)] = 0.0f;
}

// s[i][j] = a_row(ty + 16 i) . b_row(tx + 16 j) over DP columns.
template <int DP>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int LD = BwdShape<DP>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < DP / 4; ++c) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + 4 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// p of one pair (into s, from its raw dot product Q K^T) given the row's
// lse (log2 domain), and the soft cap's derivative its dS takes (1 without
// a cap); `keep` false masks the pair.
__device__ __forceinline__ float pair_p(float& s, float lse2, bool keep,
                                        float scale, float cap) {
  float x = s * scale, dcap = 1.0f;
  if (cap > 0.0f) {
    x = cap * tanhf(x / cap);
    const float t = x / cap;
    dcap = 1.0f - t * t;
  }
  s = keep ? exp2f(x * LOG2E - lse2) : 0.0f;
  return dcap;
}

// p and ds of one (row, key) pair from its raw dot products s (Q K^T) and
// dp (dO V^T), in place, given the row's lse (log2 domain) and delta;
// `keep` false masks the pair.
__device__ __forceinline__ void pair_p_ds(float& s, float& dp, float lse2,
                                          float dlt, bool keep, float scale,
                                          float cap) {
  const float dcap = pair_p(s, lse2, keep, scale, cap);
  dp = s * (dp - dlt) * dcap;
}

// P and dS of the thread's 4 x 4 pairs (rows q0 + ty + 16 i, keys k0 + tx
// + 16 j); the tile's row lse (log2 domain) and delta come from shared
// memory.
__device__ __forceinline__ void p_ds(float (&s)[4][4], float (&dp)[4][4],
                                     const float* lse2, const float* dlt,
                                     int q0, int k0, int ty, int tx, int sq,
                                     int k_valid, int causal, int q_offset,
                                     float scale, float cap) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      const bool keep = qi < sq && kj < k_valid
                        && !(causal && (long long)qi + q_offset < kj);
      pair_p_ds(s[i][j], dp[i][j], lse2[r], dlt[r], keep, scale, cap);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_cols(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

// The CPT columns of one row that thread column group cg holds.
template <int DP>
__device__ __forceinline__ void row_cols(float (&x)[BwdShape<DP>::CPT],
                                         const float* row, int cg) {
  constexpr int CPT = BwdShape<DP>::CPT, CW = BwdShape<DP>::CW;
#pragma unroll
  for (int mm = 0; mm < CPT / CW; ++mm) {
    float part[CW];
    load_cols<CW>(part, row + mm * 16 * CW + cg * CW);
#pragma unroll
    for (int c = 0; c < CW; ++c) x[mm * CW + c] = part[c];
  }
}

template <int DP>
__device__ __forceinline__ int col_of(int cg, int c) {
  constexpr int CW = BwdShape<DP>::CW;
  return (c / CW) * 16 * CW + cg * CW + c % CW;
}

__device__ __forceinline__ float at(const float4& t, int e) {
  return e == 0 ? t.x : e == 1 ? t.y : e == 2 ? t.z : t.w;
}

// delta[b, h, q] = sum_c dout[b, q, h, c] out[b, q, h, c], one warp a row.
template <typename T>
__global__ void __launch_bounds__(NT)
fa_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                    float* __restrict__ delta, long long rows, int sq, int h,
                    int dv) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bq = row / h;               // b * sq + q
  const int hh = (int)(row - bq * h);
  const size_t off = (size_t)row * dv;        // [B, Sq, H, Dv] row-major
  float acc = 0.0f;
  for (int c = lane; c < dv; c += 32)
    acc = fmaf(to_f(dout[off + c]), to_f(out[off + c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
  if (lane == 0) {
    const long long b = bq / sq, qi = bq - b * sq;
    delta[(b * h + hh) * sq + qi] = acc;
  }
}

// The tile's lse (log2 domain) and delta rows into shared memory.
__device__ __forceinline__ void load_rows(float* lse2, float* dlt,
                                          const float* lse, const float* delta,
                                          size_t base, int q0, int sq) {
  for (int r = threadIdx.x; r < BT; r += NT) {
    const int qi = q0 + r;
    lse2[r] = qi < sq ? lse[base + qi] * LOG2E : INFINITY;
    dlt[r] = qi < sq ? delta[base + qi] : 0.0f;
  }
}

// One block per (64-key block, b * Hkv + kv head).
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int sq, int sk, int seq_k, int h,
                   int hkv, int d, int dvd, int causal, int q_offset,
                   float scale, float cap) {
  using S = BwdShape<DP>;
  constexpr int LD = S::LD, TILE = S::TILE, CPT = S::CPT;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                      // [BT][LD]
  float* vs = ks + TILE;
  float* qs = vs + TILE;
  float* dos = qs + TILE;
  float* pt = dos + TILE;              // P^T  [key][row], SLD
  float* dst = pt + BT * SLD;          // dS^T [key][row]
  float* lse2 = dst + BT * SLD;        // [BT]
  float* dlt = lse2 + BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BT;
  const int bk = blockIdx.y, b = bk / hkv, kvh = bk % hkv;
  const int g = h / hkv;
  const int k_valid = seq_k < sk ? seq_k : sk;
  const size_t kv_row = (size_t)hkv * d, v_row = (size_t)hkv * dvd;
  const size_t q_row = (size_t)h * d, o_row = (size_t)h * dvd;

  zero_pad<DP>(ks, 1, d);
  zero_pad<DP>(vs, 1, dvd);
  zero_pad<DP>(qs, 1, d);
  zero_pad<DP>(dos, 1, dvd);
  load_tile<T, DP>(ks, k + (size_t)b * sk * kv_row + (size_t)kvh * d, kv_row,
                   k0, k_valid, d);
  load_tile<T, DP>(vs, v + (size_t)b * sk * v_row + (size_t)kvh * dvd, v_row,
                   k0, k_valid, dvd);

  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[j][c] = acc_v[j][c] = 0.0f;

  // the first query block that can see a key of this block
  int qb0 = 0;
  if (causal) {
    const long long first = (long long)k0 - q_offset;   // its first row
    qb0 = first <= 0 ? 0 : (int)(first / BT);
  }
  const int nqb = (sq + BT - 1) / BT;
  if (k0 < k_valid) {
    for (int gi = 0; gi < g; ++gi) {
      const int hh = kvh * g + gi;
      const T* qh = q + (size_t)b * sq * q_row + (size_t)hh * d;
      const T* doh = dout + (size_t)b * sq * o_row + (size_t)hh * dvd;
      const size_t base = ((size_t)b * h + hh) * sq;
      for (int qb = qb0; qb < nqb; ++qb) {
        const int q0 = qb * BT;
        __syncthreads();                 // the last tile's readers are done
        load_tile<T, DP>(qs, qh, q_row, q0, sq, d);
        load_tile<T, DP>(dos, doh, o_row, q0, sq, dvd);
        load_rows(lse2, dlt, lse, delta, base, q0, sq);
        __syncthreads();
        float s[4][4], dp[4][4];
        dot_tile<DP>(s, qs, ks, ty, tx);
        dot_tile<DP>(dp, dos, vs, ty, tx);
        p_ds(s, dp, lse2, dlt, q0, k0, ty, tx, sq, k_valid, causal, q_offset,
             scale, cap);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pt[(tx + 16 * j) * SLD + ty + 16 * i] = s[i][j];
            dst[(tx + 16 * j) * SLD + ty + 16 * i] = dp[i][j];
          }
        __syncthreads();
        // dV += P^T dO, dK += dS^T Q over the tile's rows: thread (ty, tx)
        // holds keys ty + 16 j and column group tx
#pragma unroll 2
        for (int r = 0; r < BT; r += 4) {
          float4 p4[4], d4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p4[j] = *reinterpret_cast<const float4*>(pt + (ty + 16 * j) * SLD
                                                     + r);
            d4[j] = *reinterpret_cast<const float4*>(dst + (ty + 16 * j) * SLD
                                                     + r);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dov[CPT], qv[CPT];
            row_cols<DP>(dov, dos + (r + e) * LD, tx);
            row_cols<DP>(qv, qs + (r + e) * LD, tx);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float pj = at(p4[j], e), dj = at(d4[j], e);
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                acc_v[j][c] = fmaf(pj, dov[c], acc_v[j][c]);
                acc_k[j][c] = fmaf(dj, qv[c], acc_k[j][c]);
              }
            }
          }
        }
      }
    }
  }
  // keys past the valid ones get zeros; keys past Sk are not written
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + ty + 16 * j;
    if (kj >= sk) continue;
    T* dkr = dk + ((size_t)b * sk + kj) * kv_row + (size_t)kvh * d;
    T* dvr = dv + ((size_t)b * sk + kj) * v_row + (size_t)kvh * dvd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = col_of<DP>(tx, c);
      if (col < d) dkr[col] = from_f<T>(acc_k[j][c] * scale);
      if (col < dvd) dvr[col] = from_f<T>(acc_v[j][c]);
    }
  }
}

// One block per (b * H + h, 64-row query block), the last blocks first.
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int sq,
                 int sk, int seq_k, int h, int hkv, int d, int dvd,
                 int causal, int q_offset, float scale, float cap) {
  using S = BwdShape<DP>;
  constexpr int LD = S::LD, TILE = S::TILE, CPT = S::CPT;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + TILE;
  float* ks = dos + TILE;
  float* vs = ks + TILE;
  float* dss = vs + TILE;              // dS [row][key], SLD
  float* lse2 = dss + 2 * BT * SLD;
  float* dlt = lse2 + BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const size_t kv_row = (size_t)hkv * d, v_row = (size_t)hkv * dvd;
  const size_t q_row = (size_t)h * d, o_row = (size_t)h * dvd;
  const T* kb = k + (size_t)b * sk * kv_row + (size_t)kvh * d;
  const T* vb = v + (size_t)b * sk * v_row + (size_t)kvh * dvd;

  const int k_valid = seq_k < sk ? seq_k : sk;
  int k_end = k_valid;
  if (causal) {
    const long long last = (long long)min(q0 + BT, sq) - 1 + q_offset;
    if (last + 1 < k_end) k_end = (int)(last + 1 > 0 ? last + 1 : 0);
  }
  zero_pad<DP>(qs, 4, d);              // Q, dO, K, V: zero the widest pad
  if (dvd < d) {
    zero_pad<DP>(dos, 1, dvd);
    zero_pad<DP>(vs, 1, dvd);
  }
  load_tile<T, DP>(qs, q + (size_t)b * sq * q_row + (size_t)hh * d, q_row, q0,
                   sq, d);
  load_tile<T, DP>(dos, dout + (size_t)b * sq * o_row + (size_t)hh * dvd,
                   o_row, q0, sq, dvd);
  load_rows(lse2, dlt, lse, delta, ((size_t)b * h + hh) * sq, q0, sq);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();                   // the last tile's readers are done
    load_tile<T, DP>(ks, kb, kv_row, k0, k_valid, d);
    load_tile<T, DP>(vs, vb, v_row, k0, k_valid, dvd);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DP>(s, qs, ks, ty, tx);
    dot_tile<DP>(dp, dos, vs, ty, tx);
    p_ds(s, dp, lse2, dlt, q0, k0, ty, tx, sq, k_valid, causal, q_offset,
         scale, cap);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * SLD + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ += dS K: thread (ty, tx) holds rows ty + 16 i and column group tx
#pragma unroll 2
    for (int kk = 0; kk < BT; kk += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = *reinterpret_cast<const float4*>(dss + (ty + 16 * i) * SLD
                                                 + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kv[CPT];
        row_cols<DP>(kv, ks + (kk + e) * LD, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float di = at(d4[i], e);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(di, kv[c], acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    T* dqr = dq + ((size_t)b * sq + qi) * q_row + (size_t)hh * d;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = col_of<DP>(tx, c);
      if (col < d) dqr[col] = from_f<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int sq, int sk, int seq_k, int h,
           int hkv, int d, int dvd, int causal, int q_offset, float scale,
           float cap, cudaStream_t stream) {
  constexpr int SMEM = BwdShape<DP>::SMEM;
  static cudaError_t attr = [] {      // once per (T, DP)
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(fa_bwd_dq_kernel<T, DP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const long long rows = (long long)b * sq * h;
  const long long qblocks = ((long long)sq + BT - 1) / BT;
  const long long kblocks = ((long long)sk + BT - 1) / BT;
  if (qblocks > 65535 || (long long)b * hkv > 65535
      || (rows + NT / 32 - 1) / (NT / 32) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  fa_bwd_delta_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                           0, stream>>>((const T*)out, (const T*)dout, delta,
                                        rows, sq, h, dvd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkdv_kernel<T, DP><<<dim3((unsigned)kblocks, (unsigned)(b * hkv)),
                              NT, SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, sq, sk, seq_k, h, hkv, d, dvd, causal, q_offset, scale,
      cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dq_kernel<T, DP><<<dim3((unsigned)(b * h), (unsigned)qblocks), NT,
                            SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, sq, sk, seq_k, h, hkv, d, dvd, causal, q_offset, scale, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores, fed by TMA
// ---------------------------------------------------------------------------
constexpr int WT = 64;     // keys and query rows a tile (wgmma's M)
constexpr int WTHREADS = 128;   // one warpgroup
constexpr int NST = 2;     // stages of the streamed tiles' ring

// Columns in shared memory: D and Dv rounded up to whole 64-column atoms.
// A "pair" is a D-wide tile (Q or K) and a Dv-wide one (dO or V) of 64 rows:
// one pair stays for the block's life, NST pairs stream.
// D past 128 (MLA's 192) takes the dK / dV kernel of two warpgroups.
template <int D, int DV>
struct WgShape {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int DVP = (DV + 63) / 64 * 64;
  static_assert(DP == 64 || DP == 128 || DP == 192,
                "dK / dQ is wgmma N = 64, 128 or 192");
  static_assert(DVP == 64 || DVP == 128, "dV is wgmma N = 64 or 128");
  static_assert(DVP <= DP, "Dv <= D");
  static constexpr int ATILE = WT * DP * 2;       // bytes of a Q or K tile
  static constexpr int PAIR = ATILE + WT * DVP * 2;
  static constexpr int SMEM = (1 + NST) * PAIR + 1024;   // + alignment
  static constexpr bool SPLIT = DP > 128;         // fa_bwd_dkdv_wgmma2_kernel
};

// acc (64 x 64) = A B^T over the first D columns of two 64-row tiles in
// shared memory, both K-major (A's rows along M, B's along N).
template <int D>
__device__ __forceinline__ void mma_ss(float (&acc)[32], uint32_t sa,
                                       uint32_t sb) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks >> 2) * (WT * 128) + (ks & 3) * 32;
    wgmma_ss_n64(acc, sw128_desc(sa + off, 16, 1024),
                 sw128_desc(sb + off, 16, 1024), 1);
  }
}

// acc (64 x 2N) += A B: A the bf16 fragments a (K = 64), B the 64-row tile
// at sb read MN-major (its rows along K, 2N columns along N).
template <int N>
__device__ __forceinline__ void mma_rs(float (&acc)[N],
                                       const uint32_t (&a)[4][4],
                                       uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(sb + kk * 16 * 128, WT * 128, 1024);
    if constexpr (N == 32) wgmma_rs_n64(acc, a[kk], db);
    else if constexpr (N == 64) wgmma_rs_n128(acc, a[kk], db);
    else wgmma_rs_n192(acc, a[kk], db);
  }
}

// The accumulators of a 64 x 64 product, rounded to bf16, as the A
// fragments of a product over its 64 columns.
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4],
                                         const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

// Rows of one 64 x Dv (or D) accumulator tile to bf16 rows of a [.., ld]
// tensor at `base` (row 0 of the tile), times `mul`; rows at or past `rows`
// (counted from the tile's row 0) and columns at or past `cols` are not
// written.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t ld,
                                           const float (&acc)[N], float mul,
                                           int row_a, int rows, int cols,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    if (col >= cols) continue;
    if (row_a < rows)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)row_a * ld + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row_a + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)(row_a + 8) * ld
                                         + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// One block per (b * Hkv + kv head, 64-key block); blockIdx.y is the key
// block, so the first keys (under causal, the most query blocks) go first.
template <int D, int DV>
__global__ void __launch_bounds__(WTHREADS)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int sk,
                         int seq_k, int h, int hkv, int causal, int q_offset,
                         float scale, float cap) {
  using S = WgShape<D, DV>;
  constexpr int DP = S::DP, DVP = S::DVP, ATILE = S::ATILE, PAIR = S::PAIR;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + NST];   // K / V, then the ring
  __shared__ float rows[2][2 * WT];   // lse (log2) then delta, two buffers
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u, s_v = s_k + ATILE;
  const uint32_t s_ring = s_k + PAIR;   // stage i: Q at + i PAIR, dO + ATILE
  const uint32_t bar_kv = (uint32_t)__cvta_generic_to_shared(bars);
  const uint32_t bar_ring = bar_kv + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bk = blockIdx.x, b = bk / hkv, kvh = bk % hkv;
  const int k0 = blockIdx.y * WT;
  const int g = h / hkv;
  const int k_valid = seq_k < sk ? seq_k : sk;

  // the query blocks that can see a key of this block, for each head of
  // the group: iteration it is head kvh * g + it / per, block qb0 + it % per
  int qb0 = 0;
  if (causal) {
    const long long first = (long long)k0 - q_offset;   // its first row
    qb0 = first <= 0 ? 0 : (int)(first / WT);
  }
  const int nqb = (sq + WT - 1) / WT;
  const int per = (k0 < k_valid && qb0 < nqb) ? nqb - qb0 : 0;
  const int n_it = g * per;

  auto fetch = [&](int it) {   // Q and dO of iteration it, on its stage
    const int hh = kvh * g + it / per, q0 = (qb0 + it % per) * WT;
    const uint32_t bar = bar_ring + (it % NST) * 8;
    const uint32_t dst = s_ring + (it % NST) * PAIR;
    mbar_expect(bar, PAIR);
    tma_tile<DP, WT>(dst, &map_q, bar, hh, q0, b);
    tma_tile<DVP, WT>(dst + ATILE, &map_do, bar, hh, q0, b);
  };
  // thread t's value of iteration it's rows: lse of row t (log2 domain,
  // +inf past Sq, so p = 0 there) for t < 64, delta of row t - 64 after
  auto row_value = [&](int it) {
    const int hh = kvh * g + it / per;
    const int qi = (qb0 + it % per) * WT + (tid & (WT - 1));
    const size_t at = ((size_t)b * h + hh) * sq + qi;
    if (tid < WT) return qi < sq ? lse[at] * LOG2E : INFINITY;
    return qi < sq ? delta[at] : 0.0f;
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + NST; ++i) mbar_init(bar_kv + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_it > 0) {
      mbar_expect(bar_kv, PAIR);
      tma_tile<DP, WT>(s_k, &map_k, bar_kv, kvh, k0, b);
      tma_tile<DVP, WT>(s_v, &map_v, bar_kv, kvh, k0, b);
      for (int it = 0; it < NST - 1 && it < n_it; ++it) fetch(it);
    }
  }
  if (n_it > 0) rows[0][tid] = row_value(0);
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);   // keys k0 + row_a, + 8
  const int kj_a = k0 + row_a, kj_b = kj_a + 8;
  float acc_k[DP / 2], acc_v[DVP / 2];
  zero(acc_k);
  zero(acc_v);
  if (n_it > 0) mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qb0 + it % per) * WT;
    const uint32_t s_q = s_ring + (it % NST) * PAIR, s_do = s_q + ATILE;
    if (tid == 0 && it + NST - 1 < n_it) fetch(it + NST - 1);
    // the next iteration's rows, loaded now and stored after this one's
    // products (its buffer was last read in iteration it - 1)
    const float next = it + 1 < n_it ? row_value(it + 1) : 0.0f;
    mbar_wait(bar_ring + (it % NST) * 8, (it / NST) & 1);

    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_ss<D>(s, s_k, s_q);      // S^T = K Q^T   (keys x rows)
    mma_ss<DV>(dp, s_v, s_do);   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T: accumulator i is key (i & 2 ? kj_b : kj_a) and query
    // row q0 + r; masks only where the tile straddles a limit
    const float* lse2 = rows[it & 1];
    const float* dlt = lse2 + WT;
    const bool edge = k0 + WT > k_valid
                      || (causal && (long long)k0 + WT - 1 > (long long)q0
                                                              + q_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      const int kj = (i & 2) ? kj_b : kj_a;
      const bool keep = !edge
          || (kj < k_valid
              && !(causal && (long long)(q0 + r) + q_offset < kj));
      pair_p_ds(s[i], dp[i], lse2[r], dlt[r], keep, scale, cap);
    }
    uint32_t ap[4][4], ads[4][4];
    to_frags(ap, s);
    to_frags(ads, dp);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    mma_rs(acc_v, ap, s_do);     // dV += P^T dO
    mma_rs(acc_k, ads, s_q);     // dK += dS^T Q
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc_v);
    fence_regs(acc_k);
    if (it + 1 < n_it) rows[(it + 1) & 1][tid] = next;
    __syncthreads();   // this stage may be refilled, the next rows are in
  }

  // keys at or past seq_k_valid hold zeros; keys past Sk are not written
  const size_t k_ld = (size_t)hkv * D, v_ld = (size_t)hkv * DV;
  store_rows(dk + ((size_t)b * sk + k0) * k_ld + (size_t)kvh * D, k_ld,
             acc_k, scale, row_a, sk - k0, D, lane);
  store_rows(dv + ((size_t)b * sk + k0) * v_ld + (size_t)kvh * DV, v_ld,
             acc_v, 1.0f, row_a, sk - k0, DV, lane);
}

// Named barriers of the two-warpgroup kernels, whose warpgroups reach
// them from code of their own: id 1 ends an iteration (both wait), id 2
// hands P over (warpgroup 0 arrives, warpgroup 1 waits).
__device__ __forceinline__ void sync_two_groups() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(2 * WTHREADS) : "memory");
}
__device__ __forceinline__ void arrive_handover() {
  asm volatile("bar.arrive 2, %0;\n" ::"r"(2 * WTHREADS) : "memory");
}
__device__ __forceinline__ void wait_handover() {
  asm volatile("bar.sync 2, %0;\n" ::"r"(2 * WTHREADS) : "memory");
}

// dK / dV at D past 128 (MLA's (192, 128)), where one warpgroup cannot
// hold both sums (64 x 192 and 64 x 128 float32: 160 accumulators a
// thread before S^T and dP^T).  One block per (b * Hkv + kv head, 64-key
// block), the same tiles, ring and order as fa_bwd_dkdv_wgmma_kernel, two
// warpgroups on the same keys, each holding one sum and computing half of
// the products (D + Dv multiply-adds a visible pair each):
//   warpgroup 0: S^T = K Q^T, P^T in registers and to shared memory for
//     warpgroup 1; dV += P^T dO;
//   warpgroup 1: dP^T = V dO^T; waits for P^T, forms dS^T; dK += dS^T Q.
// P^T goes over as float32 in the accumulators' own layout (thread t of
// one group reads what thread t of the other wrote: 16 KB, no bank
// conflict), with the soft cap's derivative beside it under a cap, so dS
// is pair_p_ds's to the bit.  Warpgroup 0's threads keep the rows' lse
// and delta buffer; the groups meet at the end of each iteration (the
// stage may then be refilled, the next rows are in, the P buffer is
// free).
template <int D, int DV>
struct Wg2Shape {
  static constexpr int PX = 2 * WT * WT * 4;   // P^T and the cap's term
  static constexpr int SMEM = WgShape<D, DV>::SMEM + PX;
};

template <int D, int DV>
__global__ void __launch_bounds__(2 * WTHREADS)
fa_bwd_dkdv_wgmma2_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int sk,
                          int seq_k, int h, int hkv, int causal,
                          int q_offset, float scale, float cap) {
  using S = WgShape<D, DV>;
  constexpr int DP = S::DP, DVP = S::DVP, ATILE = S::ATILE, PAIR = S::PAIR;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + NST];   // K / V, then the ring
  __shared__ float rows[2][2 * WT];   // lse (log2) then delta, two buffers
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u, s_v = s_k + ATILE;
  const uint32_t s_ring = s_k + PAIR;   // stage i: Q at + i PAIR, dO + ATILE
  // P^T hand-over after the ring: element i of thread t at [i][t], then
  // the cap's derivative likewise
  float* px = reinterpret_cast<float*>(smem_raw + (s_ring - raw)
                                       + NST * PAIR);
  float* pc = px + WT * WT;
  const uint32_t bar_kv = (uint32_t)__cvta_generic_to_shared(bars);
  const uint32_t bar_ring = bar_kv + 8;
  const int tid = threadIdx.x, wg = tid / WTHREADS, wt = tid % WTHREADS;
  const int warp = wt >> 5, lane = tid & 31;
  const int bk = blockIdx.x, b = bk / hkv, kvh = bk % hkv;
  const int k0 = blockIdx.y * WT;
  const int g = h / hkv;
  const int k_valid = seq_k < sk ? seq_k : sk;

  int qb0 = 0;   // iteration it: head kvh * g + it / per, block qb0 + it % per
  if (causal) {
    const long long first = (long long)k0 - q_offset;
    qb0 = first <= 0 ? 0 : (int)(first / WT);
  }
  const int nqb = (sq + WT - 1) / WT;
  const int per = (k0 < k_valid && qb0 < nqb) ? nqb - qb0 : 0;
  const int n_it = g * per;

  auto fetch = [&](int it) {   // Q and dO of iteration it, on its stage
    const int hh = kvh * g + it / per, q0 = (qb0 + it % per) * WT;
    const uint32_t bar = bar_ring + (it % NST) * 8;
    const uint32_t dst = s_ring + (it % NST) * PAIR;
    mbar_expect(bar, PAIR);
    tma_tile<DP, WT>(dst, &map_q, bar, hh, q0, b);
    tma_tile<DVP, WT>(dst + ATILE, &map_do, bar, hh, q0, b);
  };
  // warpgroup 0's thread t: iteration it's lse of row t (log2 domain, +inf
  // past Sq) for t < 64, delta of row t - 64 after
  auto row_value = [&](int it) {
    const int hh = kvh * g + it / per;
    const int qi = (qb0 + it % per) * WT + (wt & (WT - 1));
    const size_t at = ((size_t)b * h + hh) * sq + qi;
    if (wt < WT) return qi < sq ? lse[at] * LOG2E : INFINITY;
    return qi < sq ? delta[at] : 0.0f;
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + NST; ++i) mbar_init(bar_kv + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_it > 0) {
      mbar_expect(bar_kv, PAIR);
      tma_tile<DP, WT>(s_k, &map_k, bar_kv, kvh, k0, b);
      tma_tile<DVP, WT>(s_v, &map_v, bar_kv, kvh, k0, b);
      for (int it = 0; it < NST - 1 && it < n_it; ++it) fetch(it);
    }
  }
  if (n_it > 0 && wg == 0) rows[0][wt] = row_value(0);
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);   // keys k0 + row_a, + 8
  const int kj_a = k0 + row_a, kj_b = kj_a + 8;
  if (n_it > 0) mbar_wait(bar_kv, 0);

  if (wg == 0) {   // S^T, P^T, dV
    float acc_v[DVP / 2];
    zero(acc_v);
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qb0 + it % per) * WT;
      const uint32_t s_q = s_ring + (it % NST) * PAIR, s_do = s_q + ATILE;
      if (tid == 0 && it + NST - 1 < n_it) fetch(it + NST - 1);
      const float next = it + 1 < n_it ? row_value(it + 1) : 0.0f;
      mbar_wait(bar_ring + (it % NST) * 8, (it / NST) & 1);

      float s[32];
      zero(s);
      fence_regs(s);
      wgmma_fence();
      mma_ss<D>(s, s_k, s_q);      // S^T = K Q^T   (keys x rows)
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      // P^T: accumulator i is key (i & 2 ? kj_b : kj_a) and query row q0
      // + r; masks only where the tile straddles a limit
      const float* lse2 = rows[it & 1];
      const bool edge = k0 + WT > k_valid
                        || (causal && (long long)k0 + WT - 1 > (long long)q0
                                                                + q_offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const int kj = (i & 2) ? kj_b : kj_a;
        const bool keep = !edge
            || (kj < k_valid
                && !(causal && (long long)(q0 + r) + q_offset < kj));
        const float dcap = pair_p(s[i], lse2[r], keep, scale, cap);
        px[i * WTHREADS + wt] = s[i];
        if (cap > 0.0f) pc[i * WTHREADS + wt] = dcap;
      }
      arrive_handover();
      uint32_t ap[4][4];
      to_frags(ap, s);
      fence_regs(acc_v);
      wgmma_fence();
      mma_rs(acc_v, ap, s_do);     // dV += P^T dO
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_v);
      if (it + 1 < n_it) rows[(it + 1) & 1][wt] = next;
      sync_two_groups();
    }
    const size_t v_ld = (size_t)hkv * DV;
    store_rows(dv + ((size_t)b * sk + k0) * v_ld + (size_t)kvh * DV, v_ld,
               acc_v, 1.0f, row_a, sk - k0, DV, lane);
  } else {         // dP^T, dS^T, dK
    float acc_k[DP / 2];
    zero(acc_k);
    for (int it = 0; it < n_it; ++it) {
      const uint32_t s_q = s_ring + (it % NST) * PAIR, s_do = s_q + ATILE;
      mbar_wait(bar_ring + (it % NST) * 8, (it / NST) & 1);

      float dp[32];
      zero(dp);
      fence_regs(dp);
      wgmma_fence();
      mma_ss<DV>(dp, s_v, s_do);   // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dp);
      const float* dlt = rows[it & 1] + WT;
      wait_handover();
#pragma unroll
      for (int i = 0; i < 32; ++i) {   // pair_p_ds's dS
        const int r = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const float dcap = cap > 0.0f ? pc[i * WTHREADS + wt] : 1.0f;
        dp[i] = px[i * WTHREADS + wt] * (dp[i] - dlt[r]) * dcap;
      }
      uint32_t ads[4][4];
      to_frags(ads, dp);
      fence_regs(acc_k);
      wgmma_fence();
      mma_rs(acc_k, ads, s_q);     // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_k);
      sync_two_groups();
    }
    const size_t k_ld = (size_t)hkv * D;
    store_rows(dk + ((size_t)b * sk + k0) * k_ld + (size_t)kvh * D, k_ld,
               acc_k, scale, row_a, sk - k0, D, lane);
  }
}

// One block per (b * H + h, 64-row query block), the last blocks first.
template <int D, int DV>
__global__ void __launch_bounds__(WTHREADS)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int sq, int sk,
                       int seq_k, int h, int hkv, int causal, int q_offset,
                       float scale, float cap) {
  using S = WgShape<D, DV>;
  constexpr int DP = S::DP, DVP = S::DVP, ATILE = S::ATILE, PAIR = S::PAIR;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + NST];   // Q / dO, then the ring
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u, s_do = s_q + ATILE;
  const uint32_t s_ring = s_q + PAIR;   // stage i: K at + i PAIR, V + ATILE
  const uint32_t bar_q = (uint32_t)__cvta_generic_to_shared(bars);
  const uint32_t bar_ring = bar_q + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WT;

  // keys this block can see: below seq_k_valid and, causal, at or below
  // the last row's position
  const int k_valid = seq_k < sk ? seq_k : sk;
  int k_end = k_valid;
  if (causal) {
    const long long last = (long long)min(q0 + WT, sq) - 1 + q_offset;
    if (last + 1 < k_end) k_end = (int)(last + 1 > 0 ? last + 1 : 0);
  }
  const int n_tiles = (k_end + WT - 1) / WT;

  auto fetch = [&](int t) {   // K and V of tile t, on its stage
    const uint32_t bar = bar_ring + (t % NST) * 8;
    const uint32_t dst = s_ring + (t % NST) * PAIR;
    mbar_expect(bar, PAIR);
    tma_tile<DP, WT>(dst, &map_k, bar, kvh, t * WT, b);
    tma_tile<DVP, WT>(dst + ATILE, &map_v, bar, kvh, t * WT, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + NST; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect(bar_q, PAIR);
      tma_tile<DP, WT>(s_q, &map_q, bar_q, hh, q0, b);
      tma_tile<DVP, WT>(s_do, &map_do, bar_q, hh, q0, b);
      for (int t = 0; t < NST - 1 && t < n_tiles; ++t) fetch(t);
    }
  }
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);   // rows q0 + row_a, + 8
  const int qi_a = q0 + row_a, qi_b = qi_a + 8;
  const size_t base = ((size_t)b * h + hh) * sq;
  // lse (log2 domain; +inf past Sq, so p = 0 there) and delta of the rows
  const float lse_a = qi_a < sq ? lse[base + qi_a] * LOG2E : INFINITY;
  const float lse_b = qi_b < sq ? lse[base + qi_b] * LOG2E : INFINITY;
  const float dlt_a = qi_a < sq ? delta[base + qi_a] : 0.0f;
  const float dlt_b = qi_b < sq ? delta[base + qi_b] : 0.0f;
  float acc[DP / 2];
  zero(acc);
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * WT;
    const uint32_t s_k = s_ring + (t % NST) * PAIR, s_v = s_k + ATILE;
    if (tid == 0 && t + NST - 1 < n_tiles) fetch(t + NST - 1);
    mbar_wait(bar_ring + (t % NST) * 8, (t / NST) & 1);

    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_ss<D>(s, s_q, s_k);      // S = Q K^T   (rows x keys)
    mma_ss<DV>(dp, s_do, s_v);   // dP = dO V^T
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = k0 + WT > k_valid
                      || (causal && (long long)k0 + WT - 1 > (long long)q0
                                                              + q_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kj = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      const bool hi = (i & 2) != 0;
      const int qi = hi ? qi_b : qi_a;
      const bool keep = !edge
          || (kj < k_valid && !(causal && (long long)qi + q_offset < kj));
      pair_p_ds(s[i], dp[i], hi ? lse_b : lse_a, hi ? dlt_b : dlt_a, keep,
                scale, cap);
    }
    uint32_t ads[4][4];
    to_frags(ads, dp);
    fence_regs(acc);
    wgmma_fence();
    mma_rs(acc, ads, s_k);       // dQ += dS K
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();   // this stage may be refilled
  }

  const size_t q_ld = (size_t)h * D;
  store_rows(dq + ((size_t)b * sq + q0) * q_ld + (size_t)hh * D, q_ld, acc,
             scale, row_a, sq - q0, D, lane);
}

// dQ at D past 128: one block per (b * H + h, pair of 64-row query
// blocks), the last pairs first, each warpgroup one query block of the
// pair with its Q and dO resident, both on the same K / V tiles from one
// ring (two warpgroups an SM where fa_bwd_dq_wgmma_kernel's 121 KB would
// hold one, and each K / V tile loaded once for 128 rows).  Each
// warpgroup runs fa_bwd_dq_wgmma_kernel's loop body on the tiles its rows
// see and waits out the rest (the pair's later block sees at most one
// tile more under causal); the groups meet at the end of each tile.
template <int D, int DV>
struct Dq2Shape {
  static constexpr int SMEM = (2 + NST) * WgShape<D, DV>::PAIR + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(2 * WTHREADS)
fa_bwd_dq_wgmma2_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int sq, int sk,
                        int seq_k, int h, int hkv, int causal, int q_offset,
                        float scale, float cap) {
  using S = WgShape<D, DV>;
  constexpr int DP = S::DP, DVP = S::DVP, ATILE = S::ATILE, PAIR = S::PAIR;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + NST];   // Q / dO, then the ring
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_q0 = (raw + 1023) & ~1023u;      // group w: + w PAIR
  const uint32_t s_ring = s_q0 + 2 * PAIR;   // stage i: K at + i PAIR, V +
  const uint32_t bar_q = (uint32_t)__cvta_generic_to_shared(bars);
  const uint32_t bar_ring = bar_q + 8;
  const int tid = threadIdx.x, wg = tid / WTHREADS, wt = tid % WTHREADS;
  const int warp = wt >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int pair0 = (gridDim.y - 1 - blockIdx.y) * 2 * WT;
  const int q0 = pair0 + wg * WT;              // this group's rows
  const uint32_t s_q = s_q0 + wg * PAIR, s_do = s_q + ATILE;

  // keys a query block sees: below seq_k_valid and, causal, at or below
  // its last row's position; none for a block past Sq
  const int k_valid = seq_k < sk ? seq_k : sk;
  auto tiles_of = [&](int r0) {
    if (r0 >= sq) return 0;
    int k_end = k_valid;
    if (causal) {
      const long long last = (long long)min(r0 + WT, sq) - 1 + q_offset;
      if (last + 1 < k_end) k_end = (int)(last + 1 > 0 ? last + 1 : 0);
    }
    return (k_end + WT - 1) / WT;
  };
  const int mine = tiles_of(q0);
  const int n_tiles = max(tiles_of(pair0), tiles_of(pair0 + WT));

  auto fetch = [&](int t) {   // K and V of tile t, on its stage
    const uint32_t bar = bar_ring + (t % NST) * 8;
    const uint32_t dst = s_ring + (t % NST) * PAIR;
    mbar_expect(bar, PAIR);
    tma_tile<DP, WT>(dst, &map_k, bar, kvh, t * WT, b);
    tma_tile<DVP, WT>(dst + ATILE, &map_v, bar, kvh, t * WT, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + NST; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect(bar_q, 2 * PAIR);
      for (int w = 0; w < 2; ++w) {
        tma_tile<DP, WT>(s_q0 + w * PAIR, &map_q, bar_q, hh, pair0 + w * WT,
                         b);
        tma_tile<DVP, WT>(s_q0 + w * PAIR + ATILE, &map_do, bar_q, hh,
                          pair0 + w * WT, b);
      }
      for (int t = 0; t < NST - 1 && t < n_tiles; ++t) fetch(t);
    }
  }
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);   // rows q0 + row_a, + 8
  const int qi_a = q0 + row_a, qi_b = qi_a + 8;
  const size_t base = ((size_t)b * h + hh) * sq;
  // lse (log2 domain; +inf past Sq, so p = 0 there) and delta of the rows
  const float lse_a = qi_a < sq ? lse[base + qi_a] * LOG2E : INFINITY;
  const float lse_b = qi_b < sq ? lse[base + qi_b] * LOG2E : INFINITY;
  const float dlt_a = qi_a < sq ? delta[base + qi_a] : 0.0f;
  const float dlt_b = qi_b < sq ? delta[base + qi_b] : 0.0f;
  float acc[DP / 2];
  zero(acc);
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * WT;
    const uint32_t s_k = s_ring + (t % NST) * PAIR, s_v = s_k + ATILE;
    if (tid == 0 && t + NST - 1 < n_tiles) fetch(t + NST - 1);
    mbar_wait(bar_ring + (t % NST) * 8, (t / NST) & 1);
    if (t < mine) {
      float s[32], dp[32];
      zero(s);
      zero(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_ss<D>(s, s_q, s_k);      // S = Q K^T   (rows x keys)
      mma_ss<DV>(dp, s_do, s_v);   // dP = dO V^T
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      const bool edge = k0 + WT > k_valid
                        || (causal && (long long)k0 + WT - 1 > (long long)q0
                                                                + q_offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kj = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const bool hi = (i & 2) != 0;
        const int qi = hi ? qi_b : qi_a;
        const bool keep = !edge
            || (kj < k_valid && !(causal && (long long)qi + q_offset < kj));
        pair_p_ds(s[i], dp[i], hi ? lse_b : lse_a, hi ? dlt_b : dlt_a, keep,
                  scale, cap);
      }
      uint32_t ads[4][4];
      to_frags(ads, dp);
      fence_regs(acc);
      wgmma_fence();
      mma_rs(acc, ads, s_k);       // dQ += dS K
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    sync_two_groups();   // this stage may be refilled
  }

  const size_t q_ld = (size_t)h * D;
  store_rows(dq + ((size_t)b * sq + q0) * q_ld + (size_t)hh * D, q_ld, acc,
             scale, row_a, sq - q0, D, lane);
}

template <int D, int DV>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, int b, int sq,
                 int sk, int seq_k, int h, int hkv, int causal, int q_offset,
                 float scale, float cap, cudaStream_t stream) {
  // D past 128: the two-warpgroup kernels, with shared memory of their own
  constexpr bool SPLIT = WgShape<D, DV>::SPLIT;
  constexpr int SMEM = WgShape<D, DV>::SMEM;
  constexpr int KV_SMEM = SPLIT ? Wg2Shape<D, DV>::SMEM : SMEM;
  constexpr int Q_SMEM = SPLIT ? Dq2Shape<D, DV>::SMEM : SMEM;
  static cudaError_t attr = [] {      // once per (D, DV)
    cudaError_t e;
    if constexpr (SPLIT) {
      e = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma2_kernel<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               KV_SMEM);
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(fa_bwd_dq_wgmma2_kernel<D, DV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Q_SMEM);
    } else {
      e = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma_kernel<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(fa_bwd_dq_wgmma_kernel<D, DV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM);
    }
  }();
  if (attr != cudaSuccess) return (int)attr;
  const long long rows = (long long)b * sq * h;
  const long long qblocks = ((long long)sq + WT - 1) / WT;
  const long long kblocks = ((long long)sk + WT - 1) / WT;
  if (qblocks > 65535 || kblocks > 65535
      || (rows + NT / 32 - 1) / (NT / 32) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // each map by value, keyed by its own tensor's pointer and shape
  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map(&mq, q, b, sq, h, D, WT)
      || !tensor_map(&mk, k, b, sk, hkv, D, WT)
      || !tensor_map(&mv, v, b, sk, hkv, DV, WT)
      || !tensor_map(&mdo, dout, b, sq, h, DV, WT))
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 T;
  fa_bwd_delta_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                           0, stream>>>((const T*)out, (const T*)dout, delta,
                                        rows, sq, h, DV);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 kv_grid((unsigned)(b * hkv), (unsigned)kblocks);
  if constexpr (SPLIT)
    fa_bwd_dkdv_wgmma2_kernel<D, DV>
        <<<kv_grid, 2 * WTHREADS, KV_SMEM, stream>>>(
            mq, mk, mv, mdo, lse, delta, (T*)dk, (T*)dv, sq, sk, seq_k, h,
            hkv, causal, q_offset, scale, cap);
  else
    fa_bwd_dkdv_wgmma_kernel<D, DV><<<kv_grid, WTHREADS, SMEM, stream>>>(
        mq, mk, mv, mdo, lse, delta, (T*)dk, (T*)dv, sq, sk, seq_k, h, hkv,
        causal, q_offset, scale, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (SPLIT)
    fa_bwd_dq_wgmma2_kernel<D, DV>
        <<<dim3((unsigned)(b * h), (unsigned)((qblocks + 1) / 2)),
           2 * WTHREADS, Q_SMEM, stream>>>(
            mq, mk, mv, mdo, lse, delta, (T*)dq, sq, sk, seq_k, h, hkv,
            causal, q_offset, scale, cap);
  else
    fa_bwd_dq_wgmma_kernel<D, DV>
        <<<dim3((unsigned)(b * h), (unsigned)qblocks), WTHREADS, SMEM,
            stream>>>(mq, mk, mv, mdo, lse, delta, (T*)dq, sq, sk, seq_k, h,
                      hkv, causal, q_offset, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int b, int sq, int sk, int seq_k, int h,
             int hkv, int d, int dvd, int causal, int q_offset, float scale,
             float cap, void* stream) {
  if (dvd < 1 || dvd > d || d > MAX_D || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0 || sk == 0) return 0;   // the wrapper's zeros
  cudaStream_t s = (cudaStream_t)stream;
#define BWD_CASE(DP)                                                         \
  if (d <= DP)                                                               \
    return launch<T, DP>(q, k, v, out, dout, (const float*)lse,             \
                         (float*)delta, dq, dk, dv, b, sq, sk, seq_k, h, hkv, \
                         d, dvd, causal, q_offset, scale, cap, s);
  BWD_CASE(16) BWD_CASE(32) BWD_CASE(64) BWD_CASE(128)
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for
// shapes the kernels do not take (H a multiple of Hkv; float32: dv <= d <=
// 128).
// delta: a [B, H, Sq] float32 workspace.  Every element of dq, dk and dv
// is written (dk / dv of keys at or past seq_k_valid as zeros), but for
// B, Sq or Sk 0, where nothing is launched.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int seq_k, int h, int hkv, int d,
    int dvd, int causal, int q_offset, float scale, float cap,
    void* stream) {
  return dispatch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq,
                         sk, seq_k, h, hkv, d, dvd, causal, q_offset, scale,
                         cap, stream);
}

// bfloat16 on the tensor cores: (d, dv) in {(64, 64), (80, 80), (128,
// 128), (192, 128)}; q, k, v and dout 16-byte aligned.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int seq_k, int h, int hkv, int d,
    int dvd, int causal, int q_offset, float scale, float cap,
    void* stream) {
  if (hkv < 1 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0 || sk == 0) return 0;   // the wrapper's zeros
  cudaStream_t s = (cudaStream_t)stream;
#define BWD_WG_CASE(D, DV)                                                   \
  if (d == D && dvd == DV)                                                   \
    return launch_wgmma<D, DV>(q, k, v, out, dout, (const float*)lse,       \
                               (float*)delta, dq, dk, dv, b, sq, sk, seq_k,  \
                               h, hkv, causal, q_offset, scale, cap, s);
  BWD_WG_CASE(64, 64) BWD_WG_CASE(80, 80) BWD_WG_CASE(128, 128)
  BWD_WG_CASE(192, 128)
#undef BWD_WG_CASE
  return (int)cudaErrorInvalidValue;
}
