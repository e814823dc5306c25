// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the blocked
// online-softmax forward (csrc/flash_attention.cu) from the saved q, k, v,
// out and the forward's logsumexp.
//
// Replaces no Pallas kernel: the TPU path has no flash backward kernel.  Its
// counterpart is the custom VJP of repro/models/layers.py,
// _blocked_attention_core's _core_bwd, "the TPU flash-bwd dataflow in XLA
// form", which the port runs as this kernel on the card (its plain copy is
// kernels/flash_attention/ref.py blocked_bwd_ref).
//
// Layout: q [B, Sq, H, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, Dv], out / dout
// [B, Sq, H, Dv], lse [B, H, Sq] float32 (natural log; +inf for a row with
// no key), dq / dk / dv like q / k / v, in q's dtype (bfloat16 or float32).
// GQA: head h reads kv head h / (H / Hkv).  Dv <= D <= 128.
//
// Math (per query row i, key j, with s the scaled, soft-capped score):
//   p = exp(s - lse_i), masked to 0 (keys at or past seq_k_valid, above the
//   causal diagonal shifted by q_offset); delta_i = sum_c dout_ic out_ic;
//   ds = p (dp - delta_i) with dp = dout_i . v_j, times 1 - (s / cap)^2 under
//   a soft cap; dv_j = sum_i p dout_i; dk_j = scale sum_i ds q_i; dq_i =
//   scale sum_j ds k_j.
//
// Three kernels, no atomics: every output element has one owner, so a step
// repeats bit for bit (the restart check of the training loop needs that).
//   fa_bwd_delta_kernel  delta [B, H, Sq] float32, one warp a row;
//   fa_bwd_dkdv_kernel   one block per (64-key block, b * Hkv + kv head):
//                        it walks the group's query heads and the query
//                        blocks that can see its keys, recomputes S and P,
//                        forms dP and dS, and keeps dK, dV in registers;
//   fa_bwd_dq_kernel     one block per (b * H + h, 64-row query block), the
//                        blocks with the most keys (the last, causal) first:
//                        it walks its key blocks and keeps dQ in registers.
// Both recompute S = Q K^T and dP = dO V^T (7 D multiply-adds per visible
// (row, key) pair in all, against 5 D for the backward's own products).
//
// What bounds it on an H100: operations.  At smollm-135m's training shape
// ([8, 2048, 9 / 3, 64] causal bf16) one backward does 5 x 2 x 64 flops on
// each of the 8 x 9 x 2048 x 2049 / 2 visible pairs, 97 GFLOP, over 101 MB
// of q, k, v, out, dout, dq, dk, dv and lse: 0.098 ms at the bf16
// tensor-core peak against 0.030 ms at the memory rate.  This first design
// runs every product as IEEE float32 FFMA on the CUDA cores (bf16 operands
// widened exactly when they are loaded into shared memory), so its own floor
// is the 67 TFLOP/s FFMA peak: 2 x 7 D flops a pair, 135 GFLOP, 2.0 ms.  Tensor cores (mma.sync
// or wgmma on bf16 operands) and TMA come with a later redesign.
//
// Register blocking, as the float32 forward: 256 threads, (ty, tx) = (tid /
// 16, tid % 16).  S and dP: thread (ty, tx) holds rows ty + 16 i and keys
// tx + 16 j (i, j < 4), reading four Q / dO rows (a broadcast over the 16
// lanes of a row group) and four K / V rows as float4 per four steps of D.
// The dk / dv (dq) sums: thread (ty, tx) holds keys (rows) ty + 16 j and the
// columns of a 16-lane group (CPT = DP / 16 each), reading P^T and dS^T
// (dS) as float4 along the rows (keys) from shared memory.  Rows are DP + 4
// floats (an odd number of 16-byte chunks), so the 16 rows of a K load fall
// in distinct bank quads.  Shared memory: Q, dO, K, V tiles of 64 x (DP + 4)
// floats and P^T, dS^T of 64 x 68: 104 KB at DP = 64 (two blocks an SM),
// 168 KB at DP = 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
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

// P and dS of the thread's 4 x 4 pairs (rows q0 + ty + 16 i, keys k0 + tx
// + 16 j) from the raw dot products s (Q K^T) and dp (dO V^T); the tile's
// row lse (log2 domain) and delta come from shared memory.
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
      float x = s[i][j] * scale, dcap = 1.0f;
      if (cap > 0.0f) {
        x = cap * tanhf(x / cap);
        const float t = x / cap;
        dcap = 1.0f - t * t;
      }
      const float p = keep ? exp2f(x * LOG2E - lse2[r]) : 0.0f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dlt[r]) * dcap;
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
// shapes the kernels do not take (dv <= d <= 128, H a multiple of Hkv).
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

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int seq_k, int h, int hkv, int d,
    int dvd, int causal, int q_offset, float scale, float cap,
    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 b, sq, sk, seq_k, h, hkv, d, dvd, causal,
                                 q_offset, scale, cap, stream);
}
