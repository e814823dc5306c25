// Backward of the RWKV-6 WKV scan for Hopper (sm_90a), chunks of 64.
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// chunked jnp scan (repro/kernels/rwkv6_scan/ops.py, wkv6_chunked, with
// per-chunk remat); its Pallas kernel (kernel.py, wkv6_bh) has no VJP.  This
// is the counterpart of that autodiff, so that training runs the forward
// kernels (rwkv6_chunk.cu in bf16, rwkv6_scan.cu otherwise) and this one.
// Plain versions: kernels/rwkv6_scan/ref.py wkv6_bwd_ref (the yardstick) and
// wkv6_bwd_sub_ref (this kernel's sub-chunk form, for the tests).
//
// Layout as the forward's: r, k, v, dy, dr, dk, dv [B, T, H, N] (bf16 or
// float32); w, dw [B, T, H, N] float32; u [H, N]; the states the forward
// saved, entering each chunk of 64 steps, [nc, B * H, N, N] float32 (key x
// value), the first the input state; the gradient of the output state
// [B * H, N, N].  N <= 64, padded to 64 with zeros (w with ones).
//
// The decays are per key channel j, so a pair of positions s < t carries
// D(s + 1, t) = prod_{s<i<t} w_i, a vector.  As in the forward
// (rwkv6_chunk.cu) the chunk is cut into four sub-chunks of 16, and every
// decay is a product of running products that start or end at a
// sub-chunk boundary (each factor <= 1, no division, no exponent > 0):
// for t in sub-chunk q = [q0, q1), DQ_t = D(q0, t), DP_t = D(t + 1, q1),
// T_q = D(q0, q1), F(a, b) = prod_{a<q<b} T_q, RQ = r o DQ, KQ = k o DP.
// Then (the full algebra is wkv6_bwd_sub_ref's docstring):
//   P = dY V^T, X = dY S0^T, Y = V dSL^T                      (tensor cores)
//   X'_t = F(-1, q) X_t + sum_{s<q0} P[t, s] KQ_s F(q(s), q)   = dy_t S_{q0}^T
//   Y'_s = F(q, 4) Y_s + sum_{t>=q1} P[t, s] RQ_t F(q, q(t))   = v_s dS_{q1}^T
//   A^T[s, t] = KQ_s F(q(s), q(t)) . RQ_t across sub-chunks, the own
//     sub-chunk's 16 x 16 scores on the CUDA cores; dv = (KQ o F(q, 4)) dSL
//     + A^T dY + (r . (u o k)) dy
//   dS0 = D(0, L) o dSL + sum_t (RQ_t F(-1, q(t)))^T dy_t    (to chunk c - 1)
//   alpha_q = <S_{q0}, dS_{q1}> (per j, summed over i), from a = <S0, dSL>,
//     column sums of RQ o X and KQ o Y, and the products V_b
// and inside each sub-chunk one thread per (channel, sub-chunk) runs the
// recurrences of dr, dk and dw over its 16 steps (O(16^2) each).  dw is
// sum_i dS_{t+1} o S_t written out in terms (never d(log w) / w), so it
// stays finite where w is down at 1e-20.
//
// What bounds it on an H100.  It reads r, k, v, dy, w and the saved
// states and writes dr, dk, dv, dw once (~0.87 GB at rwkv6-1.6b's training
// shape [8, 2048, 32, 64] in bf16: ~0.26 ms at 3.35 TB/s); its work is
// about nine 64 x 64 x 64 products a chunk on the tensor cores and
// O(4 * 16^2 * 64) per chunk on the CUDA cores.  The design:
//   - One block of 8 warps per (batch, head, chunk); r, k, v, dy stay in
//     their type: bf16 tiles (swizzled, 16-byte cp.async, ldmatrix) in the
//     bf16 route, so P takes one mma a tile and a product with one float32
//     operand three.  A product of two float32 operands takes six, except
//     the two that only feed dv (A^T's cross blocks and (KQ o F) dSL),
//     which round their RQ / dSL operand to bf16 in the bf16 route (three;
//     dv is a bf16 output).  The float32 route keeps float tiles and six
//     mma, and one block an SM.
//   - RQ and KQ are float32 tiles, so the products read their operands
//     with one load; the decays between sub-chunks (F) enter the products
//     on P and G by Horner's scheme, a row or column scaling between k
//     steps (a k step is a sub-chunk), not in the operands.
//   - Only the pairs inside a sub-chunk stay on the CUDA cores, spread over
//     all 256 threads; everything that crosses a sub-chunk boundary is a
//     product on the tensor cores or a per-channel sum.  The products on
//     P are dealt out four k steps to each warp, A^T's six cross blocks
//     one to each of six warps.
//   - ~112 KB of shared memory (bf16) and <= 128 registers, no spill: two
//     blocks an SM, so one block's products hide the other's loads and its
//     wait on the chain.
// The state gradient passes from chunk c + 1 to c through a ticketed chain
// as in the forward kernels, in reverse: tickets map chunk-major from the
// last chunk, so a block's predecessor (the same head's next chunk) holds a
// smaller ticket and has started.  A block computes everything that does
// not need dSL, waits for its predecessor's flag, reads dSL, writes dS0
// (ds_mid, or dstate for the first chunk), raises its flag, then computes
// the rest.  du is written per (batch, chunk) and summed over them in a
// fixed order by a second launch (group_sum): no atomics, two launches on
// the same inputs are bit-equal.
#include <math.h>

#include "chunk_mma.cuh"

namespace {

using namespace chunk;
typedef __nv_bfloat16 bf16;

constexpr int NT = 256;    // 8 warps
constexpr int SUB = 16;    // sub-chunk
constexpr int NQ = L / SUB;

template <typename T>
struct Smem {
  T r[TILE], k[TILE], v[TILE], dy[TILE];   // [t][j], [s][i]
  float rqt[TILE];              // RQ [t][j]; after the wait dSL [j][i]
  float kqt[TILE];              // KQ [t][j]
  float tx[TILE];               // S0 [j][i], then X' [t][j]
  float tp[TILE];               // w [t][j], then P [t][s], then Y' [s][j]
  float diag[NQ][SUB][SUB + 1];  // own-sub-chunk scores A[t][s], then P's
                                // diagonal blocks P[t][s], [q][t - q0][s - q0]
  float dtot[NQ][L];            // T_q
  float zx[NQ][L], uy[NQ][L];   // column sums of RQ o X, KQ o Y by strip
  float cp[4][L];               // alpha_1's (2, 3), alpha_2's (0, 1) cross
                                // terms, one part a strip
  float ablk[6][32][8];         // A^T's cross-sub-chunk blocks, in the
                                // registers' order (lane, element)
  float a[L];                   // <S0, dSL> by row
  float dup[NQ][L];             // du by sub-chunk
  float u[L], bon[L];
};

// F(qa, qb) = prod_{qa<q<qb} T_q for channel j
__device__ __forceinline__ float fq(const float (*dtot)[L], int qa, int qb,
                                    int j) {
  float f = 1.0f;
#pragma unroll
  for (int d = 1; d <= NQ; ++d)
    if (qa + d < qb) f *= dtot[qa + d][j];
  return f;
}
// acc's columns (rows: by_row) scaled by T_q of their channel
__device__ __forceinline__ void scale_t(float (&acc)[4][4],
                                        const float* tq, int m0, int n0,
                                        int lane, bool by_row) {
  each_acc(acc, m0, n0, lane, [&](int r, int c, float& x) {
    x *= tq[by_row ? r : c];
  });
}

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const T* __restrict__ u, const float* __restrict__ states,
                const T* __restrict__ dy, const float* __restrict__ dsout,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ dstate, float* __restrict__ ds_mid,
                int* __restrict__ flags, int t_len, int h, int bh_n, int nc,
                int n, int vec) {
  extern __shared__ __align__(128) unsigned char raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(raw);
  // pieces of an operand of type T; also of a float32 operand of the
  // products that only feed dv (rounded to bf16 in the bf16 route)
  constexpr int PT = Pieces<T>::n;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const int sq = wp >> 1, hf = wp & 1, m0 = 16 * sq, n0 = 32 * hf;
  const int tk = take_ticket(flags + (size_t)bh_n * nc);
  const int ch = nc - 1 - tk / bh_n, bh = tk % bh_n, b = bh / h, hh = bh % h;
  const int t0 = ch * L, cn = min(L, t_len - t0);
  const size_t row = (size_t)h * n;
  const size_t base = ((size_t)b * t_len + t0) * row + (size_t)hh * n;
  const size_t nn = (size_t)n * n;
  const float* s0g = states + ((size_t)ch * bh_n + bh) * nn;
  CHUNK_PHASE_START;

  // this chunk's rows (zeros past the end and past N) and S0
  load_tile<T, NT>(sm.r, r + base, (long long)row, cn, n, vec & 1);
  load_tile<T, NT>(sm.k, k + base, (long long)row, cn, n, vec & 1);
  load_tile<T, NT>(sm.v, v + base, (long long)row, cn, n, vec & 1);
  load_tile<T, NT>(sm.dy, dy + base, (long long)row, cn, n, vec & 1);
  load_tile<float, NT>(sm.tx, s0g, n, n, n, vec & 2);
  if (tid < L) sm.u[tid] = tid < n ? to_f(u[(size_t)hh * n + tid]) : 0.0f;
  // thread (channel j, sub-chunk q): its 16 decays (ones past the end and
  // past N), RQ = r o DQ, KQ = k o DP and T_q; w into the P tile for the
  // scores
  {
    const int j = tid & 63, q = tid >> 6;
    float wv[SUB];
#pragma unroll
    for (int x = 0; x < SUB; ++x) {
      const int t = SUB * q + x;
      wv[x] = t < cn && j < n ? w[base + (size_t)t * row + j] : 1.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    float d = 1.0f;
#pragma unroll
    for (int x = 0; x < SUB; ++x) {
      const int t = SUB * q + x;
      sm.rqt[fi(t, j)] = to_f(sm.r[bi(t, j)]) * d;
      sm.tp[fi(t, j)] = wv[x];
      d *= wv[x];
    }
    sm.dtot[q][j] = d;
    d = 1.0f;
#pragma unroll
    for (int x = SUB - 1; x >= 0; --x) {
      const int t = SUB * q + x;
      sm.kqt[fi(t, j)] = to_f(sm.k[bi(t, j)]) * d;
      d *= wv[x];
    }
  }
  __syncthreads();
  CHUNK_PHASE(1);

  // the bonus r_t . (u o k_t): warp wp takes rows 8 wp .. 8 wp + 7
  for (int t = 8 * wp; t < 8 * wp + 8; ++t) {
    const int j = 2 * lane;
    float part = to_f(sm.r[bi(t, j)]) * sm.u[j] * to_f(sm.k[bi(t, j)]) +
                 to_f(sm.r[bi(t, j + 1)]) * sm.u[j + 1] *
                     to_f(sm.k[bi(t, j + 1)]);
    part = warp_sum(part);
    if (lane == 0) sm.bon[t] = part;
  }
  // own-sub-chunk scores A[t][s] = sum_j r_t k_s prod_{s<i<t} w_i: thread
  // (t, channels 16 jg .. + 15) walks s from t - 1 down to q0 with each
  // channel's product grown by one factor a step (the warp runs its
  // largest t's steps, a uniform loop for the shuffles)
  {
    const int t = tid >> 2, jg = tid & 3, q0 = t & ~(SUB - 1), j0 = 16 * jg;
    const int t_hi = (tid >> 5) * 8 + 7;
    float d[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) d[x] = 1.0f;
    if (jg == 0)
      for (int s = t - q0; s < SUB; ++s) sm.diag[q0 / SUB][t - q0][s] = 0.0f;
    for (int s = t_hi - 1; s >= q0; --s) {
      const bool on = s < t;
      float acc = 0.0f;
#pragma unroll
      for (int hx = 0; hx < 16; hx += 8) {
        float rt[8], kv[8], wv[8];
        ld8(rt, sm.r, t, j0 + hx);
        ld8(kv, sm.k, s, j0 + hx);
        ld8(wv, sm.tp, s, j0 + hx);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          acc += rt[x] * kv[x] * d[hx + x];
          d[hx + x] = on ? d[hx + x] * wv[x] : d[hx + x];
        }
      }
      acc += __shfl_xor_sync(~0u, acc, 1);
      acc += __shfl_xor_sync(~0u, acc, 2);
      if (on && jg == 0) sm.diag[q0 / SUB][t - q0][s - q0] = acc;
    }
  }
  __syncthreads();
  CHUNK_PHASE(2);

  auto rq = [&](int t, int j) { return sm.rqt[fi(t, j)]; };
  auto kq = [&](int s, int j) { return sm.kqt[fi(s, j)]; };
  // P = dY V^T into the P tile (the scores are done with w)
  {
    float acc[4][4];
    zero_acc(acc);
    mm<PT, PT>(acc, n0, 0, L,
               [&](auto& a, int k0) { frag_a(a, sm.dy, m0, k0, lane); },
               [&](auto& b_, int k0, int nn_) {
                 frag_b(b_, sm.v, nn_, k0, lane);
               });
    each_acc(acc, m0, n0, lane,
             [&](int t, int s, float& x) { sm.tp[fi(t, s)] = x; });
  }
  // X = dY S0^T; the strip's column sums of RQ o X; then F(-1, q) X
  float xacc[4][4];
  zero_acc(xacc);
  mm<PT, 3>(xacc, n0, 0, L,
            [&](auto& a, int k0) { frag_a(a, sm.dy, m0, k0, lane); },
            [&](auto& b_, int k0, int nn_) {
              frag_b(b_, sm.tx, nn_, k0, lane);
            });
  {
    float cs[4][2] = {};
    col_sums(cs, xacc, m0, n0, lane, [&](int t, int j) { return rq(t, j); });
    fold_cols(cs);
    if (lane < 4)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        sm.zx[sq][n0 + 8 * jn + cq] = cs[jn][0];
        sm.zx[sq][n0 + 8 * jn + cq + 1] = cs[jn][1];
      }
  }
  __syncthreads();                    // P is whole; S0's readers are done
  CHUNK_PHASE(3);

  // the products on P, four k steps each warp, the decays between
  // sub-chunks applied by Horner's scheme between the k steps (a k step is
  // a sub-chunk): its strip's X' = F(-1, q) X + sum_{s<q0} P[t, s] KQ_s
  // F(q(s), q) (into S0's tile) and V_own = V_{q+1}, and one part of
  // alpha_1 / alpha_2's cross terms, where V_b[s][j] = sum_{t>=16 b}
  // P[t][s] RQ_t F(b - 1, q(t))
  for (int qa = 0; qa < sq; ++qa) {
    scale_t(xacc, sm.dtot[qa], m0, n0, lane, false);
    mm<3, 3>(xacc, n0, SUB * qa, SUB * (qa + 1),
             [&](auto& a, int k0) { frag_a(a, sm.tp, m0, k0, lane); },
             [&](auto& b_, int k0, int nn_) {
               frag_bt(b_, sm.kqt, nn_, k0, lane);
             });
  }
  each_acc(xacc, m0, n0, lane,
           [&](int t, int j, float& x) { sm.tx[fi(t, j)] = x; });
  // V_b's rows in strip qs over the sub-chunks qt_lo .. qt_hi of t
  auto vprod = [&](float (&acc)[4][4], int qs, int bq, int qt_lo,
                   int qt_hi) {
    for (int qt = qt_hi; qt >= bq; --qt) {
      scale_t(acc, sm.dtot[qt], SUB * qs, n0, lane, false);
      if (qt >= qt_lo)
        mm<3, 3>(acc, n0, SUB * qt, SUB * (qt + 1),
                 [&](auto& a, int k0) {
                   frag_at(a, sm.tp, SUB * qs, k0, lane);
                 },
                 [&](auto& b_, int k0, int nn_) {
                   frag_bt(b_, sm.rqt, nn_, k0, lane);
                 });
    }
  };
  float vown[4][4];
  zero_acc(vown);
  if (sq < NQ - 1) vprod(vown, sq, sq + 1, sq + 1, NQ - 1);
  {
    // alpha_{b-1}'s cross term sum_{s in qs} KQ_s F(qs, b - 1) V_b[s] over
    // one sub-chunk of t: strip 0 (qs 1, b 3, t 48..63), 1 (0, 3, 48..63),
    // 2 (0, 2, 32..47), 3 (0, 2, 48..63)
    const int qs = sq == 0 ? 1 : 0, bq = sq < 2 ? 3 : 2;
    const int qt = sq == 2 ? 2 : 3;
    float acc[4][4];
    zero_acc(acc);
    vprod(acc, qs, bq, qt, qt);
    float cs[4][2] = {};
    col_sums(cs, acc, SUB * qs, n0, lane, [&](int s, int j) {
      return kq(s, j) * fq(sm.dtot, qs, bq - 1, j);
    });
    fold_cols(cs);
    if (lane < 4)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        sm.cp[sq][n0 + 8 * jn + cq] = cs[jn][0];
        sm.cp[sq][n0 + 8 * jn + cq + 1] = cs[jn][1];
      }
  }
  CHUNK_PHASE(4);

  // A^T's cross-sub-chunk blocks [s in qs][t in qt], qs < qt: warp w < 6
  // takes block w, KQ_s F(qs, qt) . RQ_t over the 64 channels, into ablk[w]
  // in its registers' order; then each strip's part of dv, A^T dY, with
  // the own sub-chunk's scores from the CUDA-core pass
  if (wp < 6) {
    const int qs = wp < 3 ? 0 : (wp < 5 ? 1 : 2);
    const int qt = wp < 3 ? wp + 1 : (wp < 5 ? wp - 1 : 3);
    float acc[2][4] = {};
#pragma unroll 1
    for (int k0 = 0; k0 < L; k0 += 16) {
      uint32_t a[3][4], b_[PT][4];
      a_split(a, SUB * qs, k0, lane, [&](int s, int j) {
        return make_float2(kq(s, j), kq(s, j + 1));
      });
      b_pieces<PT>(b_, SUB * qt, k0, lane, [&](int j, int t) {
        return make_float2(rq(t, j) * fq(sm.dtot, qs, qt, j),
                           rq(t, j + 1) * fq(sm.dtot, qs, qt, j + 1));
      });
      mma_p<3, PT>(acc[0], a, b_, 0);
      mma_p<3, PT>(acc[1], a, b_, 2);
    }
    float4* dst = reinterpret_cast<float4*>(sm.ablk[wp][lane]);
    dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    dst[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
  __syncthreads();
  float dvacc[4][4];
  zero_acc(dvacc);
#pragma unroll
  for (int kk = 0; kk < NQ; ++kk) {
    if (kk >= sq) {
      float c0[4], c1[4];
      if (kk == sq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = g + ((e >> 1) << 3), t = cq + (e & 1);
          c0[e] = sm.diag[sq][t][s];
          c1[e] = sm.diag[sq][t + 8][s];
        }
      } else {
        const int blk = sq == 0 ? kk - 1 : (sq == 1 ? kk + 1 : 5);
        const float4* src = reinterpret_cast<const float4*>(sm.ablk[blk][lane]);
        const float4 f0 = src[0], f1 = src[1];
        c0[0] = f0.x; c0[1] = f0.y; c0[2] = f0.z; c0[3] = f0.w;
        c1[0] = f1.x; c1[1] = f1.y; c1[2] = f1.z; c1[3] = f1.w;
      }
      uint32_t a[3][4];
      a_split_acc(a, c0, c1);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b_[PT][4];
        frag_bt(b_, sm.dy, n0 + 16 * jp, 16 * kk, lane);
        mma_p<3, PT>(dvacc[2 * jp], a, b_, 0);
        mma_p<3, PT>(dvacc[2 * jp + 1], a, b_, 2);
      }
    }
  }
  // G = sum_t (RQ_t F(-1, q(t)))^T dy_t, the chunk's part of dS0 (Horner's
  // scheme over the sub-chunks, from the last)
  float gacc[4][4];
  zero_acc(gacc);
  for (int qt = NQ - 1; qt >= 0; --qt) {
    scale_t(gacc, sm.dtot[qt], m0, n0, lane, true);
    mm<3, PT>(gacc, n0, SUB * qt, SUB * (qt + 1),
              [&](auto& a, int k0) { frag_at(a, sm.rqt, m0, k0, lane); },
              [&](auto& b_, int k0, int nn_) {
                frag_bt(b_, sm.dy, nn_, k0, lane);
              });
  }
  __syncthreads();                    // P's and the scores' readers are done
  for (int e = tid; e < NQ * SUB * SUB; e += NT) {
    const int q = e >> 8, x = (e >> 4) & 15, y = e & 15;
    sm.diag[q][x][y] = sm.tp[fi(SUB * q + x, SUB * q + y)];
  }
  __syncthreads();                    // P is done with: V_own into its tile
  each_acc(vown, m0, n0, lane,
           [&](int s, int j, float& x) { sm.tp[fi(s, j)] = x; });
  CHUNK_PHASE(5);

  // the chain: dSL in (all of a thread's loads in flight, into RQ's tile),
  // dS0 = D(0, L) o dSL + G out, then the flag; then <S0, dSL> by row
  const float* src = ch == nc - 1 ? dsout + (size_t)bh * nn
                                  : ds_mid + ((size_t)ch * bh_n + bh) * nn;
  float* dst = ch == 0 ? dstate + (size_t)bh * nn
                       : ds_mid + ((size_t)(ch - 1) * bh_n + bh) * nn;
  if (ch < nc - 1) wait_flag(flags + tk - bh_n);
  else __syncthreads();
  CHUNK_PHASE(6);
  {
    float sv[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = 4 * (tid + NT * x), j = e >> 6, i = e & 63;
      if ((n & 3) == 0) {
        const float4 f = j < n && i < n
            ? __ldcg(reinterpret_cast<const float4*>(src + j * n + i))
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        sv[x][0] = f.x; sv[x][1] = f.y; sv[x][2] = f.z; sv[x][3] = f.w;
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          sv[x][y] = j < n && i + y < n ? __ldcg(src + j * n + i + y) : 0.0f;
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = 4 * (tid + NT * x), j = e >> 6, i = e & 63;
      *reinterpret_cast<float4*>(sm.rqt + fi(j, i)) =
          make_float4(sv[x][0], sv[x][1], sv[x][2], sv[x][3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = m0 + g + 8 * hr;
    const float f = fq(sm.dtot, -1, NQ, j);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int i = n0 + 8 * jn + cq;
      if (j < n && i < n)
        store2(dst + j * n + i, i + 1 < n,
               f * sm.rqt[fi(j, i)] + gacc[jn][2 * hr],
               f * sm.rqt[fi(j, i + 1)] + gacc[jn][2 * hr + 1]);
    }
  }
  if (ch > 0) raise_flag(flags + tk);
  {
    const int j = tid >> 2, i0 = 16 * (tid & 3);
    float sv[16];
#pragma unroll
    for (int x = 0; x < 16; x += 4) {
      if ((n & 3) == 0) {
        const float4 f = j < n && i0 + x < n
            ? *reinterpret_cast<const float4*>(s0g + j * n + i0 + x)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        sv[x] = f.x; sv[x + 1] = f.y; sv[x + 2] = f.z; sv[x + 3] = f.w;
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          sv[x + y] = j < n && i0 + x + y < n ? s0g[j * n + i0 + x + y] : 0.0f;
      }
    }
    float part = 0.0f;
#pragma unroll
    for (int x = 0; x < 16; ++x) part += sm.rqt[fi(j, i0 + x)] * sv[x];
    part += __shfl_xor_sync(~0u, part, 1);
    part += __shfl_xor_sync(~0u, part, 2);
    if ((tid & 3) == 0) sm.a[j] = part;
  }
  CHUNK_PHASE(7);

  // Y = V dSL^T; the strip's column sums of KQ o Y; Y' = F(q, 4) Y + V_own
  {
    float acc[4][4];
    zero_acc(acc);
    mm<PT, 3>(acc, n0, 0, L,
              [&](auto& a, int k0) { frag_a(a, sm.v, m0, k0, lane); },
              [&](auto& b_, int k0, int nn_) {
                frag_b(b_, sm.rqt, nn_, k0, lane);
              });
    float cs[4][2] = {};
    col_sums(cs, acc, m0, n0, lane, [&](int s, int j) { return kq(s, j); });
    fold_cols(cs);
    if (lane < 4)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        sm.uy[sq][n0 + 8 * jn + cq] = cs[jn][0];
        sm.uy[sq][n0 + 8 * jn + cq + 1] = cs[jn][1];
      }
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = m0 + g + ((e >> 1) << 3), j = n0 + 8 * jn + cq + (e & 1);
        float& y = sm.tp[fi(s, j)];
        y = fq(sm.dtot, sq, NQ, j) * acc[jn][e] + y;
      }
  }
  // dv += (KQ o F(q, 4)) dSL, + the bonus term; out
  mm<3, PT>(dvacc, n0, 0, L,
            [&](auto& a, int k0) {
              a_split(a, m0, k0, lane, [&](int s, int j) {
                return make_float2(kq(s, j) * fq(sm.dtot, sq, NQ, j),
                                   kq(s, j + 1) * fq(sm.dtot, sq, NQ, j + 1));
              });
            },
            [&](auto& b_, int k0, int nn_) {
              b_pieces<PT>(b_, nn_, k0, lane, [&](int j, int i) {
                return make_float2(sm.rqt[fi(j, i)], sm.rqt[fi(j + 1, i)]);
              });
            });
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int s = m0 + g + 8 * hr, i = n0 + 8 * jn + cq;
      if (s < cn && i < n)
        store2(dv + base + (size_t)s * row + i, i + 1 < n,
               dvacc[jn][2 * hr] + sm.bon[s] * to_f(sm.dy[bi(s, i)]),
               dvacc[jn][2 * hr + 1] + sm.bon[s] * to_f(sm.dy[bi(s, i + 1)]));
    }
  __syncthreads();
  CHUNK_PHASE(8);

  // thread (channel j, sub-chunk q): alpha_q, then the recurrences over the
  // sub-chunk's 16 steps (M_t[t'] = sum_{q0<=s<t} D(s+1, t) k_s P[t', s])
  {
    // (j, q) opaque to the compiler here: the tile addresses of the
    // thread's column are recomputed, not kept in registers from the
    // first phase, which takes the same (j, q)
    int j = tid & 63, q = tid >> 6;
    asm volatile("" : "+r"(j), "+r"(q));
    const int q0 = SUB * q;
    const float f0 = fq(sm.dtot, -1, q, j), f4 = fq(sm.dtot, q, NQ, j);
    float alpha = f0 * f4 * sm.a[j];
    for (int q2 = q + 1; q2 < NQ; ++q2)
      alpha += f0 * fq(sm.dtot, q, q2, j) * sm.zx[q2][j];
    for (int q2 = 0; q2 < q; ++q2)
      alpha += f4 * fq(sm.dtot, q2, q, j) * sm.uy[q2][j];
    if (q == 1) alpha += sm.cp[2][j] + sm.cp[3][j];
    if (q == 2) alpha += sm.cp[0][j] + sm.cp[1][j];
    const float uj = sm.u[j];
    float wv[SUB], mv[SUB];
#pragma unroll
    for (int x = 0; x < SUB; ++x) {
      const int t = q0 + x;
      wv[x] = t < cn && j < n ? w[base + (size_t)t * row + j] : 1.0f;
      mv[x] = 0.0f;
    }
    auto rv = [&](int x) { return to_f(sm.r[bi(q0 + x, j)]); };
    float dqv = 1.0f, gam = 0.0f, dua = 0.0f;
#pragma unroll
    for (int x = 0; x < SUB; ++x) {
      const int t = q0 + x;
      const float kt = to_f(sm.k[bi(t, j)]);
      float pr = 1.0f, qd = 0.0f, nx = 0.0f, bw = 0.0f;
#pragma unroll
      for (int y = x + 1; y < SUB; ++y) {
        const float pv = sm.diag[q][y][x], rp = pr * rv(y);
        qd += rp * mv[y];
        nx += rp * pv;
        bw += rp * sm.tx[fi(q0 + y, j)];
        mv[y] = wv[x] * mv[y] + kt * pv;
        pr *= wv[y];
      }
      const float pd = sm.diag[q][x][x], yv = sm.tp[fi(t, j)];
      const float gr = dqv * sm.tx[fi(t, j)] + mv[x] + uj * kt * pd;
      const float gk = pr * yv + nx + rv(x) * uj * pd;
      const float gw = dqv * pr * alpha + dqv * bw + pr * gam + qd;
      dua += rv(x) * kt * pd;
      gam = wv[x] * gam + kt * yv;
      dqv *= wv[x];
      if (t < cn && j < n) {
        const size_t off = base + (size_t)t * row + j;
        dr[off] = from_f<T>(gr);
        dk[off] = from_f<T>(gk);
        dw[off] = gw;
      }
    }
    sm.dup[q][j] = dua;
  }
  __syncthreads();
  if (tid < n)
    du_part[(((size_t)b * nc + ch) * h + hh) * n + tid] =
        sm.dup[0][tid] + sm.dup[1][tid] + sm.dup[2][tid] + sm.dup[3][tid];
  CHUNK_PHASE(9);
}

template <typename T>
int set_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<T>));
  return (int)attr;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const void* u, const float* states, const void* dy,
           const float* dsout, void* dr, void* dk, void* dv, float* dw,
           float* du_part, float* du, float* dstate, float* ds_mid,
           int* flags, int b, int t_len, int h, int n, cudaStream_t stream) {
  const int rc = set_smem<T>();
  if (rc != 0) return rc;
  const int nc = (t_len + L - 1) / L, bh_n = b * h;
  auto al16 = [](const void* p) {
    return !(reinterpret_cast<uintptr_t>(p) & 15);
  };
  const int vec = (n % (16 / (int)sizeof(T)) == 0 && al16(r) && al16(k) &&
                           al16(v) && al16(dy)
                       ? 1
                       : 0) |
                  (n % 4 == 0 && al16(states) ? 2 : 0);
  wkv6_bwd_kernel<T><<<bh_n * nc, NT, sizeof(Smem<T>), stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, (const T*)u, states,
      (const T*)dy, dsout, (T*)dr, (T*)dk, (T*)dv, dw, du_part, dstate,
      ds_mid, flags, t_len, h, bh_n, nc, n, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // du = the per-(batch, chunk) parts summed in order
  return group_sum(du_part, du, 1, b * nc, (long long)h * n, stream);
}

template <typename T>
int occupancy(int* blocks, int* smem) {
  const int rc = set_smem<T>();
  if (rc != 0) return rc;
  *smem = (int)sizeof(Smem<T>);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wkv6_bwd_kernel<T>, NT, sizeof(Smem<T>));
}

}  // namespace

// dtype (of r, k, v, u, dy, dr, dk, dv): 0 float32, 1 bfloat16.  All
// tensors packed.  states: ceil(T / 64) * B * H * N * N float32, the state
// entering each chunk (the first the input state); ds_mid: (ceil(T / 64) -
// 1) * B * H * N * N float32 scratch; du_part: B * ceil(T / 64) * H * N
// float32 scratch; du [H, N] float32; flags: B * H * ceil(T / 64) + 1
// int32, zero on entry and on exit.  Returns a cudaError_t (0 on success);
// 1 (cudaErrorInvalidValue) for shapes the kernel does not take.
extern "C" int wkv6_chunk_bwd(const void* r, const void* k, const void* v,
                              const float* w, const void* u,
                              const float* states, const void* dy,
                              const float* dsout, void* dr, void* dk,
                              void* dv, float* dw, float* du_part, float* du,
                              float* dstate, float* ds_mid, int* flags, int b,
                              int t_len, int h, int n, int dtype,
                              void* stream) {
  if (n < 1 || n > L || h < 1 || t_len < 1) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, states, dy, dsout, dr, dk, dv, dw,
                         du_part, du, dstate, ds_mid, flags, b, t_len, h, n,
                         s);
  if (dtype == 1)
    return launch<bf16>(r, k, v, w, u, states, dy, dsout, dr, dk, dv, dw,
                        du_part, du, dstate, ds_mid, flags, b, t_len, h, n,
                        s);
  return (int)cudaErrorInvalidValue;
}

// The kernel's shared memory bytes and resident blocks an SM (dtype as
// above); returns a cudaError_t.
extern "C" int wkv6_chunk_bwd_occupancy(int dtype, int* blocks, int* smem) {
  if (dtype == 0) return occupancy<float>(blocks, smem);
  if (dtype == 1) return occupancy<bf16>(blocks, smem);
  return (int)cudaErrorInvalidValue;
}
