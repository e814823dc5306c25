// Chunked RWKV-6 WKV scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces, for bfloat16 sequences (T >= CHUNKED_MIN_T in the wrapper,
// ops.py), the Pallas TPU kernel of
// repro/kernels/rwkv6_scan/kernel.py:
//   wkv6_bh (_wkv6_kernel)  -> wkv6_chunk_kernel
// (rwkv6_scan.cu keeps single steps and float32.)  Same layout and results
// as wkv6_kernel: r, k, v, y [B, T, H, N] bf16; w [B, T, H, N] float32;
// u [H, N] bf16; state in / out [B, H, N, N] float32 (key x value).  N a
// multiple of 8 up to 64 (padded to 64 with zeros).
//
// What bounds it on an H100.  Step by step, each (batch, head) is one
// chain of T dependent updates: at prefill (batch 1, 32 heads, T = 384)
// wkv6_kernel runs 32 blocks of two warps through 384 steps, 79x its
// bound.  In chunks of 64 the work becomes matrix products (about
// 2 * (2 * 64 * 64 + 2 * 64 * 64) flops per step and head before the split
// below) plus per-channel exponentials on the CUDA cores; only the states
// pass from chunk to chunk.
//
// The decay is per channel, so the Pallas form, which divides k by the
// cumulative decay, overflows when decays are strong.  Here every exponent
// is a sum of lw = log(max(w, 1e-38)) between two positions, later minus
// earlier, so it is <= 0, taken as a running sum of one thread (never a
// difference of two long sums); within a sub-chunk of 16 the decays are
// multiplied as the recurrence multiplies them.  With q0 the start of t's
// sub-chunk:
//   y_t  = (r_t o exp(sum_{i<q0} lw) o exp(sum_{q0<=i<t} lw)) S     state
//        + sum_{s<q0} [(r_t o exp(sum_{q0<=i<t} lw)) .
//                      (k_s o exp(sum_{s<i<q0} lw))] v_s   earlier sub-chunks
//        + sum_{q0<=s<t} [sum_j r_t k_s prod_{s<i<t} w] v_s    own sub-chunk
//        + (r_t . (u o k_t)) v_t                                  bonus
//   S'   = exp(sum_i lw) o S + (k o exp(sum_{i>s} lw))^T v
// All factors are <= 1 in size.  The products run as mma.sync m16n8k16
// bf16 with float32 sums: v is exact in bf16 and the float32 operand
// enters in three bf16 pieces (3 mma); where both operands are float32
// (the earlier-sub-chunk scores and the state term) both are split (6
// mma), as in chunk_mma.cuh.  The own-sub-chunk scores (16 x 16 pairs)
// and the bonus run on the CUDA cores.
//
// Layout of the work: one block of 8 warps per (batch, head, chunk of 64
// steps); warp w takes rows 16 (w / 2) .. + 15 and value columns
// 32 (w % 2) .. + 31; the two warps of a row strip split the key channels
// of the scores and add each other's halves through shared memory.  The
// state passes through the same ticketed chain as ssm_chunk.cu: a block
// computes its scores, y's intra-chunk part and the chunk's own state
// term, waits for its predecessor's flag, reads the entering state, writes
// the leaving one, raises its flag, then adds the state term to y.
#include <math.h>

#include "chunk_mma.cuh"

namespace {

using namespace chunk;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int NT = 256;    // 8 warps
constexpr int SUB = 16;    // sub-chunk

struct Smem {
  bf16 r[TILE], k[TILE], v[TILE];   // [t][j], [s][j], [s][i]
  float w[TILE];                    // w, then lw; then the score exchange
  float rf[TILE];                   // r o exp(sum_{q0<=i<t} lw)   [t][j]
  float kd[TILE];                   // (k o exp(sum_{i>s} lw))^T   [j][s]
  float kf[6 * SUB * L];            // k o exp(sum_{s<i<q0} lw), q0 = 16,
                                    // 32, 48 [s][j]; then S pieces
  float ad[L][SUB + 1];             // own-sub-chunk scores [t][s - q0]
  float u[L], ecl[L], bo[L], eq[L / SUB][L];
};
static_assert(sizeof(float) * 6 * SUB * L >= 3 * sizeof(bf16) * TILE,
              "the S pieces reuse kf");

__device__ __forceinline__ float2 ld2(const float* t, int r, int c) {
  return *reinterpret_cast<const float2*>(t + fi(r, c));
}

__global__ void __launch_bounds__(NT, 2)
wkv6_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ w,
                  const bf16* __restrict__ u, const float* __restrict__ s0,
                  bf16* __restrict__ y, float* __restrict__ s_out,
                  float* __restrict__ s_mid, int* __restrict__ flags,
                  int t_len, int h, int bh_n, int nc, int n) {
  extern __shared__ __align__(128) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const int sq = wp >> 1, hf = wp & 1, m0 = 16 * sq, i0 = 32 * hf;
  const int tk = take_ticket(flags + (size_t)bh_n * nc);
  const int ch = tk / bh_n, bh = tk % bh_n, b = bh / h, hh = bh % h;
  const int t0 = ch * L, cn = min(L, t_len - t0);
  if (ch == 0 && n == L) prefetch_state(s0 + (size_t)bh * L * L);
  CHUNK_MARK(0);

  // this chunk's rows (zeros past the end and past N)
  const size_t row = (size_t)h * n;
  const size_t base = ((size_t)b * t_len + t0) * row + (size_t)hh * n;
  for (int e = tid; e < L * 8; e += NT) {
    const int rr = e >> 3, q = (e & 7) << 3;
    const bool in = rr < cn && q < n;
    const size_t off = base + rr * row + q;
    cp_async16(sm.r + bi(rr, q), in ? r + off : r, in);
    cp_async16(sm.k + bi(rr, q), in ? k + off : k, in);
    cp_async16(sm.v + bi(rr, q), in ? v + off : v, in);
  }
  for (int e = tid; e < L * 16; e += NT) {
    const int rr = e >> 4, q = (e & 15) << 2;
    const bool in = rr < cn && q < n;
    cp_async16(sm.w + fi(rr, q), in ? w + base + rr * row + q : w, in);
  }
  if (tid < L)
    sm.u[tid] = tid < n ? __bfloat162float(u[(size_t)hh * n + tid]) : 0.0f;
  cp_async_wait_all();
  __syncthreads();
  CHUNK_MARK(1);

  // bonus r_t . (u o k_t): warp wp takes rows 8 wp .. 8 wp + 7
  for (int t = 8 * wp; t < 8 * wp + 8; ++t) {
    const int j = 2 * lane;
    const float2 rv = __bfloat1622float2(
        *reinterpret_cast<const bf162*>(sm.r + bi(t, j)));
    const float2 kv = __bfloat1622float2(
        *reinterpret_cast<const bf162*>(sm.k + bi(t, j)));
    float part = rv.x * sm.u[j] * kv.x + rv.y * sm.u[j + 1] * kv.y;
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(~0u, part, o);
    if (lane == 0) sm.bo[t] = part;
  }
  // own-sub-chunk scores: thread (t, jg) takes channels 16 jg .. + 15
  // and s from t - 1 down to q0, each channel's decay product d =
  // prod_{s<i<t} w_i grown by one factor per step; the warp runs its
  // largest t's steps (a uniform loop for the shuffles), the others idle
  {
    const int t = tid >> 2, jg = tid & 3, q0 = t & ~(SUB - 1), j0 = 16 * jg;
    const int t_hi = (tid >> 5) * 8 + 7;          // the warp's largest t
    float rt[16], d[16];
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          sm.r + bi(t, j0 + 8 * h8));
      const bf162* pr = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pr[e]);
        rt[8 * h8 + 2 * e] = f.x;
        rt[8 * h8 + 2 * e + 1] = f.y;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) d[jj] = 1.0f;
    if (jg == 0)
      for (int sp = t - q0; sp < SUB; ++sp) sm.ad[t][sp] = 0.0f;
    for (int s_ = t_hi - 1; s_ >= q0; --s_) {
      const bool on = s_ < t;
      float kv[16], wv[16];
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            sm.k + bi(s_, j0 + 8 * h8));
        const bf162* pk = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(pk[e]);
          kv[8 * h8 + 2 * e] = f.x;
          kv[8 * h8 + 2 * e + 1] = f.y;
        }
      }
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const float4 f = *reinterpret_cast<const float4*>(
            sm.w + fi(s_, j0 + 4 * q4));
        wv[4 * q4] = f.x;
        wv[4 * q4 + 1] = f.y;
        wv[4 * q4 + 2] = f.z;
        wv[4 * q4 + 3] = f.w;
      }
      float a = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        a += rt[jj] * kv[jj] * d[jj];
        d[jj] = on ? d[jj] * wv[jj] : d[jj];
      }
      a += __shfl_xor_sync(~0u, a, 1);
      a += __shfl_xor_sync(~0u, a, 2);
      if (on && jg == 0) sm.ad[t][s_ - q0] = a;
    }
  }
  CHUNK_MARK(2);
  __syncthreads();
  // lw = log(max(w, 1e-38)); 0 (no decay) past the end and past N
  for (int e = tid; e < TILE; e += NT) {
    const int rr = e >> 6, c = e & 63;
    float& x = sm.w[fi(rr, c)];
    x = rr < cn && c < n ? logf(fmaxf(x, 1e-38f)) : 0.0f;
  }
  CHUNK_MARK(3);
  __syncthreads();
  // running sums of lw, one thread per (channel j, role)
  {
    const int j = tid & 63, role = tid >> 6;
    if (role == 0) {                    // forward: rf, eq, ecl
      float acc = 0.0f, loc = 0.0f;
#pragma unroll 8
      for (int t = 0; t < L; ++t) {
        if ((t & (SUB - 1)) == 0) {
          sm.eq[t / SUB][j] = expf(acc);
          loc = 0.0f;
        }
        sm.rf[fi(t, j)] = __bfloat162float(sm.r[bi(t, j)]) * expf(loc);
        const float l = sm.w[fi(t, j)];
        acc += l;
        loc += l;
      }
      sm.ecl[j] = expf(acc);
    } else if (role == 1) {             // backward to the chunk's end: kd
      float acc = 0.0f;
#pragma unroll 8
      for (int s = L - 1; s >= 0; --s) {
        sm.kd[fi(j, s)] = __bfloat162float(sm.k[bi(s, j)]) * expf(acc);
        acc += sm.w[fi(s, j)];
      }
    } else {                            // backward to q0: kf
      for (int q = role == 2 ? 1 : 3; q <= (role == 2 ? 2 : 3); ++q) {
        const int q0 = SUB * q, kb = SUB * q * (q - 1) / 2;
        float acc = 0.0f;
#pragma unroll 8
        for (int s = q0 - 1; s >= 0; --s) {
          sm.kf[fi(kb + s, j)] = __bfloat162float(sm.k[bi(s, j)]) * expf(acc);
          acc += sm.w[fi(s, j)];
        }
      }
    }
  }
  CHUNK_MARK(4);
  __syncthreads();

  // earlier-sub-chunk scores rf kf^T over this warp's half of the channels
  float acc[8][4];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.0f;
  const int kb = SUB * sq * (sq - 1) / 2;       // kf rows of q0 = 16 sq
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    const int k0 = 32 * hf + 16 * kh;
    uint32_t a3[3][4];
    a_split(a3, m0, k0, lane,
            [&](int rr, int c) { return ld2(sm.rf, rr, c); });
#pragma unroll
    for (int jn = 0; jn < 6; ++jn) {
      if (jn < 2 * sq) {
        uint32_t b0[3], b1[3];
        const float2 x0 = ld2(sm.kf, kb + 8 * jn + g, k0 + cq);
        const float2 x1 = ld2(sm.kf, kb + 8 * jn + g, k0 + cq + 8);
        split3(x0.x, x0.y, b0[0], b0[1], b0[2]);
        split3(x1.x, x1.y, b1[0], b1[1], b1[2]);
        mma(acc[jn], a3[0], b0[0], b1[0]);
        mma(acc[jn], a3[0], b0[1], b1[1]);
        mma(acc[jn], a3[1], b0[0], b1[0]);
        mma(acc[jn], a3[0], b0[2], b1[2]);
        mma(acc[jn], a3[2], b0[0], b1[0]);
        mma(acc[jn], a3[1], b0[1], b1[1]);
      }
    }
  }
  // the two warps of the strip add each other's halves (the log-decay
  // tile is free now); a + b == b + a, so both hold the same scores
  float* xch = sm.w;
  const int xb = 2 * sq * (sq - 1), xo = xb + 2 * sq * hf,
            xp = xb + 2 * sq * (1 - hf);
#pragma unroll
  for (int jn = 0; jn < 6; ++jn)
    if (jn < 2 * sq)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xch[(xo + jn) * 128 + e * 32 + lane] = acc[jn][e];
  __syncthreads();
#pragma unroll
  for (int jn = 0; jn < 6; ++jn)
    if (jn < 2 * sq)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[jn][e] += xch[(xp + jn) * 128 + e * 32 + lane];
  // the own sub-chunk's scores (zero at and above the diagonal)
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
    if (jn == 2 * sq || jn == 2 * sq + 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[jn][e] = sm.ad[m0 + g + ((e >> 1) << 3)]
                          [8 * (jn - 2 * sq) + cq + (e & 1)];
  // y = A v (A in three pieces from registers) + bonus v
  float yacc[4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[jn][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk <= sq) {
      uint32_t a3[3][4];
      a_split_acc(a3, acc[2 * kk], acc[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bt_addr(sm.v, i0 + 16 * np, 16 * kk, lane));
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          mma(yacc[2 * np], a3[q], bf[0], bf[1]);
          mma(yacc[2 * np + 1], a3[q], bf[2], bf[3]);
        }
      }
    }
  }
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = m0 + g + ((e >> 1) << 3), i = i0 + 8 * jn + cq + (e & 1);
      yacc[jn][e] += sm.bo[t] * __bfloat162float(sm.v[bi(t, i)]);
    }
  // the chunk's own state term kd^T v: rows j of the strip, this half of i
  float hacc[4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[jn][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (16 * ks < cn) {
      uint32_t a3[3][4];
      a_split(a3, m0, 16 * ks, lane,
              [&](int rr, int c) { return ld2(sm.kd, rr, c); });
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bt_addr(sm.v, i0 + 16 * np, 16 * ks, lane));
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          mma(hacc[2 * np], a3[q], bf[0], bf[1]);
          mma(hacc[2 * np + 1], a3[q], bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();                      // kf is consumed: S pieces go there
  CHUNK_MARK(5);

  // the chain: entering state in, leaving state out, then the flag
  bf16* spc = reinterpret_cast<bf16*>(sm.kf);
  const size_t nn2 = (size_t)n * n;
  const float* s_in = ch == 0 ? s0 + (size_t)bh * nn2
                             : s_mid + ((size_t)(ch - 1) * bh_n + bh) * nn2;
  float* sdst = ch == nc - 1 ? s_out + (size_t)bh * nn2
                             : s_mid + ((size_t)ch * bh_n + bh) * nn2;
  if (ch > 0) wait_flag(flags + tk - bh_n);
  CHUNK_MARK(6);
  float2 sv[4][2];                      // all loads in flight at once
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int jr = m0 + g + 8 * hr, ic = i0 + 8 * jn + cq;
      sv[jn][hr] = jr < n && ic < n
          ? __ldcg(reinterpret_cast<const float2*>(s_in + jr * n + ic))
          : make_float2(0.0f, 0.0f);
    }
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int jr = m0 + g + 8 * hr, ic = i0 + 8 * jn + cq;
      const float2 x = sv[jn][hr];
      const float e = sm.ecl[jr];
      if (jr < n && ic < n)
        *reinterpret_cast<float2*>(sdst + jr * n + ic) =
            make_float2(x.x * e + hacc[jn][2 * hr],
                        x.y * e + hacc[jn][2 * hr + 1]);
      uint32_t hi, mid, lo;
      split3(x.x, x.y, hi, mid, lo);
      *reinterpret_cast<uint32_t*>(spc + bi(jr, ic)) = hi;
      *reinterpret_cast<uint32_t*>(spc + TILE + bi(jr, ic)) = mid;
      *reinterpret_cast<uint32_t*>(spc + 2 * TILE + bi(jr, ic)) = lo;
    }
  if (ch < nc - 1)
    raise_flag(flags + tk);             // (also orders the S pieces)
  else
    __syncthreads();                    // the last chunk: no successor
  CHUNK_MARK(7);

  // y += (rf o eq) S, both operands in three pieces
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a3[3][4];
    const float* eq = sm.eq[sq];
    a_split(a3, m0, 16 * ks, lane, [&](int rr, int c) {
      const float2 x = ld2(sm.rf, rr, c);
      return make_float2(x.x * eq[c], x.y * eq[c + 1]);
    });
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bh3[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        ldsm_x4_t(bh3[q], bt_addr(spc + q * TILE, i0 + 16 * np, 16 * ks,
                                  lane));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* d = yacc[2 * np + half];
        const int o = 2 * half;
        mma(d, a3[0], bh3[0][o], bh3[0][o + 1]);
        mma(d, a3[0], bh3[1][o], bh3[1][o + 1]);
        mma(d, a3[1], bh3[0][o], bh3[0][o + 1]);
        mma(d, a3[0], bh3[2][o], bh3[2][o + 1]);
        mma(d, a3[2], bh3[0][o], bh3[0][o + 1]);
        mma(d, a3[1], bh3[1][o], bh3[1][o + 1]);
      }
    }
  }
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = m0 + g + 8 * hr, i = i0 + 8 * jn + cq;
      if (t < cn && i < n)
        *reinterpret_cast<bf162*>(y + base + t * row + i) =
            __floats2bfloat162_rn(yacc[jn][2 * hr], yacc[jn][2 * hr + 1]);
    }
  CHUNK_MARK(8);
}

}  // namespace

// bf16 only; all tensors packed.  s_mid: (ceil(T / 64) - 1) * B * H * N *
// N float32 chunk states; flags: B * H * ceil(T / 64) + 1 int32, zero on
// entry and on exit.
// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for
// shapes the kernel does not take.
extern "C" int wkv6_chunk_fwd(const void* r, const void* k, const void* v,
                              const float* w, const void* u, const float* s0,
                              void* y, float* s_out, float* s_mid,
                              int* flags, int b, int t_len, int h, int n,
                              void* stream) {
  if (n < 8 || n > L || n % 8 || h < 1 || t_len < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (attr != cudaSuccess) return (int)attr;
  const int nc = (t_len + L - 1) / L, bh_n = b * h;
  wkv6_chunk_kernel<<<bh_n * nc, NT, sizeof(Smem), (cudaStream_t)stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, w, (const bf16*)u, s0,
      (bf16*)y, s_out, s_mid, flags, t_len, h, bh_n, nc, n);
  return (int)cudaGetLastError();
}
