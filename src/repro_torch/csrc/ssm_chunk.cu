// Chunked Mamba-2 SSD scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces, for bfloat16 sequences (T >= CHUNKED_MIN_T in the wrapper,
// ops.py), the Pallas TPU kernel of
// repro/kernels/ssm_scan/kernel.py:
//   ssd_bh (_ssd_kernel)  -> ssd_chunk_kernel
// (ssm_scan.cu keeps single steps and float32.)  Same layout and results
// as ssd_kernel: x, y [B, T, H, P] bf16 (x read through its batch and time
// strides); dt [B, T, H] float32; A, D [H] float32; Bm, Cm [B, T, N] bf16,
// one group shared by the heads; state in / out [B, H, P, N] float32.  P
// and N multiples of 8 up to 64 (padded to 64 with zeros), rows and
// strides 16-byte aligned.
//
// What bounds it on an H100.  The step-by-step recurrence is one chain of
// T dependent updates per (batch, head): at prefill (batch 1, 64 heads,
// T = 384) ssd_kernel runs 64 blocks of two warps through 384 steps, 46x
// its bound.  The chunked form (the one the Pallas kernel computes, chunk
// 64) turns a chunk's steps into matrix products, so the work is products
// on the tensor cores (about 2 * 64 * (64 + 64 + 2 * 64) flops per step
// and head, before the split below) and the bytes of x, y and the states;
// only the states pass from chunk to chunk.
//
// Design: one block of 4 warps per (batch, head, chunk of 64 steps); warp
// w owns rows 16 w .. 16 w + 15 of each 64 x 64 product.  Per chunk, with
// cum_t = sum_{i <= t} dt_i A and rev_s = sum_{i > s} dt_i A (each a scan
// of one warp, forward or backward, not a difference of two long sums):
//   G    = C B^T                                   (bf16 x bf16: exact)
//   M    = G o exp(cum_t - cum_s) o dt_s, s <= t    (masked before exp)
//   y    = exp(cum_t) (C S^T) + M x + D x
//   S'   = exp(cum_last) S + x^T (diag(dt_s exp(rev_s)) B)
// The products run as mma.sync m16n8k16 bf16 with float32 sums.  C, B and
// x are exact in bf16; M, S and diag(..) B are float32 and enter in three
// bf16 pieces each (chunk_mma.cuh), so every partial product is exact and
// the sums keep float32 accuracy (one bf16 rounding of a float32 operand
// put the state 165x past its check).  M stays in registers between its
// two products; the warps skip the tiles above the diagonal.
//
// The state passes through a chain: blocks take a ticket from a counter
// and map it chunk-major to (chunk, batch x head), so a block's
// predecessor (the same head's previous chunk) holds a smaller ticket and
// has started.  A block computes G, M x and its chunk's own state term
// x^T (..) B first, then waits on its predecessor's flag, reads the
// entering state (L2), writes the leaving one (s_mid [nc - 1, B * H, P, N],
// or the state output for the last chunk), raises its own flag, and only
// then computes the C S^T term and writes y.  One launch per call; the
// kernel leaves the flags and the counter at 0, so the wrapper keeps them
// between calls and zeroes them only when it makes them.  Exponents, masks, the dt and
// D terms stay in float32 on the CUDA cores.  x, B and C tiles come in
// with 16-byte cp.async, zero-filled past the sequence's end.
#include <math.h>

#include "chunk_mma.cuh"

namespace {

using namespace chunk;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int NT = 128;    // 4 warps

struct Smem {
  bf16 x[TILE], b[TILE], c[TILE];   // [s][p], [s][n], [t][n]
  bf16 pc[3][TILE];                 // pieces: Bw [s][n], then S [p][n]
  float cum[L], ec[L], wb[L], dts[L];
};

__global__ void __launch_bounds__(NT, 4)
ssd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const float* __restrict__ D,
                 const float* __restrict__ s0, bf16* __restrict__ y,
                 float* __restrict__ s_out, float* __restrict__ s_mid,
                 int* __restrict__ flags, int t_len, int h, int bh_n, int nc,
                 int p, int n, long long x_sb, long long x_st,
                 long long b_sb, long long b_st, long long c_sb,
                 long long c_st) {
  extern __shared__ __align__(128) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cq = (lane & 3) * 2, m0 = 16 * w;
  const int tk = take_ticket(flags + (size_t)bh_n * nc);
  const int ch = tk / bh_n, bh = tk % bh_n, b = bh / h, hh = bh % h;
  const int t0 = ch * L, cn = min(L, t_len - t0);
  if (ch == 0 && p == L && n == L) prefetch_state(s0 + (size_t)bh * L * L);
  CHUNK_MARK(0);

  // this chunk's x, B and C rows (zeros past the end and past P / N)
  const bf16* xb = x + (size_t)b * x_sb + (size_t)t0 * x_st + (size_t)hh * p;
  const bf16* bb = Bm + (size_t)b * b_sb + (size_t)t0 * b_st;
  const bf16* cb = Cm + (size_t)b * c_sb + (size_t)t0 * c_st;
  for (int e = tid; e < L * 8; e += NT) {
    const int r = e >> 3, q = (e & 7) << 3;
    const bool xin = r < cn && q < p, bin = r < cn && q < n;
    cp_async16(sm.x + bi(r, q), xin ? xb + r * x_st + q : x, xin);
    cp_async16(sm.b + bi(r, q), bin ? bb + r * b_st + q : Bm, bin);
    cp_async16(sm.c + bi(r, q), bin ? cb + r * c_st + q : Cm, bin);
  }
  if (tid < L)
    sm.dts[tid] =
        tid < cn ? dt[((size_t)b * t_len + t0 + tid) * h + hh] : 0.0f;
  cp_async_wait_all();
  __syncthreads();
  CHUNK_MARK(1);
  const float a_h = A[hh];
  if (w < 2) {          // warp 0: cum_t forward, warp 1: rev_s backward;
    const float l0 = sm.dts[2 * lane] * a_h,       // lane holds steps
        l1 = sm.dts[2 * lane + 1] * a_h;           // 2 lane, 2 lane + 1
    float x = l0 + l1;
    if (w == 0) {                                  // inclusive prefix
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(~0u, x, o);
        if (lane >= o) x += y;
      }
      float ex = __shfl_up_sync(~0u, x, 1);
      if (lane == 0) ex = 0.0f;
      sm.cum[2 * lane] = ex + l0;
      sm.cum[2 * lane + 1] = ex + (l0 + l1);
    } else {                                       // exclusive suffix
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(~0u, x, o);
        if (lane + o < 32) x += y;
      }
      float ex = __shfl_down_sync(~0u, x, 1);
      if (lane == 31) ex = 0.0f;
      sm.wb[2 * lane + 1] = sm.dts[2 * lane + 1] * expf(ex);
      sm.wb[2 * lane] = sm.dts[2 * lane] * expf(ex + l1);
    }
  }
  __syncthreads();
  if (tid < L) sm.ec[tid] = expf(sm.cum[tid]);
  // Bw = diag(dt_s exp(rev_s)) B in three pieces
  for (int e = tid; e < L * L / 2; e += NT) {
    const int r = e >> 5, col = (e & 31) << 1;
    const float f = sm.wb[r];
    const float2 bv =
        __bfloat1622float2(*reinterpret_cast<const bf162*>(sm.b + bi(r, col)));
    uint32_t hi, mid, lo;
    split3(f * bv.x, f * bv.y, hi, mid, lo);
    *reinterpret_cast<uint32_t*>(sm.pc[0] + bi(r, col)) = hi;
    *reinterpret_cast<uint32_t*>(sm.pc[1] + bi(r, col)) = mid;
    *reinterpret_cast<uint32_t*>(sm.pc[2] + bi(r, col)) = lo;
  }
  CHUNK_MARK(2);
  __syncthreads();

  // G = C B^T on this warp's rows, the tiles at or below the diagonal
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_addr(sm.c, m0, 16 * ks, lane));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp <= w) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr(sm.b, 16 * jp, 16 * ks, lane));
        mma(acc[2 * jp], a, bf[0], bf[1]);
        mma(acc[2 * jp + 1], a, bf[2], bf[3]);
      }
    }
  }
  // M = G o exp(cum_t - cum_s) o dt_s for s <= t, else 0
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = m0 + g + ((e >> 1) << 3), s = 8 * j + cq + (e & 1);
      acc[j][e] = s <= t
          ? acc[j][e] * expf(sm.cum[t] - sm.cum[s]) * sm.dts[s] : 0.0f;
    }
  // y = M x (M split in three pieces, from registers)
  float yacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk <= w) {
      uint32_t a3[3][4];
      a_split_acc(a3, acc[2 * kk], acc[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bt_addr(sm.x, 16 * np, 16 * kk, lane));
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          mma(yacc[2 * np], a3[q], bf[0], bf[1]);
          mma(yacc[2 * np + 1], a3[q], bf[2], bf[3]);
        }
      }
    }
  }
  // the chunk's own state term x^T Bw: rows p of this warp, all n
  float hacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (16 * ks < cn) {
      uint32_t a[4];
      ldsm_x4_t(a, at_addr(sm.x, m0, 16 * ks, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bt_addr(sm.pc[q], 16 * np, 16 * ks, lane));
          mma(hacc[2 * np], a, bf[0], bf[1]);
          mma(hacc[2 * np + 1], a, bf[2], bf[3]);
        }
    }
  }
  __syncthreads();                      // every warp is done with Bw
  CHUNK_MARK(3);

  // the chain: entering state in, leaving state out, then the flag
  const size_t pn = (size_t)p * n;
  const float* s_in = ch == 0 ? s0 + (size_t)bh * pn
                             : s_mid + ((size_t)(ch - 1) * bh_n + bh) * pn;
  float* sdst = ch == nc - 1 ? s_out + (size_t)bh * pn
                             : s_mid + ((size_t)ch * bh_n + bh) * pn;
  if (ch > 0) wait_flag(flags + tk - bh_n);
  CHUNK_MARK(4);
  const float ecl = sm.ec[L - 1];
  float2 sv[8][2];                      // all loads in flight at once
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pr = m0 + g + 8 * hf, nn = 8 * j + cq;
      sv[j][hf] = pr < p && nn < n
          ? __ldcg(reinterpret_cast<const float2*>(s_in + pr * n + nn))
          : make_float2(0.0f, 0.0f);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pr = m0 + g + 8 * hf, nn = 8 * j + cq;
      const float2 v = sv[j][hf];
      if (pr < p && nn < n)
        *reinterpret_cast<float2*>(sdst + pr * n + nn) =
            make_float2(v.x * ecl + hacc[j][2 * hf],
                        v.y * ecl + hacc[j][2 * hf + 1]);
      uint32_t hi, mid, lo;
      split3(v.x, v.y, hi, mid, lo);
      *reinterpret_cast<uint32_t*>(sm.pc[0] + bi(pr, nn)) = hi;
      *reinterpret_cast<uint32_t*>(sm.pc[1] + bi(pr, nn)) = mid;
      *reinterpret_cast<uint32_t*>(sm.pc[2] + bi(pr, nn)) = lo;
    }
  if (ch < nc - 1)
    raise_flag(flags + tk);             // (also orders the S pieces)
  else
    __syncthreads();                    // the last chunk: no successor
  CHUNK_MARK(5);

  // y += exp(cum_t) C S^T + D x
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_addr(sm.c, m0, 16 * ks, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr(sm.pc[q], 16 * np, 16 * ks, lane));
        mma(acc[2 * np], a, bf[0], bf[1]);
        mma(acc[2 * np + 1], a, bf[2], bf[3]);
      }
  }
  const float d_h = D[hh];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = m0 + g + 8 * hf, pp = 8 * j + cq;
      if (t < cn && pp < p) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(sm.x + bi(t, pp)));
        const float e = sm.ec[t];
        *reinterpret_cast<bf162*>(
            y + ((size_t)((size_t)b * t_len + t0 + t) * h + hh) * p + pp) =
            __floats2bfloat162_rn(
                acc[j][2 * hf] * e + yacc[j][2 * hf] + d_h * xv.x,
                acc[j][2 * hf + 1] * e + yacc[j][2 * hf + 1] + d_h * xv.y);
      }
    }
  CHUNK_MARK(6);
}

}  // namespace

// bf16 only.  s_mid: (ceil(T / 64) - 1) * B * H * P * N float32 chunk
// states; flags: B * H * ceil(T / 64) + 1 int32, zero on entry and on
// exit.  Strides in elements.  Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take.
extern "C" int ssd_chunk_fwd(const void* x, const float* dt, const float* a,
                             const void* bm, const void* cm, const float* d,
                             const float* s0, void* y, float* s_out,
                             float* s_mid, int* flags, int b, int t_len,
                             int h, int p, int n, long long x_sb,
                             long long x_st, long long b_sb, long long b_st,
                             long long c_sb, long long c_st, void* stream) {
  if (p < 8 || p > L || p % 8 || n < 8 || n > L || n % 8 || h < 1 ||
      t_len < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (attr != cudaSuccess) return (int)attr;
  const int nc = (t_len + L - 1) / L, bh_n = b * h;
  ssd_chunk_kernel<<<bh_n * nc, NT, sizeof(Smem), (cudaStream_t)stream>>>(
      (const bf16*)x, dt, a, (const bf16*)bm, (const bf16*)cm, d, s0,
      (bf16*)y, s_out, s_mid, flags, t_len, h, bh_n, nc, p, n, x_sb, x_st,
      b_sb, b_st, c_sb, c_st);
  return (int)cudaGetLastError();
}
