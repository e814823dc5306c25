// Backward of the Mamba-2 SSD scan for Hopper (sm_90a), chunks of 64.
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// chunked jnp scan (repro/kernels/ssm_scan/ops.py, ssd_chunked, with
// per-chunk remat); its Pallas kernel (kernel.py, ssd_bh) has no VJP.  This
// is the counterpart of that autodiff, so that training runs the forward
// kernels (ssm_chunk.cu in bf16, ssm_scan.cu otherwise) and this one.
// Plain version: kernels/ssm_scan/ref.py ssd_bwd_ref, which writes out the
// same terms.
//
// Layout as the forward's: x [B, T, H, P] and Bm, Cm [B, T, N] read through
// their batch and time strides; dy, dx [B, T, H, P] packed (x's type, bf16
// or float32); dt, ddt [B, T, H] float32; A, D [H] float32; the states the
// forward saved, entering each chunk of 64 steps, [nc, B * H, P, N]
// float32, the first the input state; the gradient of the output state
// [B * H, P, N].  P, N <= 64, padded to 64 with zeros.
//
// Per chunk, with cum_t = sum_{i<=t} dt_i A (a running sum of one thread),
// E[t, s] = exp(cum_t - cum_s) for s <= t (masked before exp, so every
// exponent is <= 0), e1_t = exp(sum_{i>t} dt_i A) (a running sum from the
// end), G the gradient of the leaving state:
//   CB = C B^T, DX = dY X^T (dy_t . x_s), DYS = dY S0, XG = X G
//   G_in  = exp(cum_last) G + (dY o exp(cum))^T C      (to the previous chunk)
//   GB_t  = e1_t (B G^T)_t + sum_{t'>=t} CB[t', t] E[t', t] dy_t'
//   dx_t  = dt_t GB_t + D dy_t,   ddt_t = x_t . GB_t + A dla_t
//   dB_t  = dt_t (e1_t XG_t + sum_{t'>=t} DX[t', t] E[t', t] C_t')   (per head)
//   dC_t  = exp(cum_t) DYS_t + sum_{s<=t} DX[t, s] E[t, s] dt_s B_s  (per head)
//   dcum_m = exp(cum_m) DYS_m . C_m + sum_s Q[m, s] - sum_t Q[t, m]
//            - e1_m dt_m XG_m . B_m + [m = last] <G, S_leaving>,
//   Q[t, s] = E[t, s] dt_s CB[t, s] DX[t, s],  dla_t = sum_{m>=t} dcum_m
//   dA += sum_t dt_t dla_t,  dD += sum_t dy_t . x_t
// (<G, S_leaving> = exp(cum_last) <G, S0> + sum_s e1_s dt_s XG_s . B_s.)
//
// What bounds it on an H100.  It reads x, dy, dt, B, C and the saved states
// and writes dx, ddt and the per-head parts of dB, dC (~0.7 GB at
// zamba2-1.2b's training shape [8, 2048, 64, 64], N 64, in bf16 with the
// parts in float32: ~0.2 ms at 3.35 TB/s).  Its work: ten 64 x 64 x 64
// products a chunk on the tensor cores (mma.sync m16n8k16, both operands
// in three bf16 pieces, six mma a tile, chunk_mma.cuh) and O(64^2) per
// chunk on the CUDA cores.  A first, simple design: one block of 8 warps
// per (batch, head, chunk), one block per SM (~163 KB of float tiles).
//
// B and C are shared by the heads, and A, D are summed over batch and
// time: each block writes its head's parts of dB and dC ([B, H, T, N]
// float32) and its (batch, chunk)'s parts of dA and dD, and a second
// launch (group_sum) sums them in a fixed order.  No atomics: two launches
// on the same inputs are bit-equal.  The state gradient passes from chunk
// c + 1 to c through the reverse ticketed chain of rwkv6_chunk_bwd.cu.
#include <math.h>

#include "chunk_mma.cuh"

namespace {

using namespace chunk;
typedef __nv_bfloat16 bf16;

constexpr int NT = 256;    // 8 warps

struct Smem {
  float x[FT], dy[FT];             // [t][p]
  float bt[FT], ct[FT];            // [t][n]
  float s0[FT];                    // S0 [p][n], then GB [t][p]
  float gend[FT];                  // G [p][n]
  float cb[FT], dx[FT];            // CB [t][s], DX [t][s]
  float dys[FT], xg[FT];           // DYS [t][n], XG [t][n]
  float cum[L], ecum[L], e1[L], dt[L], dcum[L], xgb[L], ddt[L];
  float red[8];
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ states, const T* __restrict__ dy,
               const float* __restrict__ dsout, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ db_part,
               float* __restrict__ dc_part, float* __restrict__ da_part,
               float* __restrict__ dd_part, float* __restrict__ dstate,
               float* __restrict__ ds_mid, int* __restrict__ flags,
               int t_len, int h, int bh_n, int nc, int p, int n,
               long long x_sb, long long x_st, long long b_sb,
               long long b_st, long long c_sb, long long c_st) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int m0 = 16 * (wp >> 1), n0 = 32 * (wp & 1);
  const int tk = take_ticket(flags + (size_t)bh_n * nc);
  const int ch = nc - 1 - tk / bh_n, bh = tk % bh_n, b = bh / h, hh = bh % h;
  const int t0 = ch * L, cn = min(L, t_len - t0);
  const size_t pn = (size_t)p * n;
  const float a_h = A[hh], d_h = D[hh];
  const T* xb = x + (size_t)b * x_sb + (size_t)t0 * x_st + (size_t)hh * p;
  const T* bb = Bm + (size_t)b * b_sb + (size_t)t0 * b_st;
  const T* cb = Cm + (size_t)b * c_sb + (size_t)t0 * c_st;
  const size_t ybase = (((size_t)b * t_len + t0) * h + hh) * p;
  const size_t yrow = (size_t)h * p;
  const float* dtb = dt + ((size_t)b * t_len + t0) * h + hh;

  // this chunk's rows (zeros past the end, past P and past N) and S0
  const float* s0 = states + ((size_t)ch * bh_n + bh) * pn;
  for (int e = tid; e < L * L; e += NT) {
    const int t = e >> 6, c = e & 63;
    const bool tp = t < cn && c < p, tn = t < cn && c < n;
    sm.x[ti(t, c)] = tp ? to_f(xb[(size_t)t * x_st + c]) : 0.0f;
    sm.dy[ti(t, c)] = tp ? to_f(dy[ybase + (size_t)t * yrow + c]) : 0.0f;
    sm.bt[ti(t, c)] = tn ? to_f(bb[(size_t)t * b_st + c]) : 0.0f;
    sm.ct[ti(t, c)] = tn ? to_f(cb[(size_t)t * c_st + c]) : 0.0f;
    sm.s0[ti(t, c)] = t < p && c < n ? s0[t * n + c] : 0.0f;
  }
  if (tid < L) sm.dt[tid] = tid < cn ? dtb[(size_t)tid * h] : 0.0f;
  __syncthreads();
  // running sums of dt A: forward (cum) and from the end (e1)
  if (tid == 0) {
    float c = 0.0f;
    for (int t = 0; t < L; ++t) {
      c += sm.dt[t] * a_h;
      sm.cum[t] = c;
      sm.ecum[t] = expf(c);
    }
  } else if (tid == 32) {
    float rv = 0.0f;
    for (int t = L - 1; t >= 0; --t) {
      sm.e1[t] = expf(rv);
      rv += sm.dt[t] * a_h;
    }
  }
  __syncthreads();
  auto ex = [&](int t, int s) {               // E[t, s], masked before exp
    return s <= t ? expf(sm.cum[t] - sm.cum[s]) : 0.0f;
  };

  // CB, DX, DYS; the chunk's part of G_in stays in registers
  {
    float acc[4][4];
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int t, int c) { return sm.ct[ti(t, c)]; },
        [&](int c, int s) { return sm.bt[ti(s, c)]; });
    each_acc(acc, m0, n0, lane,
             [&](int t, int s, float v) { sm.cb[ti(t, s)] = v; });
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int t, int c) { return sm.dy[ti(t, c)]; },
        [&](int c, int s) { return sm.x[ti(s, c)]; });
    each_acc(acc, m0, n0, lane,
             [&](int t, int s, float v) { sm.dx[ti(t, s)] = v; });
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int t, int c) { return sm.dy[ti(t, c)]; },
        [&](int c, int j) { return sm.s0[ti(c, j)]; });
    each_acc(acc, m0, n0, lane,
             [&](int t, int j, float v) { sm.dys[ti(t, j)] = v; });
  }
  float gacc[4][4];
  zero_acc(gacc);
  mm6(gacc, m0, n0, lane,
      [&](int c, int t) { return sm.dy[ti(t, c)] * sm.ecum[t]; },
      [&](int t, int j) { return sm.ct[ti(t, j)]; });

  // the chain: G in, G_in = exp(cum_last) G + (dY o exp(cum))^T C out
  const float* src = ch == nc - 1 ? dsout + (size_t)bh * pn
                                  : ds_mid + ((size_t)ch * bh_n + bh) * pn;
  float* dst = ch == 0 ? dstate + (size_t)bh * pn
                       : ds_mid + ((size_t)(ch - 1) * bh_n + bh) * pn;
  if (ch < nc - 1) wait_flag(flags + tk - bh_n);
  for (int e = tid; e < L * L; e += NT) {
    const int r = e >> 6, c = e & 63;
    sm.gend[ti(r, c)] = r < p && c < n ? __ldcg(src + r * n + c) : 0.0f;
  }
  __syncthreads();
  const float etot = sm.ecum[L - 1];
  each_acc(gacc, m0, n0, lane, [&](int r, int c, float v) {
    if (r < p && c < n) dst[r * n + c] = etot * sm.gend[ti(r, c)] + v;
  });
  if (ch > 0)
    raise_flag(flags + tk);
  else
    __syncthreads();

  // <G, S0> (S0's tile is free after this)
  float part = 0.0f;
  for (int e = tid; e < L * L; e += NT)
    part += sm.gend[ti(e >> 6, e & 63)] * sm.s0[ti(e >> 6, e & 63)];
  const float gs0 = block_sum(part, sm.red);

  // XG, then dB_t = dt_t (e1_t XG_t + sum_{t'>=t} DX[t', t] E[t', t] C_t')
  const size_t pbase = (((size_t)b * h + hh) * t_len + t0) * n;
  {
    float acc[4][4];
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int t, int c) { return sm.x[ti(t, c)]; },
        [&](int c, int j) { return sm.gend[ti(c, j)]; });
    each_acc(acc, m0, n0, lane,
             [&](int t, int j, float v) { sm.xg[ti(t, j)] = v; });
    // rescale in place: element (t, j) by e1_t
    {
      const int g = lane >> 2;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] *= sm.e1[m0 + g + ((e >> 1) << 3)];
    }
    mm6(acc, m0, n0, lane,
        [&](int t, int u) { return u >= t ? sm.dx[ti(u, t)] * ex(u, t) : 0.0f; },
        [&](int u, int j) { return sm.ct[ti(u, j)]; });
    each_acc(acc, m0, n0, lane, [&](int t, int j, float v) {
      if (t < cn && j < n) db_part[pbase + (size_t)t * n + j] = sm.dt[t] * v;
    });
  }
  // dC_t = exp(cum_t) DYS_t + sum_{s<=t} DX[t, s] E[t, s] dt_s B_s
  {
    float acc[4][4];
    {
      const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m0 + g + ((e >> 1) << 3);
          acc[jn][e] = sm.ecum[t] * sm.dys[ti(t, n0 + 8 * jn + cq + (e & 1))];
        }
    }
    mm6(acc, m0, n0, lane,
        [&](int t, int s) {
          return s <= t ? sm.dx[ti(t, s)] * ex(t, s) * sm.dt[s] : 0.0f;
        },
        [&](int s, int j) { return sm.bt[ti(s, j)]; });
    each_acc(acc, m0, n0, lane, [&](int t, int j, float v) {
      if (t < cn && j < n) dc_part[pbase + (size_t)t * n + j] = v;
    });
  }
  // GB_t = e1_t (B G^T)_t + sum_{t'>=t} CB[t', t] E[t', t] dy_t', into S0's
  // tile (block_sum's barriers ordered <G, S0> before); dx = dt GB + D dy
  {
    float acc[4][4];
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int t, int j) { return sm.bt[ti(t, j)]; },
        [&](int j, int c) { return sm.gend[ti(c, j)]; });
    {
      const int g = lane >> 2;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] *= sm.e1[m0 + g + ((e >> 1) << 3)];
    }
    mm6(acc, m0, n0, lane,
        [&](int t, int u) { return u >= t ? sm.cb[ti(u, t)] * ex(u, t) : 0.0f; },
        [&](int u, int c) { return sm.dy[ti(u, c)]; });
    each_acc(acc, m0, n0, lane, [&](int t, int c, float v) {
      sm.s0[ti(t, c)] = v;
      if (t < cn && c < p)
        dx[ybase + (size_t)t * yrow + c] =
            from_f<T>(sm.dt[t] * v + d_h * sm.dy[ti(t, c)]);
    });
  }
  __syncthreads();

  // per step m (thread m): dcum, the direct part of ddt
  if (tid < L) {
    const int m = tid;
    float dyc = 0.0f, xgb = 0.0f, gx = 0.0f;
    for (int c = 0; c < L; ++c) {
      dyc += sm.dys[ti(m, c)] * sm.ct[ti(m, c)];
      xgb += sm.xg[ti(m, c)] * sm.bt[ti(m, c)];
      gx += sm.x[ti(m, c)] * sm.s0[ti(m, c)];
    }
    float qr = 0.0f, qc = 0.0f;        // sum_s Q[m, s], sum_t Q[t, m]
    for (int s = 0; s <= m; ++s)
      qr += ex(m, s) * sm.dt[s] * sm.cb[ti(m, s)] * sm.dx[ti(m, s)];
    for (int t = m; t < L; ++t)
      qc += ex(t, m) * sm.dt[m] * sm.cb[ti(t, m)] * sm.dx[ti(t, m)];
    const float xgbm = sm.e1[m] * sm.dt[m] * xgb;
    sm.xgb[m] = xgbm;
    sm.dcum[m] = sm.ecum[m] * dyc + qr - qc - xgbm;
    sm.ddt[m] = gx;
  }
  __syncthreads();
  // the leaving state's part, dla = the reverse running sum, ddt, dA
  float dap = 0.0f;
  if (tid == 0) {
    float sl = etot * gs0;
    for (int s = 0; s < L; ++s) sl += sm.xgb[s];
    sm.dcum[L - 1] += sl;
    float dla = 0.0f;
    for (int t = L - 1; t >= 0; --t) {
      dla += sm.dcum[t];
      sm.ddt[t] += a_h * dla;
      dap += sm.dt[t] * dla;
    }
  }
  __syncthreads();
  if (tid < cn) ddt[((size_t)b * t_len + t0 + tid) * h + hh] = sm.ddt[tid];
  // dD: sum_t dy_t . x_t
  part = 0.0f;
  for (int e = tid; e < L * L; e += NT)
    part += sm.dy[ti(e >> 6, e & 63)] * sm.x[ti(e >> 6, e & 63)];
  const float ddp = block_sum(part, sm.red);
  if (tid == 0) {
    const size_t q = ((size_t)b * nc + ch) * h + hh;
    da_part[q] = dap;
    dd_part[q] = ddp;
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* d, const float* states,
           const void* dy, const float* dsout, void* dx, float* ddt,
           float* db_part, float* dc_part, float* db, float* dc,
           float* da_part, float* dd_part, float* da, float* dd,
           float* dstate, float* ds_mid, int* flags, int b, int t_len, int h,
           int p, int n, long long x_sb, long long x_st, long long b_sb,
           long long b_st, long long c_sb, long long c_st,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (attr != cudaSuccess) return (int)attr;
  const int nc = (t_len + L - 1) / L, bh_n = b * h;
  ssd_bwd_kernel<T><<<bh_n * nc, NT, sizeof(Smem), stream>>>(
      (const T*)x, dt, a, (const T*)bm, (const T*)cm, d, states,
      (const T*)dy, dsout, (T*)dx, ddt, db_part, dc_part, da_part, dd_part,
      dstate, ds_mid, flags, t_len, h, bh_n, nc, p, n, x_sb, x_st, b_sb,
      b_st, c_sb, c_st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the second stage: dB, dC over the heads; dA, dD over (batch, chunk)
  const long long tn = (long long)t_len * n;
  int rc = group_sum(db_part, db, b, h, tn, stream);
  if (rc == 0) rc = group_sum(dc_part, dc, b, h, tn, stream);
  if (rc == 0) rc = group_sum(da_part, da, 1, b * nc, h, stream);
  if (rc == 0) rc = group_sum(dd_part, dd, 1, b * nc, h, stream);
  return rc;
}

}  // namespace

// dtype (of x, Bm, Cm, dy, dx): 0 float32, 1 bfloat16.  x, Bm, Cm with
// packed last dims, read through the given batch / time strides; the rest
// packed.  states: ceil(T / 64) * B * H * P * N float32 (the state
// entering each chunk, the first the input state); ds_mid: (ceil(T / 64) -
// 1) * B * H * P * N float32 scratch; db_part, dc_part: B * H * T * N
// float32 scratch; db, dc [B, T, N] float32; da_part, dd_part: B *
// ceil(T / 64) * H float32 scratch; da, dd [H] float32; flags:
// B * H * ceil(T / 64) + 1 int32, zero on entry and on exit.  Returns a
// cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for shapes the
// kernel does not take.
extern "C" int ssd_chunk_bwd(const void* x, const float* dt, const float* a,
                             const void* bm, const void* cm, const float* d,
                             const float* states, const void* dy,
                             const float* dsout, void* dx, float* ddt,
                             float* db_part, float* dc_part, float* db,
                             float* dc, float* da_part, float* dd_part,
                             float* da, float* dd, float* dstate,
                             float* ds_mid, int* flags, int b, int t_len,
                             int h, int p, int n, long long x_sb,
                             long long x_st, long long b_sb, long long b_st,
                             long long c_sb, long long c_st, int dtype,
                             void* stream) {
  if (p < 1 || p > L || n < 1 || n > L || h < 1 || t_len < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, d, states, dy, dsout, dx, ddt,
                         db_part, dc_part, db, dc, da_part, dd_part, da, dd,
                         dstate, ds_mid, flags, b, t_len, h, p, n, x_sb,
                         x_st, b_sb, b_st, c_sb, c_st, s);
  if (dtype == 1)
    return launch<bf16>(x, dt, a, bm, cm, d, states, dy, dsout, dx, ddt,
                        db_part, dc_part, db, dc, da_part, dd_part, da, dd,
                        dstate, ds_mid, flags, b, t_len, h, p, n, x_sb, x_st,
                        b_sb, b_st, c_sb, c_st, s);
  return (int)cudaErrorInvalidValue;
}
