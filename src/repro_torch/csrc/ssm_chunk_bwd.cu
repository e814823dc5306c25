// Backward of the Mamba-2 SSD scan for Hopper (sm_90a), chunks of 64.
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// chunked jnp scan (repro/kernels/ssm_scan/ops.py, ssd_chunked, with
// per-chunk remat); its Pallas kernel (kernel.py, ssd_bh) has no VJP.  This
// is the counterpart of that autodiff, so that training runs the forward
// kernels (ssm_chunk.cu in bf16, ssm_scan.cu otherwise) and this one.
// Plain versions: kernels/ssm_scan/ref.py ssd_bwd_ref (the yardstick) and
// ssd_bwd_grouped_ref (this kernel's dataflow, for the tests).
//
// Layout as the forward's: x [B, T, H, P] and Bm, Cm [B, T, N] read through
// their batch and time strides; dy, dx [B, T, H, P] packed (x's type, bf16
// or float32); dt, ddt [B, T, H] float32; A, D [H] float32; the states the
// forward saved, entering each chunk of 64 steps, [nc, B * H, P, N]
// float32, the first the input state; the gradient of the output state
// [B * H, P, N].  P, N <= 64, padded to 64 with zeros.
//
// Per chunk and head, with cum_t = sum_{i<=t} dt_i A and e1_t =
// exp(sum_{i>t} dt_i A) (warp scans, forward and from the end), E[t, s] =
// exp(cum_t - cum_s) for s <= t (masked before exp, so every exponent is
// <= 0), G the gradient of the leaving state:
//   CB = C B^T, DX = dY X^T, M1 = CB o E, M2 = DX o E, Q = M2 o CB o dt_s
//   G_in  = exp(cum_last) G + (dY o exp(cum))^T C      (to the previous chunk)
//   GB    = e1 o (B G^T) + M1^T dY,   dx = dt GB + D dy,  ddt = x . GB + A dla
//   dB   += dt o (e1 o (X G) + M2^T C)                  (the group's heads)
//   dC   += exp(cum) o (dY S0) + (M2 o dt_s) B
//   dcum_m = exp(cum_m) (dY S0)_m . C_m + sum_s Q[m, s] - sum_t Q[t, m]
//            - e1_m dt_m (X G)_m . B_m + [m = last] <G, S_leaving>,
//   dla_t = sum_{m>=t} dcum_m,  dA += sum_t dt_t dla_t,  dD += sum_t dy_t . x_t
// (<G, S_leaving> = exp(cum_last) <G, S0> + sum_s e1_s dt_s (X G)_s . B_s.)
//
// What bounds it on an H100.  It reads x, dy, dt, B, C and the saved states
// and writes dx and ddt (~0.7 GB at zamba2-1.2b's training shape [8, 2048,
// 64, 64], N 64, bf16: ~0.21 ms at 3.35 TB/s); its work is nine 64 x 64 x
// 64 products a (head, chunk) on the tensor cores and O(64^2) elementwise.
// The design keeps it near the tensor cores and the loads:
//   - One block of 8 warps per (batch, chunk, group of hg heads): B, C and
//     C B^T are loaded and computed once for the group; the heads run one
//     after the other, each with its own hand-over on the chain, and their
//     dB / dC parts are summed in registers, in head order, so the parts
//     written ([B, H / hg, T, N] float32) and the second stage's reads are
//     hg times fewer than one part a head.
//   - x, dy, B, C stay in their type: bf16 tiles (swizzled, 16-byte
//     cp.async, ldmatrix) in the bf16 route, so C B^T and dY X^T take one
//     mma a tile and a product with one float32 operand three (the float32
//     route keeps float tiles: six, and one block an SM).
//   - E is taken once per (head, chunk), by the thread that holds the
//     element of C B^T and dY X^T, and folded into M1 and M2 there; Q's row
//     and column sums fold in registers and over the warps in a fixed order.
//   - ~100 KB of shared memory (bf16) and <= 128 registers: two blocks an
//     SM, so one block's products hide the other's waits on the chain.
// No atomics: two launches on the same inputs are bit-equal.  dA and dD are
// written per (batch, chunk, head) and dB, dC per (batch, group, step), and
// a second launch (group_sum) sums them in a fixed order.  The state
// gradient passes from chunk c + 1 to c through the reverse ticketed chain
// of rwkv6_chunk_bwd.cu, one flag per (chunk, batch, head).
#include <math.h>

#include "chunk_mma.cuh"

namespace {

using namespace chunk;
typedef __nv_bfloat16 bf16;

constexpr int NT = 256;    // 8 warps

template <typename T>
struct Smem {
  T x[TILE], dy[TILE];              // this head's [t][p]
  T bt[TILE], ct[TILE];             // the group's B [s][n], C [t][n]
  float cb[TILE];                   // C B^T [t][s]
  float sg[TILE];                   // S0 [p][n], then G [p][n]
  float m1t[TILE];                  // (CB o E)^T [s][t]
  float m2[TILE];                   // DX o E [t][s]
  float cum[L], ecum[L], e1[L], dt[2][L];   // dt by head parity
  float rowp[5][2][L];              // row sums of the strip's two warps:
                                    // dYS.C, Q, XG.B, x.GB, dy.x
  float colp[4][L];                 // Q's column sums, by strip
  float red[8];
};

// vec bits: 16-byte rows of x, dy, B, C and the states
enum { V_X = 1, V_DY = 2, V_B = 4, V_C = 8, V_S = 16 };

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ states, const T* __restrict__ dy,
               const float* __restrict__ dsout, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ db_part,
               float* __restrict__ dc_part, float* __restrict__ da_part,
               float* __restrict__ dd_part, float* __restrict__ dstate,
               float* __restrict__ ds_mid, int* __restrict__ flags,
               int t_len, int h, int bh_n, int nc, int p, int n, int hg,
               int vec, long long x_sb, long long x_st, long long b_sb,
               long long b_st, long long c_sb, long long c_st) {
  extern __shared__ __align__(128) unsigned char raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(raw);
  constexpr int PT = Pieces<T>::n;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const int sq = wp >> 1, hf = wp & 1, m0 = 16 * sq, n0 = 32 * hf;
  const int ng = h / hg, bg_n = (bh_n / h) * ng;
  const int tk = take_ticket(flags + (size_t)bh_n * nc);
  const int ch = nc - 1 - tk / bg_n, bg = tk % bg_n, b = bg / ng,
            grp = bg % ng;
  const int t0 = ch * L, cn = min(L, t_len - t0);
  const size_t pn = (size_t)p * n;
  const size_t yrow = (size_t)h * p;
  CHUNK_PHASE_START;

  // the group's B and C, then the first head's rows
  load_tile<T, NT>(sm.bt, Bm + (size_t)b * b_sb + (size_t)t0 * b_st, b_st,
                   cn, n, vec & V_B);
  load_tile<T, NT>(sm.ct, Cm + (size_t)b * c_sb + (size_t)t0 * c_st, c_st,
                   cn, n, vec & V_C);
  auto load_head = [&](int jh) {
    const int hh = grp * hg + jh;
    load_tile<T, NT>(sm.x, x + (size_t)b * x_sb + (size_t)t0 * x_st +
                               (size_t)hh * p,
                     x_st, cn, p, vec & V_X);
    load_tile<T, NT>(sm.dy, dy + (((size_t)b * t_len + t0) * h + hh) * p,
                     (long long)yrow, cn, p, vec & V_DY);
    load_tile<float, NT>(sm.sg, states + ((size_t)ch * bh_n + b * h + hh) *
                                             pn,
                         n, p, n, vec & V_S);
    if (tid < L)
      cp_async4(&sm.dt[jh & 1][tid],
                tid < cn ? dt + ((size_t)b * t_len + t0 + tid) * h + hh : dt,
                tid < cn);
  };
  load_head(0);
  cp_async_wait_all();
  __syncthreads();
  // C B^T, once for the group
  {
    float acc[4][4];
    zero_acc(acc);
    mm<PT, PT>(acc, n0, 0, L,
               [&](auto& a, int k0) { frag_a(a, sm.ct, m0, k0, lane); },
               [&](auto& b_, int k0, int nn) {
                 frag_b(b_, sm.bt, nn, k0, lane);
               });
    each_acc(acc, m0, n0, lane,
             [&](int t, int s, float& v) { sm.cb[fi(t, s)] = v; });
  }
  CHUNK_PHASE(1);

  float dbacc[4][4], dcacc[4][4];
  zero_acc(dbacc);
  zero_acc(dcacc);
  // warp 0, after a head's products: dcum, dla (a scan from the end),
  // ddt, dA's and dD's parts of head jh (its sums in rowp, colp and red),
  // beside the next head's loads (its dt into the other buffer)
  auto tail = [&](int jh) {
    const int hh = grp * hg + jh;
    const float a_h = A[hh], etot = sm.ecum[L - 1];
    const float *dtv = sm.dt[jh & 1], *ecum = sm.ecum, *e1 = sm.e1;
    float dc[2], gxv[2], ddv[2], xb[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = 2 * lane + hr;
      const float qc = sm.colp[0][m] + sm.colp[1][m] + sm.colp[2][m] +
                       sm.colp[3][m];
      xb[hr] = e1[m] * dtv[m] * (sm.rowp[2][0][m] + sm.rowp[2][1][m]);
      dc[hr] = ecum[m] * (sm.rowp[0][0][m] + sm.rowp[0][1][m]) +
               (sm.rowp[1][0][m] + sm.rowp[1][1][m]) - qc - xb[hr];
      gxv[hr] = sm.rowp[3][0][m] + sm.rowp[3][1][m];
      ddv[hr] = sm.rowp[4][0][m] + sm.rowp[4][1][m];
    }
    // the leaving state's part, on the last step
    const float xbs = warp_sum(xb[0] + xb[1]);
    float gsum = 0.0f;
    for (int w = 0; w < NT / 32; ++w) gsum += sm.red[w];
    if (lane == 31) dc[1] += etot * gsum + xbs;
    // dla_t = sum_{m>=t} dcum_m
    const float d1 = dc[1], d0 = dc[0] + dc[1];
    float s = d0;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(~0u, s, o);
      if (lane + o < 32) s += y;
    }
    float ex = __shfl_down_sync(~0u, s, 1);
    if (lane == 31) ex = 0.0f;
    const float dla[2] = {ex + d0, ex + d1};
    float dap = 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = 2 * lane + hr;
      if (m < cn) ddt[((size_t)b * t_len + t0 + m) * h + hh] =
          gxv[hr] + a_h * dla[hr];
      dap += dtv[m] * dla[hr];
    }
    dap = warp_sum(dap);
    const float ddp = warp_sum(ddv[0] + ddv[1]);
    if (lane == 0) {
      const size_t q = ((size_t)b * nc + ch) * h + hh;
      da_part[q] = dap;
      dd_part[q] = ddp;
    }
  };
  for (int jh = 0; jh < hg; ++jh) {
    const int hh = grp * hg + jh, bh = b * h + hh, buf = jh & 1;
    const float a_h = A[hh], d_h = D[hh];
    const float* dtv = sm.dt[buf];
    float *cum = sm.cum, *ecum = sm.ecum, *e1 = sm.e1;
    if (jh > 0) cp_async_wait_all();
    __syncthreads();
    // cum and exp(cum) (warp 0), e1 (warp 1): lane holds steps 2 lane,
    // 2 lane + 1
    if (wp < 2) {
      const float l0 = dtv[2 * lane] * a_h, l1 = dtv[2 * lane + 1] * a_h;
      float s = l0 + l1;
      if (wp == 0) {
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(~0u, s, o);
          if (lane >= o) s += y;
        }
        float ex = __shfl_up_sync(~0u, s, 1);
        if (lane == 0) ex = 0.0f;
        cum[2 * lane] = ex + l0;
        cum[2 * lane + 1] = ex + (l0 + l1);
        ecum[2 * lane] = expf(ex + l0);
        ecum[2 * lane + 1] = expf(ex + (l0 + l1));
      } else {
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_down_sync(~0u, s, o);
          if (lane + o < 32) s += y;
        }
        float ex = __shfl_down_sync(~0u, s, 1);
        if (lane == 31) ex = 0.0f;
        e1[2 * lane + 1] = expf(ex);
        e1[2 * lane] = expf(ex + l1);
      }
    }
    __syncthreads();
    CHUNK_PHASE(2);

    // DX = dY X^T, then E at each element once: M2 = DX o E, M1 = CB o E
    // (stored transposed), Q = M2 o CB o dt_s summed by rows and columns
    {
      float acc[4][4];
      zero_acc(acc);
      mm<PT, PT>(acc, n0, 0, L,
                 [&](auto& a, int k0) { frag_a(a, sm.dy, m0, k0, lane); },
                 [&](auto& b_, int k0, int nn) {
                   frag_b(b_, sm.x, nn, k0, lane);
                 });
      float qr[2] = {0.0f, 0.0f}, qc[4][2] = {};
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m0 + g + ((e >> 1) << 3), s = n0 + 8 * jn + cq + (e & 1);
          const float ee = s <= t ? expf(cum[t] - cum[s]) : 0.0f;
          const float cbv = sm.cb[fi(t, s)], m2 = acc[jn][e] * ee;
          sm.m2[fi(t, s)] = m2;
          sm.m1t[fi(s, t)] = cbv * ee;
          const float qv = m2 * cbv * dtv[s];
          qr[e >> 1] += qv;
          qc[jn][e & 1] += qv;
        }
      fold_rows(qr);
      fold_cols(qc);
      if ((lane & 3) == 0) {
        sm.rowp[1][hf][m0 + g] = qr[0];
        sm.rowp[1][hf][m0 + g + 8] = qr[1];
      }
      if (lane < 4)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          sm.colp[sq][n0 + 8 * jn + cq] = qc[jn][0];
          sm.colp[sq][n0 + 8 * jn + cq + 1] = qc[jn][1];
        }
    }
    // dY S0: dC's state part, and (dY S0)_t . C_t
    {
      float acc[4][4];
      zero_acc(acc);
      mm<PT, 3>(acc, n0, 0, L,
                [&](auto& a, int k0) { frag_a(a, sm.dy, m0, k0, lane); },
                [&](auto& b_, int k0, int nn) {
                  frag_bt(b_, sm.sg, nn, k0, lane);
                });
      float dyc[2] = {0.0f, 0.0f};
      row_sums(dyc, acc, m0, n0, lane,
               [&](int t, int j) { return to_f(sm.ct[bi(t, j)]); });
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dcacc[jn][e] += ecum[m0 + g + ((e >> 1) << 3)] * acc[jn][e];
      fold_rows(dyc);
      if ((lane & 3) == 0) {
        sm.rowp[0][hf][m0 + g] = dyc[0];
        sm.rowp[0][hf][m0 + g + 8] = dyc[1];
      }
    }
    // the chunk's part of G_in, (dY o exp(cum))^T C, stays in registers
    float gacc[4][4];
    zero_acc(gacc);
    mm<3, PT>(gacc, n0, 0, L,
              [&](auto& a, int k0) {
                a_split(a, m0, k0, lane, [&](int pp, int t) {
                  return make_float2(to_f(sm.dy[bi(t, pp)]) * ecum[t],
                                     to_f(sm.dy[bi(t + 1, pp)]) *
                                         ecum[t + 1]);
                });
              },
              [&](auto& b_, int k0, int nn) {
                frag_bt(b_, sm.ct, nn, k0, lane);
              });
    __syncthreads();                  // S0's readers are done
    CHUNK_PHASE(3);

    // the chain: G in, G_in = exp(cum_last) G + (dY o exp(cum))^T C out
    const float* src = ch == nc - 1 ? dsout + (size_t)bh * pn
                                    : ds_mid + ((size_t)ch * bh_n + bh) * pn;
    float* dst = ch == 0 ? dstate + (size_t)bh * pn
                         : ds_mid + ((size_t)(ch - 1) * bh_n + bh) * pn;
    if (ch < nc - 1) wait_flag(flags + (size_t)(nc - 2 - ch) * bh_n + bh);
    CHUNK_PHASE(4);
    float gs0 = 0.0f;                 // <G, S0>, this thread's part
    {
      float gv[4][4];                 // all of a thread's loads in flight
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = 4 * (tid + NT * x), r = e >> 6, c = e & 63;
        if ((n & 3) == 0) {
          const float4 f = r < p && c < n
              ? __ldcg(reinterpret_cast<const float4*>(src + r * n + c))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          gv[x][0] = f.x; gv[x][1] = f.y; gv[x][2] = f.z; gv[x][3] = f.w;
        } else {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            gv[x][y] = r < p && c + y < n ? __ldcg(src + r * n + c + y)
                                          : 0.0f;
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = 4 * (tid + NT * x), r = e >> 6, c = e & 63;
        float4* pos = reinterpret_cast<float4*>(sm.sg + fi(r, c));
        const float4 s0 = *pos;
        gs0 += gv[x][0] * s0.x + gv[x][1] * s0.y + gv[x][2] * s0.z +
               gv[x][3] * s0.w;
        *pos = make_float4(gv[x][0], gv[x][1], gv[x][2], gv[x][3]);
      }
    }
    gs0 = warp_sum(gs0);
    if (lane == 0) sm.red[wp] = gs0;
    __syncthreads();
    const float etot = ecum[L - 1];
    each_acc(gacc, m0, n0, lane, [&](int r, int c, float& v) {
      if (r < p && c < n) dst[r * n + c] = etot * sm.sg[fi(r, c)] + v;
    });
    if (ch > 0)
      raise_flag(flags + (size_t)(nc - 1 - ch) * bh_n + bh);
    CHUNK_PHASE(5);

    // X G: dB's state part and (X G)_t . B_t; then dB += dt o (e1 o X G +
    // M2^T C) (M2[u][t] = 0 for u < t) and dC += (M2 o dt_s) B (s <= t)
    {
      float acc[4][4];
      zero_acc(acc);
      mm<PT, 3>(acc, n0, 0, L,
                [&](auto& a, int k0) { frag_a(a, sm.x, m0, k0, lane); },
                [&](auto& b_, int k0, int nn) {
                  frag_bt(b_, sm.sg, nn, k0, lane);
                });
      float xgb[2] = {0.0f, 0.0f};
      row_sums(xgb, acc, m0, n0, lane,
               [&](int t, int j) { return to_f(sm.bt[bi(t, j)]); });
      each_acc(acc, m0, n0, lane, [&](int t, int j, float& v) { v *= e1[t]; });
      fold_rows(xgb);
      if ((lane & 3) == 0) {
        sm.rowp[2][hf][m0 + g] = xgb[0];
        sm.rowp[2][hf][m0 + g + 8] = xgb[1];
      }
      mm<3, PT>(acc, n0, m0, L,
                [&](auto& a, int k0) { frag_at(a, sm.m2, m0, k0, lane); },
                [&](auto& b_, int k0, int nn) {
                  frag_bt(b_, sm.ct, nn, k0, lane);
                });
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dbacc[jn][e] += dtv[m0 + g + ((e >> 1) << 3)] * acc[jn][e];
    }
    mm<3, PT>(dcacc, n0, 0, m0 + 16,
              [&](auto& a, int k0) {
                a_split(a, m0, k0, lane, [&](int t, int s) {
                  const float2 v = f2at(sm.m2, t, s);
                  return make_float2(v.x * dtv[s], v.y * dtv[s + 1]);
                });
              },
              [&](auto& b_, int k0, int nn) {
                frag_bt(b_, sm.bt, nn, k0, lane);
              });
    // GB = e1 o (B G^T) + M1^T dY (M1[u][t] = 0 for u < t); dx, x . GB
    {
      float acc[4][4];
      zero_acc(acc);
      mm<PT, 3>(acc, n0, 0, L,
                [&](auto& a, int k0) { frag_a(a, sm.bt, m0, k0, lane); },
                [&](auto& b_, int k0, int nn) {
                  frag_b(b_, sm.sg, nn, k0, lane);
                });
      each_acc(acc, m0, n0, lane,
               [&](int t, int c, float& v) { v *= e1[t]; });
      mm<3, PT>(acc, n0, m0, L,
                [&](auto& a, int k0) { frag_a(a, sm.m1t, m0, k0, lane); },
                [&](auto& b_, int k0, int nn) {
                  frag_bt(b_, sm.dy, nn, k0, lane);
                });
      float gx[2] = {0.0f, 0.0f}, dd[2] = {0.0f, 0.0f};
      T* dxb = dx + (((size_t)b * t_len + t0) * h + hh) * p;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = m0 + g + 8 * hr, c = n0 + 8 * jn + cq;
          const float x0 = to_f(sm.x[bi(t, c)]), x1 = to_f(sm.x[bi(t, c + 1)]);
          const float y0 = to_f(sm.dy[bi(t, c)]),
                      y1 = to_f(sm.dy[bi(t, c + 1)]);
          const float v0 = acc[jn][2 * hr], v1 = acc[jn][2 * hr + 1];
          gx[hr] += x0 * v0 + x1 * v1;
          dd[hr] += y0 * x0 + y1 * x1;
          if (t < cn && c < p)
            store2(dxb + (size_t)t * yrow + c, c + 1 < p,
                   dtv[t] * v0 + d_h * y0, dtv[t] * v1 + d_h * y1);
        }
      fold_rows(gx);
      fold_rows(dd);
      if ((lane & 3) == 0) {
        sm.rowp[3][hf][m0 + g] = gx[0];
        sm.rowp[3][hf][m0 + g + 8] = gx[1];
        sm.rowp[4][hf][m0 + g] = dd[0];
        sm.rowp[4][hf][m0 + g + 8] = dd[1];
      }
    }
    __syncthreads();                  // x, dy, G and the sums are done
    CHUNK_PHASE(6);
    if (jh + 1 < hg) load_head(jh + 1);
    if (wp == 0) tail(jh);
    CHUNK_PHASE(7);

  }


  // the group's parts of dB and dC
  const size_t pbase = (((size_t)b * ng + grp) * t_len + t0) * n;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = m0 + g + 8 * hr, j = n0 + 8 * jn + cq;
      if (t < cn && j < n) {
        store2(db_part + pbase + (size_t)t * n + j, j + 1 < n,
               dbacc[jn][2 * hr], dbacc[jn][2 * hr + 1]);
        store2(dc_part + pbase + (size_t)t * n + j, j + 1 < n,
               dcacc[jn][2 * hr], dcacc[jn][2 * hr + 1]);
      }
    }
  CHUNK_PHASE(8);
}

template <typename T>
int set_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<T>));
  return (int)attr;
}

bool al16(const void* ptr) {
  return !(reinterpret_cast<uintptr_t>(ptr) & 15);
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* d, const float* states,
           const void* dy, const float* dsout, void* dx, float* ddt,
           float* db_part, float* dc_part, float* db, float* dc,
           float* da_part, float* dd_part, float* da, float* dd,
           float* dstate, float* ds_mid, int* flags, int b, int t_len, int h,
           int p, int n, int hg, long long x_sb, long long x_st,
           long long b_sb, long long b_st, long long c_sb, long long c_st,
           cudaStream_t stream) {
  const int rc0 = set_smem<T>();
  if (rc0 != 0) return rc0;
  const int nc = (t_len + L - 1) / L, bh_n = b * h, ng = h / hg;
  constexpr long long per = 16 / sizeof(T);
  auto rows = [&](const void* ptr, long long sb, long long st) {
    return al16(ptr) && sb % per == 0 && st % per == 0;
  };
  const int vec = (rows(x, x_sb, x_st) && p % per == 0 ? V_X : 0) |
                  (al16(dy) && p % per == 0 ? V_DY : 0) |
                  (rows(bm, b_sb, b_st) ? V_B : 0) |
                  (rows(cm, c_sb, c_st) ? V_C : 0) |
                  (al16(states) && n % 4 == 0 ? V_S : 0);
  ssd_bwd_kernel<T><<<b * ng * nc, NT, sizeof(Smem<T>), stream>>>(
      (const T*)x, dt, a, (const T*)bm, (const T*)cm, d, states,
      (const T*)dy, dsout, (T*)dx, ddt, db_part, dc_part, da_part, dd_part,
      dstate, ds_mid, flags, t_len, h, bh_n, nc, p, n, hg, vec, x_sb, x_st,
      b_sb, b_st, c_sb, c_st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the second stage: dB, dC over the groups; dA, dD over (batch, chunk)
  const long long tn = (long long)t_len * n;
  int rc = group_sum(db_part, db, b, ng, tn, stream);
  if (rc == 0) rc = group_sum(dc_part, dc, b, ng, tn, stream);
  if (rc == 0) rc = group_sum(da_part, da, 1, b * nc, h, stream);
  if (rc == 0) rc = group_sum(dd_part, dd, 1, b * nc, h, stream);
  return rc;
}

template <typename T>
int occupancy(int* blocks, int* smem) {
  const int rc = set_smem<T>();
  if (rc != 0) return rc;
  *smem = (int)sizeof(Smem<T>);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_bwd_kernel<T>, NT, sizeof(Smem<T>));
}

}  // namespace

// dtype (of x, Bm, Cm, dy, dx): 0 float32, 1 bfloat16.  x, Bm, Cm with
// packed last dims, read through the given batch / time strides; the rest
// packed.  hg: the heads a block takes (divides H).  states: ceil(T / 64)
// * B * H * P * N float32 (the state entering each chunk, the first the
// input state); ds_mid: (ceil(T / 64) - 1) * B * H * P * N float32
// scratch; db_part, dc_part: B * (H / hg) * T * N float32 scratch; db, dc
// [B, T, N] float32; da_part, dd_part: B * ceil(T / 64) * H float32
// scratch; da, dd [H] float32; flags: B * H * ceil(T / 64) + 1 int32, zero
// on entry and on exit.  Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take.
extern "C" int ssd_chunk_bwd(const void* x, const float* dt, const float* a,
                             const void* bm, const void* cm, const float* d,
                             const float* states, const void* dy,
                             const float* dsout, void* dx, float* ddt,
                             float* db_part, float* dc_part, float* db,
                             float* dc, float* da_part, float* dd_part,
                             float* da, float* dd, float* dstate,
                             float* ds_mid, int* flags, int b, int t_len,
                             int h, int p, int n, int hg, long long x_sb,
                             long long x_st, long long b_sb, long long b_st,
                             long long c_sb, long long c_st, int dtype,
                             void* stream) {
  if (p < 1 || p > L || n < 1 || n > L || h < 1 || t_len < 1 || hg < 1 ||
      h % hg)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, d, states, dy, dsout, dx, ddt,
                         db_part, dc_part, db, dc, da_part, dd_part, da, dd,
                         dstate, ds_mid, flags, b, t_len, h, p, n, hg, x_sb,
                         x_st, b_sb, b_st, c_sb, c_st, s);
  if (dtype == 1)
    return launch<bf16>(x, dt, a, bm, cm, d, states, dy, dsout, dx, ddt,
                        db_part, dc_part, db, dc, da_part, dd_part, da, dd,
                        dstate, ds_mid, flags, b, t_len, h, p, n, hg, x_sb,
                        x_st, b_sb, b_st, c_sb, c_st, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel's shared memory bytes and resident blocks an SM (dtype as
// above); returns a cudaError_t.
extern "C" int ssd_chunk_bwd_occupancy(int dtype, int* blocks, int* smem) {
  if (dtype == 0) return occupancy<float>(blocks, smem);
  if (dtype == 1) return occupancy<bf16>(blocks, smem);
  return (int)cudaErrorInvalidValue;
}
