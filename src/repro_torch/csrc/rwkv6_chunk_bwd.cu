// Backward of the RWKV-6 WKV scan for Hopper (sm_90a), chunks of 64.
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// chunked jnp scan (repro/kernels/rwkv6_scan/ops.py, wkv6_chunked, with
// per-chunk remat); its Pallas kernel (kernel.py, wkv6_bh) has no VJP.  This
// is the counterpart of that autodiff, so that training runs the forward
// kernels (rwkv6_chunk.cu in bf16, rwkv6_scan.cu otherwise) and this one.
// Plain version: kernels/rwkv6_scan/ref.py wkv6_bwd_ref, which writes out
// the same terms.
//
// Layout as the forward's: r, k, v, dy, dr, dk, dv [B, T, H, N] (bf16 or
// float32); w, dw [B, T, H, N] float32; u [H, N]; the states the forward
// saved, entering each chunk of 64 steps, [nc, B * H, N, N] float32 (key x
// value), the first the input state; the gradient of the output state
// [B * H, N, N].  N <= 64, padded to 64 with zeros (w with ones).
//
// Per chunk (t, s local; S0 entering state, dSL the gradient of the leaving
// one; D(a, b) = prod_{a <= i < b} w_i per key channel j, Dsp[t, s] =
// D(s + 1, t)):
//   P = dY V^T, X = dY S0^T, Y = V dSL^T, G = (R o D(0, t))^T dY
//   dS0   = D(0, L) o dSL + G                       (to the previous chunk)
//   A[t, s] = sum_j r_t k_s Dsp[t, s]  (s < t)
//   dv    = (K o D(s+1, L)) dSL + A^T dY + b o dY,   b_s = r_s . (u o k_s)
//   dr_t  = D(0, t) o X_t + M_t[t] + u o k_t P[t, t]
//   dk_t  = D(t+1, L) o Y_t + N_t + r_t o u P[t, t]
//   dw_t  = D(0, t) D(t+1, L) o a + D(0, t) o Z_t + D(t+1, L) o U_t + Q_t
// with, per key channel j, M_t[t'] = sum_{s<t} Dsp[t, s] k_s P[t', s] (a
// running recurrence M_{t+1} = w_t M_t + k_t P[:, t]), N_t = sum_{t'>t}
// Dsp[t', t] r_t' P[t', t], Q_t = sum_{t'>t} Dsp[t', t] r_t' M_t[t'],
// Z_t = sum_{t'>t} Dsp[t', t] r_t' X_t', U_t = sum_{s<t} Dsp[t, s] k_s Y_s,
// a = sum_i S0 o dSL.  dw is sum_i dS_{t+1} o S_t written out, never d(log
// w) / w, so it stays finite where w is down at 1e-38.  Every decay is a
// running product of w (each factor <= 1); no cumulative decay is divided
// by, the exponent discipline of the forward kernels.
//
// What bounds it on an H100.  It reads r, k, v, dy, w and the saved
// states and writes dr, dk, dv, dw once (~0.87 GB at rwkv6-1.6b's training
// shape [8, 2048, 32, 64] in bf16: ~0.26 ms at 3.35 TB/s).  Its work: five
// 64 x 64 x 64 products a chunk on the tensor cores (mma.sync m16n8k16,
// both operands in three bf16 pieces, six mma a tile, as in chunk_mma.cuh,
// so the sums keep float32 accuracy), and O(64^2 N) per chunk on the CUDA
// cores for the per-channel decays (the scores A and the M / N / Q scans).
// A first, simple design: one block of 8 warps per (batch, head, chunk),
// one block per SM (~196 KB of float tiles).
//
// The state gradient passes from chunk c + 1 to c through a ticketed chain
// as in the forward kernels, in reverse: tickets map chunk-major from the
// last chunk, so a block's predecessor (the same head's next chunk) holds a
// smaller ticket and has started.  A block computes P, X and G, waits for
// its predecessor's flag, reads dSL, writes dS0 (ds_mid, or dstate for the
// first chunk), raises its flag, then computes the rest.  du is written
// per (batch, chunk) and summed over them in a fixed order by a second
// launch (group_sum): no atomics, two launches on the same inputs are
// bit-equal.
#include <math.h>

#include "chunk_mma.cuh"

namespace {

using namespace chunk;
typedef __nv_bfloat16 bf16;

constexpr int NT = 256;    // 8 warps

struct Smem {
  float r[FT], k[FT], v[FT], dy[FT], w[FT];   // [t][j], [t][i]
  float dpre[FT], dpost[FT];                  // D(0, t), D(t+1, L) [t][j]
  float p[FT];                                // P [t][s]
  float x[FT];                                // X [t][j]
  float y[FT];                                // Y [s][j]
  float sa[FT];                               // S0 [j][i], A [t][s], Z [t][j]
  float sd[FT];                               // dSL [j][i]
  float u[L], etot[L], bon[L], a[L];
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const T* __restrict__ u, const float* __restrict__ states,
                const T* __restrict__ dy, const float* __restrict__ dsout,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ dstate, float* __restrict__ ds_mid,
                int* __restrict__ flags, int t_len, int h, int bh_n, int nc,
                int n) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int m0 = 16 * (wp >> 1), n0 = 32 * (wp & 1);
  const int tk = take_ticket(flags + (size_t)bh_n * nc);
  const int ch = nc - 1 - tk / bh_n, bh = tk % bh_n, b = bh / h, hh = bh % h;
  const int t0 = ch * L, cn = min(L, t_len - t0);
  const size_t row = (size_t)h * n;
  const size_t base = ((size_t)b * t_len + t0) * row + (size_t)hh * n;
  const size_t nn = (size_t)n * n;

  // this chunk's rows (zeros past the end and past N; w ones) and S0
  const float* s0 = states + ((size_t)ch * bh_n + bh) * nn;
  for (int e = tid; e < L * L; e += NT) {
    const int t = e >> 6, j = e & 63;
    const bool in = t < cn && j < n;
    const size_t off = base + (size_t)t * row + j;
    sm.r[ti(t, j)] = in ? to_f(r[off]) : 0.0f;
    sm.k[ti(t, j)] = in ? to_f(k[off]) : 0.0f;
    sm.v[ti(t, j)] = in ? to_f(v[off]) : 0.0f;
    sm.dy[ti(t, j)] = in ? to_f(dy[off]) : 0.0f;
    sm.w[ti(t, j)] = in ? w[off] : 1.0f;
    sm.sa[ti(t, j)] = t < n && j < n ? s0[t * n + j] : 0.0f;
  }
  if (tid < L) sm.u[tid] = tid < n ? to_f(u[(size_t)hh * n + tid]) : 0.0f;
  __syncthreads();

  // running products of w, one thread per channel; the bonus per step
  if (tid < L) {
    const int j = tid;
    float d = 1.0f;
    for (int t = 0; t < L; ++t) {
      sm.dpre[ti(t, j)] = d;
      d *= sm.w[ti(t, j)];
    }
    sm.etot[j] = d;
  } else if (tid < 2 * L) {
    const int j = tid - L;
    float d = 1.0f;
    for (int t = L - 1; t >= 0; --t) {
      sm.dpost[ti(t, j)] = d;
      d *= sm.w[ti(t, j)];
    }
  } else if (tid < 3 * L) {
    const int t = tid - 2 * L;
    float acc = 0.0f;
    for (int j = 0; j < L; ++j)
      acc += sm.r[ti(t, j)] * sm.u[j] * sm.k[ti(t, j)];
    sm.bon[t] = acc;
  }
  __syncthreads();

  // P = dY V^T, X = dY S0^T; G = (R o D(0, t))^T dY stays in registers
  {
    float acc[4][4];
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int t, int i) { return sm.dy[ti(t, i)]; },
        [&](int i, int s) { return sm.v[ti(s, i)]; });
    each_acc(acc, m0, n0, lane,
             [&](int t, int s, float x) { sm.p[ti(t, s)] = x; });
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int t, int i) { return sm.dy[ti(t, i)]; },
        [&](int i, int j) { return sm.sa[ti(j, i)]; });
    each_acc(acc, m0, n0, lane,
             [&](int t, int j, float x) { sm.x[ti(t, j)] = x; });
  }
  float gacc[4][4];
  zero_acc(gacc);
  mm6(gacc, m0, n0, lane,
      [&](int j, int t) { return sm.r[ti(t, j)] * sm.dpre[ti(t, j)]; },
      [&](int t, int i) { return sm.dy[ti(t, i)]; });

  // the chain: dSL in, dS0 = D(0, L) o dSL + G out, then the flag
  const float* src = ch == nc - 1 ? dsout + (size_t)bh * nn
                                  : ds_mid + ((size_t)ch * bh_n + bh) * nn;
  float* dst = ch == 0 ? dstate + (size_t)bh * nn
                       : ds_mid + ((size_t)(ch - 1) * bh_n + bh) * nn;
  if (ch < nc - 1) wait_flag(flags + tk - bh_n);
  for (int e = tid; e < L * L; e += NT) {
    const int j = e >> 6, i = e & 63;
    sm.sd[ti(j, i)] = j < n && i < n ? __ldcg(src + j * n + i) : 0.0f;
  }
  __syncthreads();
  each_acc(gacc, m0, n0, lane, [&](int j, int i, float x) {
    if (j < n && i < n) dst[j * n + i] = sm.etot[j] * sm.sd[ti(j, i)] + x;
  });
  if (ch > 0)
    raise_flag(flags + tk);
  else
    __syncthreads();

  // a = sum_i S0 o dSL (S0's tile is free after this)
  if (tid < L) {
    float acc = 0.0f;
    for (int i = 0; i < L; ++i) acc += sm.sa[ti(tid, i)] * sm.sd[ti(tid, i)];
    sm.a[tid] = acc;
  }
  __syncthreads();
  // Y = V dSL^T on the tensor cores, and the scores A on the CUDA cores:
  // thread (t, channels 16 jg .. + 15) walks s from t - 1 down with each
  // channel's product D(s + 1, t) grown by one factor a step (the warp
  // runs its largest t's steps, a uniform loop for the shuffles)
  {
    float acc[4][4];
    zero_acc(acc);
    mm6(acc, m0, n0, lane, [&](int s, int i) { return sm.v[ti(s, i)]; },
        [&](int i, int j) { return sm.sd[ti(j, i)]; });
    each_acc(acc, m0, n0, lane,
             [&](int s, int j, float x) { sm.y[ti(s, j)] = x; });
  }
  for (int e = tid; e < L * L; e += NT) {
    const int t = e >> 6, s = e & 63;
    if (s >= t) sm.sa[ti(t, s)] = 0.0f;
  }
  {
    const int t = tid >> 2, jg = tid & 3, j0 = 16 * jg;
    const int t_hi = (tid >> 5) * 8 + 7;
    float rt[16], d[16];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      rt[jj] = sm.r[ti(t, j0 + jj)];
      d[jj] = 1.0f;
    }
    for (int s = t_hi - 1; s >= 0; --s) {
      const bool on = s < t;
      float acc = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        acc += rt[jj] * sm.k[ti(s, j0 + jj)] * d[jj];
        d[jj] = on ? d[jj] * sm.w[ti(s, j0 + jj)] : d[jj];
      }
      acc += __shfl_xor_sync(~0u, acc, 1);
      acc += __shfl_xor_sync(~0u, acc, 2);
      if (on && jg == 0) sm.sa[ti(t, s)] = acc;
    }
  }
  __syncthreads();

  // dv = (K o D(s+1, L)) dSL + A^T dY + b o dY
  {
    float acc[4][4];
    zero_acc(acc);
    mm6(acc, m0, n0, lane,
        [&](int s, int j) { return sm.k[ti(s, j)] * sm.dpost[ti(s, j)]; },
        [&](int j, int i) { return sm.sd[ti(j, i)]; });
    mm6(acc, m0, n0, lane, [&](int s, int t) { return sm.sa[ti(t, s)]; },
        [&](int t, int i) { return sm.dy[ti(t, i)]; });
    each_acc(acc, m0, n0, lane, [&](int s, int i, float x) {
      if (s < cn && i < n)
        dv[base + (size_t)s * row + i] =
            from_f<T>(x + sm.bon[s] * sm.dy[ti(s, i)]);
    });
  }
  __syncthreads();
  // Z_t = sum_{t'>t} Dsp[t', t] r_t' X_t', a reverse scan per channel,
  // into A's tile
  if (tid < L) {
    const int j = tid;
    float z = 0.0f;
    for (int t = L - 1; t >= 0; --t) {
      sm.sa[ti(t, j)] = z;
      z = sm.r[ti(t, j)] * sm.x[ti(t, j)] + sm.w[ti(t, j)] * z;
    }
  }
  __syncthreads();

  // dr, dk, dw step by step: thread (j, q) keeps M_t[t'] for t' in
  // 16 q .. 16 q + 15 in registers; the sums over t' > t (N_t, Q_t) are
  // taken per range and folded across the four threads of a channel
  {
    const int j = tid >> 2, q = tid & 3, tq = 16 * q;
    const float uj = sm.u[j], aj = sm.a[j];
    float mreg[16];
#pragma unroll
    for (int xx = 0; xx < 16; ++xx) mreg[xx] = 0.0f;
    float uu = 0.0f, dua = 0.0f;
    for (int t = 0; t < L; ++t) {
      float mt = 0.0f;
#pragma unroll
      for (int xx = 0; xx < 16; ++xx)
        if (tq + xx == t) mt = mreg[xx];
      mt += __shfl_xor_sync(~0u, mt, 1);
      mt += __shfl_xor_sync(~0u, mt, 2);
      float qp = 0.0f, np = 0.0f, pr = 1.0f;
#pragma unroll
      for (int xx = 0; xx < 16; ++xx) {
        const int tp = tq + xx;
        if (tp > t) {
          const float rr = sm.r[ti(tp, j)];
          qp += pr * rr * mreg[xx];
          np += pr * rr * sm.p[ti(tp, t)];
          pr *= sm.w[ti(tp, j)];
        }
      }
      // (part, prod) of ranges q, q + 1, ... folded: part_0 + prod_0
      // (part_1 + prod_1 (part_2 + prod_2 part_3)), complete in q == 0
      const float q1 = __shfl_down_sync(~0u, qp, 1);
      const float n1 = __shfl_down_sync(~0u, np, 1);
      const float p1 = __shfl_down_sync(~0u, pr, 1);
      if ((q & 1) == 0) {
        qp += pr * q1;
        np += pr * n1;
        pr *= p1;
      }
      const float q2 = __shfl_down_sync(~0u, qp, 2);
      const float n2 = __shfl_down_sync(~0u, np, 2);
      const float wt = sm.w[ti(t, j)], kt = sm.k[ti(t, j)];
      if (q == 0) {
        qp += pr * q2;
        np += pr * n2;
        const float pd = sm.p[ti(t, t)], rt = sm.r[ti(t, j)];
        const float dp = sm.dpre[ti(t, j)], dq = sm.dpost[ti(t, j)];
        const float yt = sm.y[ti(t, j)];
        const float gr = dp * sm.x[ti(t, j)] + mt + uj * kt * pd;
        const float gk = dq * yt + np + rt * uj * pd;
        const float gw = dp * dq * aj + dp * sm.sa[ti(t, j)] + dq * uu + qp;
        uu = wt * uu + kt * yt;
        dua += rt * kt * pd;
        if (t < cn && j < n) {
          const size_t off = base + (size_t)t * row + j;
          dr[off] = from_f<T>(gr);
          dk[off] = from_f<T>(gk);
          dw[off] = gw;
        }
      }
#pragma unroll
      for (int xx = 0; xx < 16; ++xx)
        if (tq + xx > t)
          mreg[xx] = wt * mreg[xx] + kt * sm.p[ti(tq + xx, t)];
    }
    if (q == 0 && j < n)
      du_part[(((size_t)b * nc + ch) * h + hh) * n + j] = dua;
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const void* u, const float* states, const void* dy,
           const float* dsout, void* dr, void* dk, void* dv, float* dw,
           float* du_part, float* du, float* dstate, float* ds_mid,
           int* flags, int b, int t_len, int h, int n, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (attr != cudaSuccess) return (int)attr;
  const int nc = (t_len + L - 1) / L, bh_n = b * h;
  wkv6_bwd_kernel<T><<<bh_n * nc, NT, sizeof(Smem), stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, (const T*)u, states,
      (const T*)dy, dsout, (T*)dr, (T*)dk, (T*)dv, dw, du_part, dstate,
      ds_mid, flags, t_len, h, bh_n, nc, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // du = the per-(batch, chunk) parts summed in order
  return group_sum(du_part, du, 1, b * nc, (long long)h * n, stream);
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
