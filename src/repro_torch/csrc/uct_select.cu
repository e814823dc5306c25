// Fused UCT score + masked first-max argmax for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/uct_select/kernel.py:
//   uct_argmax_tiles         (_uct_kernel)          -> uct_tiles_kernel
//   uct_argmax_running_call  (_uct_running_kernel)  -> uct_running_kernel
//
// What bounds it on an H100: neither bytes nor operations.  A Select level
// scores lanes x A children (a few KB of operands, a few thousand flops), so
// a launch is bound by launch latency and by a dependent chain.  For the
// independent board the chain is one row's scores and one first-max.  The
// running variant is a walk: lane k's in-flight counts carry the picks of
// the earlier active lanes with its parent id, so a step waits for the one
// before it.  Its chain is as long as the largest group of lanes sharing a
// parent: all L lanes on a level-0 board (every lane at the root), a few on
// deeper ones.
// What the design does about it.  The independent board: a row is scored
// by a sub-group of g = group_width(A) consecutive threads, 32 / g rows to
// a warp (2 at A = 16), thread gl holding the columns gl, gl + g, ...: the
// warp's loads are consecutive addresses, every column is scored at once,
// log(max(n_p, 1)) is taken once per row, and the first-max is the two
// REDUX of group_best.  At the timed board (4,096 rows x A 16) that is 512
// blocks of 128 threads, against 32 blocks of a thread per row before.  The
// count planes (N, the mode's in-flight plane, n_p) are read in their own
// type, int32 (the arena's) or float32, and converted in registers as
// .to(torch.float32) converts them, so the wrapper copies nothing; only the
// mode's in-flight plane is passed.
// The running walk: one block per search root first copies the root's
// [L, A] board to shared memory with coalesced loads, then links each
// active lane to the next lane of its group (__match_any_sync inside a
// warp), and every group is walked at once by its own sub-group of g
// threads, spread over the A columns.  The counts are exact integers, so
// the float sum with the in-flight count is the reference's.  With one
// column a thread (A <= 32) the count lives in a register, and the IEEE
// score math leaves the chain: a lane whose row equals its group head's (as
// on the select path, where a group's lanes gather one node's children)
// looks its score up in a table of the head's scores at every count the
// group can reach, filled by the whole block before the walk.  A step is
// then one shared-memory load and two warp reductions (REDUX: the largest
// score, then the lowest column holding it).  No recount over earlier
// lanes, no device memory inside the chain.  The TPU's A->128 / rows->8
// padding is not carried over: rows and columns are bounds-checked
// instead.
#include <cuda_runtime.h>

#include "uct_common.cuh"

// A sub-group of g threads per row of the [R, A] board; an all-invalid row
// returns 0.  C: the count planes' type (int or float).
template <typename C>
__global__ void __launch_bounds__(128) uct_tiles_kernel(
    const C* __restrict__ n, const float* __restrict__ w,
    const C* __restrict__ infl, const C* __restrict__ pn,
    const unsigned char* __restrict__ valid, int* __restrict__ out,
    int rows, int a, float cp, float vl_weight, int wu, int g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = t / g, gl = t & (g - 1);
  if (r >= rows) return;                 // a whole sub-group at once
  const size_t base = (size_t)r * a;
  const float log_pn = logf(fmaxf((float)pn[r], 1.0f));
  float best = 0.0f;
  int idx = -1;
  for (int j = gl; j < a; j += g) {      // first max over this thread's
    const size_t e = base + j;           // columns; every load issued
    const bool ok = valid[e];            // before the mask is read
    const float sc = uct_score_log((float)n[e], w[e], (float)infl[e],
                                   log_pn, cp, vl_weight, wu);
    const float s = ok ? sc : UCT_NEG_INF;
    if (idx < 0 || s > best) {
      best = s;
      idx = j;
    }
  }
  const int pick = group_best(best, idx, idx >= 0, group_mask(g));
  if (gl == 0) out[r] = pick;
}

// One block per search root, the group-parallel running walk.  Lane k
// scores with its in-flight counts raised by the picks of the earlier
// active lanes with its parent id (its group); lanes of other groups never
// interact, so each group is walked by one sub-group of g threads, all
// groups at once, and the chain is the largest group, not L.  A walker
// keeps its group's running count per column, each read and written only
// by the thread that holds that column: in a register when a thread holds
// one column (A <= 32; scores from the table `tab` where the rows allow),
// else in shared memory, or in `cnt_global` (nsg x A ints a root) when A
// alone exceeds it.  The board's first `staged` lanes
// are copied to shared memory first (coalesced; all of it unless the board
// exceeds the block's shared memory), the rest are read in place.
// Dynamic shared memory: see running_shape.
extern "C" __global__ void __launch_bounds__(1024) uct_running_kernel(
    const float* __restrict__ n, const float* __restrict__ w,
    const float* __restrict__ vl, const float* __restrict__ o,
    const float* __restrict__ pn, const unsigned char* __restrict__ valid,
    const int* __restrict__ parent_id, int* __restrict__ out,
    int* __restrict__ cnt_global, int lanes, int a, float cp,
    float vl_weight, int wu, int g, int nsg, int staged, int dcap) {
  extern __shared__ int smem[];
  const int L = lanes, A = a, S = staged, t = threadIdx.x, T = blockDim.x;
  int* prev = smem;                        // [L]
  int* next = prev + L;                    // [L]
  int* act = next + L;                     // [L] 0 idle, 1 active, 2 active
  int* pid = act + L;                      //  with its predecessor's row, 3
                                           //  head of a table-only walk
  int* rank = pid + L;                     // [L] place in its group
  int* cnt = rank + L;                     // [nsg, A] when A > g, unless
  float* tab = reinterpret_cast<float*>(   // cnt_global
      cnt + (A <= g || cnt_global ? 0 : nsg * A));
  float* sn = tab + (size_t)L * dcap * A;  // tab [L, dcap, A]
  float* sw = sn + (size_t)S * A;          // [S, A] each
  float* sv = sw + (size_t)S * A;
  float* spn = sv + (size_t)S * A;         // [S]
  unsigned char* sval = reinterpret_cast<unsigned char*>(spn + S);
  const size_t rb = (size_t)blockIdx.x * L;
  const float* gn = n + rb * A;
  const float* gw = w + rb * A;
  const float* gv = (wu ? o : vl) + rb * A;
  const unsigned char* gval = valid + rb * A;
  for (size_t e = t; e < (size_t)S * A; e += T) {
    sn[e] = gn[e];
    sw[e] = gw[e];
    sv[e] = gv[e];
    sval[e] = gval[e];
  }
  for (int k = t; k < S; k += T) spn[k] = pn[rb + k];
  for (int k = t; k < L; k += T) pid[k] = parent_id[rb + k];
  __syncthreads();
  const int sg = t / g, gl = t & (g - 1);
  const unsigned mask = group_mask(g);
  if (sg < nsg) {                          // a lane is active when any
    for (int k = sg; k < L; k += nsg) {    // column is valid
      const unsigned char* rv = k < S ? sval + (size_t)k * A
                                      : gval + (size_t)k * A;
      int any = 0;
      for (int j = gl; j < A; j += g) any |= rv[j];
      any = __any_sync(mask, any);
      if (gl == 0) {
        act[k] = any;
        if (!any) out[rb + k] = 0;         // all-invalid row: index 0
      }
    }
  }
  __syncthreads();
  link_items(
      L, L,
      [&](int k) -> long long {
        return act[k] ? (long long)(unsigned)pid[k] : -1;
      },
      prev, next);
  auto row_score = [&](int k, int j, int d) -> float {
    const bool st = k < S;
    const size_t e = (size_t)k * A + j;
    if (!(st ? sval[e] : gval[e])) return UCT_NEG_INF;
    return uct_score(st ? sn[e] : gn[e], st ? sw[e] : gw[e],
                     (st ? sv[e] : gv[e]) + (float)d,
                     st ? spn[k] : pn[rb + k], 0.0f, cp, vl_weight, wu, 0);
  };
  const bool one = A <= g;                 // one column a thread
  if (one && dcap > 0) {
    // The score table: a lane whose row equals its predecessor's, back to
    // its group's head, scores from the head's row, so the walk only looks
    // scores up.  tab[h][d][j] is head h's score at count d; a count never
    // reaches the group's size, so the lane of rank d fills row d (below
    // dcap), all lanes at once.
    if (sg < nsg) {                        // rows equal to their
      for (int k = sg; k < L; k += nsg) {  // predecessor's
        const int q = prev[k];
        if (q < 0) continue;
        bool eq = true;
        if (gl < A) {
          const size_t e = (size_t)k * A + gl, f = (size_t)q * A + gl;
          const bool sk = k < S, sq = q < S;
          eq = __float_as_uint(sk ? sn[e] : gn[e]) ==
                   __float_as_uint(sq ? sn[f] : gn[f]) &&
               __float_as_uint(sk ? sw[e] : gw[e]) ==
                   __float_as_uint(sq ? sw[f] : gw[f]) &&
               __float_as_uint(sk ? sv[e] : gv[e]) ==
                   __float_as_uint(sq ? sv[f] : gv[f]) &&
               (sk ? sval[e] : gval[e]) == (sq ? sval[f] : gval[f]);
        }
        eq = __all_sync(mask, eq) &&
             __float_as_uint(k < S ? spn[k] : pn[rb + k]) ==
                 __float_as_uint(q < S ? spn[q] : pn[rb + q]);
        if (gl == 0 && eq) act[k] = 2;
      }
    }
    __syncthreads();
    // rank and head of every lane; a head whose group's rows all equal its
    // own and fit the table is marked 3 (its walk only looks scores up)
    if (L <= 32) {
      if (t < 32) {
        const int a_ = t < L ? act[t] : 0;
        const unsigned grp =
            __match_any_sync(0xffffffffu, a_ ? (long long)(unsigned)pid[t]
                                             : -2 - (long long)t);
        const unsigned lt = (1u << t) - 1u;
        const unsigned same2 = __ballot_sync(0xffffffffu, a_ == 2);
        if (a_) {
          const int h = __ffs(grp) - 1;
          rank[t] = __popc(grp & lt);
          pid[t] = h;
          if (t == h && ((same2 | (1u << h)) & grp) == grp &&
              __popc(grp) <= dcap)
            act[t] = 3;
        }
      }
    } else {
      for (int h = t; h < L; h += T) {     // down each group
        if (prev[h] >= 0 || !act[h]) continue;
        int r = 0;
        bool all = true;
        for (int k = h; k >= 0; k = next[k]) {
          rank[k] = r++;
          pid[k] = h;
          all = all && (k == h || act[k] == 2);
        }
        if (all && r <= dcap) act[h] = 3;
      }
    }
    __syncthreads();
    if (sg < nsg && gl < A) {
      for (int k = sg; k < L; k += nsg) {
        const int d = rank[k], h = pid[k];
        if (act[k] && d < dcap)
          tab[((size_t)h * dcap + d) * A + gl] = row_score(h, gl, d);
      }
    }
    __syncthreads();
  }
  if (sg >= nsg) return;
  if (one) {
    // The walk: the running count of this thread's column in a register;
    // a step looks its score up (or, for a row unlike the head's, computes
    // it) and reduces.
    const int j = gl;
    const bool has = j < A;
    for (int h = sg; h < L; h += nsg) {
      if (!act[h] || prev[h] >= 0) continue;  // walk from each group's head
      const float* th = tab + (size_t)h * dcap * A + j;
      int c = 0;
      if (act[h] == 3) {                   // every score in the table
        for (int k = h; k >= 0; k = next[k]) {
          const int pick = group_best(has ? th[c * A] : 0.0f, j, has, mask);
          if (gl == 0) out[rb + k] = pick;
          c += pick == j;
        }
        continue;
      }
      bool same = true;
      for (int k = h; k >= 0;) {
        const int nk = next[k];
        same = same && (k == h || act[k] == 2);
        float s = 0.0f;
        if (has) s = same && c < dcap ? th[c * A] : row_score(k, j, c);
        const int pick = group_best(s, j, has, mask);
        if (gl == 0) out[rb + k] = pick;
        c += pick == j;
        k = nk;
      }
    }
    return;
  }
  // Several columns a thread: the counts live in shared memory (or device
  // scratch), one slice of A per walker, each entry touched only by the
  // thread that holds its column.
  int* my = cnt_global ? cnt_global + ((size_t)blockIdx.x * nsg + sg) * A
                       : cnt + sg * A;
  for (int h = sg; h < L; h += nsg) {
    if (!act[h] || prev[h] >= 0) continue;
    for (int j = gl; j < A; j += g) my[j] = 0;
    for (int k = h; k >= 0; k = next[k]) {
      float best = 0.0f;
      int idx = -1;
      for (int j = gl; j < A; j += g) {
        const float s = row_score(k, j, my[j]);
        if (idx < 0 || s > best) {
          best = s;
          idx = j;
        }
      }
      const int pick = group_best(best, idx, true, mask);
      if ((pick & (g - 1)) == gl) my[pick] += 1;
      if (gl == 0) out[rb + k] = pick;
    }
  }
}

// n, infl (the mode's in-flight plane) and pn are int32 when counts_int,
// else float32.
extern "C" int uct_argmax_tiles(const void* n, const float* w,
                                const void* infl, const void* pn,
                                const unsigned char* valid, int* out,
                                int rows, int a, float cp, float vl_weight,
                                int wu, int counts_int, void* stream) {
  if (rows == 0) return 0;
  const int threads = 128, g = group_width(a);
  if ((long long)rows * g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)rows * g + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (counts_int)
    uct_tiles_kernel<int><<<(unsigned)blocks, threads, 0, st>>>(
        (const int*)n, w, (const int*)infl, (const int*)pn, valid, out, rows,
        a, cp, vl_weight, wu, g);
  else
    uct_tiles_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)n, w, (const float*)infl, (const float*)pn, valid, out,
        rows, a, cp, vl_weight, wu, g);
  return (int)cudaGetLastError();
}

// The running walk's launch shape for [B, lanes, A] boards: the sub-group
// width, the walkers per block, the staged lanes and the dynamic shared
// memory; cnt_ints > 0 when the counts need device scratch (nsg x A ints a
// root).  Shared memory: 5 ints a lane, the walkers' counts, the staged
// rows (n, w, in-flight, pn in float, valid in bytes), then the score
// table with what is left (dcap counts, at most L).
struct RunShape {
  int g, nsg, threads, staged, dcap, cnt_ints;
  size_t smem;
};

static const size_t RUN_SMEM_MAX = 232448;  // 227 KB, the block's limit

static RunShape running_shape(int lanes, int a) {
  RunShape r;
  r.g = group_width(a);
  r.nsg = lanes < 1024 / r.g ? lanes : 1024 / r.g;
  const size_t base = 5 * sizeof(int) * (size_t)lanes;
  // one walker's counts; in registers when a thread holds one column
  const size_t cnt = a > r.g ? sizeof(int) * (size_t)a : 0;
  if (cnt && base + cnt * r.nsg > RUN_SMEM_MAX) {
    const size_t fit = (RUN_SMEM_MAX - base) / cnt;
    r.nsg = fit >= 1 ? (int)fit : r.nsg;
  }
  r.cnt_ints = base + cnt * r.nsg > RUN_SMEM_MAX ? r.nsg * a : 0;
  size_t used = base + (r.cnt_ints ? 0 : cnt * r.nsg);
  const size_t row = (size_t)a * (3 * sizeof(float) + 1) + sizeof(float);
  const size_t fit = (RUN_SMEM_MAX - used) / row;
  r.staged = fit < (size_t)lanes ? (int)fit : lanes;
  used += row * r.staged;
  // the score table, with what is left: one column a thread only
  const size_t per = sizeof(float) * (size_t)lanes * a;
  const size_t deep = cnt ? 0 : (RUN_SMEM_MAX - used) / per;
  r.dcap = deep < (size_t)lanes ? (int)deep : lanes;
  r.smem = used + per * r.dcap;
  r.threads = (r.nsg * r.g + 31) / 32 * 32;
  return r;
}

// Device ints of count scratch a root needs (0: shared memory holds them).
extern "C" int uct_running_scratch_ints(int lanes, int a) {
  return running_shape(lanes, a).cnt_ints;
}

extern "C" int uct_argmax_running(const float* n, const float* w,
                                  const float* vl, const float* o,
                                  const float* pn, const unsigned char* valid,
                                  const int* parent_id, int* out,
                                  int* scratch, int batch, int lanes, int a,
                                  float cp, float vl_weight, int wu,
                                  void* stream) {
  if (batch == 0) return 0;
  const RunShape r = running_shape(lanes, a);
  if (r.cnt_ints && !scratch) return (int)cudaErrorInvalidValue;
  if (r.smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        uct_running_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)r.smem);
    if (rc) return (int)rc;
  }
  uct_running_kernel<<<batch, r.threads, r.smem, (cudaStream_t)stream>>>(
      n, w, vl, o, pn, valid, parent_id, out, r.cnt_ints ? scratch : nullptr,
      lanes, a, cp, vl_weight, wu, r.g, r.nsg, r.staged, r.dcap);
  return (int)cudaGetLastError();
}
