// UCT / PUCT child score and the lane-walk helpers shared by the
// uct_select and search_wave kernels.
//
// Formula for formula the plain PyTorch path (repro_torch/core/uct.py):
//   loss: n_eff = n + vl, Q = (w - vl_weight * vl) / max(n_eff, 1)
//   wu:   n_eff = n + O,  Q = w / max(n, 1)
//   UCT:  Q + cp * sqrt(log(max(n_p, 1)) / max(n_eff, 1))
//   PUCT: Q + cp * prior * sqrt(max(n_p, 1)) / (1 + n_eff)
// with the 1e30 must-explore sentinel for n_eff < 0.5.  ``infl`` is the
// mode's in-flight count (vl in loss mode, O in wu mode), running delta
// included.  The sources are built with -fmad=false and without fast math,
// so every product and sum rounds separately as the tensor ops do and
// division, sqrt and log are the IEEE / libdevice versions PyTorch uses.
#pragma once

#define UCT_SENTINEL 1e30f
#define UCT_NEG_INF (-1e30f)

// The exploitation term Q of either mode.
__device__ __forceinline__ float uct_exploit(float n, float w, float infl,
                                            float vl_weight, int wu) {
  return wu ? w / fmaxf(n, 1.0f)
            : (w - vl_weight * infl) / fmaxf(n + infl, 1.0f);
}

// UCT with log(max(n_p, 1)) taken by the caller (once per row).
__device__ __forceinline__ float uct_score_log(float n, float w, float infl,
                                               float log_pn, float cp,
                                               float vl_weight, int wu) {
  const float n_eff = n + infl;
  const float s = uct_exploit(n, w, infl, vl_weight, wu)
                  + cp * sqrtf(log_pn / fmaxf(n_eff, 1.0f));
  return n_eff < 0.5f ? UCT_SENTINEL : s;
}

__device__ __forceinline__ float uct_score(float n, float w, float infl,
                                           float pn, float prior, float cp,
                                           float vl_weight, int wu,
                                           int puct) {
  const float pnc = fmaxf(pn, 1.0f);
  if (!puct) return uct_score_log(n, w, infl, logf(pnc), cp, vl_weight, wu);
  const float n_eff = n + infl;
  const float s = uct_exploit(n, w, infl, vl_weight, wu)
                  + cp * (prior * sqrtf(pnc) / (1.0f + n_eff));
  return n_eff < 0.5f ? UCT_SENTINEL : s;
}

// A row's A columns are spread over a sub-group of g threads (g a power of
// two <= 32, aligned inside its warp): thread gl holds the columns
// j = gl, gl + g, ...  group_mask is the sub-group's lanes in the warp.
__device__ __forceinline__ unsigned group_mask(int g) {
  if (g >= 32) return 0xffffffffu;
  return ((1u << g) - 1u) << ((threadIdx.x & 31) & ~(g - 1));
}

// The sub-group width for A columns: the next power of two, at most 32.
__host__ __device__ __forceinline__ int group_width(int a) {
  int g = 1;
  while (g < a && g < 32) g <<= 1;
  return g;
}

// First-max over a sub-group: the larger score wins, a tie goes to the
// lower index; every thread of the sub-group gets the winning index.  A
// thread offers its best (score s at index j) when `has`.  Two warp
// reductions (REDUX): the largest score as an order-preserving key (-0 is
// taken as +0, which compares equal to it), then the lowest index holding
// it.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int group_best(float s, int j, bool has,
                                          unsigned mask) {
  const unsigned key = has ? order_key(s) : 0u;
  const unsigned top = __reduce_max_sync(mask, key);
  return (int)__reduce_min_sync(mask, has && key == top ? (unsigned)j
                                                        : 0xffffffffu);
}

// Same-key chains over items 0..n-1 in item order, every thread of the
// block calling (blockDim.x a multiple of 32).  key(i) >= 0 (below 2^32)
// makes item i a member; keys compare only inside segments of `seg`
// consecutive items.  prev[i] = the last earlier member of i's segment
// with i's key, next[i] = the first later one (-1 when there is none or i
// is not a member).  Inside a warp's 32 items __match_any_sync finds the
// predecessor at once; only an item with none there looks back over the
// earlier items of its segment (never for n <= 32).  Ends synchronised.
template <typename KeyFn>
__device__ void link_items(int n, int seg, KeyFn key, int* prev, int* next) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n; i += blockDim.x) next[i] = -1;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const long long k = i < n ? key(i) : -1;
    const long long s = i / seg;
    const long long mk = k >= 0 ? (s << 32) | k : -2 - (long long)i;
    const unsigned same = __match_any_sync(0xffffffffu, mk);
    const unsigned lower = same & ((1u << lane) - 1u);
    int p = -1;
    if (k >= 0) {
      if (lower) {
        p = i - lane + (31 - __clz(lower));
      } else {
        const int s0 = (int)s * seg;
        for (int q = i - lane - 1; q >= s0; --q)
          if (key(q) == k) {
            p = q;
            break;
          }
      }
      if (p >= 0) next[p] = i;
    }
    if (i < n) prev[i] = p;
  }
  __syncthreads();
}

// Exclusive prefix sum of v over the threads in order; every thread of the
// block calls; scratch holds 32 ints of shared memory.  Ends synchronised.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? scratch[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    scratch[lane] = t;
  }
  __syncthreads();
  const int out = (w ? scratch[w - 1] : 0) + x - v;
  __syncthreads();
  return out;
}
