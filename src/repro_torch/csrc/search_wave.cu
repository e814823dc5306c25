// Fused search wave for Hopper (sm_90a): Select -> Expand -> Backup phases
// over the arena planes, one thread block per search root.
//
// Replaces the Pallas TPU kernels of repro/kernels/search_wave/kernel.py:
//   se_call  (_se_kernel)   -> sw_se_kernel   Select(wave) -> Expand(wave)
//   bes_call (_bes_kernel)  -> sw_bes_kernel  Backup(t-3) -> Expand(t-1)
//                                             -> Select(t), one pipeline tick
//   b_call   (_b_kernel)    -> sw_b_kernel    Backup alone
// built from three __device__ phases mirroring _select_phase,
// _expand_phase and _backup_phase.
//
// What bounds it on an H100: a dependent chain, not bytes or operations.
// A wave touches lanes x depth x A entries of planes that stay in device
// memory (one root's children + prior are N x A x 8 bytes, far above
// shared memory), and each tree level depends on the last.  Per launch the
// chain is: Select, one step per tree level (at most max_depth; the walk
// stops at the level where no lane descends), each step two rounds of
// gathers (a node's children row, then the children's statistics) and, in
// the running variant, a walk of as many steps as the largest group of
// lanes on one node (all L at the root); Expand, two walks as long as the
// largest group of lanes on one leaf; Backup, one walk as long as the
// largest group of lanes holding one node (all L at the root column).
// What the design does about it:
//  - Select: each lane's A children are spread over a sub-group of g =
//    min(32, pow2(A)) threads, so a level is one round of parallel child
//    gathers (ids, then visits / value / in-flight; the prior only under
//    PUCT), a first-max over the sub-group by two warp reductions (REDUX),
//    and a vote for the lane's activity (terminal, fully expanded) on the
//    same row.  The running walk links the lanes on each node
//    (__match_any_sync) and walks every group at once, one sub-group each.
//    The lanes of a group see one row, so the walker gathers it once and
//    keeps each column's running count: in registers with one column a
//    thread (A <= 32), where each column also holds its score for its
//    count and for one more, so a step is the reduction, then the picked
//    column takes its next score and computes the one after (still in
//    the chain: a warp issues in order); in a shared-memory slice
//    otherwise.
//  - Expand: the reference's sequential lane walk becomes scans.  A lane's
//    tentative `can` is ok and its rank among the earlier ok lanes of its
//    leaf below the leaf's free-slot count (a walk down the lanes of each
//    leaf, all leaves at once).  The r < cap0 cap only cuts a suffix of
//    the lanes: r counts earlier lanes that allocated, so once the cap
//    binds at a lane no later lane allocates and r never grows again;
//    before that point can == tentative.  So can = tentative && (exclusive
//    prefix of tentative) < cap0, and r is that prefix wherever can holds.
//    `taken` (an output through `slot`, which every lane gets) then counts
//    the earlier lanes of the leaf that can, which for a lane past the cap
//    counts only the lanes before it; a second walk per leaf gives it.
//    Slot and row choice stay the reference's (free list LIFO first, then
//    the next_free bump).
//  - Backup: the lanes holding each node in each path column are linked
//    (__match_any_sync, no scan over earlier lanes); the lowest such lane
//    adds the node's visits and drains its in-flight count, and adds its
//    value contributions in lane order, the order of the plain version's
//    flat scatter-add, so `value` equals it bit for bit.  A node sits in
//    one column only (its depth), so that lane is its only writer.
// Integer in-flight adds in Select and Expand stay atomic (order-free).
// The TPU's one-hot matmul gathers become indexed loads and its [1, 4]
// scalar word becomes kernel arguments.
#include <cuda_runtime.h>

#include "uct_common.cuh"

#define UNEXPANDED (-1)
#define ROOT 0

struct Planes {          // one root's planes (pointers already offset)
  int* visits;           // [N]
  float* value;          // [N]
  int* infl;             // [N]  vloss ("loss") or unobs ("wu")
  float* prior;          // [N, A]
  int* children;         // [N, A]
  const unsigned char* terminal;  // [N]
  const int* free_list;  // [N]
  int n, a;
};

struct Cfg {
  int lanes, path_len, max_depth;
  float cp, vl_weight;
  int puct, wu, running;
  int g, nsg, cols;      // sub-group width, sub-groups, backup columns/pass
};

struct Sub {             // this thread's place in its sub-group
  int sg, gl;
  unsigned mask;
  bool on;
};

__device__ __forceinline__ Sub sub_of(const Cfg& c) {
  Sub s;
  s.sg = threadIdx.x / c.g;
  s.gl = threadIdx.x & (c.g - 1);
  s.mask = group_mask(c.g);
  s.on = s.sg < c.nsg;
  return s;
}

// ints of a running walker's slice: child id, visits, value, in-flight,
// running count, and the prior under PUCT
__host__ __device__ __forceinline__ int slice_words(int puct) {
  return puct ? 6 : 5;
}

__device__ __forceinline__ Planes root_planes(
    int b, int n, int a, int* visits, float* value, int* infl, float* prior,
    int* children, const unsigned char* terminal, const int* free_list) {
  const size_t rn = (size_t)b * n;
  Planes p;
  p.visits = visits ? visits + rn : nullptr;
  p.value = value ? value + rn : nullptr;
  p.infl = infl + rn;
  p.prior = prior ? prior + rn * a : nullptr;
  p.children = children ? children + rn * a : nullptr;
  p.terminal = terminal ? terminal + rn : nullptr;
  p.free_list = free_list ? free_list + rn : nullptr;
  p.n = n;
  p.a = a;
  return p;
}

// ---------------------------------------------------------------------------
// Backup: add N and W along the paths, drain the in-flight plane, write the
// new rows' priors.  pb_* are this root's [L, ...] Playout->Backup operands.
// Items are (column, lane) pairs, column-major, `cols` columns a pass.
// Shared memory: fval [L], prev / next [L * cols].
// ---------------------------------------------------------------------------
__device__ void backup_phase(const Planes& p, const Cfg& c, int* raw,
                             const int* pb_path, const float* pb_value,
                             const float* pb_priors, const int* pb_node,
                             const unsigned char* pb_isnew,
                             const unsigned char* pb_valid) {
  const int L = c.lanes, P = c.path_len, A = p.a, t = threadIdx.x;
  const int T = blockDim.x;
  float* fval = reinterpret_cast<float*>(raw);
  int* prev = raw + L;
  int* next = prev + L * c.cols;
  for (int l = t; l < L; l += T) fval[l] = pb_value[l];
  for (int c0 = 0; c0 < P; c0 += c.cols) {
    const int n = min(c.cols, P - c0) * L;
    auto key = [&](int i) -> long long {
      const int l = i % L;
      const int x = pb_valid[l] ? pb_path[l * P + c0 + i / L] : UNEXPANDED;
      return x >= 0 ? (long long)x : -1;
    };
    link_items(n, L, key, prev, next);    // synchronises fval too
    for (int i = t; i < n; i += T) {
      const long long x = key(i);
      if (x < 0 || prev[i] >= 0) continue;
      float acc = p.value[x];             // the lowest lane holding x adds
      int cnt = 0;                        // its lanes' values in lane order
      for (int k = i; k >= 0; k = next[k]) {
        acc = acc + fval[k % L];
        ++cnt;
      }
      p.value[x] = acc;
      p.visits[x] += cnt;
      p.infl[x] -= cnt;
    }
    __syncthreads();                      // prev / next reused next pass
  }
  for (int e = t; e < L * A; e += T) {
    const int l = e / A;
    if (pb_isnew[l] && pb_valid[l])
      p.prior[(size_t)pb_node[l] * A + (e - l * A)] = pb_priors[e];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Structural expand: lane i takes the (taken+1)-th free slot of its leaf's
// row as it stood before the wave (taken = earlier lanes of the wave that
// expanded the same leaf) and the (r+1)-th row of the allocation order
// (free-list LIFO first, then the next_free bump; r = earlier lanes that
// allocated).  Links the child and adds +1 in-flight on the new row.  See
// the source note for why scans give the sequential walk's answer.
// Shared memory: 8 ints a lane + 32.
// ---------------------------------------------------------------------------
__device__ void expand_phase(const Planes& p, const Cfg& c, int* raw,
                             const int* leaf_in, const unsigned char* ok_in,
                             int wave_ok, int nf0, int ft0, int* e_can,
                             int* e_slot, int* e_new) {
  const int L = c.lanes, A = p.a, n = p.n, t = threadIdx.x;
  const int T = blockDim.x, g = c.g;
  int* leaf = raw;
  int* freec = leaf + L;
  int* flag = freec + L;                 // ok, then tentative, then can
  int* rank = flag + L;                  // rank among ok, then taken
  int* newrow = rank + L;
  int* slot = newrow + L;
  int* prev = slot + L;
  int* next = prev + L;
  int* scratch = next + L;               // [32]
  const Sub sb = sub_of(c);
  if (sb.on) {
    for (int l = sb.sg; l < L; l += c.nsg) {
      const int lf = leaf_in[l];
      const int* row = p.children + (size_t)lf * A;
      int fc = 0;
      for (int j0 = 0; j0 < A; j0 += g) {
        const int j = j0 + sb.gl;
        fc += __popc(__ballot_sync(sb.mask, j < A && row[j] == UNEXPANDED)
                     & sb.mask);
      }
      if (sb.gl == 0) {
        leaf[l] = lf;
        freec[l] = fc;
        flag[l] = (ok_in ? ok_in[l] != 0 : wave_ok != 0) && !p.terminal[lf];
      }
    }
  }
  __syncthreads();
  auto by_leaf = [&](int i) -> long long { return (unsigned)leaf[i]; };
  link_items(L, L, by_leaf, prev, next);
  for (int h = t; h < L; h += T) {       // tentative: among the first
    if (prev[h] >= 0) continue;          // free-count ok lanes of its leaf
    int r = 0;
    for (int k = h; k >= 0; k = next[k]) {
      const int ok = flag[k];
      flag[k] = ok && r < freec[k];
      r += ok;
    }
  }
  __syncthreads();
  const int cap0 = ft0 + (n - nf0);
  const int tent = t < L ? flag[t] : 0;
  const int r = block_exclusive_scan(tent, scratch);
  if (t < L) {
    const int ci = tent && r < cap0;
    flag[t] = ci;
    newrow[t] = ci ? (r < ft0 ? p.free_list[min(max(ft0 - 1 - r, 0), n - 1)]
                              : nf0 + (r - ft0))
                   : n;
  }
  __syncthreads();
  for (int h = t; h < L; h += T) {       // taken: earlier lanes of the
    if (prev[h] >= 0) continue;          // leaf that can
    int tk = 0;
    for (int k = h; k >= 0; k = next[k]) {
      rank[k] = tk;
      tk += flag[k];
    }
  }
  __syncthreads();
  if (sb.on) {                           // the (taken+1)-th free slot
    for (int l = sb.sg; l < L; l += c.nsg) {
      const int* row = p.children + (size_t)leaf[l] * A;
      int need = rank[l] + 1, s = 0;
      for (int j0 = 0; j0 < A; j0 += g) {
        const int j = j0 + sb.gl;
        unsigned b = __ballot_sync(sb.mask, j < A && row[j] == UNEXPANDED)
                     & sb.mask;
        b >>= (threadIdx.x & 31) & ~(g - 1);
        const int m = __popc(b);
        if (m >= need) {
          for (; need > 1; --need) b &= b - 1;
          s = j0 + __ffs(b) - 1;
          break;
        }
        need -= m;
      }
      if (sb.gl == 0) slot[l] = s;
    }
  }
  __syncthreads();                       // every lane read its row first
  for (int l = t; l < L; l += T) {
    if (flag[l]) {
      p.children[(size_t)leaf[l] * A + slot[l]] = newrow[l];
      atomicAdd(&p.infl[newrow[l]], 1);
    }
    e_can[l] = flag[l];
    e_slot[l] = slot[l];
    e_new[l] = newrow[l];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Lockstep select: all lanes descend together, one tree level per step.
// Shared memory: 7 ints a lane, and under the running walk a slice of
// slice_words(puct) x A ints per sub-group when A > 32.
// ---------------------------------------------------------------------------
__device__ void select_phase(const Planes& p, const Cfg& c, int* raw,
                             int wave_valid, int* s_leaf, int* s_depth,
                             int* s_path, int* s_dup) {
  const int L = c.lanes, A = p.a, P = c.path_len, t = threadIdx.x;
  const int T = blockDim.x, g = c.g;
  int* node = raw;
  int* alive = node + L;                 // still descending
  int* depth = alive + L;
  int* nxt = depth + L;                  // the child picked this level
  int* pre = nxt + L;                    // its in-flight count before it
  int* prev = pre + L;
  int* next = prev + L;
  int* slices = next + L;
  int* infl = p.infl;
  const Sub sb = sub_of(c);
  const bool running = c.running && L > 1;   // one lane: no delta
  // pre: the in-flight count before this wave at the lane's leaf
  // (dup_cross); the root's is read here, a deeper node's at the level
  // that moves onto it, before that level's adds
  for (int l = t; l < L; l += T) {
    node[l] = ROOT;
    alive[l] = wave_valid;
    depth[l] = 0;
    pre[l] = infl[ROOT];
  }
  for (int e = t; e < L * P; e += T)
    s_path[e] = (wave_valid && e % P == 0) ? ROOT : UNEXPANDED;
  __syncthreads();
  if (t == 0 && wave_valid) infl[ROOT] += L;
  __syncthreads();
  for (int it = 0; it < c.max_depth; ++it) {
    if (!running) {
      if (sb.on) {
        for (int l = sb.sg; l < L; l += c.nsg) {
          if (!alive[l]) continue;
          const int nd = node[l];
          const int* ch = p.children + (size_t)nd * A;
          const float* pr = p.prior + (size_t)nd * A;
          const bool term = p.terminal[nd];
          const float pn = (float)(p.visits[nd] + infl[nd] - 1);
          bool full = true;
          float best = 0.0f;
          int idx = -1, bx = 0, bi = 0;
          for (int j = sb.gl; j < A; j += g) {
            const int x = ch[j];
            full = full && x >= 0;
            if (x < 0) continue;
            const int ix = infl[x];
            const float sc = uct_score((float)p.visits[x], p.value[x],
                                       (float)ix, pn,
                                       c.puct ? pr[j] : 0.0f, c.cp,
                                       c.vl_weight, c.wu, c.puct);
            if (idx < 0 || sc > best) {
              best = sc;
              idx = j;
              bx = x;
              bi = ix;
            }
          }
          const bool act = !term && __all_sync(sb.mask, full);
          const int own = group_best(best, idx, idx >= 0, sb.mask) & (g - 1);
          bx = __shfl_sync(sb.mask, bx, own, g);
          bi = __shfl_sync(sb.mask, bi, own, g);
          if (sb.gl == 0) {
            alive[l] = act;
            nxt[l] = bx;
            pre[l] = act ? bi : pre[l];
          }
        }
      }
    } else {
      if (sb.on) {                         // activity: a vote on the row
        for (int l = sb.sg; l < L; l += c.nsg) {
          if (!alive[l]) continue;
          const int nd = node[l];
          const int* ch = p.children + (size_t)nd * A;
          bool full = true;
          for (int j = sb.gl; j < A; j += g) full = full && ch[j] >= 0;
          const bool act = !p.terminal[nd] && __all_sync(sb.mask, full);
          if (sb.gl == 0) alive[l] = act;
        }
      }
      __syncthreads();
      link_items(
          L, L,
          [&](int i) -> long long {
            return alive[i] ? (long long)(unsigned)node[i] : -1;
          },
          prev, next);
      if (sb.on) {                         // one walker per node's group
        for (int h = sb.sg; h < L; h += c.nsg) {
          if (!alive[h] || prev[h] >= 0) continue;
          const int nd = node[h];
          const int* ch = p.children + (size_t)nd * A;
          const float* pr = p.prior + (size_t)nd * A;
          const float pn = (float)(p.visits[nd] + infl[nd] - 1);
          if (A <= g) {
            // One column a thread: the node's row, the column's count and
            // its score with that count and with one more stay in
            // registers; a step is the reduction, then the picked column
            // takes its next score and computes the one after.
            const int j = sb.gl;
            const bool has = j < A;
            const int x = has ? ch[j] : 0;
            const float cn = has ? (float)p.visits[x] : 0.0f;
            const float cw = has ? p.value[x] : 0.0f;
            const int cv = has ? infl[x] : 0;
            const float cp_ = has && c.puct ? pr[j] : 0.0f;
            auto score = [&](int d) {
              return uct_score(cn, cw, (float)cv + (float)d, pn, cp_, c.cp,
                               c.vl_weight, c.wu, c.puct);
            };
            int d = 0;
            float s = score(0), s1 = score(1);
            for (int k = h; k >= 0; k = next[k]) {
              if (group_best(s, j, has, sb.mask) == j) {
                nxt[k] = x;
                pre[k] = cv;
                d += 1;
                s = s1;
                s1 = score(d + 1);
              }
            }
            continue;
          }
          // several columns a thread: the node's row in this walker's
          // slice of shared memory, each entry touched only by the thread
          // that holds its column
          const int W = slice_words(c.puct);
          int* sc_ = slices + (size_t)sb.sg * W * A;
          float* sn = reinterpret_cast<float*>(sc_ + A);
          float* sw = sn + A;
          int* sv = reinterpret_cast<int*>(sw + A);
          int* cnt = sv + A;
          float* sp = reinterpret_cast<float*>(cnt + A);
          for (int j = sb.gl; j < A; j += g) {   // stage the node's row
            const int x = ch[j];
            sc_[j] = x;
            sn[j] = (float)p.visits[x];
            sw[j] = p.value[x];
            sv[j] = infl[x];
            cnt[j] = 0;
            if (c.puct) sp[j] = pr[j];
          }
          for (int k = h; k >= 0; k = next[k]) {
            float best = 0.0f;
            int idx = -1;
            for (int j = sb.gl; j < A; j += g) {
              const float s = uct_score(sn[j], sw[j],
                                        (float)sv[j] + (float)cnt[j], pn,
                                        c.puct ? sp[j] : 0.0f, c.cp,
                                        c.vl_weight, c.wu, c.puct);
              if (idx < 0 || s > best) {
                best = s;
                idx = j;
              }
            }
            const int pick = group_best(best, idx, true, sb.mask);
            if ((pick & (g - 1)) == sb.gl) {
              cnt[pick] += 1;
              nxt[k] = sc_[pick];
              pre[k] = sv[pick];
            }
          }
        }
      }
    }
    __syncthreads();                       // all reads of this level done
    int moved = 0;
    for (int l = t; l < L; l += T) {
      if (!alive[l]) continue;
      const int x = nxt[l];
      atomicAdd(&infl[x], 1);
      node[l] = x;
      depth[l] += 1;
      s_path[l * P + depth[l]] = x;
      moved = 1;
    }
    if (!__syncthreads_or(moved)) break;   // no lane descends any more
  }
  link_items(
      L, L,
      [&](int i) -> long long {
        return wave_valid ? (long long)(unsigned)node[i] : -1;
      },
      prev, next);
  for (int l = t; l < L; l += T) {
    s_leaf[l] = node[l];
    s_depth[l] = depth[l];
    s_dup[2 * l] = prev[l] >= 0;           // within this wave
    s_dup[2 * l + 1] = wave_valid && pre[l] > 0;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kernels: blockIdx.x = search root
// ---------------------------------------------------------------------------
extern "C" __global__ void __launch_bounds__(1024) sw_se_kernel(
    int* visits, float* value, int* infl, float* prior, int* children,
    const unsigned char* terminal, const int* free_list, const int* next_free,
    const int* free_top, int* s_leaf, int* s_depth, int* s_path, int* s_dup,
    int* e_can, int* e_slot, int* e_new, int n, int a, Cfg c,
    int wave_valid) {
  extern __shared__ int raw[];
  const int b = blockIdx.x;
  const Planes p = root_planes(b, n, a, visits, value, infl, prior, children,
                               terminal, free_list);
  const size_t rl = (size_t)b * c.lanes;
  select_phase(p, c, raw, wave_valid, s_leaf + rl, s_depth + rl,
               s_path + rl * c.path_len, s_dup + 2 * rl);
  expand_phase(p, c, raw, s_leaf + rl, nullptr, wave_valid, next_free[b],
               free_top[b], e_can + rl, e_slot + rl, e_new + rl);
}

extern "C" __global__ void __launch_bounds__(1024) sw_bes_kernel(
    int* visits, float* value, int* infl, float* prior, int* children,
    const unsigned char* terminal, const int* free_list, const int* next_free,
    const int* free_top, const int* se_leaf, const unsigned char* se_valid,
    const int* pb_path, const float* pb_value, const float* pb_priors,
    const int* pb_node, const unsigned char* pb_isnew,
    const unsigned char* pb_valid, int* s_leaf, int* s_depth, int* s_path,
    int* s_dup, int* e_can, int* e_slot, int* e_new, int n, int a, Cfg c,
    int wave_valid) {
  extern __shared__ int raw[];
  const int b = blockIdx.x;
  const Planes p = root_planes(b, n, a, visits, value, infl, prior, children,
                               terminal, free_list);
  const size_t rl = (size_t)b * c.lanes;
  backup_phase(p, c, raw, pb_path + rl * c.path_len, pb_value + rl,
               pb_priors + rl * a, pb_node + rl, pb_isnew + rl,
               pb_valid + rl);
  expand_phase(p, c, raw, se_leaf + rl, se_valid + rl, 0, next_free[b],
               free_top[b], e_can + rl, e_slot + rl, e_new + rl);
  select_phase(p, c, raw, wave_valid, s_leaf + rl, s_depth + rl,
               s_path + rl * c.path_len, s_dup + 2 * rl);
}

extern "C" __global__ void __launch_bounds__(1024) sw_b_kernel(
    int* visits, float* value, int* infl, float* prior, const int* pb_path,
    const float* pb_value, const float* pb_priors, const int* pb_node,
    const unsigned char* pb_isnew, const unsigned char* pb_valid, int n,
    int a, Cfg c) {
  extern __shared__ int raw[];
  const int b = blockIdx.x;
  const Planes p = root_planes(b, n, a, visits, value, infl, prior, nullptr,
                               nullptr, nullptr);
  const size_t rl = (size_t)b * c.lanes;
  backup_phase(p, c, raw, pb_path + rl * c.path_len, pb_value + rl,
               pb_priors + rl * a, pb_node + rl, pb_isnew + rl,
               pb_valid + rl);
}

// ---------------------------------------------------------------------------
// host launchers (plain C interface, bound with ctypes)
// ---------------------------------------------------------------------------
static const size_t SMEM_MAX = 232448;     // 227 KB, the block's limit

// The launch shape: sub-groups of g threads, as many as there are lanes
// (at most 1024 threads), fewer when the running walk's slices would not
// fit; backup columns per pass likewise.  The phases share one dynamic
// shared-memory area, sized for the largest; with one sub-group and one
// column a pass it is never above the earlier single-thread-per-lane
// kernel's 4 L (7 + 3 A + P) bytes, so every shape that fitted still does.
static Cfg make_cfg(int lanes, int a, int path_len, int max_depth, float cp,
                    float vl_weight, int puct, int wu, int running,
                    size_t* smem, int* threads) {
  Cfg c;
  c.lanes = lanes;
  c.path_len = path_len;
  c.max_depth = max_depth;
  c.cp = cp;
  c.vl_weight = vl_weight;
  c.puct = puct;
  c.wu = wu;
  c.running = running;
  c.g = group_width(a);
  const size_t L = lanes, I = sizeof(int), cap = SMEM_MAX / I;
  size_t nsg = L < 1024 / (size_t)c.g ? L : 1024 / (size_t)c.g;
  const size_t slice = running && lanes > 1 && a > c.g
                           ? slice_words(puct) * (size_t)a : 0;
  if (slice && 7 * L + nsg * slice > cap)
    nsg = cap > 7 * L + slice ? (cap - 7 * L) / slice : 1;
  size_t cols = path_len > 0 ? path_len : 1;
  if (L + 2 * L * cols > cap) cols = cap > 3 * L ? (cap - L) / (2 * L) : 1;
  c.nsg = (int)nsg;
  c.cols = (int)cols;
  size_t need = 7 * L + nsg * slice;                  // select
  need = need > 8 * L + 32 ? need : 8 * L + 32;       // expand
  need = need > L + 2 * L * cols ? need : L + 2 * L * cols;  // backup
  *smem = need * I;
  const size_t th = L > nsg * c.g ? L : nsg * c.g;
  *threads = (int)((th + 31) / 32 * 32);
  return c;
}

template <typename K>
static int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

extern "C" int sw_smem_bytes(int lanes, int a, int path_len, int puct,
                             int running) {
  size_t smem;
  int threads;
  make_cfg(lanes, a, path_len, 0, 0.0f, 0.0f, puct, 0, running, &smem,
           &threads);
  return (int)smem;
}

extern "C" int sw_se(int* visits, float* value, int* infl, float* prior,
                     int* children, const unsigned char* terminal,
                     const int* free_list, const int* next_free,
                     const int* free_top, int* s_leaf, int* s_depth,
                     int* s_path, int* s_dup, int* e_can, int* e_slot,
                     int* e_new, int batch, int n, int a, int lanes,
                     int path_len, int max_depth, float cp, float vl_weight,
                     int puct, int wu, int running, int wave_valid,
                     void* stream) {
  size_t smem;
  int threads;
  const Cfg c = make_cfg(lanes, a, path_len, max_depth, cp, vl_weight, puct,
                         wu, running, &smem, &threads);
  int rc = prepare(sw_se_kernel, smem);
  if (rc) return rc;
  sw_se_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      visits, value, infl, prior, children, terminal, free_list, next_free,
      free_top, s_leaf, s_depth, s_path, s_dup, e_can, e_slot, e_new, n, a,
      c, wave_valid);
  return (int)cudaGetLastError();
}

extern "C" int sw_bes(int* visits, float* value, int* infl, float* prior,
                      int* children, const unsigned char* terminal,
                      const int* free_list, const int* next_free,
                      const int* free_top, const int* se_leaf,
                      const unsigned char* se_valid, const int* pb_path,
                      const float* pb_value, const float* pb_priors,
                      const int* pb_node, const unsigned char* pb_isnew,
                      const unsigned char* pb_valid, int* s_leaf,
                      int* s_depth, int* s_path, int* s_dup, int* e_can,
                      int* e_slot, int* e_new, int batch, int n, int a,
                      int lanes, int path_len, int max_depth, float cp,
                      float vl_weight, int puct, int wu, int running,
                      int wave_valid, void* stream) {
  size_t smem;
  int threads;
  const Cfg c = make_cfg(lanes, a, path_len, max_depth, cp, vl_weight, puct,
                         wu, running, &smem, &threads);
  int rc = prepare(sw_bes_kernel, smem);
  if (rc) return rc;
  sw_bes_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      visits, value, infl, prior, children, terminal, free_list, next_free,
      free_top, se_leaf, se_valid, pb_path, pb_value, pb_priors, pb_node,
      pb_isnew, pb_valid, s_leaf, s_depth, s_path, s_dup, e_can, e_slot,
      e_new, n, a, c, wave_valid);
  return (int)cudaGetLastError();
}

extern "C" int sw_b(int* visits, float* value, int* infl, float* prior,
                    const int* pb_path, const float* pb_value,
                    const float* pb_priors, const int* pb_node,
                    const unsigned char* pb_isnew,
                    const unsigned char* pb_valid, int batch, int n, int a,
                    int lanes, int path_len, void* stream) {
  size_t smem;
  int threads;
  const Cfg c = make_cfg(lanes, a, path_len, 0, 0.0f, 0.0f, 0, 0, 0, &smem,
                         &threads);
  int rc = prepare(sw_b_kernel, smem);
  if (rc) return rc;
  sw_b_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      visits, value, infl, prior, pb_path, pb_value, pb_priors, pb_node,
      pb_isnew, pb_valid, n, a, c);
  return (int)cudaGetLastError();
}
