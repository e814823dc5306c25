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
// What bounds it on an H100: latency, not bytes or operations.  A wave
// touches lanes x depth x A entries of planes that stay in device memory
// (one root's children + prior are N x A x 8 bytes, far above shared
// memory), and each tree level depends on the last: the launch is a chain
// of max_depth dependent gathers plus two short serial lane walks.
// What the design does about it: one block per root, so a batch of B roots
// fills up to B SMs at once; one thread per lane, so a level is one gather
// round per lane with __syncthreads() between levels; integer in-flight and
// visit counts use atomicAdd (order-free); the float value sum is NOT atomic
// — each node's contributions are added by one thread in lane order, the
// order of the plain version's flat scatter-add, so the kernel equals it
// bit for bit.  The serial parts (the running-assignment walk and the
// expand bookkeeping) read only shared memory.  The TPU's one-hot matmul
// gathers become indexed loads and its [1, 4] scalar word becomes kernel
// arguments.
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
};

struct Smem {            // views into dynamic shared memory
  int* node;             // [L]
  int* active;           // [L]
  int* pick;             // [L]
  int* aux0;             // [L]
  int* aux1;             // [L]
  int* aux2;             // [L]
  float* bn;             // [L, A] running board: child visits
  float* bw;             // [L, A] child values
  float* bv;             // [L, A] child in-flight counts
  float* fval;           // [L]
  int* path;             // [L, P]
};

__device__ Smem smem_views(int lanes, int a, int p) {
  extern __shared__ int raw[];
  Smem s;
  s.node = raw;
  s.active = s.node + lanes;
  s.pick = s.active + lanes;
  s.aux0 = s.pick + lanes;
  s.aux1 = s.aux0 + lanes;
  s.aux2 = s.aux1 + lanes;
  s.bn = reinterpret_cast<float*>(s.aux2 + lanes);
  s.bw = s.bn + lanes * a;
  s.bv = s.bw + lanes * a;
  s.fval = s.bv + lanes * a;
  s.path = reinterpret_cast<int*>(s.fval + lanes);
  return s;
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

__device__ __forceinline__ bool lane_active(const Planes& p, int node,
                                            int depth, int max_depth) {
  if (depth >= max_depth || p.terminal[node]) return false;
  const int* ch = p.children + (size_t)node * p.a;
  for (int j = 0; j < p.a; ++j)
    if (ch[j] < 0) return false;
  return true;
}

// ---------------------------------------------------------------------------
// Backup: add N and W along the paths, drain the in-flight plane, write the
// new rows' priors.  pb_* are this root's [L, ...] Playout->Backup operands.
// ---------------------------------------------------------------------------
__device__ void backup_phase(const Planes& p, const Cfg& c, const Smem& s,
                             const int* pb_path, const float* pb_value,
                             const float* pb_priors, const int* pb_node,
                             const unsigned char* pb_isnew,
                             const unsigned char* pb_valid) {
  const int l = threadIdx.x, L = c.lanes, P = c.path_len;
  if (l < L) {
    const bool v = pb_valid[l];
    for (int col = 0; col < P; ++col)
      s.path[l * P + col] = v ? pb_path[l * P + col] : UNEXPANDED;
    s.fval[l] = pb_value[l];
  }
  __syncthreads();
  if (l < L) {
    for (int col = 0; col < P; ++col) {
      const int x = s.path[l * P + col];
      if (x < 0) continue;
      atomicAdd(&p.visits[x], 1);
      atomicSub(&p.infl[x], 1);
      // A node sits at one column only (its depth), so its contributions
      // come in lane order; the lowest lane holding it adds them all.
      bool first = true;
      for (int m = 0; m < l; ++m)
        if (s.path[m * P + col] == x) {
          first = false;
          break;
        }
      if (first) {
        float acc = p.value[x];
        for (int m = l; m < L; ++m)
          if (s.path[m * P + col] == x) acc = acc + s.fval[m];
        p.value[x] = acc;
      }
    }
    if (pb_isnew[l] && pb_valid[l]) {
      float* dst = p.prior + (size_t)pb_node[l] * p.a;
      for (int j = 0; j < p.a; ++j) dst[j] = pb_priors[l * p.a + j];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Structural expand: lane i takes the (taken+1)-th free slot of its leaf's
// row as it stood before the wave (taken = earlier lanes of the wave that
// expanded the same leaf) and the (r+1)-th row of the allocation order
// (free-list LIFO first, then the next_free bump; r = earlier lanes that
// allocated).  Links the child and adds +1 in-flight on the new row.
// ---------------------------------------------------------------------------
__device__ void expand_phase(const Planes& p, const Cfg& c, const Smem& s,
                             int leaf, bool lane_ok, int nf0, int ft0,
                             int* e_can, int* e_slot, int* e_new) {
  const int l = threadIdx.x, L = c.lanes, A = p.a, n = p.n;
  int* leafs = s.node;
  int* ok = s.active;
  int* free_cnt = s.pick;
  int* can = s.aux0;
  int* taken = s.aux1;
  int* newrow = s.aux2;
  if (l < L) {
    const int* row = p.children + (size_t)leaf * A;
    int fc = 0;
    for (int j = 0; j < A; ++j) fc += (row[j] == UNEXPANDED);
    leafs[l] = leaf;
    free_cnt[l] = fc;
    ok[l] = lane_ok && !p.terminal[leaf];
  }
  __syncthreads();
  if (l == 0) {
    const int cap0 = ft0 + (n - nf0);
    int r = 0;
    for (int i = 0; i < L; ++i) {
      int tk = 0;
      for (int m = 0; m < i; ++m) tk += (leafs[m] == leafs[i] && can[m]);
      const int ci = ok[i] && free_cnt[i] > tk && r < cap0;
      int nr = n;
      if (ci) {
        nr = r < ft0 ? p.free_list[min(max(ft0 - 1 - r, 0), n - 1)]
                     : nf0 + (r - ft0);
      }
      can[i] = ci;
      taken[i] = tk;
      newrow[i] = nr;
      r += ci;
    }
  }
  __syncthreads();
  int slot = 0;
  if (l < L) {
    const int* row = p.children + (size_t)leaf * A;
    int cnt = 0;
    for (int j = 0; j < A; ++j) {
      if (row[j] == UNEXPANDED && ++cnt == taken[l] + 1) {
        slot = j;
        break;
      }
    }
  }
  __syncthreads();                       // every lane read its row first
  if (l < L) {
    if (can[l]) {
      p.children[(size_t)leaf * A + slot] = newrow[l];
      atomicAdd(&p.infl[newrow[l]], 1);
    }
    e_can[l] = can[l];
    e_slot[l] = slot;
    e_new[l] = newrow[l];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Lockstep select: all lanes descend together, one tree level per step.
// ---------------------------------------------------------------------------
__device__ void select_phase(const Planes& p, const Cfg& c, const Smem& s,
                             int wave_valid, int* s_leaf, int* s_depth,
                             int* s_path, int* s_dup) {
  const int l = threadIdx.x, L = c.lanes, A = p.a, P = c.path_len;
  const bool lane = l < L;
  int* infl = p.infl;
  // in-flight count before this wave at the lane's leaf (dup_cross): the
  // root's is read here; a deeper node only gains counts at the level that
  // moves onto it, so it is read there, before that level's adds
  int pre = lane ? infl[ROOT] : 0;
  __syncthreads();
  if (l == 0 && wave_valid) infl[ROOT] += L;
  int* path = s_path + (size_t)(lane ? l : 0) * P;
  if (lane) {
    path[0] = ROOT;
    for (int col = 1; col < P; ++col) path[col] = UNEXPANDED;
  }
  __syncthreads();
  int node = ROOT, depth = 0;
  bool active = lane && wave_valid && lane_active(p, ROOT, 0, c.max_depth);
  for (int it = 0; it < c.max_depth; ++it) {
    int pick = 0;
    if (active) {
      const int* ch = p.children + (size_t)node * A;
      const float pn = (float)(p.visits[node] + infl[node] - 1);
      const float* pr = p.prior + (size_t)node * A;
      if (c.running) {
        for (int j = 0; j < A; ++j) {
          const int x = ch[j];
          s.bn[l * A + j] = (float)p.visits[x];
          s.bw[l * A + j] = p.value[x];
          s.bv[l * A + j] = (float)infl[x];
        }
        s.fval[l] = pn;
      } else {
        float best = 0.0f;
        for (int j = 0; j < A; ++j) {
          const int x = ch[j];
          const float sc = uct_score((float)p.visits[x], p.value[x],
                                     (float)infl[x], pn, pr[j], c.cp,
                                     c.vl_weight, c.wu, c.puct);
          if (j == 0 || sc > best) {
            best = sc;
            pick = j;
          }
        }
      }
    }
    if (c.running) {
      if (lane) {
        s.node[l] = node;
        s.active[l] = active;
      }
      __syncthreads();
      if (l < 32) {                      // warp 0 walks the lanes in order
        for (int k = 0; k < L; ++k) {
          float best = UCT_NEG_INF;
          int idx = A;
          if (s.active[k]) {
            const float* pr = p.prior + (size_t)s.node[k] * A;
            for (int j = l; j < A; j += 32) {
              int d = 0;
              for (int m = 0; m < k; ++m)
                d += (s.active[m] && s.node[m] == s.node[k] &&
                      s.pick[m] == j);
              const int e = k * A + j;
              const float sc = uct_score(s.bn[e], s.bw[e],
                                         s.bv[e] + (float)d, s.fval[k],
                                         pr[j], c.cp, c.vl_weight, c.wu,
                                         c.puct);
              if (idx == A || sc > best) {
                best = sc;
                idx = j;
              }
            }
          }
          warp_argmax(best, idx, A);
          if (l == 0) s.pick[k] = s.active[k] ? idx : 0;
          __syncwarp();
        }
      }
      __syncthreads();
      if (active) pick = s.pick[l];
    }
    int nxt = 0;
    if (active) {
      nxt = p.children[(size_t)node * A + pick];
      pre = infl[nxt];
      path[depth + 1] = nxt;
    }
    __syncthreads();                     // all reads of this level done
    if (active) atomicAdd(&infl[nxt], 1);
    __syncthreads();
    if (active) {
      node = nxt;
      depth += 1;
      active = lane_active(p, node, depth, c.max_depth);
    }
  }
  if (lane) s.aux0[l] = node;
  __syncthreads();
  if (lane) {
    int dw = 0;
    if (wave_valid)
      for (int m = 0; m < l; ++m) dw |= (s.aux0[m] == node);
    s_leaf[l] = node;
    s_depth[l] = depth;
    s_dup[2 * l] = dw;
    s_dup[2 * l + 1] = wave_valid && pre > 0;
    if (!wave_valid)
      for (int col = 0; col < P; ++col) path[col] = UNEXPANDED;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kernels: blockIdx.x = search root
// ---------------------------------------------------------------------------
extern "C" __global__ void sw_se_kernel(
    int* visits, float* value, int* infl, float* prior, int* children,
    const unsigned char* terminal, const int* free_list, const int* next_free,
    const int* free_top, int* s_leaf, int* s_depth, int* s_path, int* s_dup,
    int* e_can, int* e_slot, int* e_new, int n, int a, Cfg c,
    int wave_valid) {
  const int b = blockIdx.x, L = c.lanes, l = threadIdx.x;
  const Planes p = root_planes(b, n, a, visits, value, infl, prior, children,
                               terminal, free_list);
  const Smem s = smem_views(L, a, c.path_len);
  const size_t rl = (size_t)b * L;
  select_phase(p, c, s, wave_valid, s_leaf + rl, s_depth + rl,
               s_path + rl * c.path_len, s_dup + 2 * rl);
  const int leaf = l < L ? s_leaf[rl + l] : 0;
  expand_phase(p, c, s, leaf, wave_valid != 0, next_free[b], free_top[b],
               e_can + rl, e_slot + rl, e_new + rl);
}

extern "C" __global__ void sw_bes_kernel(
    int* visits, float* value, int* infl, float* prior, int* children,
    const unsigned char* terminal, const int* free_list, const int* next_free,
    const int* free_top, const int* se_leaf, const unsigned char* se_valid,
    const int* pb_path, const float* pb_value, const float* pb_priors,
    const int* pb_node, const unsigned char* pb_isnew,
    const unsigned char* pb_valid, int* s_leaf, int* s_depth, int* s_path,
    int* s_dup, int* e_can, int* e_slot, int* e_new, int n, int a, Cfg c,
    int wave_valid) {
  const int b = blockIdx.x, L = c.lanes, l = threadIdx.x;
  const Planes p = root_planes(b, n, a, visits, value, infl, prior, children,
                               terminal, free_list);
  const Smem s = smem_views(L, a, c.path_len);
  const size_t rl = (size_t)b * L;
  backup_phase(p, c, s, pb_path + rl * c.path_len, pb_value + rl,
               pb_priors + rl * a, pb_node + rl, pb_isnew + rl,
               pb_valid + rl);
  const int leaf = l < L ? se_leaf[rl + l] : 0;
  const bool ok = l < L ? se_valid[rl + l] != 0 : false;
  expand_phase(p, c, s, leaf, ok, next_free[b], free_top[b], e_can + rl,
               e_slot + rl, e_new + rl);
  select_phase(p, c, s, wave_valid, s_leaf + rl, s_depth + rl,
               s_path + rl * c.path_len, s_dup + 2 * rl);
}

extern "C" __global__ void sw_b_kernel(
    int* visits, float* value, int* infl, float* prior, const int* pb_path,
    const float* pb_value, const float* pb_priors, const int* pb_node,
    const unsigned char* pb_isnew, const unsigned char* pb_valid, int n,
    int a, Cfg c) {
  const int b = blockIdx.x, L = c.lanes;
  const Planes p = root_planes(b, n, a, visits, value, infl, prior, nullptr,
                               nullptr, nullptr);
  const Smem s = smem_views(L, a, c.path_len);
  const size_t rl = (size_t)b * L;
  backup_phase(p, c, s, pb_path + rl * c.path_len, pb_value + rl,
               pb_priors + rl * a, pb_node + rl, pb_isnew + rl,
               pb_valid + rl);
}

// ---------------------------------------------------------------------------
// host launchers (plain C interface, bound with ctypes)
// ---------------------------------------------------------------------------
static size_t smem_bytes(int lanes, int a, int p) {
  return sizeof(int) * ((size_t)6 * lanes + 3 * (size_t)lanes * a + lanes +
                        (size_t)lanes * p);
}

static int block_threads(int lanes) { return lanes < 32 ? 32 : (lanes + 31) / 32 * 32; }

template <typename K>
static int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

static Cfg make_cfg(int lanes, int path_len, int max_depth, float cp,
                    float vl_weight, int puct, int wu, int running) {
  Cfg c;
  c.lanes = lanes;
  c.path_len = path_len;
  c.max_depth = max_depth;
  c.cp = cp;
  c.vl_weight = vl_weight;
  c.puct = puct;
  c.wu = wu;
  c.running = running;
  return c;
}

extern "C" int sw_smem_bytes(int lanes, int a, int path_len) {
  return (int)smem_bytes(lanes, a, path_len);
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
  const size_t smem = smem_bytes(lanes, a, path_len);
  int rc = prepare(sw_se_kernel, smem);
  if (rc) return rc;
  const Cfg c = make_cfg(lanes, path_len, max_depth, cp, vl_weight, puct, wu,
                         running);
  sw_se_kernel<<<batch, block_threads(lanes), smem, (cudaStream_t)stream>>>(
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
  const size_t smem = smem_bytes(lanes, a, path_len);
  int rc = prepare(sw_bes_kernel, smem);
  if (rc) return rc;
  const Cfg c = make_cfg(lanes, path_len, max_depth, cp, vl_weight, puct, wu,
                         running);
  sw_bes_kernel<<<batch, block_threads(lanes), smem, (cudaStream_t)stream>>>(
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
  const size_t smem = smem_bytes(lanes, a, path_len);
  int rc = prepare(sw_b_kernel, smem);
  if (rc) return rc;
  const Cfg c = make_cfg(lanes, path_len, 0, 0.0f, 0.0f, 0, 0, 0);
  sw_b_kernel<<<batch, block_threads(lanes), smem, (cudaStream_t)stream>>>(
      visits, value, infl, prior, pb_path, pb_value, pb_priors, pb_node,
      pb_isnew, pb_valid, n, a, c);
  return (int)cudaGetLastError();
}
