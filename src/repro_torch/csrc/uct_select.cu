// Fused UCT score + masked first-max argmax for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/uct_select/kernel.py:
//   uct_argmax_tiles         (_uct_kernel)          -> uct_tiles_kernel
//   uct_argmax_running_call  (_uct_running_kernel)  -> uct_running_kernel
//
// What bounds it on an H100: neither bytes nor operations.  A Select level
// scores lanes x A children (a few KB of operands, a few thousand flops), so
// a launch is bound by launch latency and by the dependent chain of one
// row's scan; the running variant is a walk over the wave's lanes in order,
// L steps of (L + log2(32)) dependent shared-memory operations.
// What the design does about it: one thread per row for the independent
// board (no shared memory, no synchronisation); one warp per search root for
// the running walk, the warp's threads spread over the A children and a
// shuffle reduction picking the first maximum, so a step costs a warp-wide
// reduction instead of a serial scan.  The TPU's A->128 / rows->8 padding is
// not carried over: rows and columns are bounds-checked instead.
#include <cuda_runtime.h>

#include "uct_common.cuh"

// One thread per row of the [R, A] board; an all-invalid row returns 0.
extern "C" __global__ void uct_tiles_kernel(
    const float* __restrict__ n, const float* __restrict__ w,
    const float* __restrict__ vl, const float* __restrict__ o,
    const float* __restrict__ pn, const unsigned char* __restrict__ valid,
    int* __restrict__ out, int rows, int a, float cp, float vl_weight,
    int wu) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const size_t base = (size_t)r * a;
  const float* infl = wu ? o : vl;
  float best = 0.0f;
  int idx = 0;
  for (int j = 0; j < a; ++j) {
    const size_t e = base + j;
    const float s = valid[e] ? uct_score(n[e], w[e], infl[e], pn[r], 0.0f,
                                         cp, vl_weight, wu, 0)
                             : UCT_NEG_INF;
    if (j == 0 || s > best) {
      best = s;
      idx = j;
    }
  }
  out[r] = idx;
}

// One warp per search root: the [L, A] board of root b is walked in lane
// order; lane k's in-flight counts carry the picks of the earlier active
// lanes with the same parent id.  Dynamic shared memory: 3 * L ints.
extern "C" __global__ void uct_running_kernel(
    const float* __restrict__ n, const float* __restrict__ w,
    const float* __restrict__ vl, const float* __restrict__ o,
    const float* __restrict__ pn, const unsigned char* __restrict__ valid,
    const int* __restrict__ parent_id, int* __restrict__ out, int lanes,
    int a, float cp, float vl_weight, int wu) {
  extern __shared__ int smem[];
  int* picks = smem;
  int* act = smem + lanes;
  int* pid = smem + 2 * lanes;
  const int t = threadIdx.x;
  const size_t rb = (size_t)blockIdx.x * lanes;
  const float* infl = wu ? o : vl;
  for (int k = t; k < lanes; k += 32) {
    int any = 0;
    for (int j = 0; j < a; ++j) any |= valid[(rb + k) * a + j];
    act[k] = any;
    pid[k] = parent_id[rb + k];
  }
  __syncwarp();
  for (int k = 0; k < lanes; ++k) {
    float best = UCT_NEG_INF;
    int idx = a;                                   // "no column" marker
    for (int j = t; j < a; j += 32) {
      int d = 0;
      if (act[k])
        for (int m = 0; m < k; ++m)
          d += (act[m] && pid[m] == pid[k] && picks[m] == j);
      const size_t e = (rb + k) * a + j;
      const float s = valid[e]
                          ? uct_score(n[e], w[e], infl[e] + (float)d,
                                      pn[rb + k], 0.0f, cp, vl_weight, wu, 0)
                          : UCT_NEG_INF;
      if (idx == a || s > best) {
        best = s;
        idx = j;
      }
    }
    warp_argmax(best, idx, a);
    if (t == 0) picks[k] = idx;
    __syncwarp();
  }
  for (int k = t; k < lanes; k += 32) out[rb + k] = picks[k];
}

extern "C" int uct_argmax_tiles(const float* n, const float* w,
                                const float* vl, const float* o,
                                const float* pn, const unsigned char* valid,
                                int* out, int rows, int a, float cp,
                                float vl_weight, int wu, void* stream) {
  if (rows == 0) return 0;
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  uct_tiles_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      n, w, vl, o, pn, valid, out, rows, a, cp, vl_weight, wu);
  return (int)cudaGetLastError();
}

extern "C" int uct_argmax_running(const float* n, const float* w,
                                  const float* vl, const float* o,
                                  const float* pn, const unsigned char* valid,
                                  const int* parent_id, int* out, int batch,
                                  int lanes, int a, float cp, float vl_weight,
                                  int wu, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = 3 * (size_t)lanes * sizeof(int);
  uct_running_kernel<<<batch, 32, smem, (cudaStream_t)stream>>>(
      n, w, vl, o, pn, valid, parent_id, out, lanes, a, cp, vl_weight, wu);
  return (int)cudaGetLastError();
}
