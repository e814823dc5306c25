// UCT / PUCT child score shared by the uct_select and search_wave kernels.
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

__device__ __forceinline__ float uct_score(float n, float w, float infl,
                                           float pn, float prior, float cp,
                                           float vl_weight, int wu,
                                           int puct) {
  const float n_eff = n + infl;
  const float q = wu ? w / fmaxf(n, 1.0f)
                     : (w - vl_weight * infl) / fmaxf(n_eff, 1.0f);
  const float pnc = fmaxf(pn, 1.0f);
  const float explore = puct ? prior * sqrtf(pnc) / (1.0f + n_eff)
                             : sqrtf(logf(pnc) / fmaxf(n_eff, 1.0f));
  const float s = q + cp * explore;
  return n_eff < 0.5f ? UCT_SENTINEL : s;
}

// First-max reduction over one warp: the larger score wins, a tie goes to
// the lower index; a lane holding no column carries idx == none.
__device__ __forceinline__ void warp_argmax(float& best, int& idx, int none) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (oi != none &&
        (idx == none || os > best || (os == best && oi < idx))) {
      best = os;
      idx = oi;
    }
  }
}
