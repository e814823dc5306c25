// Blocked causal / non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention/kernel.py:
//   flash_attention_bhsd (_fa_kernel)  -> fa_wgmma_kernel (bfloat16),
//                                         fa_kernel (float32)
// and implements what that path drops: q_offset and logits_soft_cap.
//
// Training: both kernels also write, when given an lse pointer, each
// row's natural-log logsumexp of its scaled, capped, masked scores ([B, H,
// Sq] float32; (m + log2 l) ln 2 from the log2-domain running max and the
// float32 sum of P, before P is rounded; +inf for a row with no key), for
// the backward of flash_attention_bwd.cu.  The serving path passes nullptr.
//
// Layout: q [B, Sq, H, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, Dv], out
// [B, Sq, H, Dv], row-major (the public layout of the port's wrapper, read
// in place: no transpose or padding copy).  GQA: head h reads kv head
// h / (H / Hkv).  Dv is D but for deepseek-v2's MLA prefill, whose q and k
// carry 192 columns (128 from the latent, 64 rotary) and v 128.
//
// What bounds it on an H100.  bfloat16: bytes.  At the main path's
// prefill shapes (smollm-135m, 16 prompts x 276 positions, 9 heads of 64;
// zamba2-1.2b [16, 166] and [1, 384], 32 heads of 128) a launch does
// 0.1-3 GFLOP of causal QK^T and PV over 1-23 MB of bf16 q/k/v/out:
// ~0.1-3 us at the bf16 tensor-core peak against ~0.4-7 us at the memory
// rate.  float32: operations.  The same smollm prefill in float32 is 1.4
// GFLOP of exact causal work over 14 MB, 21 us at the 67 TFLOP/s FFMA
// peak against 4 us at the memory rate.
//
// bfloat16, fa_wgmma_kernel<D, DV> ((D, Dv) in {(64, 64), (80, 80),
// (128, 128), (192, 128)}): one CTA of one warpgroup (128 threads) per
// (64-row query tile, b * H + h).  One thread issues
// every copy by TMA (cp.async.bulk.tensor on a 4-D tensor map of the
// [B, S, H, D] tensor, completing on an mbarrier): the Q tile once, K and
// V tiles of 64 keys through a ring in shared memory (K of tile t + 1 and V
// of tile t in flight while tile t's S = Q K^T and softmax run).  Tiles
// land in the 128-byte swizzle that wgmma reads: 64-column atoms of rows x
// 128 B, 16-byte chunk c of row r at chunk c ^ (r % 8); D = 80 takes two
// atoms and D = 192 three (Q and K tiles; V's follow Dv), the columns past
// D and the rows past the end arriving as zeros.  S = Q K^T is wgmma
// m64n64k16 (D / 16 steps: 12 at D = 192) with both operands K-major in
// shared memory, float32 accumulators; the online softmax (scale, soft cap, masks, row max
// and sum over the quad of lanes that holds a row) runs on the accumulator
// fragments in registers; P is rounded to bf16 in registers, as the Pallas
// kernel rounds it to V's dtype, and O += P V is wgmma m64nNk16 (N = 64 or
// 128, from Dv) with A from registers and V [keys, D] as the MN-major B operand; l is
// summed from the float32 P.  seq_k_valid and the causal diagonal are masked
// only in the tiles that straddle them; tiles above the diagonal (shifted
// by q_offset) are never loaded.  A row with no key writes 0.  The tensor
// maps are made on the host (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint) and kept for the last few pointers and shapes.
//
// float32, fa_kernel<DP> (any Dv <= D <= 128, D padded to DP = 16, 32, 64
// or 128; the smoke models, whose card == CPU token streams go through
// it, deepseek-v2's at D 24 / Dv 16).  Both
// products stay IEEE float32 FFMA on the CUDA cores: wgmma has no float32
// mode but TF32, which would break those streams.  One block of 8 warps per
// (b * H + h, 64-row query tile), the tiles with the most keys (the last,
// under causal) launched first.  Q, then K / V tiles of 64 keys, reach
// shared memory by cp.async (16-byte LDGSTS when D is a multiple of 4,
// 4-byte otherwise; rows past the end zero-filled, columns past D zeroed
// once), K / V double-buffered so that tile t + 1 is copied while tile t
// is computed.  Rows are DP + 4 floats (an odd number of 16-byte chunks),
// so the 16 keys a K load reads fall in distinct bank quads.  Register
// blocking: warp w owns query rows 8w .. 8w + 7; lane (rg, cg) = (lane /
// 16, lane % 16) holds a 4 x 4 tile of S (rows 8w + rg + 2i, keys cg +
// 16j) and a 4 x DP/16 tile of O (the same rows).  S = Q K^T reads four
// Q rows and four K rows as float4 per four steps of D, 8 LDS.128 for 64
// FFMA, the Q reads broadcast across the 16 lanes of a row group.  The
// online softmax runs on S in registers (log2 domain; a row's max over the
// 16 lanes that hold it by 4 shuffles; l kept per lane and summed at the
// end).  P goes through shared memory inside the warp (its rows are its
// own, so a __syncwarp, not a block barrier), and O += P V reads P as
// float4 along the keys (broadcast over the 16 lanes of a row group) and V
// rows as float4 (the 16 lanes on consecutive columns), again 8 LDS.128
// for 64 FFMA.  Masks run only in tiles that straddle seq_k_valid or the
// causal diagonal (shifted by q_offset); tiles above it are never loaded,
// a warp whose rows are all past Sq or above a tile skips it, and P V
// stops at the warp's last visible key.  A row with no key writes 0.
// Sizes: 64 x 64 tiles keep S's 16 and O's 4 x DP/16 accumulators plus the
// float4 operands within 128 registers a thread (ptxas: 128 at DP <= 64, 0
// spills), so two blocks (16 warps) are resident per SM; shared memory is
// 5 tiles of 64 x (DP + 4) floats and P's 64 x 80, 105 KB at DP = 64 (two
// blocks fit the SM's 228 KB).  DP = 128 takes 168 registers and 185 KB:
// one block per SM.  At smollm's float32 prefill the tiles issue 1.16x
// the exact causal flops: the diagonal tiles and a last query tile of 20
// rows add work, but warps above a tile or past Sq skip it and P V stops
// at the warp's last key.
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched
                     // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;   // fa_kernel's largest head dim

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------
constexpr int TM = 64;          // query rows per CTA (one warpgroup)
constexpr int TN = 64;          // keys per tile
// K / V tiles in the ring: K of tile t + 1 is copied while tile t is
// computed, V of tile t while its S = Q K^T and softmax run.  One V stage
// leaves room for three CTAs per SM at D = 128 (64 KB of shared memory and
// ~21 K registers each).
constexpr int KS = 2;
constexpr int VS = 1;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` to complete.  A copy that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spin > (1LL << 24)) __trap();
  }
}

// One TMA copy of a box of a 4-D tensor map, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The rows [row, row + R) of head `hd` of sequence `b` as DP / 64 atoms of
// R rows x 64 columns, each one TMA box; columns past D and rows past the
// tensor's end arrive as zeros.
template <int DP, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int hd, int row,
                                         int b) {
#pragma unroll
  for (int a = 0; a < DP / 64; ++a)
    tma_load(dst + a * R * 128, map, bar, a * 64, hd, row, b);
}

// The natural-log logsumexp of a row from its log2-domain max m and sum l
// (of 2^(s - m)); +inf for a row with no key, so that the backward's
// exp(s - lse) is 0 there, as the forward's output is.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? (m + log2f(l)) * 0.6931471805599453f : INFINITY;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns in shared memory: D and Dv rounded up to whole 64-column atoms.
// At (192, 128) the Q tile is 24 KB and each K stage 24 KB, with 16 KB of
// V: 89 KB of the SM's 227 KB.
template <int D, int DV>
struct WgmmaShape {
  static constexpr int DP = (D + 63) / 64 * 64;   // Q / K columns
  static constexpr int DVP = (DV + 63) / 64 * 64; // V / O columns
  static_assert(DVP == 64 || DVP == 128, "O is wgmma N = 64 or 128");
  static constexpr int QTILE = TM * DP * 2;       // bytes of the Q tile
  static constexpr int KTILE = TN * DP * 2;       // bytes of a K tile
  static constexpr int VTILE = TN * DVP * 2;      // bytes of a V tile
  static constexpr int SMEM = QTILE + KS * KTILE + VS * VTILE + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(128)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int sq, int sk, int seq_k, int h, int hkv, int causal,
                int q_offset, float scale, float cap) {
  using S = WgmmaShape<D, DV>;
  constexpr int DP = S::DP, DVP = S::DVP, QTILE = S::QTILE;
  constexpr int KTILE = S::KTILE, VTILE = S::VTILE;
  constexpr int NO = DVP / 2;              // O accumulators per thread
  constexpr int NSC = TN / 2;              // S accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + KS + VS];   // Q, K, V stages
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;   // atoms 1024-B aligned
  const uint32_t s_k = s_q + QTILE, s_v = s_k + KS * KTILE;
  const uint32_t bar_q = (uint32_t)__cvta_generic_to_shared(bars);
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TM;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);

  // keys this tile can see: below seq_k_valid and, causal, at or below
  // the last query row's position
  const int k_valid = seq_k < sk ? seq_k : sk;
  int k_end = k_valid;
  if (causal) {
    const long long last = (long long)min(q0 + TM, sq) - 1 + q_offset;
    if (last + 1 < k_end) k_end = (int)(last + 1 > 0 ? last + 1 : 0);
  }
  const int n_tiles = (k_end + TN - 1) / TN;

  // one thread issues every copy: Q, then tile t of K into stage t % KS
  // and of V into stage t % VS, each on its stage's barrier
  auto issue_k = [&](int t) {
    const uint32_t bar = bar_k + (t % KS) * 8;
    mbar_expect(bar, KTILE);
    tma_tile<DP, TN>(s_k + (t % KS) * KTILE, &map_k, bar, kvh, t * TN, b);
  };
  auto issue_v = [&](int t) {
    const uint32_t bar = bar_v + (t % VS) * 8;
    mbar_expect(bar, VTILE);
    tma_tile<DVP, TN>(s_v + (t % VS) * VTILE, &map_v, bar, kvh, t * TN, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + KS + VS; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_q, QTILE);
    tma_tile<DP, TM>(s_q, &map_q, bar_q, hh, q0, b);
    for (int t = 0; t < KS - 1 && t < n_tiles; ++t) issue_k(t);
    for (int t = 0; t < VS - 1 && t < n_tiles; ++t) issue_v(t);
  }
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);   // this thread's two rows
  const int qi_a = q0 + row_a, qi_b = qi_a + 8;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  const float sl2 = scale * LOG2E;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TN;
    const uint32_t sk_t = s_k + (t % KS) * KTILE;
    const uint32_t sv_t = s_v + (t % VS) * VTILE;
    if (tid == 0) {        // the stages these fill were freed at t - 1
      if (t + KS - 1 < n_tiles) issue_k(t + KS - 1);
      if (t + VS - 1 < n_tiles) issue_v(t + VS - 1);
    }
    mbar_wait(bar_k + (t % KS) * 8, (t / KS) & 1);

    float s[NSC];
#pragma unroll
    for (int i = 0; i < NSC; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      const uint64_t dq = sw128_desc(s_q + (ks >> 2) * (TM * 128) + col, 16,
                                     1024);
      const uint64_t dk = sw128_desc(sk_t + (ks >> 2) * (TN * 128) + col,
                                     16, 1024);
      wgmma_ss_n64(s, dq, dk, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scores in the log2 domain, masked where the tile straddles a limit
    if (cap > 0.0f) {
#pragma unroll
      for (int i = 0; i < NSC; ++i) s[i] = cap * tanhf(s[i] * scale / cap);
#pragma unroll
      for (int i = 0; i < NSC; ++i) s[i] *= LOG2E;
    } else {
#pragma unroll
      for (int i = 0; i < NSC; ++i) s[i] *= sl2;
    }
    if (k0 + TN > k_valid || (causal && k0 + TN - 1 > q0 + q_offset)) {
#pragma unroll
      for (int i = 0; i < NSC; ++i) {
        const int kj = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const int qi = (i & 2) ? qi_b : qi_a;
        if (kj >= k_valid || (causal && qi + q_offset < kj))
          s[i] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      if (i & 2) mx_b = fmaxf(mx_b, s[i]);
      else mx_a = fmaxf(mx_a, s[i]);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;   // no key yet
    const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
    const float c_a = exp2f(m_a - mu_a), c_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? mu_b : mu_a));
      s[i] = p;
      if (i & 2) ps_b += p;
      else ps_a += p;
    }
    l_a = l_a * c_a + ps_a;        // from the float32 P, before rounding
    l_b = l_b * c_b + ps_b;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? c_b : c_a;
    uint32_t a[TN / 16][4];
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    mbar_wait(bar_v + (t % VS) * 8, (t / VS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {
      const uint64_t dv = sw128_desc(sv_t + kk * 16 * 128, TN * 128, 1024);
      if constexpr (DVP == 64) wgmma_rs_n64(o, a[kk], dv);
      else wgmma_rs_n128(o, a[kk], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    __syncthreads();   // this tile's stages may be refilled
  }

  l_a += __shfl_xor_sync(~0u, l_a, 1);
  l_a += __shfl_xor_sync(~0u, l_a, 2);
  l_b += __shfl_xor_sync(~0u, l_b, 1);
  l_b += __shfl_xor_sync(~0u, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {   // the quad's rows, natural log
    float* lb = lse + (size_t)bh * sq;
    if (qi_a < sq) lb[qi_a] = row_lse(m_a, l_a);
    if (qi_b < sq) lb[qi_b] = row_lse(m_b, l_b);
  }
  const size_t q_ld = (size_t)h * DV;
  __nv_bfloat16* ob = out + (size_t)b * sq * q_ld + (size_t)hh * DV;
#pragma unroll
  for (int j = 0; j < DVP / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    if (col < DV) {
      if (qi_a < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qi_a * q_ld + col) =
            __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (qi_b < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qi_b * q_ld + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv_b,
                                  o[4 * j + 3] * inv_b);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &got) != cudaSuccess
        || got != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return (EncodeTiled)f;
  }();
  return fn;
}

// Writes to *out the 4-D map {D, H, S, B} (innermost first) of a
// [B, S, H, D] bf16 tensor with boxes of 64 columns x 1 head x `rows` rows
// x 1 sequence, 128-byte swizzle; out-of-range columns and rows read as
// zeros.  The last few maps are kept, by pointer and shape, and handed out
// by value: a later lookup may overwrite a slot, never a map in use.
bool tensor_map(CUtensorMap* out, const void* base, int b, int s, int h,
                int d, int rows) {
  struct Entry {
    const void* base;
    int key[5];
    CUtensorMap map;
  };
  static Entry cache[8];
  static int next = 0;
  const int key[5] = {b, s, h, d, rows};
  for (const Entry& e : cache)
    if (e.base == base && e.key[0] == b && e.key[1] == s && e.key[2] == h
        && e.key[3] == d && e.key[4] == rows) {
      *out = e.map;
      return true;
    }
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  if (enc(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)base, dims,
          strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  Entry& e = cache[next];
  e.map = *out;
  e.base = base;
  for (int i = 0; i < 5; ++i) e.key[i] = key[i];
  next = (next + 1) % 8;
  return true;
}

template <int D, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int b, int sq, int sk, int seq_k, int h, int hkv,
                 int causal,
                 int q_offset, float scale, float cap, cudaStream_t stream) {
  constexpr int SMEM = WgmmaShape<D, DV>::SMEM;
  static cudaError_t attr = cudaFuncSetAttribute(   // once per (D, DV)
      fa_wgmma_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // each map keyed by its own tensor's pointer and shape, its last dim
  // included: q and k at D, v at DV
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, b, sq, h, D, TM)
      || !tensor_map(&mk, k, b, sk, hkv, D, TN)
      || !tensor_map(&mv, v, b, sk, hkv, DV, TN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((sq + TM - 1) / TM, b * h);
  fa_wgmma_kernel<D, DV><<<grid, 128, SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, lse, sq, sk, seq_k, h, hkv, causal,
      q_offset, scale, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: register-blocked FFMA on the CUDA cores, fed by cp.async
// ---------------------------------------------------------------------------
constexpr int FQ = 64;                // query rows per block (and keys a tile)
constexpr int FWARPS = 8;             // 8 query rows a warp
constexpr int FTHREADS = FWARPS * 32;
constexpr int PLD = FQ + 16;          // P's row stride in floats

// D padded to DP (16, 32, 64 or 128); rows of DP + 4 floats in shared
// memory, so that the 16 keys a K load reads lie in distinct bank quads
// (a row is an odd number of 16-byte chunks).  Q, K x 2, V x 2 and P.  V
// (Dv <= D columns) takes tiles of the same shape, its columns past Dv
// zero, so O's columns past Dv stay 0 and are not written.
template <int DP>
struct F32Shape {
  static constexpr int LD = DP + 4;
  static constexpr int TILE = FQ * LD;
  static constexpr int SMEM = (5 * TILE + FQ * PLD) * 4;
  static constexpr int CPT = DP / 16;           // O columns a thread
  static constexpr int CW = CPT < 4 ? CPT : 4;  // ... of them adjacent
  static constexpr int MIN_BLOCKS = DP <= 64 ? 2 : 1;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + FQ) of one head (src: its row 0, rows `stride`
// floats apart) into a tile at shared address dst; rows at or past `rows`
// arrive as zeros.  16-byte copies when D is a multiple of 4 (rows are
// then 16-byte aligned): a thread takes one 16-byte column of the padded
// row (its index modulo DP / 4, a power of two, so no division) in every
// FTHREADS / (DP / 4)-th row, and the columns past D are left to the
// zeroed padding; 4-byte copies otherwise.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src,
                                          size_t stride, int row0, int rows,
                                          int d) {
  constexpr int LD = F32Shape<DP>::LD;
  if ((d & 3) == 0) {
    constexpr int CPR = DP / 4;
    const int c = threadIdx.x % CPR;
    if (4 * c >= d) return;
#pragma unroll
    for (int r = threadIdx.x / CPR; r < FQ; r += FTHREADS / CPR) {
      const bool in = row0 + r < rows;
      cp_async16(dst + 4u * (r * LD + 4 * c),
                 in ? src + (size_t)(row0 + r) * stride + 4 * c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < FQ * d; e += FTHREADS) {
      const int r = e / d, c = e - r * d;
      const bool in = row0 + r < rows;
      cp_async4(dst + 4u * (r * LD + c),
                in ? src + (size_t)(row0 + r) * stride + c : src,
                in ? 4 : 0);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_cols(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

__device__ __forceinline__ float at(const float4& t, int e) {
  return e == 0 ? t.x : e == 1 ? t.y : e == 2 ? t.z : t.w;
}

// One block of 8 warps per (b * H + h, 64-row query tile), the tiles with
// the most keys (the last, under causal) first.  Warp w owns query rows
// 8w .. 8w + 7; lane (rg = lane / 16, cg = lane % 16) rows 8w + rg + 2i
// (i < 4), keys cg + 16j (j < 4) of S, and columns of O (CPT of them).
template <int DP>
__global__ void __launch_bounds__(FTHREADS, F32Shape<DP>::MIN_BLOCKS)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out,
          float* __restrict__ lse, int sq, int sk, int seq_k, int h, int hkv,
          int d, int dv, int causal, int q_offset, float scale, float cap) {
  using S = F32Shape<DP>;
  constexpr int LD = S::LD, TILE = S::TILE, CPT = S::CPT, CW = S::CW;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                       // [FQ][LD]
  float* ks = qs + TILE;                 // 2 x [FQ][LD]
  float* vs = ks + 2 * TILE;             // 2 x [FQ][LD]
  float* ps = vs + 2 * TILE;             // [FQ][PLD]
  const uint32_t s_q = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t s_k = s_q + 4u * TILE, s_v = s_k + 8u * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FQ;
  const size_t q_row = (size_t)h * d, kv_row = (size_t)hkv * d;
  const size_t v_row = (size_t)hkv * dv, o_row = (size_t)h * dv;
  const float* qb = q + (size_t)b * sq * q_row + (size_t)hh * d;
  const float* kb = k + (size_t)b * sk * kv_row + (size_t)kvh * d;
  const float* vb = v + (size_t)b * sk * v_row + (size_t)kvh * dv;

  // keys this tile can see: below seq_k_valid and, causal, at or below
  // the last query row's position
  const int k_valid = seq_k < sk ? seq_k : sk;
  int k_end = k_valid;
  if (causal) {
    const long long last = (long long)min(q0 + FQ, sq) - 1 + q_offset;
    if (last + 1 < k_end) k_end = (int)(last + 1 > 0 ? last + 1 : 0);
  }
  const int n_tiles = (k_end + FQ - 1) / FQ;

  // columns past D (Q, K x 2) and past Dv (V x 2) read as zeros
  if (d < DP)
    for (int e = tid; e < 3 * FQ * (DP - d); e += FTHREADS)
      fsm[(e / (DP - d)) * LD + d + e % (DP - d)] = 0.0f;
  if (dv < DP)
    for (int e = tid; e < 2 * FQ * (DP - dv); e += FTHREADS)
      vs[(e / (DP - dv)) * LD + dv + e % (DP - dv)] = 0.0f;
  if (n_tiles > 0) {                     // Q with the first K / V tile
    load_tile<DP>(s_q, qb, q_row, q0, sq, d);
    load_tile<DP>(s_k, kb, kv_row, 0, k_end, d);
    load_tile<DP>(s_v, vb, v_row, 0, k_end, dv);
  }
  cp_async_commit();

  const int rg = lane >> 4, cg = lane & 15;
  const int row0 = warp * 8 + rg;        // rows row0 + 2i
  const int wlast = q0 + warp * 8 + 7;   // the warp's last query row
  const bool live = q0 + warp * 8 < sq;
  const float sl2 = scale * LOG2E;
  float o[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FQ;
    if (t + 1 < n_tiles) {               // tile t + 1 in flight meanwhile
      load_tile<DP>(s_k + 4u * ((t + 1) & 1) * TILE, kb, kv_row, k0 + FQ,
                    k_end, d);
      load_tile<DP>(s_v + 4u * ((t + 1) & 1) * TILE, vb, v_row, k0 + FQ,
                    k_end, dv);
    }
    cp_async_commit();
    cp_async_wait1();                    // tile t (and Q) landed
    __syncthreads();
    const float* kt = ks + (t & 1) * TILE;
    const float* vt = vs + (t & 1) * TILE;
    // a warp whose rows are all past Sq, or all above the tile (causal),
    // has nothing to add
    if (live && (!causal || (long long)wlast + q_offset >= k0)) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (row0 + 2 * i) * LD
                                                   + 4 * c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(kt + (cg + 16 * j) * LD
                                                   + 4 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      // scores in the log2 domain, masked where the tile straddles a limit
      const bool edge = k0 + FQ > k_valid
                        || (causal && (long long)k0 + FQ - 1 > q0 + q_offset);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + row0 + 2 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = cap > 0.0f ? cap * tanhf(x * scale / cap) * LOG2E : x * sl2;
          if (edge) {
            const int kj = k0 + cg + 16 * j;
            if (kj >= k_valid || (causal && (long long)qi + q_offset < kj))
              x = -INFINITY;
          }
          s[i][j] = x;
        }
      }
      // online softmax: a row's max over the 16 lanes holding it; l stays
      // a per-lane partial sum until the end
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off));
        const float mn = fmaxf(m[i], mx);
        const float mu = mn == -INFINITY ? 0.0f : mn;   // no key yet
        const float corr = exp2f(m[i] - mu);
        m[i] = mn;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(s[i][j] - mu);
          s[i][j] = p;
          sum += p;
        }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[i][c] *= corr;
      }
      // P through shared memory, inside the warp (its rows are its own)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps[(row0 + 2 * i) * PLD + cg + 16 * j] = s[i][j];
      __syncwarp();
      // O += P V over the keys with data and, causal, at or below the
      // warp's last row (P and V are 0 past them)
      int kn = min(FQ, k_end - k0);
      if (causal) kn = (int)min((long long)kn, (long long)wlast + q_offset
                                                   - k0 + 1);
#pragma unroll 2
      for (int kc = 0; kc < kn; kc += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(ps + (row0 + 2 * i) * PLD
                                                   + kc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vv[CPT];
#pragma unroll
          for (int mm = 0; mm < CPT / CW; ++mm) {
            float part[CW];
            load_cols<CW>(part, vt + (kc + e) * LD + mm * 16 * CW + cg * CW);
#pragma unroll
            for (int c = 0; c < CW; ++c) vv[mm * CW + c] = part[c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = at(pv[i], e);
#pragma unroll
            for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
          }
        }
      }
    }
    __syncthreads();                     // K, V and P free for tile t + 2
  }

  float* ob = out + (size_t)b * sq * o_row + (size_t)hh * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      li += __shfl_xor_sync(~0u, li, off);
    const float inv = 1.0f / fmaxf(li, 1e-30f);
    const int qi = q0 + row0 + 2 * i;
    if (lse != nullptr && cg == 0 && qi < sq)
      lse[(size_t)bh * sq + qi] = row_lse(m[i], li);
    if (qi < sq) {
#pragma unroll
      for (int mm = 0; mm < CPT / CW; ++mm)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int col = mm * 16 * CW + cg * CW + c;
          if (col < dv) ob[(size_t)qi * o_row + col] = o[i][mm * CW + c] * inv;
        }
    }
  }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int sq, int sk, int seq_k, int h, int hkv,
               int d, int dv, int causal, int q_offset, float scale,
               float cap, cudaStream_t stream) {
  constexpr int SMEM = F32Shape<DP>::SMEM;
  static cudaError_t attr = cudaFuncSetAttribute(   // once per DP
      fa_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles = ((long long)sq + FQ - 1) / FQ;
  if (tiles > 65535 || (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * h), (unsigned)tiles);
  fa_kernel<DP><<<grid, FTHREADS, SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
      sq, sk, seq_k, h, hkv, d, dv, causal, q_offset, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for
// shapes the kernel does not take.  d is q's and k's head dim, dv v's and
// out's.  float32: dv <= d <= 128.  lse: nullptr, or [B, H, Sq] float32
// that receives each row's natural-log logsumexp of its scaled, capped,
// masked scores (+inf for a row with no key) for the backward.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int b, int sq, int sk, int seq_k, int h,
                                   int hkv, int d, int dv, int causal,
                                   int q_offset, float scale, float cap,
                                   void* stream) {
  if (dv < 1 || dv > d || d > MAX_D || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 16)
    return launch_f32<16>(q, k, v, out, (float*)lse, b, sq, sk, seq_k, h,
                          hkv, d, dv, causal, q_offset, scale, cap, s);
  if (d <= 32)
    return launch_f32<32>(q, k, v, out, (float*)lse, b, sq, sk, seq_k, h,
                          hkv, d, dv, causal, q_offset, scale, cap, s);
  if (d <= 64)
    return launch_f32<64>(q, k, v, out, (float*)lse, b, sq, sk, seq_k, h,
                          hkv, d, dv, causal, q_offset, scale, cap, s);
  return launch_f32<128>(q, k, v, out, (float*)lse, b, sq, sk, seq_k, h,
                         hkv, d, dv, causal, q_offset, scale, cap, s);
}

// bfloat16 on the tensor cores: (d, dv) in {(64, 64), (80, 80), (128, 128),
// (192, 128)}; q, k, v 16-byte aligned.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int b, int sq, int sk, int seq_k, int h,
                                    int hkv, int d, int dv, int causal,
                                    int q_offset, float scale, float cap,
                                    void* stream) {
  if (hkv < 1 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(D, DV)                                                      \
  if (d == D && dv == DV)                                                   \
    return launch_wgmma<D, DV>(q, k, v, out, (float*)lse, b, sq, sk, seq_k,  \
                               h, hkv, causal, q_offset, scale, cap, s);
  FA_CASE(64, 64) FA_CASE(80, 80) FA_CASE(128, 128) FA_CASE(192, 128)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
