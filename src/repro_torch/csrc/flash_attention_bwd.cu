// Hopper flash_attention backward: dq, dk, dv of the causal GQA attention
// that csrc/flash_attention.cu computes forward, from (q, k, v, o, dO, lse).
//
// Replaces the gradient of the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py :: flash_attention. That kernel
// has no backward: the reference trains through plain jnp attention and
// lets XLA differentiate it. Here the gradient is two kernels that recompute
// the probabilities from Q, K and the forward's row log-sum-exp instead of
// keeping the (rows x keys) matrix, as FlashAttention-2's backward does:
//
//   s = q.k * scale, softcapped c tanh(s / c), masked to -1e30
//   P = exp(s - lse)            dP = dO V^T        Dv = rowsum(dO o O)
//   dS = P (dP - Dv) (1 - (s / c)^2 under a softcap) * scale
//   dQ = dS K     dK = dS^T Q     dV = P^T dO
//
// Layout as the forward: q, dq (BH, G, Tq, D); o, dO (BH, G, Tq, Dv); k, dk
// (BH, Tkv, D); v, dv (BH, Tkv, Dv); lse (BH, G, Tq) float32. Dv = D but at
// MLA's (192, 128) and, on ffma only, (24, 16). The G query heads of a KV head are
// folded into rows (row = t * G + g), so summing dK and dV over a tile's
// rows sums them over the G heads with no extra pass.
//
// Deterministic, no atomics: every output has one owner. Two kernels, in
// order on one stream:
//  * dq: a block per (BH, 64 folded rows) walks the key tiles of its
//    causal/window band and accumulates dQ; it also forms Dv for its rows
//    and writes it to a float32 scratch for the second kernel.
//  * dkv: a block per (BH, 64 keys) walks the row tiles that can see its
//    keys and accumulates dK and dV (the ffma path's tiles are 32 rows or
//    keys at D = 256).
// Both recompute S and dP (two 64 x 64 x D products a tile pair), so the
// pair does seven products where the function needs five. Blocks are
// launched heaviest first: the dq grid's row tiles from the last, the dkv
// grid's key tiles from the first (the longest causal bands).
//
// What bounds it: at smollm_360m's training shape, q (40, 3, 512, 64)
// causal, the function is about 10 GFLOP against 42 MB, bound by bytes
// (about 13 us) on the card. Paths, picked as the forward's (the wrapper's
// choose_path; the C side refuses a path the inputs cannot take):
//  * mma at D = 64 (bf16, every tensor 16-byte aligned; smollm_360m's
//    layers) and D = 80 (h2o_danube_1_8b): the five products on wgmma
//    (m64n64k16 for the scores, m64n<D>k16 for the gradients), a warpgroup a
//    64 x 64 tile pair. Q, dO, K and V sit in swizzled shared tiles filled
//    by cp.async (a 64-wide bf16 row is one 128-byte swizzle row; a 160-byte
//    D 80 row is five 32-byte boxes under the 32-byte swizzle, hopper.cuh's
//    desc_kb / desc_mnb; the folded rows of a tile are not one TMA box when
//    64 is not a multiple of G; a row's offset is found by a multiply,
//    row_off_m, not an integer divide). S, dP (dq) and S^T, dP^T (dkv) are products of two
//    shared operands; P^T, dS^T and dS stay in registers as the A operand
//    of dV += P^T dO, dK += dS^T Q and dQ += dS K, whose B (dO, Q, K) is read
//    MN-major from the same tiles. The dkv block has three warpgroups (two
//    at D = 80, where three spill at their 168 registers) that
//    walk every third row tile of the band and sum their dK, dV in
//    warpgroup order through shared memory: it shortens the longest walk
//    (the causal key tile 0 sees all 24 row tiles) threefold and holds 12
//    warps an SM. Dropping the scale from dS until the accumulators are
//    stored, and exp2 on lse log2(e), keep the elementwise work to a few
//    instructions a score. What bounds it is latency, not the tensor cores
//    (the dK/dV kernel runs at about 120 TFLOP/s): each tile pair is a chain
//    of two wgmma groups, each waited on, with the scores' exponentials
//    between them. probe_gradients.py (numbers in PERF.md) takes the dK/dV
//    kernel apart: leaving out the score products saves nothing, leaving
//    out the scores' elementwise work or the register-operand products each
//    saves about half; two or four warpgroups, or a third cp.async stage,
//    are slower. Also tried and slower: deferring each tile's second wait
//    into the next tile, P^T and dS^T through shared memory as a shared A
//    operand, splitting the first wait so that P's work overlaps dP's
//    product. Also tried and dropped: the dK/dV kernel storing dS^T for a
//    dQ kernel that only reads it (five products instead of seven); it was
//    faster alone and moved no train step, at a scratch of about Tkv / D
//    times q's size.
//  * mma at D = 256 (bf16; gemma3_12b's head dim). What bounds it: a global
//    gemma3 layer's backward, q (16, 2, 2048, 256) causal, is 171.9 GFLOP
//    against 202 MB, so operations (0.174 ms at the card's 989 TFLOP/s);
//    at D = 256 an accumulator of 64 rows is 128 floats a thread, so the
//    design is a register budget. Every product is wgmma on [64][256]
//    tiles of four 64-column 128-byte-swizzled atoms filled by cp.async
//    (swizzle by hand), each product formed once, two warpgroups a block
//    (one block, 8 warps, an SM):
//    - dQ: both warpgroups share the block's Q, dO and a two-stage K/V
//      ring; warpgroup w takes keys 32 w .. 32 w + 31 of each tile: S and
//      dP of 64 rows x 32 keys (m64n32k16 over 16 k-steps), dS in
//      registers as the A operand of dQ += dS K (m64n256k16, K read
//      MN-major), a partial dQ of all 256 columns a warpgroup; the two are
//      added in warpgroup order once, through shared memory. 3 products a
//      tile pair; 204 registers, 193 KB of shared memory.
//    - dK/dV: both warpgroups share the block's K, V and a two-stage ring
//      of Q, dO, lse and Dv. Warpgroup 0 forms S^T = K Q^T, P^T from it,
//      leaves P'^T = P^T (1 - (s/c)^2 under a softcap) as float32 in shared
//      memory (its accumulator layout is warpgroup 1's, so thread t reads
//      what thread t wrote) and accumulates dV += P^T dO; warpgroup 1 forms
//      dP^T = V dO^T, waits on a named barrier for P'^T, forms dS^T = P'^T
//      (dP^T - Dv) and accumulates dK += dS^T Q. 4 products a tile pair;
//      216 registers, 210 KB.
//    Each kernel issues its next tile's gather while its score products
//    run. No atomics; Dv goes from the dQ kernel to the dK/dV kernel
//    through the float32 scratch. On an H100 (PERF.md) the global layer
//    takes about 1.03 ms (167 TFLOP/s): dQ 0.37, dK/dV 0.65.
//    At D = 80 (danube's layer, q (16, 4, 8192, 80) with window 4096: 1289
//    GFLOP against 422 MB, so operations, 1.30 ms) both kernels walk long
//    bands (a dK/dV block about 256 row tiles) and are bound the same way
//    as at D = 64; on an H100 (PERF.md) the layer takes about 8.0 ms (dQ
//    2.9, dK/dV 5.3). Tried and slower there: a dQ block of two warpgroups
//    sharing each K/V tile, and a dK/dV warpgroup that issues a tile's score
//    products with the last tile's gradient products and runs the
//    elementwise work under the latter (236 registers).
//  * mma at D = 128 (bf16; qwen2_moe_a2_7b's layer, q (128, 1, 1024, 128)
//    causal: 86.0 GFLOP against 269 MB, so operations, 0.087 ms). A 64-row
//    tile is two 128-byte swizzle atoms a row. Both kernels are the D = 64
//    / 80 ones at D = 128, and the register budget sets their shape: a
//    dK/dV warpgroup holds dK and dV of its 64 keys (128 floats a thread)
//    beside S^T and dP^T, 228 registers without a spill, so the block is
//    one warpgroup (DKV_WGS 1, 98 KB) and an SM holds two, each running
//    its exponentials under the other's products; the dQ block (162
//    registers) takes one K/V stage (65 KB), so an SM holds three. On an
//    H100 (PERF.md; probe_flash_wg.py) the layer takes about 0.57 ms (dQ
//    0.24 + dK/dV 0.33; 0.60 with two dQ blocks of two stages), where the
//    mma.sync kernels took 1.03. Measured slower for dK/dV: D = 256's role
//    split (flash_bwd_dkv_wgsplit<128>, 158 registers but one block of
//    147 KB an SM; 0.52 ms for dK/dV alone, with two or three Q/dO stages),
//    and two warpgroups a block walking alternate row tiles (0.36 ms).
//  * mma at MLA's (192, 128) (bf16; deepseek_v2_lite_16b's layer, q (128,
//    1, 1024, 192), v (128, 1024, 128) causal: 111.8 GFLOP over five
//    products, three over 192 and two over 128, against 337 MB, so
//    operations, 0.113 ms). Q and K rows are three 128-byte atoms, dO and V
//    rows two. The register budget sets the shape, as at D 128: one
//    warpgroup holding dK (96 floats a thread) and dV (64) beside S^T and
//    dP^T would pass 255 registers, so the dK/dV kernel is the role split
//    flash_bwd_dkv_wgsplit<192> (warpgroup 0: S^T over 12 k-steps, then dV
//    += P^T dO on m64n128; warpgroup 1: dP^T over 8, then dK += dS^T Q on
//    m64n192; one accumulator of at most 96 floats each; a three-stage
//    Q/dO ring, 180 KB, one block an SM: 8 warps of 186 registers fill the
//    register file); the dQ kernel is flash_bwd_dq_wgmma<192> (96 floats of dQ
//    beside S and dP, m64n192 for dQ += dS K; one K/V stage, 81 KB, two
//    blocks an SM). The gathers copy a row's 24 and 16 chunks apart, as 24
//    chunks make no whole number of rows a pass of 256 threads.
//  * mma at D = 16, 32 (bf16; D 128 until the D = 128 wgmma kernels above):
//    the same walk on mma.sync.m16n8k16 with the forward mma path's
//    fragments. 4 warps own 16 rows (dq) or 16 keys (dkv) each; the block's
//    own Q, dO (dq) or K, V (dkv) are gathered once by cp.async, the
//    streamed tiles (K, V or Q, dO, with lse and Dv) in a two-stage cp.async
//    ring; dq reads O for Dv from device memory, once. The row stride D + 8
//    keeps ldmatrix free of bank conflicts at every D (176 B at 80: the 8
//    rows of a fragment land on 8 distinct 4-bank groups). dkv computes
//    S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out of the
//    accumulators already in the A layout of dV += P^T dO and dK += dS^T Q
//    (the m16n8 accumulator layout is the m16n8k16 A layout); dq computes
//    dS the same way for dQ += dS K.
//    The second operand of those three goes through ldmatrix.trans. P and
//    dS are rounded to bf16 for their products.
//  * ffma (float32, and bf16 the mma path cannot take, such as the reduced
//    deepseek config's (24, 16)): float32 FFMA, the first version. Each thread holds a 4 x 4 block of the 64 x 64 score
//    tile and a 4-row (or 4-key) x D/16 block of its accumulator; operands
//    sit in padded shared memory (row stride D + 1) so that the reads are
//    free of bank conflicts. At D = 256 the tiles are 32 x 32 (a 2 x 2
//    block a thread): four [32][257] float tiles take 132 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // ffma: 16 x 16 threads, an RT x RT block of the score tile each
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Attn {
  int G, Tq, Tkv, causal, window;
  float softcap;
  int q_offset;
  float scale;
  float scale_cap;            // scale / softcap (0 without a softcap)
  unsigned long long fold_m;  // 2^32 / G + 1: rr / G by a multiply (row_off_m)
};

// Folded row rr of a (G, Tq, D) head block: row rr / G of head rr % G.
__device__ __forceinline__ size_t row_off(int rr, int G, int Tq) {
  return (size_t)(rr % G) * Tq + rr / G;
}

// P and dS (scaled to the raw q.k product) of one score: row rr at query
// position qpos with log-sum-exp lse and Dv dv, key kp. Both paths.
__device__ __forceinline__ void prob_grad(Attn a, float s, float dp, int rr, int R,
                                          int qpos, int kp, float lse, float dv, float& p,
                                          float& ds) {
  float x = s * a.scale;
  if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
  bool ok = rr < R && kp < a.Tkv;
  if (a.causal) ok = ok && kp <= qpos;
  if (a.window > 0) ok = ok && kp > qpos - a.window;
  p = expf((ok ? x : NEG_INF) - lse);
  ds = ok ? p * (dp - dv) : 0.f;
  if (a.softcap > 0.f) {
    const float t = x / a.softcap;
    ds *= 1.f - t * t;
  }
  ds *= a.scale;
}

// The head dim of v, O and dO (DV) beside that of q and k (D): D but at
// MLA's pairs, (192, 128) (deepseek_v2_lite_16b) and (24, 16) (its reduced
// config, ffma only). Every kernel is keyed by D alone.
template <int D>
__host__ __device__ constexpr int dv_of() {
  return D == 192 ? 128 : D == 24 ? 16 : D;
}

// ---------------------------------------------------------------------------
// ffma: float32 FFMA (and bf16 inputs the mma path cannot take). A block
// owns BT folded rows (dq) or keys (dkv) and walks tiles of BT keys or rows:
// BT = 64, and 32 at D = 256, where four [64][D + 1] float tiles would take
// 263 KB of the 227 KB a block may have (four [32][257] take 132 KB; at
// (192, 128) four [64][D + 1] or [64][DV + 1] tiles take 165 KB). A thread
// owns columns tx + 16 j of a row: at D = 24 the columns past D are read
// clamped and never written.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int ffma_tile() {
  return D + dv_of<D>() > 384 ? 32 : 64;
}
// A thread's column j of a row of N values: tx + 16 j, clamped to N - 1.
template <int N>
__device__ __forceinline__ int ffma_col(int tx, int j) {
  return N % 16 == 0 ? tx + 16 * j : min(tx + 16 * j, N - 1);
}

// BT folded rows from r0 of src (G, Tq, D) into dst[BT][D + 1] as float;
// rows past R read as zeros.
template <class T, int D, int BT>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int R, int G,
                                          int Tq) {
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, d = i % D, rr = r0 + r;
    dst[r * (D + 1) + d] = rr < R ? to_f(src[row_off(rr, G, Tq) * D + d]) : 0.f;
  }
}

// BT keys from kv0 of src (Tkv, D) into dst[BT][D + 1]; keys past Tkv read
// as zeros.
template <class T, int D, int BT>
__device__ __forceinline__ void load_keys(float* dst, const T* src, int kv0, int Tkv) {
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int c = i / D, d = i % D, kp = kv0 + c;
    dst[c * (D + 1) + d] = kp < Tkv ? to_f(src[(size_t)kp * D + d]) : 0.f;
  }
}

// s[i][j] = Q[rq + i] . K[kk + 16 j] over D and dp[i][j] = dO[rq + i] .
// V[kk + 16 j] over DV, from the tile's shared rows (strides D + 1, DV + 1),
// i, j < RT.
template <int D, int DV, int RT>
__device__ __forceinline__ void score_tile(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, int rq, int kk, float (&s)[RT][RT],
                                           float (&dp)[RT][RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[RT], kb[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) qa[i] = Qs[(rq + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < RT; ++j) kb[j] = Ks[(kk + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
  }
#pragma unroll 4
  for (int d = 0; d < DV; ++d) {
    float da[RT], vb[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) da[i] = dOs[(rq + i) * (DV + 1) + d];
#pragma unroll
    for (int j = 0; j < RT; ++j) vb[j] = Vs[(kk + 16 * j) * (DV + 1) + d];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
  }
}

template <int D>
constexpr int dq_smem_floats() {
  constexpr int BT = ffma_tile<D>(), DV = dv_of<D>();
  return 2 * BT * (D + 1) + 2 * BT * (DV + 1) + BT * (BT + 1) + 2 * BT;
}

template <class T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ dvec,
             Attn a) {
  constexpr int BT = ffma_tile<D>(), RT = BT / 16, DV = dv_of<D>();
  constexpr int DC = (D + 15) / 16;     // dQ columns a thread owns
  constexpr int LPR = THREADS / BT;     // lanes a row in the Dv sum
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BT][D + 1]
  float* dOs = Qs + BT * (D + 1);     // [BT][DV + 1]
  float* Ks = dOs + BT * (DV + 1);    // [BT][D + 1]; first O, [BT][DV + 1], for Dv
  float* Vs = Ks + BT * (D + 1);      // [BT][DV + 1]
  float* dSs = Vs + BT * (DV + 1);    // [BT][BT + 1]
  float* lse_s = dSs + BT * (BT + 1);
  float* dv_s = lse_s + BT;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, r0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest first
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, ooff = (size_t)bh * R * DV;
  const size_t koff = (size_t)bh * a.Tkv * D, voff = (size_t)bh * a.Tkv * DV;

  load_rows<T, D, BT>(Qs, q + qoff, r0, R, G, Tq);
  load_rows<T, DV, BT>(dOs, dout + ooff, r0, R, G, Tq);
  load_rows<T, DV, BT>(Ks, o + ooff, r0, R, G, Tq);
  if (tid < BT) {
    const int rr = r0 + tid;
    lse_s[tid] = rr < R ? lse[(size_t)bh * R + row_off(rr, G, Tq)] : 0.f;
  }
  __syncthreads();
  {  // Dv = rowsum(dO o O): LPR neighbouring lanes a row, then shuffles
    const int r = tid / LPR, part = tid % LPR;
    float acc = 0.f;
    for (int d = part; d < DV; d += LPR)
      acc = fmaf(dOs[r * (DV + 1) + d], Ks[r * (DV + 1) + d], acc);
#pragma unroll
    for (int m = 1; m < LPR; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (part == 0) {
      dv_s[r] = acc;
      if (r0 + r < R) dvec[(size_t)bh * R + row_off(r0 + r, G, Tq)] = acc;
    }
  }

  // The keys these rows can see, as in the forward.
  const int qmin = a.q_offset + r0 / G;
  const int qmax = a.q_offset + (min(R, r0 + BT) - 1) / G;
  const int kv_end = a.causal ? min(a.Tkv, qmax + 1) : a.Tkv;
  const int kv_begin = a.window > 0 ? max(0, qmin - a.window + 1) / BT * BT : 0;

  int qpos[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) qpos[i] = a.q_offset + (r0 + ty * RT + i) / G;
  float acc[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BT) {
    __syncthreads();  // the previous tile's Ks/Vs/dSs (and O) are consumed
    load_keys<T, D, BT>(Ks, k + koff, kv0, a.Tkv);
    load_keys<T, DV, BT>(Vs, v + voff, kv0, a.Tkv);
    __syncthreads();
    float s[RT][RT], dp[RT][RT];
    score_tile<D, DV, RT>(Qs, dOs, Ks, Vs, ty * RT, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        float p, ds;
        prob_grad(a, s[i][j], dp[i][j], r0 + r, R, qpos[i], kv0 + tx + 16 * j, lse_s[r],
                  dv_s[r], p, ds);
        dSs[r * (BT + 1) + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float dsv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) dsv[i] = dSs[(ty * RT + i) * (BT + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = Ks[c * (D + 1) + ffma_col<D>(tx, j)];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int rr = r0 + ty * RT + i;
    if (rr >= R) continue;
    T* row = dq + qoff + row_off(rr, G, Tq) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (D % 16 == 0 || tx + 16 * j < D) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  constexpr int BT = ffma_tile<D>(), DV = dv_of<D>();
  return 2 * BT * (D + 1) + 2 * BT * (DV + 1) + 2 * BT * (BT + 1) + 2 * BT;
}

template <class T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, Attn a) {
  constexpr int BT = ffma_tile<D>(), RT = BT / 16, DV = dv_of<D>();
  constexpr int DC = (D + 15) / 16, DCV = (DV + 15) / 16;  // dK / dV columns a thread owns
  extern __shared__ float smem[];
  float* Ks = smem;                   // [BT][D + 1]: this block's keys
  float* Vs = Ks + BT * (D + 1);      // [BT][DV + 1]
  float* Qs = Vs + BT * (DV + 1);     // [BT][D + 1]: the current row tile
  float* dOs = Qs + BT * (D + 1);     // [BT][DV + 1]
  float* Ps = dOs + BT * (DV + 1);    // [BT rows][BT + 1]
  float* dSs = Ps + BT * (BT + 1);
  float* lse_s = dSs + BT * (BT + 1);
  float* dv_s = lse_s + BT;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, kv0 = blockIdx.x * BT;
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, ooff = (size_t)bh * R * DV;
  const size_t koff = (size_t)bh * a.Tkv * D, voff = (size_t)bh * a.Tkv * DV;

  load_keys<T, D, BT>(Ks, k + koff, kv0, a.Tkv);
  load_keys<T, DV, BT>(Vs, v + voff, kv0, a.Tkv);

  // The folded rows that can see a key of [kv0, kv1): query position at
  // least kv0 (causal) and below kv1 - 1 + window (sliding window).
  const int kv1 = min(a.Tkv, kv0 + BT);
  const int rr_lo = a.causal ? max(0, (kv0 - a.q_offset) * G) : 0;
  const int rr_hi = a.window > 0 ? min(R, max(0, kv1 - 1 + a.window - a.q_offset) * G) : R;

  float acc_k[RT][DC], acc_v[RT][DCV];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DCV; ++c) acc_v[i][c] = 0.f;
  }

  for (int r0 = rr_lo / BT * BT; r0 < rr_hi; r0 += BT) {
    __syncthreads();  // the previous row tile is consumed
    load_rows<T, D, BT>(Qs, q + qoff, r0, R, G, Tq);
    load_rows<T, DV, BT>(dOs, dout + ooff, r0, R, G, Tq);
    if (tid < BT) {
      const int rr = r0 + tid;
      const size_t off = (size_t)bh * R + row_off(rr < R ? rr : 0, G, Tq);
      lse_s[tid] = rr < R ? lse[off] : 0.f;
      dv_s[tid] = rr < R ? dvec[off] : 0.f;
    }
    __syncthreads();
    float s[RT][RT], dp[RT][RT];
    score_tile<D, DV, RT>(Qs, dOs, Ks, Vs, ty * RT, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i, rr = r0 + r;
      const int qpos = a.q_offset + rr / G;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        float p, ds;
        prob_grad(a, s[i][j], dp[i][j], rr, R, qpos, kv0 + tx + 16 * j, lse_s[r], dv_s[r],
                  p, ds);
        Ps[r * (BT + 1) + tx + 16 * j] = p;
        dSs[r * (BT + 1) + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    // dV[key] += P[row, key] dO[row]; dK[key] += dS[row, key] Q[row]; this
    // thread's keys are ty * RT + i, its columns tx + 16 j.
#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float pv[RT], dsv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        pv[i] = Ps[r * (BT + 1) + ty * RT + i];
        dsv[i] = dSs[r * (BT + 1) + ty * RT + i];
      }
#pragma unroll
      for (int j = 0; j < DCV; ++j) {
        const float dov = dOs[r * (DV + 1) + ffma_col<DV>(tx, j)];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc_v[i][j] = fmaf(pv[i], dov, acc_v[i][j]);
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float qv = Qs[r * (D + 1) + ffma_col<D>(tx, j)];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kp = kv0 + ty * RT + i;
    if (kp >= a.Tkv) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (D % 16 == 0 || tx + 16 * j < D)
        dk[koff + (size_t)kp * D + tx + 16 * j] = from_f<T>(acc_k[i][j]);
#pragma unroll
    for (int j = 0; j < DCV; ++j)
      if (DV % 16 == 0 || tx + 16 * j < DV)
        dv[voff + (size_t)kp * DV + tx + 16 * j] = from_f<T>(acc_v[i][j]);
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 on tensor cores (mma.sync.m16n8k16, float32 accumulate), the
// fragments and copies of the forward's mma path.
// ---------------------------------------------------------------------------
constexpr int PAD = 8;                        // bf16 past each shared row: 16 bytes
constexpr int MMA_WARPS = 4;                  // 16 rows (dq) or keys (dkv) each
constexpr int MMA_TILE = 16 * MMA_WARPS;      // rows or keys a block owns, and a tile
constexpr int MMA_THREADS = 32 * MMA_WARPS;

// 16 (or 4) bytes from global to shared; zero-filled when !in (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b: mma.sync.m16n8k16, row.col, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats as a bf16 pair, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 folded rows from r0 of a (G, Tq, D) head block into dst[64][D + PAD]
// by cp.async, zeros past R. (Rolled: unrolled copy loops cost registers.)
template <int D>
__device__ __forceinline__ void gather_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int r0, int R, int G, int Tq) {
  constexpr int LD = D + PAD, CPR = D / 8;
#pragma unroll 1
  for (int i = threadIdx.x; i < MMA_TILE * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, rr = r0 + r;
    const bool in = rr < R;
    cp_async16(smem_u32(dst + r * LD + c), in ? src + row_off(rr, G, Tq) * D + c : src, in);
  }
}

// 64 keys from kv0 of a (Tkv, D) block into dst[64][D + PAD], zeros past Tkv.
template <int D>
__device__ __forceinline__ void gather_keys(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int kv0, int Tkv) {
  constexpr int LD = D + PAD, CPR = D / 8;
#pragma unroll 1
  for (int i = threadIdx.x; i < MMA_TILE * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, kp = kv0 + r;
    const bool in = kp < Tkv;
    cp_async16(smem_u32(dst + r * LD + c), in ? src + (size_t)kp * D + c : src, in);
  }
}

// acc (16 x 64) = A B^T over D: A the warp's 16 shared rows at `a`, B the
// 64 shared rows at `b` (both [row][D + PAD]). Eight 8-column tiles.
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], const __nv_bfloat16* a,
                                             const __nv_bfloat16* b) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(a + (lane & 15) * LD + kc * 16 + ((lane >> 4) << 3)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      const int n = np * 16 + ((lane >> 4) << 3) + (lane & 7);
      ldsm_x4(bf, smem_u32(b + n * LD + kc * 16 + (((lane >> 3) & 1) << 3)));
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += F B: F (16 x 64) as bf16 A fragments, B the N columns
// from `b` of 64 shared rows of stride LD, read through ldmatrix.trans
// (k = row, n = column).
template <int N, int LD>
__device__ __forceinline__ void frags_by_rows(float (&acc)[N / 8][4], const uint32_t (&f)[4][4],
                                              const __nv_bfloat16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp) {
      uint32_t bf[4];
      const int r = kc * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
      ldsm_x4_trans(bf, smem_u32(b + r * LD + dp * 16 + ((lane >> 4) << 3)));
      mma_bf16(acc[2 * dp], f[kc], bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], f[kc], bf[2], bf[3]);
    }
}

// A 16 x 64 accumulator tile as bf16 A fragments: the m16n8 accumulator
// layout is the m16n8k16 A layout, so no value leaves its thread.
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2] = pack_bf16(acc[j][0], acc[j][1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(acc[j][2], acc[j][3]);
  }
}

template <int D>
constexpr int dq_mma_smem_bytes() {
  static_assert(D <= 32, "D 64 and up take the wgmma kernels");
  return 6 * MMA_TILE * (D + PAD) * 2;  // Q, dO, two stages of K and V
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                 __nv_bfloat16* __restrict__ dq, float* __restrict__ dvec, Attn a) {
  constexpr int LD = D + PAD, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* dOs = Qs + MMA_TILE * LD;                          // [64][LD]
  __nv_bfloat16* Ks = dOs + MMA_TILE * LD;                          // [2][64][LD]
  __nv_bfloat16* Vs = Ks + 2 * MMA_TILE * LD;                       // [2][64][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, r0 = (gridDim.x - 1 - blockIdx.x) * MMA_TILE;  // longest first
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, koff = (size_t)bh * a.Tkv * D;

  gather_rows<D>(Qs, q + qoff, r0, R, G, Tq);
  gather_rows<D>(dOs, dout + qoff, r0, R, G, Tq);
  const int qmin = a.q_offset + r0 / G;
  const int qmax = a.q_offset + (min(R, r0 + MMA_TILE) - 1) / G;
  const int kv_end = a.causal ? min(a.Tkv, qmax + 1) : a.Tkv;
  const int kv_begin = a.window > 0 ? max(0, qmin - a.window + 1) / MMA_TILE * MMA_TILE : 0;
  auto load_kv = [&](int kv0, int st) {
    gather_keys<D>(Ks + st * MMA_TILE * LD, k + koff, kv0, a.Tkv);
    gather_keys<D>(Vs + st * MMA_TILE * LD, v + koff, kv0, a.Tkv);
  };
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();

  // This thread's rows: g and g + 8 of the warp's 16. Dv over a quad's
  // lanes, from dO and O in device memory (O has no shared tile).
  const int wrow = warp * 16;
  int qpos[2];
  float lse_r[2], dv_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + wrow + g + 8 * h;
    qpos[h] = a.q_offset + (rr < R ? rr / G : 0);
    lse_r[h] = rr < R ? lse[(size_t)bh * R + row_off(rr, G, Tq)] : 0.f;
    float acc = 0.f;
    if (rr < R) {
      const size_t off = qoff + row_off(rr, G, Tq) * D;
#pragma unroll 1
      for (int c = 2 * t4; c < D; c += 8) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(dout + off + c);
        const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(o + off + c);
        acc = fmaf(__low2float(x), __low2float(y), acc);
        acc = fmaf(__high2float(x), __high2float(y), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dv_r[h] = acc;
    if (t4 == 0 && rr < R) dvec[(size_t)bh * R + row_off(rr, G, Tq)] = acc;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  int st = 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += MMA_TILE, st ^= 1) {
    if (kv0 + MMA_TILE < kv_end) load_kv(kv0 + MMA_TILE, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile landed; the next stays in flight
    __syncthreads();
    const __nv_bfloat16* ks = Ks + st * MMA_TILE * LD;
    float s[8][4], dp[8][4];
    rows_by_rows<D>(s, Qs + wrow * LD, ks);
    rows_by_rows<D>(dp, dOs + wrow * LD, Vs + st * MMA_TILE * LD);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p;
        prob_grad(a, s[j][e], dp[j][e], r0 + wrow + g + 8 * h, R, qpos[h],
                  kv0 + j * 8 + 2 * t4 + (e & 1), lse_r[h], dv_r[h], p, s[j][e]);
      }
    uint32_t dsf[4][4];
    to_frags(dsf, s);
    frags_by_rows<D, LD>(acc, dsf, ks);  // dQ += dS K
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + wrow + g + 8 * h;
    if (rr >= R) continue;
    __nv_bfloat16* row = dq + qoff + row_off(rr, G, Tq) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int D>
constexpr int dkv_mma_smem_bytes() {
  return 6 * MMA_TILE * (D + PAD) * 2 + 4 * MMA_TILE * 4;  // K, V, 2 x (Q, dO), lse, Dv
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ dvec,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Attn a) {
  constexpr int LD = D + PAD, DT = D / 8;
  static_assert(D <= 32, "D 64 and up take the wgmma kernels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* Vs = Ks + MMA_TILE * LD;                           // [64][LD]
  __nv_bfloat16* Qs = Vs + MMA_TILE * LD;                           // [2][64][LD]
  __nv_bfloat16* dOs = Qs + 2 * MMA_TILE * LD;                      // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * MMA_TILE * LD);  // [2][64]
  float* dv_s = lse_s + 2 * MMA_TILE;                                // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, kv0 = blockIdx.x * MMA_TILE;
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, koff = (size_t)bh * a.Tkv * D;

  gather_keys<D>(Ks, k + koff, kv0, a.Tkv);
  gather_keys<D>(Vs, v + koff, kv0, a.Tkv);
  // The folded rows that can see a key of [kv0, kv1), as the ffma kernel.
  const int kv1 = min(a.Tkv, kv0 + MMA_TILE);
  const int rr_lo = a.causal ? max(0, (kv0 - a.q_offset) * G) : 0;
  const int rr_hi = a.window > 0 ? min(R, max(0, kv1 - 1 + a.window - a.q_offset) * G) : R;
  auto load_rows = [&](int r0, int st) {
    gather_rows<D>(Qs + st * MMA_TILE * LD, q + qoff, r0, R, G, Tq);
    gather_rows<D>(dOs + st * MMA_TILE * LD, dout + qoff, r0, R, G, Tq);
    if (tid < MMA_TILE) {  // plain loads: visible after the next barrier
      const int rr = r0 + tid;
      const size_t off = (size_t)bh * R + row_off(rr < R ? rr : 0, G, Tq);
      lse_s[st * MMA_TILE + tid] = rr < R ? lse[off] : 0.f;
      dv_s[st * MMA_TILE + tid] = rr < R ? dvec[off] : 0.f;
    }
  };
  const int r_first = rr_lo / MMA_TILE * MMA_TILE;
  if (r_first < rr_hi) load_rows(r_first, 0);
  cp_async_commit();

  // This thread's keys: g and g + 8 of the warp's 16.
  const int wkey = warp * 16;
  int kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kpos[h] = kv0 + wkey + g + 8 * h;
  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  int st = 0;
  for (int r0 = r_first; r0 < rr_hi; r0 += MMA_TILE, st ^= 1) {
    if (r0 + MMA_TILE < rr_hi) load_rows(r0 + MMA_TILE, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) landed; the next stays in flight
    __syncthreads();
    const __nv_bfloat16* qs = Qs + st * MMA_TILE * LD;
    const __nv_bfloat16* dos = dOs + st * MMA_TILE * LD;
    // S^T and dP^T: this warp's 16 keys by the tile's 64 rows.
    float s[8][4], dp[8][4];
    rows_by_rows<D>(s, Ks + wkey * LD, qs);
    rows_by_rows<D>(dp, Vs + wkey * LD, dos);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1), rr = r0 + col;
        prob_grad(a, s[j][e], dp[j][e], rr, R, a.q_offset + rr / G, kpos[e >> 1],
                  lse_s[st * MMA_TILE + col], dv_s[st * MMA_TILE + col], s[j][e], dp[j][e]);
      }
    uint32_t f[4][4];
    to_frags(f, s);
    frags_by_rows<D, LD>(acc_v, f, dos);  // dV += P^T dO
    to_frags(f, dp);
    frags_by_rows<D, LD>(acc_k, f, qs);   // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= a.Tkv) continue;
    const size_t off = koff + (size_t)kpos[h] * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t4) =
          pack_bf16(acc_k[j][2 * h], acc_k[j][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t4) =
          pack_bf16(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// mma at D = 64 (every attention layer of the zoo that trains) and D = 80
// (h2o_danube_1_8b): the five products on wgmma, a warpgroup a 64 x 64 tile
// pair, operands in swizzled shared tiles of boxes (hopper.cuh's desc_kb /
// desc_mnb: at D = 64 one 128-byte box a row, at D = 80 five 32-byte boxes,
// as 160-byte rows are not a whole number of 128-byte ones), filled by
// cp.async with the swizzle applied by hand: the folded rows of a tile are
// not one TMA box when 64 is not a multiple of G.
// ---------------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;

// Per head dim: the bytes of a box row (SWB), the dQ kernel's blocks an SM
// (DQ_BLOCKS: its register budget; shared memory allows as many) and K/V
// buffers (DQ_STAGES: two at D = 64 and 80, where three measured slower),
// and the dK/dV kernel's warpgroups (DKV_WGS), each walking every
// DKV_WGS-th row tile (3 at D = 80 spill at their 168 registers; 2 take
// 184). At D = 128 (two 128-byte atoms a row) the dQ block takes 162
// registers and one K/V stage (65 KB), three blocks an SM, which beat two
// blocks of two stages; the dK/dV block is one warpgroup holding both
// accumulators (228 registers, no spill, 98 KB), two blocks an SM, which
// beat two warpgroups a block walking alternate row tiles and the role
// split (probe_flash_wg.py).
template <int D> struct BwdWg;
template <> struct BwdWg<64> {
  static constexpr int SWB = 128, DQ_BLOCKS = 4, DQ_STAGES = 2, DKV_WGS = 3;
};
template <> struct BwdWg<80> {
  static constexpr int SWB = 32, DQ_BLOCKS = 3, DQ_STAGES = 2, DKV_WGS = 2;
};
template <> struct BwdWg<128> {
  static constexpr int SWB = 128, DQ_BLOCKS = 3, DQ_STAGES = 1, DKV_WGS = 1;
};
// MLA's (192, 128): Q/K rows of three 128-byte atoms, dO/V rows of two. The
// dQ block holds 96 floats of dQ beside S and dP (two blocks an SM, one K/V
// stage: 81 KB each); its dK/dV kernel is the role split.
template <> struct BwdWg<192> {
  static constexpr int SWB = 128, DQ_BLOCKS = 2, DQ_STAGES = 1, DKV_WGS = 1;
};
// The head dim from which the dK/dV kernel is the role split
// (flash_bwd_dkv_wgsplit) rather than flash_bwd_dkv_wgmma.
constexpr int DKV_SPLIT_D = 192;
template <int D>
__host__ __device__ constexpr int wg_tile() {  // bytes of a 64 x D bf16 tile
  return 64 * D * 2;
}

// A warpgroup's 64 x 64 accumulator as bf16 A fragments of its 4 k steps:
// accumulator d[4j + 2h + e] is row 16 warp + g + 8h, column 8j + 2 t4 + e,
// which is the A layout of k step j / 2.
__device__ __forceinline__ void acc_frags(uint32_t (&f)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2] = pack_bf16(d[4 * j], d[4 * j + 1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// row_off without an integer divide: rr / G as (rr fold_m) >> 32, at most
// one too large (fold_m = 2^32 / G + 1 and rr < 2^31), then corrected.
__device__ __forceinline__ size_t row_off_m(int rr, const Attn& a) {
  int t = static_cast<int>((static_cast<unsigned long long>(rr) * a.fold_m) >> 32);
  t -= t * a.G > rr;
  return (size_t)(rr - t * a.G) * a.Tq + t;
}

// 64 folded rows from r0 of a (G, Tq, D) head block (Q) and a (G, Tq, DB)
// one (dO; DB = D but at MLA's pair) into two swizzled tiles, zeros past R,
// by `n` threads of which this is thread t; each chunk's row offset found
// once for both (chunks past DB / 8 of a row copy Q's alone).
template <int D, int DB = D>
__device__ __forceinline__ void gather_rows_sw(uint32_t ta, uint32_t tb, const __nv_bfloat16* srca,
                                               const __nv_bfloat16* srcb, int r0, const Attn& a,
                                               int t, int n) {
  constexpr int CPR = D / 8;
  static_assert(DB <= D, "dO's row fits Q's");
  const int R = a.G * a.Tq;
#pragma unroll 1
  for (int i = t; i < 64 * CPR; i += n) {
    const int r = i / CPR, c = i % CPR, rr = r0 + r;
    const bool in = rr < R;
    const size_t ro = in ? row_off_m(rr, a) : 0;
    cp_async16(sw_chunk_b<BwdWg<D>::SWB, 64>(ta, r, c), srca + (in ? ro * D + c * 8 : 0), in);
    if (DB == D || c < DB / 8)
      cp_async16(sw_chunk_b<BwdWg<DB>::SWB, 64>(tb, r, c), srcb + (in ? ro * DB + c * 8 : 0), in);
  }
}
// 64 keys from kv0 of a (Tkv, D) block into a swizzled tile, zeros past Tkv.
template <int D>
__device__ __forceinline__ void gather_keys_sw(uint32_t tile, const __nv_bfloat16* src, int kv0,
                                               int Tkv, int t, int n) {
  constexpr int CPR = D / 8;
#pragma unroll 1
  for (int i = t; i < 64 * CPR; i += n) {
    const int r = i / CPR, c = i % CPR, kp = kv0 + r;
    const bool in = kp < Tkv;
    cp_async16(sw_chunk_b<BwdWg<D>::SWB, 64>(tile, r, c), in ? src + (size_t)kp * D + c * 8 : src,
               in);
  }
}

// Whether every (row, key) of the 64 x 64 tile pair at folded row r0 and
// key kv0 is visible, so that no score of it needs a mask.
__device__ __forceinline__ bool tile_visible(const Attn& a, int r0, int kv0) {
  const int R = a.G * a.Tq;
  bool all = r0 + 64 <= R && kv0 + 64 <= a.Tkv;
  if (a.causal) all = all && a.q_offset + r0 / a.G >= kv0 + 63;
  if (a.window > 0) all = all && a.q_offset + (r0 + 63) / a.G - kv0 < a.window;
  return all;
}

// P and dS / scale of one score, as prob_grad but lean, for the wgmma
// kernels' fragments: sl2 = scale log2(e), lse2 = lse log2(e); the scale of
// dS is applied to the dQ and dK accumulators once, after the walk. The mask
// is tested only when `masked`.
__device__ __forceinline__ void prob_grad2(const Attn& a, float sl2, bool masked, float s,
                                           float dp, int rr, int kp, float lse2, float dv,
                                           float& p, float& ds) {
  if (a.softcap > 0.f) {
    const float t = tanhf(s * a.scale_cap);
    p = ex2(t * a.softcap * LOG2E - lse2);
    ds = p * (dp - dv) * (1.f - t * t);
  } else {
    p = ex2(fmaf(s, sl2, -lse2));
    ds = p * (dp - dv);
  }
  if (masked) {
    const int qpos = a.q_offset + rr / a.G;
    bool ok = rr < a.G * a.Tq && kp < a.Tkv;
    if (a.causal) ok = ok && kp <= qpos;
    if (a.window > 0) ok = ok && kp > qpos - a.window;
    if (!ok) p = ds = 0.f;
  }
}

template <int D>
__host__ __device__ constexpr int dq_wg_smem() {  // Q, dO, the K/V ring; alignment
  return (1 + BwdWg<D>::DQ_STAGES) * (wg_tile<D>() + wg_tile<dv_of<D>()>()) + 1024;
}

// dQ of 64 folded rows: one warpgroup walks the key tiles of its band. Q
// and K rows of D values, dO and V rows of DV = dv_of<D>().
template <int D>
__global__ void __launch_bounds__(128, BwdWg<D>::DQ_BLOCKS)
flash_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ dvec, Attn a) {
  constexpr int DV = dv_of<D>(), SWB = BwdWg<D>::SWB, SWBV = BwdWg<DV>::SWB;
  constexpr int TQ = wg_tile<D>(), TV = wg_tile<DV>(), DQ_STAGES = BwdWg<D>::DQ_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // K and V of stage st at sK + st (TQ + TV), V TQ after its K.
  const uint32_t sQ = base, sdO = base + TQ, sK = base + TQ + TV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, r0 = (gridDim.y - 1 - blockIdx.y) * 64;  // longest first
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, ooff = (size_t)bh * R * DV;
  const size_t koff = (size_t)bh * a.Tkv * D, voff = (size_t)bh * a.Tkv * DV;

  gather_rows_sw<D, DV>(sQ, sdO, q + qoff, dout + ooff, r0, a, tid, 128);
  const int qmin = a.q_offset + r0 / G;
  const int qmax = a.q_offset + (min(R, r0 + 64) - 1) / G;
  const int kv_end = a.causal ? min(a.Tkv, qmax + 1) : a.Tkv;
  const int kv_begin = a.window > 0 ? max(0, qmin - a.window + 1) / 64 * 64 : 0;
  auto load_kv = [&](int kv0, int st) {
    gather_keys_sw<D>(sK + st * (TQ + TV), k + koff, kv0, a.Tkv, tid, 128);
    gather_keys_sw<DV>(sK + st * (TQ + TV) + TQ, v + voff, kv0, a.Tkv, tid, 128);
  };
#pragma unroll
  for (int st = 0; st < DQ_STAGES - 1; ++st) {
    if (kv_begin + 64 * st < kv_end) load_kv(kv_begin + 64 * st, st);
    cp_async_commit();
  }

  // This thread's rows: 16 warp + g + 8h. Dv = rowsum(dO o O) over a quad.
  float lse2[2], dv_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + 16 * warp + g + 8 * h;
    lse2[h] = rr < R ? lse[(size_t)bh * R + row_off(rr, G, Tq)] * LOG2E : 0.f;
    float acc = 0.f;
    if (rr < R) {
      const size_t off = ooff + row_off(rr, G, Tq) * DV;
#pragma unroll
      for (int c = 2 * t4; c < DV; c += 8) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(dout + off + c);
        const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(o + off + c);
        acc = fmaf(__low2float(x), __low2float(y), acc);
        acc = fmaf(__high2float(x), __high2float(y), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dv_r[h] = acc;
    if (t4 == 0 && rr < R) dvec[(size_t)bh * R + row_off(rr, G, Tq)] = acc;
  }

  const float sl2 = a.scale * LOG2E;
  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  for (int kv0 = kv_begin, it = 0; kv0 < kv_end; kv0 += 64, ++it) {
    const int st = it % DQ_STAGES, ahead = kv0 + 64 * (DQ_STAGES - 1);
    if (ahead < kv_end) load_kv(ahead, (it + DQ_STAGES - 1) % DQ_STAGES);
    cp_async_commit();
    cp_async_wait<DQ_STAGES - 1>();  // this tile (and Q, dO) landed; the next stay in flight
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = sK + st * (TQ + TV), vs = ks + TQ;
    // S = Q K^T (over D) and dP = dO V^T (over DV).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_kb<SWB, 64>(sQ, kk), desc_kb<SWB, 64>(ks, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss(dp, desc_kb<SWBV, 64>(sdO, kk), desc_kb<SWBV, 64>(vs, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    const bool masked = !tile_visible(a, r0, kv0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, i = 4 * j + e;
        float p;
        prob_grad2(a, sl2, masked, s[i], dp[i], r0 + 16 * warp + g + 8 * h,
                   kv0 + 8 * j + 2 * t4 + (e & 1), lse2[h], dv_r[h], p, s[i]);
      }
    // dQ += dS K: K read MN-major (k = key).
    uint32_t f[4][4];
    acc_frags(f, s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs_n<D>(acc, f[kc], desc_mnb<SWB, 64>(ks, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(f);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + 16 * warp + g + 8 * h;
    if (rr >= R) continue;
    __nv_bfloat16* row = dq + qoff + row_off(rr, G, Tq) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(acc[4 * j + 2 * h] * a.scale, acc[4 * j + 2 * h + 1] * a.scale);
  }
}

// dK/dV blocks: DKV_WGS warpgroups walk every DKV_WGS-th row tile of a key
// tile's band (kernel.py's bwd_walks mirrors this band arithmetic), each
// with DKV_STAGES buffers of (Q, dO). Shared memory: K, V; the buffers; lse
// and Dv of each buffer; alignment. The fixed-order sum of the walks goes
// through the buffers of warpgroups 1 and up.
constexpr int DKV_STAGES = 2;
template <int D>
__host__ __device__ constexpr int dkv_tiles() {  // K, V, the buffers
  return 2 + 2 * DKV_STAGES * BwdWg<D>::DKV_WGS;
}
template <int D>
__host__ __device__ constexpr int dkv_wg_smem() {
  return dkv_tiles<D>() * wg_tile<D>() + BwdWg<D>::DKV_WGS * DKV_STAGES * 2 * 64 * 4 + 1024;
}

// dK, dV of 64 keys: the warpgroups walk alternate row tiles of the keys'
// band, then sum their accumulators in warpgroup order.
template <int D>
__global__ void __launch_bounds__(128 * BwdWg<D>::DKV_WGS, 1)
flash_bwd_dkv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Attn a) {
  constexpr int SWB = BwdWg<D>::SWB, DKV_WGS = BwdWg<D>::DKV_WGS, TB = wg_tile<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + TB;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int lane = tid & 31, warp = t >> 5, g = lane >> 2, t4 = lane & 3;
  // Warpgroup wg, stage st: Q at stage(st), dO one tile on.
  auto stage = [&](int st) { return base + (2 + 2 * (DKV_STAGES * wg + st)) * TB; };
  // lse and Dv of each stage's rows: [DKV_STAGES][2][64]
  float* ld_s = reinterpret_cast<float*>(gbase + dkv_tiles<D>() * TB) + wg * DKV_STAGES * 128;

  const int bh = blockIdx.x, kv0 = blockIdx.y * 64;  // causal: heaviest key tiles first
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, koff = (size_t)bh * a.Tkv * D;

  gather_keys_sw<D>(sK, k + koff, kv0, a.Tkv, tid, 128 * DKV_WGS);
  gather_keys_sw<D>(sV, v + koff, kv0, a.Tkv, tid, 128 * DKV_WGS);
  cp_async_commit();
  // The folded rows that can see a key of [kv0, kv1), as the other kernels.
  const int kv1 = min(a.Tkv, kv0 + 64);
  const int rr_lo = a.causal ? max(0, (kv0 - a.q_offset) * G) : 0;
  const int rr_hi = a.window > 0 ? min(R, max(0, kv1 - 1 + a.window - a.q_offset) * G) : R;
  const int r_first = rr_lo / 64 * 64;
  const int ntile = rr_hi > r_first ? (rr_hi - r_first + 63) / 64 : 0;
  auto load_rows = [&](int i, int st) {
    const int r0 = r_first + 64 * i;
    gather_rows_sw<D>(stage(st), stage(st) + TB, q + qoff, dout + qoff, r0, a, t, 128);
    if (t < 64) {
      const int rr = r0 + t;
      const size_t off = (size_t)bh * R + row_off_m(rr < R ? rr : 0, a);
      cp_async4(smem_u32(ld_s + st * 128 + t), lse + off, rr < R);
      cp_async4(smem_u32(ld_s + st * 128 + 64 + t), dvec + off, rr < R);
    }
  };
#pragma unroll
  for (int st = 0; st < DKV_STAGES - 1; ++st) {
    if (wg + DKV_WGS * st < ntile) load_rows(wg + DKV_WGS * st, st);
    cp_async_commit();
  }
  cp_async_wait<DKV_STAGES - 1>();  // K and V landed
  fence_proxy_async();
  __syncthreads();

  const float sl2 = a.scale * LOG2E;
  float acc_k[D / 2], acc_v[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  for (int i = wg, it = 0; i < ntile; i += DKV_WGS, ++it) {
    const int r0 = r_first + 64 * i, st = it % DKV_STAGES, ahead = i + DKV_WGS * (DKV_STAGES - 1);
    if (ahead < ntile) load_rows(ahead, (it + DKV_STAGES - 1) % DKV_STAGES);
    cp_async_commit();
    cp_async_wait<DKV_STAGES - 1>();  // this stage landed; the next stay in flight
    fence_proxy_async();
    wg_sync(1 + wg);
    const uint32_t qs = stage(st), dos = qs + TB;
    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys by 64 rows.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_kb<SWB, 64>(sK, kk), desc_kb<SWB, 64>(qs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_kb<SWB, 64>(sV, kk), desc_kb<SWB, 64>(dos, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    const bool masked = !tile_visible(a, r0, kv0);
    // P^T and dS^T of each 8 rows, packed at once as the A fragments of
    // dV += P^T dO and dK += dS^T Q (acc_frags' layout)
    uint32_t fp[4][4], fs[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e;
        // one row's lse (times log2(e)) and Dv, for both of this thread's keys
        const float lse2 = ld_s[st * 128 + col] * LOG2E, dvr = ld_s[st * 128 + 64 + col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i2 = 4 * j + 2 * h + e;
          prob_grad2(a, sl2, masked, s[i2], dp[i2], r0 + col, kv0 + 16 * warp + g + 8 * h,
                     lse2, dvr, s[i2], dp[i2]);
        }
      }
      fp[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      fp[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      fs[j >> 1][(j & 1) * 2] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
      fs[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
    }
    // dO and Q read MN-major (k = row).
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs_n<D>(acc_v, fp[kc], desc_mnb<SWB, 64>(dos, kc));
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs_n<D>(acc_k, fs[kc], desc_mnb<SWB, 64>(qs, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_v);
    fence_acc(acc_k);
    fence_frags(fp);
    fence_frags(fs);
    wg_sync(1 + wg);  // the warpgroup is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // Fixed-order sum of the walks: warpgroup w > 0 leaves its accumulators
  // in its own stages (thread by thread: every warpgroup holds the same
  // fragment layout), warpgroup 0 adds them in order w = 1, 2, ...
  static_assert(2 * DKV_STAGES * TB >= D * 128 * 4,
                "the sum goes through a warpgroup's stages: D 128 floats");
  auto red = [&](int w) {
    return reinterpret_cast<float*>(gbase + (2 + 2 * DKV_STAGES * w) * TB);
  };
  __syncthreads();
  if (wg > 0) {
    float* r = red(wg);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      r[i * 128 + t] = acc_k[i];
      r[(D / 2 + i) * 128 + t] = acc_v[i];
    }
  }
  __syncthreads();
  if (wg > 0) return;
#pragma unroll 1
  for (int w = 1; w < DKV_WGS; ++w) {
    const float* r = red(w);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      acc_k[i] += r[i * 128 + t];
      acc_v[i] += r[(D / 2 + i) * 128 + t];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = kv0 + 16 * warp + g + 8 * h;
    if (kp >= a.Tkv) continue;
    const size_t off = koff + (size_t)kp * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i0 = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t4) =
          pack_bf16(acc_k[i0] * a.scale, acc_k[i0 + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t4) =
          pack_bf16(acc_v[i0], acc_v[i0 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// mma at D = 256 (gemma3_12b): wgmma on [64][D] tiles of D / 64 64-column
// swizzle atoms filled by cp.async, two warpgroups a block, every product
// once: the dQ kernel's key split and the dK/dV kernel's role split (a
// template of D: probe_flash_wg.py launches it at D = 128 too).
// ---------------------------------------------------------------------------
constexpr int TILE256 = 4 * SW_ATOM;  // 64 rows x 256 columns: 32 KB
// dQ at D = 256: Q, dO and two stages of K and V; alignment.
constexpr int DQ256_SMEM = 6 * TILE256 + 1024;
// The role-split dK/dV kernel's ring of (Q, dO) stages by head dim: two at
// D = 256 (210 KB). (probe_flash_wg.py adds D = 128, where a third fits.)
template <int D> struct BwdSplit;
template <> struct BwdSplit<256> { static constexpr int STAGES = 2; };
// (192, 128): three stages (180 KB) measured 2-3% faster than two
// (139 KB; probe_flash_wg.py), one block an SM either way.
template <> struct BwdSplit<192> { static constexpr int STAGES = 3; };
// K, V, the stages of Q and dO, P'^T (64 x 64 float32), each stage's rows'
// lse and Dv; alignment.
template <int D>
__host__ __device__ constexpr int dkv_split_smem() {
  return (1 + BwdSplit<D>::STAGES) * (wg_tile<D>() + wg_tile<dv_of<D>()>()) + 64 * 64 * 4 +
         BwdSplit<D>::STAGES * 2 * 64 * 4 + 1024;
}
// Keys kp and kp + 8 of a warpgroup's accumulator, N columns a key, as bf16
// rows of out (Tkv, N) scaled by sc.
template <int N, int M>
__device__ __forceinline__ void store_keys(const float (&acc)[M], __nv_bfloat16* out, int kp,
                                           int Tkv, int t4, float sc) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kp + 8 * h >= Tkv) continue;
    __nv_bfloat16* row = out + (size_t)(kp + 8 * h) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(acc[4 * j + 2 * h] * sc, acc[4 * j + 2 * h + 1] * sc);
  }
}
// The first N of a register array's M floats, as an array of its own.
template <int N, int M>
__device__ __forceinline__ float (&head(float (&a)[M]))[N] {
  static_assert(N <= M, "a head of the array");
  return *reinterpret_cast<float(*)[N]>(a);
}

// Named barrier `id` over 256 threads: one warpgroup arrives, the other waits.
__device__ __forceinline__ void bar_arrive256(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_sync256(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

#define FA_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_ACC16(i) FA_ACC4(i), FA_ACC4(i + 4), FA_ACC4(i + 8), FA_ACC4(i + 12)
#define FA_REGS16(a, b, c, d, e, f, g, h, i, j, k, l, m, n, o, p) \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h ", %" #i ", %" #j \
  ", %" #k ", %" #l ", %" #m ", %" #n ", %" #o ", %" #p

// d (64 x 32) = (acc ? d : 0) + A B over 16 k; A and B shared, K-major.
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      FA_REGS16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC16(0)
      : "l"(da), "l"(db), "r"(acc));
}
#undef FA_REGS16
#undef FA_ACC16
#undef FA_ACC4

// 64 folded rows from r0 of two (G, Tq, D) head blocks (Q and dO) into
// two [64][D] tiles of 128-byte atoms, zeros past R, by 256 threads: thread
// t copies chunk t % (D / 8) of rows t / (D / 8), t / (D / 8) + 2048 / D,
// ..., each row's offset found once for both tiles.
template <int D>
__device__ __forceinline__ void gather_rows_at(uint32_t ta, uint32_t tb, const __nv_bfloat16* a,
                                               const __nv_bfloat16* b, int r0, int R, int G,
                                               int Tq, int t) {
  constexpr int CPR = D / 8, STEP = 256 / CPR;
  const int c = t % CPR;
#pragma unroll 1
  for (int r = t / CPR; r < 64; r += STEP) {
    const int rr = r0 + r;
    const bool in = rr < R;
    const size_t off = in ? row_off(rr, G, Tq) * D + c * 8 : 0;
    cp_async16(sw_chunk_b<128, 64>(ta, r, c), a + off, in);
    cp_async16(sw_chunk_b<128, 64>(tb, r, c), b + off, in);
  }
}
// 64 keys from kv0 of two (Tkv, D) blocks (K and V) into two [64][D]
// tiles, zeros past Tkv, by 256 threads as gather_rows_at.
template <int D>
__device__ __forceinline__ void gather_keys_at(uint32_t ta, uint32_t tb, const __nv_bfloat16* a,
                                               const __nv_bfloat16* b, int kv0, int Tkv, int t) {
  constexpr int CPR = D / 8, STEP = 256 / CPR;
  const int c = t % CPR;
#pragma unroll 1
  for (int r = t / CPR; r < 64; r += STEP) {
    const int kp = kv0 + r;
    const bool in = kp < Tkv;
    const size_t off = in ? (size_t)kp * D + c * 8 : 0;
    cp_async16(sw_chunk_b<128, 64>(ta, r, c), a + off, in);
    cp_async16(sw_chunk_b<128, 64>(tb, r, c), b + off, in);
  }
}

// dQ of 64 folded rows at D = 256: both warpgroups walk the key tiles of
// the rows' band; warpgroup w takes keys 32 w .. 32 w + 31 of each tile
// (S and dP of 64 rows x 32 keys, then dQ += dS K over its keys, all 256
// columns), and the two partial dQ are added in warpgroup order at the end.
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_wg256(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ dvec, Attn a) {
  constexpr int D = 256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  // K and V of stage st at sK + 2 st TILE256, one tile apart.
  const uint32_t sQ = base, sdO = base + TILE256, sK = base + 2 * TILE256;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int lane = tid & 31, warp = t >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, r0 = (gridDim.y - 1 - blockIdx.y) * 64;  // longest first
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, koff = (size_t)bh * a.Tkv * D;

  gather_rows_at<D>(sQ, sdO, q + qoff, dout + qoff, r0, R, G, Tq, tid);
  const int qmin = a.q_offset + r0 / G;
  const int qmax = a.q_offset + (min(R, r0 + 64) - 1) / G;
  const int kv_end = a.causal ? min(a.Tkv, qmax + 1) : a.Tkv;
  const int kv_begin = a.window > 0 ? max(0, qmin - a.window + 1) / 64 * 64 : 0;
  auto load_kv = [&](int kv0, int st) {
    gather_keys_at<D>(sK + 2 * st * TILE256, sK + (2 * st + 1) * TILE256, k + koff, v + koff,
                      kv0, a.Tkv, tid);
  };
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();

  // This thread's rows: 16 warp + g + 8h (the same in both warpgroups). Dv
  // = rowsum(dO o O) over a quad, 16 bytes a load, in a fixed order.
  float lse2[2], dv_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + 16 * warp + g + 8 * h;
    lse2[h] = rr < R ? lse[(size_t)bh * R + row_off(rr, G, Tq)] * LOG2E : 0.f;
    float acc = 0.f;
    if (rr < R) {
      const size_t off = qoff + row_off(rr, G, Tq) * D;
#pragma unroll 2
      for (int c = 8 * t4; c < D; c += 32) {
        const uint4 x4 = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint4 y4 = *reinterpret_cast<const uint4*>(o + off + c);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&x4);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&y4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc = fmaf(__low2float(x[e]), __low2float(y[e]), acc);
          acc = fmaf(__high2float(x[e]), __high2float(y[e]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dv_r[h] = acc;
    if (wg == 0 && t4 == 0 && rr < R) dvec[(size_t)bh * R + row_off(rr, G, Tq)] = acc;
  }

  const float sl2 = a.scale * LOG2E;
  const uint32_t kofs = wg * 32 * 128;  // this warpgroup's 32 keys: rows 32 wg .. of each atom
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kv0 = kv_begin, it = 0; kv0 < kv_end; kv0 += 64, ++it) {
    const int st = it & 1;
    cp_async_wait<0>();  // this tile (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = sK + 2 * st * TILE256, vs = ks + TILE256;
    // S = Q K^T and dP = dO V^T over this warpgroup's keys; the next tile
    // loads into the other stage meanwhile.
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) wgmma_ss32(s, desc_k256(sQ, kk), desc_k256(ks + kofs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss32(dp, desc_k256(sdO, kk), desc_k256(vs + kofs, kk), kk);
    wgmma_commit();
    if (kv0 + 64 < kv_end) load_kv(kv0 + 64, st ^ 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    const bool masked = !tile_visible(a, r0, kv0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int h = (i >> 1) & 1;
      float p;
      prob_grad2(a, sl2, masked, s[i], dp[i], r0 + 16 * warp + g + 8 * h,
                 kv0 + 32 * wg + (i >> 2) * 8 + 2 * t4 + (i & 1), lse2[h], dv_r[h], p, s[i]);
    }
    // dQ += dS K: dS as the A fragments of two k steps, K read MN-major.
    uint32_t f[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) wgmma_rs256(acc, f[kc], desc_mn256(ks + kofs, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(f);
    __syncthreads();  // both warpgroups are done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // Fixed-order sum: warpgroup 1 leaves its partial dQ in the K/V stages
  // (thread by thread: both hold the same fragment layout), warpgroup 0 adds it.
  float* red = reinterpret_cast<float*>(gbase + 2 * TILE256);
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 128; ++i) red[i * 128 + t] = acc[i];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] += red[i * 128 + t];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + 16 * warp + g + 8 * h;
    if (rr >= R) continue;
    __nv_bfloat16* row = dq + qoff + row_off(rr, G, Tq) * D;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(acc[4 * j + 2 * h] * a.scale, acc[4 * j + 2 * h + 1] * a.scale);
  }
}

// dK, dV of 64 keys at D = 128, 192 (MLA's pair, dV of DV = 128) and 256:
// both warpgroups walk the row tiles of the keys' band. Warpgroup 0 forms S^T
// = K Q^T (over D), P^T from it, leaves P'^T = P^T (1 - (s / c)^2 under a
// softcap) in shared memory and accumulates dV += P^T dO (DV columns);
// warpgroup 1 forms dP^T = V dO^T (over DV), dS^T / scale = P'^T (dP^T -
// Dv) and accumulates dK += dS^T Q (D columns). Each holds one accumulator
// of at most D / 2 floats a thread, where one warpgroup owning both
// (flash_bwd_dkv_wgmma's layout) would hold (D + DV) / 2 plus the two score
// tiles' 64. Q, dO, lse and Dv come through a ring of BwdSplit<D>::STAGES
// stages, each filled while the products of the stages before it run.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_wgsplit(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Attn a) {
  constexpr int DV = dv_of<D>(), TB = wg_tile<D>(), TV = wg_tile<DV>();
  constexpr int STAGES = BwdSplit<D>::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + TB;
  // Q of stage st; its dO TB on.
  auto stage = [&](int st) { return base + (1 + st) * (TB + TV); };
  // P'^T: [32][128], thread-major; then [STAGES][lse, Dv][64]
  float* pt = reinterpret_cast<float*>(gbase + (1 + STAGES) * (TB + TV));
  float* ld_s = pt + 64 * 64;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int lane = tid & 31, warp = t >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, kv0 = blockIdx.y * 64;  // causal: heaviest key tiles first
  const int G = a.G, Tq = a.Tq, R = G * Tq;
  const size_t qoff = (size_t)bh * R * D, ooff = (size_t)bh * R * DV;
  const size_t koff = (size_t)bh * a.Tkv * D, voff = (size_t)bh * a.Tkv * DV;

  // gather_*_sw read BwdWg<D>'s swizzle, which D 256 (kernels of its own,
  // fed by gather_*_at) has none of.
  if constexpr (D == DV) {
    gather_keys_at<D>(sK, sV, k + koff, v + koff, kv0, a.Tkv, tid);
  } else {  // rows of 24 chunks: no whole number of rows a pass of 256 threads
    gather_keys_sw<D>(sK, k + koff, kv0, a.Tkv, tid, 256);
    gather_keys_sw<DV>(sV, v + voff, kv0, a.Tkv, tid, 256);
  }
  // The folded rows that can see a key of [kv0, kv1), as the other kernels.
  const int kv1 = min(a.Tkv, kv0 + 64);
  const int rr_lo = a.causal ? max(0, (kv0 - a.q_offset) * G) : 0;
  const int rr_hi = a.window > 0 ? min(R, max(0, kv1 - 1 + a.window - a.q_offset) * G) : R;
  const int r_first = rr_lo / 64 * 64;
  const int ntile = rr_hi > r_first ? (rr_hi - r_first + 63) / 64 : 0;
  auto load_rows = [&](int i, int st) {
    const int r0 = r_first + 64 * i;
    if constexpr (D == DV)
      gather_rows_at<D>(stage(st), stage(st) + TB, q + qoff, dout + qoff, r0, R, G, Tq, tid);
    else
      gather_rows_sw<D, DV>(stage(st), stage(st) + TB, q + qoff, dout + ooff, r0, a, tid, 256);
    if (tid < 64) {
      const int rr = r0 + tid;
      const size_t off = (size_t)bh * R + row_off(rr < R ? rr : 0, G, Tq);
      cp_async4(smem_u32(ld_s + st * 128 + tid), lse + off, rr < R);
      cp_async4(smem_u32(ld_s + st * 128 + 64 + tid), dvec + off, rr < R);
    }
  };
  // One commit group a row tile (the first with K and V): tile i is group i.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntile) load_rows(st, st);
    cp_async_commit();
  }

  const float sl2 = a.scale * LOG2E;
  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1): keys 16 warp + g + 8h
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < ntile; ++i) {
    const int r0 = r_first + 64 * i, st = i % STAGES;
    cp_async_wait<STAGES - 2>();  // this stage (and K, V) landed; the later ones stay in flight
    fence_proxy_async();
    __syncthreads();
    const uint32_t qs = stage(st), dos = qs + TB;
    const float* lds = ld_s + st * 128;
    const bool masked = !tile_visible(a, r0, kv0);
    // s[4j + 2h + e]: key 16 warp + g + 8h, row 8j + 2 t4 + e of the tile.
    // The row tile STAGES - 1 on loads into the stage the last one freed,
    // under the product.
    float s[32];
    uint32_t f[4][4];
    wgmma_fence();
    // At D = Dv both warpgroups run one stream of wgmmas, the operands
    // picked per warpgroup: apart (as at MLA's pair), D 256's dK/dV kernel
    // took 10% longer (42 HGMMA in its SASS rather than 20).
    if constexpr (D == DV) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_kb<128, 64>(wg == 0 ? sK : sV, kk),
                 desc_kb<128, 64>(wg == 0 ? qs : dos, kk), kk);
    } else if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_kb<128, 64>(sK, kk), desc_kb<128, 64>(qs, kk), kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss(s, desc_kb<128, 64>(sV, kk), desc_kb<128, 64>(dos, kk), kk);
    }
    wgmma_commit();
    if (i + STAGES - 1 < ntile) load_rows(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(s);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e;
          const float lse2 = lds[col] * LOG2E;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // P and P' = P (1 - (s / c)^2): prob_grad2's dS at dP - Dv = 1
            const int i2 = 4 * j + 2 * h + e;
            float pf;
            prob_grad2(a, sl2, masked, s[i2], 1.f, r0 + col, kv0 + 16 * warp + g + 8 * h, lse2,
                       0.f, s[i2], pf);
            pt[i2 * 128 + t] = pf;
          }
        }
      bar_arrive256(1);  // P'^T is in shared memory for warpgroup 1
    } else {
      bar_sync256(1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dvr = lds[64 + 8 * j + 2 * t4 + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i2 = 4 * j + 2 * h + e;
            s[i2] = pt[i2 * 128 + t] * (s[i2] - dvr);
          }
        }
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): the rows
    // read MN-major (k = row).
    acc_frags(f, s);
    wgmma_fence();
    if constexpr (D == DV) {  // one stream of wgmmas, as above
      const uint32_t b = wg == 0 ? dos : qs;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs_n<D>(acc, f[kc], desc_mnb<128, 64>(b, kc));
    } else if (wg == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs_n<DV>(head<DV / 2>(acc), f[kc], desc_mnb<128, 64>(dos, kc));
    } else {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs_n<D>(acc, f[kc], desc_mnb<128, 64>(qs, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(f);
    __syncthreads();  // both warpgroups are done with this stage and P'^T
  }
  cp_async_wait<0>();

  // dV (warpgroup 0: DV columns, unscaled) or dK (warpgroup 1: D columns).
  if (wg == 0)
    store_keys<DV>(acc, dv + voff, kv0 + 16 * warp + g, a.Tkv, t4, 1.f);
  else
    store_keys<D>(acc, dk + koff, kv0 + 16 * warp + g, a.Tkv, t4, a.scale);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------
enum Path { PATH_MMA = 0, PATH_FFMA = 1 };

// The head dims of q/k (D) and v/o (Dv) each path takes: D = Dv in {16,
// 32, 64, 80, 128, 256}, or MLA's (192, 128); ffma also (24, 16).
bool mma_dims(int D, int Dv) {
  if (D == 192) return Dv == 128;
  return D == Dv && (D == 16 || D == 32 || D == 64 || D == 80 || D == 128 || D == 256);
}

bool path_fits(int path, int dtype, int D, int Dv, bool aligned) {
  switch (path) {
    case PATH_MMA: return mma_dims(D, Dv) && dtype == 1 && aligned;
    case PATH_FFMA: return (mma_dims(D, Dv) || (D == 24 && Dv == 16)) && (dtype == 0 || dtype == 1);
    default: return false;
  }
}

template <class T, int D>
cudaError_t launch(int path, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* dvec, int BH, const Attn& a, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  const int R = a.G * a.Tq, mma_rows = (R + MMA_TILE - 1) / MMA_TILE;
  const int mma_keys = (a.Tkv + MMA_TILE - 1) / MMA_TILE;
  if constexpr (sizeof(T) == 2 && D >= 64) {
    if (path == PATH_MMA) {
      // dQ: one warpgroup a block (flash_bwd_dq_wgmma<D>, D <= 128 and MLA's
      // 192) or the two of flash_bwd_dq_wg256; dK/dV: DKV_WGS warpgroups each
      // owning both accumulators (D < DKV_SPLIT_D) or the role split. Grid y: row
      // tiles longest first (dQ), key tiles heaviest first (dK/dV).
      if constexpr (D <= 128 || D == 192) {
        constexpr int dq_bytes = dq_wg_smem<D>();
        static const cudaError_t attr_dq = cudaFuncSetAttribute(
            flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
        if (attr_dq != cudaSuccess) return attr_dq;
        flash_bwd_dq_wgmma<D><<<dim3(BH, mma_rows), 128, dq_bytes, stream>>>(
            qt, kt, vt, ot, dot, lse, static_cast<T*>(dq), dvec, a);
      } else {
        static const cudaError_t attr_dq = cudaFuncSetAttribute(
            flash_bwd_dq_wg256, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ256_SMEM);
        if (attr_dq != cudaSuccess) return attr_dq;
        flash_bwd_dq_wg256<<<dim3(BH, mma_rows), 256, DQ256_SMEM, stream>>>(
            qt, kt, vt, ot, dot, lse, static_cast<T*>(dq), dvec, a);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      if constexpr (D < DKV_SPLIT_D) {
        constexpr int dkv_bytes = dkv_wg_smem<D>();
        static_assert(dkv_bytes <= 232448, "227 KB of shared memory a block");
        static const cudaError_t attr_dkv = cudaFuncSetAttribute(
            flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
        if (attr_dkv != cudaSuccess) return attr_dkv;
        flash_bwd_dkv_wgmma<D><<<dim3(BH, mma_keys), 128 * BwdWg<D>::DKV_WGS, dkv_bytes,
                                 stream>>>(qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk),
                                           static_cast<T*>(dv), a);
      } else {
        constexpr int dkv_bytes = dkv_split_smem<D>();
        static_assert(dkv_bytes <= 232448, "227 KB of shared memory a block");
        static const cudaError_t attr_dkv = cudaFuncSetAttribute(
            flash_bwd_dkv_wgsplit<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
        if (attr_dkv != cudaSuccess) return attr_dkv;
        flash_bwd_dkv_wgsplit<D><<<dim3(BH, mma_keys), 256, dkv_bytes, stream>>>(
            qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), a);
      }
      return cudaGetLastError();
    }
  } else if constexpr (sizeof(T) == 2 && D % 16 == 0) {
    if (path == PATH_MMA) {
      constexpr int dq_bytes = dq_mma_smem_bytes<D>(), dkv_bytes = dkv_mma_smem_bytes<D>();
      static_assert(dq_bytes <= 232448 && dkv_bytes <= 232448, "227 KB of shared memory a block");
      static const cudaError_t attr_dq = cudaFuncSetAttribute(
          flash_bwd_dq_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
      static const cudaError_t attr_dkv = cudaFuncSetAttribute(
          flash_bwd_dkv_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
      if (attr_dq != cudaSuccess) return attr_dq;
      if (attr_dkv != cudaSuccess) return attr_dkv;
      flash_bwd_dq_mma<D><<<dim3(mma_rows, BH), MMA_THREADS, dq_bytes, stream>>>(
          qt, kt, vt, ot, dot, lse, static_cast<T*>(dq), dvec, a);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      flash_bwd_dkv_mma<D><<<dim3(mma_keys, BH), MMA_THREADS, dkv_bytes, stream>>>(
          qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), a);
      return cudaGetLastError();
    }
  }
  constexpr int BT = ffma_tile<D>();
  constexpr int dq_bytes = dq_smem_floats<D>() * sizeof(float);
  constexpr int dkv_bytes = dkv_smem_floats<D>() * sizeof(float);
  static_assert(dq_bytes <= 232448 && dkv_bytes <= 232448, "227 KB of shared memory a block");
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bwd_dkv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (attr_dq != cudaSuccess) return attr_dq;
  if (attr_dkv != cudaSuccess) return attr_dkv;
  flash_bwd_dq<T, D><<<dim3((R + BT - 1) / BT, BH), THREADS, dq_bytes, stream>>>(
      qt, kt, vt, ot, dot, lse, static_cast<T*>(dq), dvec, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv<T, D><<<dim3((a.Tkv + BT - 1) / BT, BH), THREADS, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), a);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int path, int D, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse, void* dq, void* dk,
                     void* dv, float* dvec, int BH, const Attn& a, cudaStream_t s) {
  switch (D) {  // path_fits: D alone names the pair (dv_of)
    case 16: return launch<T, 16>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    case 24: return launch<T, 24>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    case 32: return launch<T, 32>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    case 64: return launch<T, 64>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    case 80: return launch<T, 80>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    case 128: return launch<T, 128>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    case 192: return launch<T, 192>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    case 256: return launch<T, 256>(path, q, k, v, o, dout, lse, dq, dk, dv, dvec, BH, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients
// share it); lse and dvec float32, dvec (BH, G, Tq) scratch for Dv. (D, Dv),
// the head dims of q/k/dq/dk and of v/o/dO/dv: D = Dv in {16, 32, 64, 80,
// 128, 256}, or (192, 128), or on ffma (24, 16). path: 0 = mma (bf16, every
// tensor 16-byte aligned), 1 = ffma. Launches the dQ kernel, then the dK/dV kernel, on `stream`;
// returns the CUDA error of the launches (cudaErrorInvalidValue for a path
// the inputs cannot take), 0 when both launched.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* dvec, int BH,
                                          int G, int Tq, int Tkv, int D, int Dv, int dtype,
                                          int causal, int window, float softcap,
                                          int q_offset, float scale, int path, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (dtype < 0 || dtype > 1 || BH < 1 || G < 1 || Tq < 1 || Tkv < 1 ||
      !path_fits(path, dtype, D, Dv, (any & 15) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Attn a{G, Tq, Tkv, causal, window, softcap, q_offset, scale,
               softcap > 0.f ? scale / softcap : 0.f, (1ull << 32) / G + 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dvp = static_cast<float*>(dvec);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(path, D, q, k, v, o, dout, l, dq, dk, dv, dvp, BH, a, s)
          : dispatch<__nv_bfloat16>(path, D, q, k, v, o, dout, l, dq, dk, dv, dvp, BH, a, s);
  return static_cast<int>(err);
}
