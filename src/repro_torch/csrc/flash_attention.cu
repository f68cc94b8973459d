// Hopper flash_attention: causal GQA FlashAttention-2 forward with online
// softmax (m, l, acc in float32), scale 1/sqrt(DK), optional logit softcap
// tanh(s/c)*c, causal mask with q_offset, sliding window kv > q - window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// :: flash_attention (body _kernel). The TPU kernel walks KV blocks as the
// innermost sequential grid axis and keeps (m, l, acc) in VMEM scratch; here
// one block owns one (batch * kv-head, row tile) and loops over the KV tiles
// itself, carrying (m, l, acc) in registers.
//
// Layout: q (BH, G, Tq, DK), k (BH, Tkv, DK), v (BH, Tkv, DV), o (BH, G, Tq,
// DV); DK = DV but at MLA's (192, 128) and, on ffma only, the reduced
// deepseek config's (24, 16). The G query heads that
// share a KV head are folded into the row dimension as row = t * G + g, so a
// tile of 64 rows covers a contiguous run of query positions of all G heads:
// each K/V tile is loaded once into shared memory and serves all of them
// (GQA's point: K/V traffic divided by G), and G need not be a power of two
// (smollm_360m has G = 3).
//
// Two paths. The wrapper (kernels/flash_attention/kernel.py::choose_path)
// picks one from (dtype, D, alignment) and passes it in; a path the inputs
// cannot take returns cudaErrorInvalidValue, never another path.
//  * mma (bf16, 16-byte aligned q/k/v/o: every serving prefill). What bounds
//    it: causal prefill at smollm's shapes is about 4 GFLOP against 21 MB a
//    layer, so by the card's rates it is bound by bytes (about 6 us). On an
//    H100 it takes about 38 us of device time (probe_attention_scan.py):
//    a block's fixed cost (Q gather, first tile, output) is about 15 us of
//    it and each product 5-7 us, while the softmax and the K/V reloads from
//    L2 each move it by under 7%, and 128-row blocks or 128-key tiles were
//    slower. So it is bound by how fast ldmatrix feeds mma.sync (about 105
//    TFLOP/s of the attention's work); wgmma from shared memory, or two
//    16-row tiles a warp so each K/V fragment serves twice, is the next step.
//    Head dims 16, 32 and 64: both products on bf16
//    tensor cores (mma.sync.m16n8k16, float32 accumulate). A block of 4
//    warps owns 64 folded rows, 16 a warp; Q is gathered once with cp.async
//    (each folded row is a contiguous run of D values) and kept in
//    registers as A fragments (ldmatrix). K/V tiles of 64 keys stream
//    through a two-stage cp.async ring in padded shared memory (row stride
//    D + 8, so ldmatrix is free of bank conflicts: the stride is 16 bytes
//    past a multiple of 32 words for every D here, so the 8
//    row addresses of an ldmatrix start in 8 distinct 4-bank groups): the
//    next tile loads while this one is multiplied. K enters S = QK^T
//    through ldmatrix, V enters PV through ldmatrix.trans. The online
//    softmax runs on the S accumulators in registers (a row lives in a quad
//    of lanes: two shfl_xor for its max and sum), and P, rounded to bf16,
//    is the A fragment of PV as it stands: the m16n8 accumulator layout is
//    the m16n8k16 A layout, so P never goes through shared memory. Masks
//    are computed only on tiles that cross the causal diagonal, the window
//    edge or the Tkv tail; tiles outside the band are never loaded. Row
//    tiles are launched longest first (the causal band grows with the
//    row), and the output goes out through shared memory as 16-byte stores.
//    Head dim 256 (gemma3_12b) takes its own kernel, flash_fwd_wg256. What
//    bounds it: a global gemma3 layer's prefill, q (32, 2, 2048, 256)
//    causal, is 137.5 GFLOP against 201 MB, so operations (0.139 ms at the
//    card's 989 TFLOP/s); its output accumulator of 64 rows is 128 floats
//    a thread, so the design is a register budget. Both products are
//    wgmma: S = Q K^T (m64n64k16, 16 k-steps) with
//    Q and K in 128-byte-swizzled shared tiles (a 256-wide row is four
//    64-column atoms), and O += P V (m64n256k16) with P from registers (the
//    wgmma accumulator layout is its register-A layout) and V read MN-major.
//    A block owns 128 folded rows: warpgroup 0 is the producer (one thread
//    keeps a two-stage ring of 64-key K and V tiles full by TMA, a 3-D
//    tensor map (D, Tkv, BH) that zero-fills past Tkv, completion on
//    mbarriers), warpgroups 1 and 2 each own 64 rows, gather their Q by
//    cp.async (folded rows are one TMA box only where G divides them) and
//    share every K/V tile; setmaxnreg gives the consumers 240 registers a
//    thread for the 128-float accumulator, the producer 24. Each consumer
//    skips the tiles of the block's band that its own rows cannot see.
//    Shared memory: Q 64 KB, two stages of K and V 128 KB (193 KB in
//    all); 168 registers at entry. One rescale of the accumulator serves
//    64 keys. On an H100 (PERF.md) the global layer takes about 0.37 ms
//    (369 TFLOP/s).
//    Head dims 80 (h2o_danube_1_8b) and 128 (command_r_plus_104b) take
//    flash_fwd_wg<D, D>: the same producer and consumers, on tiles of boxes
//    (hopper.cuh's desc_kb / desc_mnb). A 160-byte D 80 row is no whole
//    number of 128-byte swizzle rows, so its tiles are five boxes of 16
//    columns under the 32-byte swizzle, which TMA writes and wgmma reads as
//    they stand (D 128: two 128-byte atoms; 32-byte boxes measured the same
//    there). What bounds them: danube's layer, q (16, 4, 8192, 80) with
//    window 4096, is 515 GFLOP against 210 MB, so operations (0.52 ms); at
//    D 80 its exponentials alone (one a score, 16 a clock an SM) hold the
//    special-function unit 0.44 ms, so the design overlaps them with the
//    tensor cores: a consumer issues S = Q K^T of tile j and O += P V of
//    tile j - 1 together and runs tile j's softmax under the latter (two P
//    buffers in registers; K and V released on barriers of their own), and
//    the scale is fused into the exponent where a tile has no mask. Three
//    consumers of 64 rows on 64-key tiles at D 80 (160 registers each after
//    setmaxnreg), two at D 128 (240; three spill). command_r's layer, q
//    (64, 12, 512, 128) causal, is 51.6 GFLOP against 218 MB, so bytes
//    (0.065 ms), but a block of 128 rows sees about four key tiles, so its
//    fixed cost (Q gather, the first tile's latency, the output) is most of
//    its time, and one block an SM hides none of it; two blocks an SM of one
//    consumer each measured no faster. On an H100 (PERF.md) danube's layer
//    takes about 1.39 ms (371 TFLOP/s), command_r's about 0.24 ms.
//    MLA's pair (deepseek_v2_lite_16b: q and k of head dim 192, v and o of
//    128) takes flash_fwd_wg<192, 128>, the D 128 kernel with Q and K rows of
//    three 128-byte atoms (S = Q K^T over 12 k-steps of m64n64k16) and V rows
//    of two (O += P V as m64n128k16): K and V have tensor maps of their own
//    widths and the producer expects a K tile's and a V tile's bytes apart.
//    Two consumers of 64 rows: Q 48 KB, a two-stage ring of K 48 KB and V
//    32 KB, and the 64-float accumulator of D 128. What bounds it: deepseek's
//    layer, q (128, 1, 1024, 192) causal, is 43.0 GFLOP against 168 MB, so
//    bytes (0.050 ms).
//  * ffma (float32, and bf16 the mma path cannot take, such as (24, 16)).
//    True float32 FFMA (never TF32) for the float32 parity runs: each thread keeps a 4-row x
//    8-key score tile and a 4-row x D/8 output tile in registers, reads Q
//    and K rows from padded (conflict-free) shared memory, and tiles outside
//    the causal/window band are never loaded. This was the first version of
//    the kernel; chip_smoke.py also times it in bf16 beside the mma path.
//
// Both paths also write each row's log-sum-exp, lse = m + log(l) (float32,
// (BH, G, Tq), natural log), when given a pointer for it: training keeps it
// for the backward kernels (csrc/flash_attention_bwd.cu), serving passes null.
//
// Masking reproduces the reference constants: masked scores are -1e30 (not
// -inf) and l is clamped at 1e-30. Ragged Tq and Tkv tails are masked. P is
// rounded to the input type before PV, as the reference casts p to v.dtype,
// and l sums the unrounded p, as the reference does. Deterministic: one
// block owns an output row, no atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;       // keys a KV tile holds
constexpr int ROWS = 64;     // ffma: (query position, head) rows a block owns
constexpr int THREADS = 128; // ffma: 16 row groups of 4 rows x 8 lanes
constexpr float NEG_INF = -1e30f;

enum Path { PATH_MMA = 0, PATH_FFMA = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// ffma: float32 FFMA (and bf16 inputs the mma path cannot take).
// ---------------------------------------------------------------------------
// Q and K rows of DK values, V and O rows of DV (DK = DV but at MLA's
// (192, 128) and (24, 16)).
template <int DK, int DV>
constexpr int smem_floats() {
  return ROWS * (DK + 1) + BK * (DK + 1) + BK * DV + ROWS * (BK + 1);
}

template <class T, int DK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_ffma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int G, int Tq, int Tkv, int causal,
          int window, float softcap, int q_offset, float scale) {
  constexpr int DJ = DV / 8;  // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                   // [ROWS][DK + 1]
  float* Ks = Qs + ROWS * (DK + 1);   // [BK][DK + 1]
  float* Vs = Ks + BK * (DK + 1);     // [BK][DV]
  float* Ps = Vs + BK * DV;           // [ROWS][BK + 1]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, r0 = blockIdx.x * ROWS;
  const int R = G * Tq;
  const T* qb = q + (size_t)bh * R * DK;
  const T* kb = k + (size_t)bh * Tkv * DK;
  const T* vb = v + (size_t)bh * Tkv * DV;
  T* ob = o + (size_t)bh * R * DV;

  for (int idx = tid; idx < ROWS * DK; idx += THREADS) {
    const int r = idx / DK, d = idx % DK, rr = r0 + r;
    float val = 0.f;
    if (rr < R) val = to_f(qb[((size_t)(rr % G) * Tq + rr / G) * DK + d]);
    Qs[r * (DK + 1) + d] = val;
  }

  // Query positions this tile covers, and the band of keys they can see.
  const int qmin = q_offset + r0 / G;
  const int qmax = q_offset + (min(R, r0 + ROWS) - 1) / G;
  const int kv_end = causal ? min(Tkv, qmax + 1) : Tkv;
  const int kv_begin = window > 0 ? max(0, qmin - window + 1) / BK * BK : 0;

  int qpos[4];
  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    qpos[i] = q_offset + (rr < R ? rr / G : 0);
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps are consumed; Qs is stored
    for (int idx = tid; idx < BK * DK; idx += THREADS) {
      const int c = idx / DK, d = idx % DK, kp = kv0 + c;
      Ks[c * (DK + 1) + d] = kp < Tkv ? to_f(kb[(size_t)kp * DK + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * DV; idx += THREADS) {
      const int c = idx / DV, d = idx % DV, kp = kv0 + c;
      Vs[c * DV + d] = kp < Tkv ? to_f(vb[(size_t)kp * DV + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      float qa[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * (DK + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = Ks[(tx + 8 * j) * (DK + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = kv0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kp < Tkv;
        if (causal) ok = ok && kp <= qpos[i];
        if (window > 0) ok = ok && kp > qpos[i] - window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 8 * j] = to_f(from_f<T>(p));
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l_i[i] = l_i[i] * corr + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row's P is written and read by the same 8 lanes

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * DV + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    if (rr >= R) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * R + (rr % G) * Tq + rr / G] = m_i[i] + logf(l);
    T* orow = ob + ((size_t)(rr % G) * Tq + rr / G) * DV;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 8 * j] = from_f<T>(acc[i][j] / l);
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 tensor cores, cp.async double buffering, P kept in registers.
// ---------------------------------------------------------------------------
constexpr int PAD = 8;  // bf16 elements past each shared row: 16 bytes
constexpr int MMA_WARPS = 4;               // 16 folded rows each
constexpr int MMA_ROWS = 16 * MMA_WARPS;   // rows a block owns
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes from global to shared; zero-filled when !in (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
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

template <int D>
constexpr int mma_smem_bytes() {
  return (MMA_ROWS + 4 * BK) * (D + PAD) * 2;  // Q, and two stages of K and V
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int G, int Tq, int Tkv, int causal, int window,
              float softcap, int q_offset, float scale) {
  constexpr int LD = D + PAD;   // shared row stride (elements)
  constexpr int KC = D / 16;    // k-steps of S = QK^T
  constexpr int DT = D / 8;     // 8-wide column tiles of the output (even: D % 16 == 0)
  constexpr int CPR = D / 8;    // 16-byte pieces of a row
  constexpr int NT = BK / 8;    // 8-key tiles of S
  static_assert(D % 16 == 0 && D <= 64, "k-steps of 16; D 80, 128, 256 take the wgmma kernels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MMA_ROWS][LD]
  __nv_bfloat16* Ks = Qs + MMA_ROWS * LD;                          // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                            // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MMA_ROWS;  // longest rows first
  const int R = G * Tq;
  const __nv_bfloat16* qb = q + (size_t)bh * R * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Tkv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tkv * D;
  __nv_bfloat16* ob = o + (size_t)bh * R * D;

  // Q: folded row rr is row rr / G of head rr % G, a contiguous run of D.
  // (The copy loops stay rolled: unrolled, they cost registers and spill at D = 16.)
#pragma unroll 1
  for (int i = tid; i < MMA_ROWS * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, rr = r0 + r;
    const bool in = rr < R;
    const __nv_bfloat16* src = in ? qb + ((size_t)(rr % G) * Tq + rr / G) * D + c : qb;
    cp_async16(smem_u32(Qs + r * LD + c), src, in);
  }

  // Query positions this tile covers, and the band of keys they can see.
  const int qmin = q_offset + r0 / G;
  const int qmax = q_offset + (min(R, r0 + MMA_ROWS) - 1) / G;
  const int kv_end = causal ? min(Tkv, qmax + 1) : Tkv;
  const int kv_begin = window > 0 ? max(0, qmin - window + 1) / BK * BK : 0;

  auto load_kv = [&](int kv0, int stage) {
    __nv_bfloat16* ks = Ks + stage * BK * LD;
    __nv_bfloat16* vs = Vs + stage * BK * LD;
#pragma unroll 1
    for (int i = tid; i < BK * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, kp = kv0 + r;
      const bool in = kp < Tkv;
      const size_t off = in ? (size_t)kp * D + c : 0;
      cp_async16(smem_u32(ks + r * LD + c), kb + off, in);
      cp_async16(smem_u32(vs + r * LD + c), vb + off, in);
    }
  };
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();

  // This thread's two rows: g and g + 8 of the warp's 16.
  const int wrow = warp * 16;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + wrow + g + 8 * h;
    qpos[h] = q_offset + (rr < R ? rr / G : 0);
  }
  // Q's A fragment of k-step kc (rows wrow .. wrow + 15, columns 16 kc ..).
  const uint32_t q_addr = smem_u32(Qs + (wrow + (lane & 15)) * LD + ((lane >> 4) << 3));
  uint32_t qf[KC][4];
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int stage = 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK, stage ^= 1) {
    if (kv0 + BK < kv_end) load_kv(kv0 + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed; the next stays in flight
    __syncthreads();
    if (kv0 == kv_begin) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) ldsm_x4(qf[kc], q_addr + kc * 32);
    }
    const __nv_bfloat16* ks = Ks + stage * BK * LD;
    const __nv_bfloat16* vs = Vs + stage * BK * LD;

    // S = Q K^T: 16 rows x BK keys a warp, NT 8-key tiles.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + ((lane >> 4) << 3) + (lane & 7);
        ldsm_x4(b, smem_u32(ks + key * LD + kc * 16 + (((lane >> 3) & 1) << 3)));
        mma_bf16(s[2 * np], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // Online softmax in the log2 domain; masks only where the tile needs them.
    const bool masked = kv0 + BK > Tkv || (causal && kv0 + BK - 1 > qmin) ||
                        (window > 0 && kv0 <= qmax - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x *= LOG2E;
        if (masked) {
          const int kp = kv0 + j * 8 + 2 * t4 + (e & 1);
          bool ok = kp < Tkv;
          if (causal) ok = ok && kp <= qpos[h];
          if (window > 0) ok = ok && kp > qpos[h] - window;
          if (!ok) x = NEG_INF;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    // P = exp(s - m), rounded to bf16 as the A fragments of PV: keys
    // 16 kc .. 16 kc + 15 are tiles 2 kc and 2 kc + 1.
    uint32_t pa[NT / 2][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - m_r[0]), p1 = exp2f(s[j][1] - m_r[0]);
      const float p2 = exp2f(s[j][2] - m_r[1]), p3 = exp2f(s[j][3] - m_r[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l_r[h] = l_r[h] * corr[h] + ps[h];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += P V: V enters as the col operand through ldmatrix.trans.
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc)
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        const int key = kc * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
        ldsm_x4_trans(b, smem_u32(vs + key * LD + dp * 16 + ((lane >> 4) << 3)));
        mma_bf16(acc[2 * dp], pa[kc], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa[kc], b[2], b[3]);
      }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // Q has landed even where the band held no tile

  // O = acc / l through the warp's own 16 rows of Qs, then 16-byte stores.
  __nv_bfloat16* os = Qs + wrow * LD;
  const float inv0 = 1.f / fmaxf(l_r[0], 1e-30f), inv1 = 1.f / fmaxf(l_r[1], 1e-30f);
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + wrow + g + 8 * h;
      if (rr < R)  // back from the log2 domain: ln 2 (m + log2 l)
        lse[(size_t)bh * R + (rr % G) * Tq + rr / G] =
            0.6931471805599453f * (m_r[h] + log2f(fmaxf(l_r[h], 1e-30f)));
    }
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(os + g * LD + c) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + c) =
        pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = (i % CPR) * 8, rr = r0 + wrow + r;
    if (rr < R)
      *reinterpret_cast<uint4*>(ob + ((size_t)(rr % G) * Tq + rr / G) * D + c) =
          *reinterpret_cast<const uint4*>(os + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// mma at D = 256 (gemma3_12b): wgmma, K/V by TMA, one producer warpgroup.
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 384;    // warpgroup 0 loads; 1 and 2 own 64 folded rows each
constexpr int WG_ROWS = 128;       // folded rows a block owns
constexpr int WG_STAGES = 2;       // K/V tiles in flight
constexpr int TILE256 = 4 * SW_ATOM;  // 64 rows x 256 columns: four atoms, 32 KB
// Q of both consumers, the K and V ring, its 3 x WG_STAGES mbarriers; alignment
constexpr int WG_SMEM = (2 + 2 * WG_STAGES) * TILE256 + 3 * WG_STAGES * 8 + 1024;

// One TMA box of `map` at (c0 innermost, c1, c2) into shared memory at
// `dst`; its bytes count toward the transactions `bar` expects.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Folded row rr of a (G, Tq, D) head block: row rr / G of head rr % G.
__device__ __forceinline__ size_t row_off(int rr, int G, int Tq) {
  return (size_t)(rr % G) * Tq + rr / G;
}

// Online softmax of the S of the tile of 64 keys at kv0, masked when
// `masked`: s[4j + 2h + e] is row 16 warp + g + 8h (query position qpos[h]),
// key kv0 + 8j + 2 t4 + e. In the log2 domain a score is s sl2 (sl2 = scale
// log2 e), the multiply fused into the exponent where no score of the tile
// is masked; under a softcap c it is tanh(s scale / c) c log2 e (scale_cap =
// scale / c). P = exp(s - m),
// rounded to bf16 as the register A operand of PV (the accumulator's 8-key
// groups 2kc and 2kc + 1 are the A fragment of k step kc); corr rescales the
// output accumulator, l sums the unrounded P.
__device__ __forceinline__ void fwd_softmax(float (&s)[32], uint32_t (&pf)[4][4],
                                            float (&m_r)[2], float (&l_r)[2], float (&corr)[2],
                                            bool masked, int kv0, int Tkv, int causal, int window,
                                            float softcap, float sl2, float scale_cap,
                                            const int (&qpos)[2], int t4) {
  float mul = sl2;
  if (softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = tanhf(s[i] * scale_cap) * (softcap * LOG2E);
    mul = 1.f;
  }
  float mx[2] = {NEG_INF, NEG_INF};
  if (masked) {  // scaled first: a masked score is NEG_INF in the log2 domain itself
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, kp = kv0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
      bool ok = kp < Tkv;
      if (causal) ok = ok && kp <= qpos[h];
      if (window > 0) ok = ok && kp > qpos[h] - window;
      s[i] = ok ? s[i] * mul : NEG_INF;
      mx[h] = fmaxf(mx[h], s[i]);
    }
    mul = 1.f;
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_r[h], mx[h] * mul);
    corr[h] = ex2(m_r[h] - m_new);
    m_r[h] = m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = ex2(fmaf(s[4 * j], mul, -m_r[0])), p1 = ex2(fmaf(s[4 * j + 1], mul, -m_r[0]));
    const float p2 = ex2(fmaf(s[4 * j + 2], mul, -m_r[1]));
    const float p3 = ex2(fmaf(s[4 * j + 3], mul, -m_r[1]));
    ps[0] += p0 + p1;
    ps[1] += p2 + p3;
    pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
    ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
    l_r[h] = l_r[h] * corr[h] + ps[h];
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wg256(const __grid_constant__ CUtensorMap tmap_k,
                const __grid_constant__ CUtensorMap tmap_v, const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int G, int Tq, int Tkv,
                int causal, int window, float softcap, int q_offset, float scale) {
  constexpr int D = 256;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  // Q of consumer c at base + c TILE256; K and V of stage st after both; then
  // the barriers: full_k, full_v (the producer's TMA), empty (the consumers).
  const uint32_t sK = base + 2 * TILE256, bars = base + (2 + 2 * WG_STAGES) * TILE256;
  auto k_of = [&](int st) { return sK + 2 * st * TILE256; };
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (WG_STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * WG_STAGES + st); };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.x, r0 = (gridDim.y - 1 - blockIdx.y) * WG_ROWS;  // longest first
  const int R = G * Tq;
  // Query positions the block covers, and the band of keys they can see.
  const int qmin = q_offset + r0 / G;
  const int qmax = q_offset + (min(R, r0 + WG_ROWS) - 1) / G;
  const int kv_end = causal ? min(Tkv, qmax + 1) : Tkv;
  const int kv_begin = window > 0 ? max(0, qmin - window + 1) / BK * BK : 0;
  const int ntile = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  if (tid == 0) {
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      for (int it = 0; it < ntile; ++it) {
        const int st = it % WG_STAGES, kv0 = kv_begin + BK * it;
        if (it >= WG_STAGES) mbar_wait(empty(st), ((it / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k(st), TILE256);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_load3(k_of(st) + c * SW_ATOM, &tmap_k, full_k(st), 64 * c, kv0, bh);
        mbar_expect_tx(full_v(st), TILE256);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_load3(k_of(st) + TILE256 + c * SW_ATOM, &tmap_v, full_v(st), 64 * c, kv0, bh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // Consumer c owns folded rows rw .. rw + 63 of the block.
  const int c = wg - 1, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = r0 + 64 * c;
  const uint32_t sQ = base + c * TILE256;
  const __nv_bfloat16* qb = q + (size_t)bh * R * D;
  // Thread t copies chunk t % 32 (16 bytes) of rows t / 32, t / 32 + 4, ...
  const int ch = t & 31;
#pragma unroll 1
  for (int r = t >> 5; r < 64; r += 4) {
    const int rr = rw + r;
    const bool in = rr < R;
    cp_async16(sQ + (ch >> 3) * SW_ATOM + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
               in ? qb + row_off(rr, G, Tq) * D + ch * 8 : qb, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  wg_sync(1 + c);

  // The band of this warpgroup's rows (empty when it has none): the tiles
  // it_lo .. it_hi - 1 of the block's band. The others are waited on and
  // released, not computed.
  const bool rows = rw < R;
  const int qmin_w = q_offset + rw / G, qmax_w = q_offset + (min(R, rw + 64) - 1) / G;
  const int end_w = !rows ? 0 : causal ? min(Tkv, qmax_w + 1) : Tkv;
  const int begin_w = window > 0 ? max(0, qmin_w - window + 1) : 0;
  const int it_hi = max(0, min(ntile, (end_w - kv_begin + BK - 1) / BK));
  const int it_lo = min(it_hi, max(0, (begin_w - kv_begin) / BK));
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = rw + 16 * warp + g + 8 * h;
    qpos[h] = q_offset + (rr < R ? rr / G : 0);
  }
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f}, corr[2];
  const float sl2 = scale * LOG2E, scale_cap = softcap > 0.f ? __fdividef(scale, softcap) : 0.f;
  float s[32], acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t pf[4][4];

  // Tile it: S = Q K^T, its softmax and the rescale of acc, then acc += P V
  // (V read MN-major, k = key, n = all 256 columns). Overlapping one tile's
  // softmax with the last one's PV in the same warpgroup was slower
  // (ptxas serializes the wgmmas around the softmax's reads); the two
  // consumers' tiles overlap instead.
  for (int it = 0; it < ntile; ++it) {
    const int st = it % WG_STAGES, kv0 = kv_begin + BK * it;
    const uint32_t par = (it / WG_STAGES) & 1;
    mbar_wait(full_k(st), par);
    if (it < it_lo || it >= it_hi) {  // released only once it has landed
      mbar_wait(full_v(st), par);
      if (lane == 0) mbar_arrive(empty(st));
      continue;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) wgmma_ss(s, desc_k256(sQ, kk), desc_k256(k_of(st), kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    // masks only where the tile crosses the Tkv tail, the causal diagonal or
    // the window edge of this warpgroup's rows
    const bool masked = kv0 + BK > Tkv || (causal && kv0 + BK - 1 > qmin_w) ||
                        (window > 0 && kv0 <= qmax_w - window);
    fwd_softmax(s, pf, m_r, l_r, corr, masked, kv0, Tkv, causal, window, softcap, sl2, scale_cap,
                qpos, t4);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] *= corr[(i >> 1) & 1];
    mbar_wait(full_v(st), par);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs256(acc, pf[kc], desc_mn256(k_of(st) + TILE256, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(pf);
    if (lane == 0) mbar_arrive(empty(st));
  }

  // O = acc / l through this warpgroup's Q tile (64 rows of 512 bytes, the
  // 16-byte chunks of a row XOR-swizzled by row), a warp its own 16 rows,
  // then 16-byte stores.
  const float inv[2] = {1.f / fmaxf(l_r[0], 1e-30f), 1.f / fmaxf(l_r[1], 1e-30f)};
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = rw + 16 * warp + g + 8 * h;
      if (rr < R)  // back from the log2 domain: ln 2 (m + log2 l)
        lse[(size_t)bh * R + row_off(rr, G, Tq)] =
            0.6931471805599453f * (m_r[h] + log2f(fmaxf(l_r[h], 1e-30f)));
    }
  }
  fence_proxy_async();  // the wgmma reads of Q are done before it is overwritten
  unsigned char* os = gbase + c * TILE256;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      *reinterpret_cast<uint32_t*>(os + r * 512 + ((j ^ (r & 7)) << 4) + 4 * t4) =
          pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
    }
  __syncwarp();
  __nv_bfloat16* ob = o + (size_t)bh * R * D;
#pragma unroll 4
  for (int i = lane; i < 16 * 32; i += 32) {
    const int r = 16 * warp + (i >> 5), ch = i & 31, rr = rw + r;
    if (rr < R)
      *reinterpret_cast<uint4*>(ob + row_off(rr, G, Tq) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(os + r * 512 + ((ch ^ (r & 7)) << 4));
  }
}

// ---------------------------------------------------------------------------
// mma at D = 80 and 128 (h2o_danube_1_8b, command_r_plus_104b) and at MLA's
// (192, 128) (deepseek_v2_lite_16b): the D = 256 kernel's producer and
// consumers, on tiles of boxes (hopper.cuh's desc_kb / desc_mnb) that TMA
// fills with the box's swizzle.
// ---------------------------------------------------------------------------
// Per head-dim pair (DK of q and k, DV of v and o; equal but at MLA's
// (192, 128)): consumer warpgroups of 64 folded rows (NC) and the bytes of
// a box row (SWB: 128 where a row is whole 64-column atoms; 32 at D = 80,
// whose 160-byte rows are five 32-byte boxes). K/V tiles of BK keys in a
// ring of WG_STAGES, as at D = 256.
template <int DK, int DV> struct FwdWg;
template <> struct FwdWg<80, 80> { static constexpr int NC = 3, SWB = 32; };
template <> struct FwdWg<128, 128> { static constexpr int NC = 2, SWB = 128; };
template <> struct FwdWg<192, 128> { static constexpr int NC = 2, SWB = 128; };
// Registers a consumer thread takes once the producer warpgroup has given up
// all but 24 of its own: the block's registers at launch (the most one block
// of its threads may have, in units of 8) shared out again (setmaxnreg: a
// multiple of 8, here at most 240).
template <int DK, int DV>
__host__ __device__ constexpr int fwd_consumer_regs() {
  constexpr int NC = FwdWg<DK, DV>::NC;
  const int threads = 128 * (NC + 1), entry = 65536 / threads / 8 * 8;
  const int r = (threads * entry - 128 * 24) / (128 * NC) / 8 * 8;
  return r < 240 ? r : 240;
}

// Q of every consumer, the K/V ring, its 4 x WG_STAGES mbarriers; alignment.
template <int DK, int DV>
__host__ __device__ constexpr int fwd_wg_smem() {
  return FwdWg<DK, DV>::NC * 64 * DK * 2 + WG_STAGES * BK * (DK + DV) * 2 + 4 * WG_STAGES * 8 +
         1024;
}

template <int DK, int DV>
__global__ void __launch_bounds__(128 * (FwdWg<DK, DV>::NC + 1), 1)
flash_fwd_wg(const __grid_constant__ CUtensorMap tmap_k, const __grid_constant__ CUtensorMap tmap_v,
             const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int G, int Tq, int Tkv, int causal, int window,
             float softcap, int q_offset, float scale) {
  constexpr int NC = FwdWg<DK, DV>::NC, SWB = FwdWg<DK, DV>::SWB, STAGES = WG_STAGES;
  constexpr int ROWS = 64 * NC;    // folded rows a block owns
  constexpr int QT = 64 * DK * 2;  // bytes of a consumer's Q tile (its O tile at the end)
  constexpr int KT = BK * DK * 2;  // bytes of a K tile
  constexpr int VT = BK * DV * 2;  // bytes of a V tile
  constexpr int BOX = SWB / 2;     // columns a box holds
  constexpr int CPR = DK / 8;      // 16-byte chunks a Q row
  constexpr int CPO = DV / 8;      // 16-byte chunks an O row
  static_assert(DK % BOX == 0 && DV % BOX == 0 && DV <= DK, "whole boxes; O fits Q's tile");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  // Q of consumer c at base + c QT; K and V of stage st after them; then the
  // barriers: full_k, full_v (the producer's TMA), empty_k, empty_v (the
  // consumers: K is released once S is formed, V once P V is).
  const uint32_t sK = base + NC * QT, bars = sK + STAGES * (KT + VT);
  auto k_of = [&](int st) { return sK + st * (KT + VT); };
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (STAGES + st); };
  auto empty_k = [&](int st) { return bars + 8 * (2 * STAGES + st); };
  auto empty_v = [&](int st) { return bars + 8 * (3 * STAGES + st); };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.x, r0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest first
  const int R = G * Tq;
  // Query positions the block covers, and the band of keys they can see.
  const int qmin = q_offset + r0 / G;
  const int qmax = q_offset + (min(R, r0 + ROWS) - 1) / G;
  const int kv_end = causal ? min(Tkv, qmax + 1) : Tkv;
  const int kv_begin = window > 0 ? max(0, qmin - window + 1) / BK * BK : 0;
  const int ntile = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 4 * NC);  // one arrival per consumer warp
      mbar_init(empty_v(st), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      for (int it = 0; it < ntile; ++it) {
        const int st = it % STAGES, kv0 = kv_begin + BK * it;
        const uint32_t par = ((it / STAGES) & 1) ^ 1;
        if (it >= STAGES) mbar_wait(empty_k(st), par);
        mbar_expect_tx(full_k(st), KT);
#pragma unroll
        for (int b = 0; b < DK / BOX; ++b)
          tma_load3(k_of(st) + b * BK * SWB, &tmap_k, full_k(st), BOX * b, kv0, bh);
        if (it >= STAGES) mbar_wait(empty_v(st), par);
        mbar_expect_tx(full_v(st), VT);
#pragma unroll
        for (int b = 0; b < DV / BOX; ++b)
          tma_load3(k_of(st) + KT + b * BK * SWB, &tmap_v, full_v(st), BOX * b, kv0, bh);
      }
    }
    return;
  }
  // the consumers share what the producer gave up
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(fwd_consumer_regs<DK, DV>())
               : "memory");

  // Consumer c owns folded rows rw .. rw + 63 of the block.
  const int c = wg - 1, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = r0 + 64 * c;
  const uint32_t sQ = base + c * QT;
  const __nv_bfloat16* qb = q + (size_t)bh * R * DK;
#pragma unroll 1
  for (int i = t; i < 64 * CPR; i += 128) {
    const int r = i / CPR, ch = i % CPR, rr = rw + r;
    const bool in = rr < R;
    cp_async16(sw_chunk_b<SWB, 64>(sQ, r, ch), in ? qb + row_off(rr, G, Tq) * DK + ch * 8 : qb,
               in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  wg_sync(1 + c);

  // The band of this warpgroup's rows (empty when it has none): the tiles
  // it_lo .. it_hi - 1 of the block's band. The others are waited on and
  // released, not computed.
  const bool rows = rw < R;
  const int qmin_w = q_offset + rw / G, qmax_w = q_offset + (min(R, rw + 64) - 1) / G;
  const int end_w = !rows ? 0 : causal ? min(Tkv, qmax_w + 1) : Tkv;
  const int begin_w = window > 0 ? max(0, qmin_w - window + 1) : 0;
  const int it_hi = max(0, min(ntile, (end_w - kv_begin + BK - 1) / BK));
  const int it_lo = min(it_hi, max(0, (begin_w - kv_begin) / BK));
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = rw + 16 * warp + g + 8 * h;
    qpos[h] = q_offset + (rr < R ? rr / G : 0);
  }
  const float sl2 = scale * LOG2E, scale_cap = softcap > 0.f ? __fdividef(scale, softcap) : 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f}, corr[2];
  float s[32], acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  uint32_t pa[4][4], pb[4][4];  // P of the last tile and of this one, in turn

  auto release = [&](int it) {  // a tile this warpgroup does not compute
    const int st = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    mbar_wait(full_k(st), par);
    mbar_wait(full_v(st), par);
    if (lane == 0) {
      mbar_arrive(empty_k(st));
      mbar_arrive(empty_v(st));
    }
  };
  // S = Q K^T of tile it (m64n64, DK / 16 k-steps), issued, not waited on.
  auto issue_s = [&](int it) {
    const int st = it % STAGES;
    mbar_wait(full_k(st), (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss(s, desc_kb<SWB, 64>(sQ, kk), desc_kb<SWB, BK>(k_of(st), kk), kk);
    wgmma_commit();
  };
  // acc += P V of tile it (m64n<DV>, V read MN-major), issued, not waited on.
  auto issue_pv = [&](int it, uint32_t(&pf)[4][4]) {
    const int st = it % STAGES;
    mbar_wait(full_v(st), (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs_n<DV>(acc, pf[kc], desc_mnb<SWB, BK>(k_of(st) + KT, kc));
    wgmma_commit();
  };
  // The softmax of tile it's S, once formed; K is released. Masks only where
  // the tile crosses the Tkv tail, the causal diagonal or the window edge of
  // this warpgroup's rows.
  auto softmax = [&](int it, uint32_t(&pf)[4][4]) {
    fence_acc(s);
    if (lane == 0) mbar_arrive(empty_k(it % STAGES));
    const int kv0 = kv_begin + BK * it;
    const bool masked = kv0 + BK > Tkv || (causal && kv0 + BK - 1 > qmin_w) ||
                        (window > 0 && kv0 <= qmax_w - window);
    fwd_softmax(s, pf, m_r, l_r, corr, masked, kv0, Tkv, causal, window, softcap, sl2, scale_cap,
                qpos, t4);
  };
  // Tile it after the first: its S is formed while the last tile's P V runs,
  // its softmax runs under that P V, then acc is rescaled.
  auto step = [&](int it, uint32_t(&last)[4][4], uint32_t(&next)[4][4]) {
    issue_s(it);
    issue_pv(it - 1, last);
    wgmma_wait<1>();
    softmax(it, next);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(last);
    if (lane == 0) mbar_arrive(empty_v((it - 1) % STAGES));
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
  };

  for (int it = 0; it < it_lo; ++it) release(it);
  if (it_lo < it_hi) {
    issue_s(it_lo);
    wgmma_wait<0>();
    softmax(it_lo, pa);  // acc is zero: no rescale
    int it = it_lo + 1;
    for (; it + 1 < it_hi; it += 2) {
      step(it, pa, pb);
      step(it + 1, pb, pa);
    }
    const bool in_b = it < it_hi;  // one tile left: its P goes to pb
    if (in_b) step(it, pa, pb);
    if (in_b) issue_pv(it_hi - 1, pb); else issue_pv(it_hi - 1, pa);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(pa);
    fence_frags(pb);
    if (lane == 0) mbar_arrive(empty_v((it_hi - 1) % STAGES));
  }
  for (int it = max(it_lo, it_hi); it < ntile; ++it) release(it);

  // O = acc / l through this warpgroup's Q tile (in its box layout), a warp
  // its own 16 rows, then 16-byte stores.
  const float inv[2] = {__fdividef(1.f, fmaxf(l_r[0], 1e-30f)),
                        __fdividef(1.f, fmaxf(l_r[1], 1e-30f))};
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = rw + 16 * warp + g + 8 * h;
      if (rr < R)  // back from the log2 domain: ln 2 (m + log2 l)
        lse[(size_t)bh * R + row_off(rr, G, Tq)] =
            0.6931471805599453f * (m_r[h] + log2f(fmaxf(l_r[h], 1e-30f)));
    }
  }
  fence_proxy_async();  // the wgmma reads of Q are done before it is overwritten
  unsigned char* os = gbase + c * QT;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      *reinterpret_cast<uint32_t*>(os + sw_chunk_b<SWB, 64>(0, r, j) + 4 * t4) =
          pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
    }
  __syncwarp();
  __nv_bfloat16* ob = o + (size_t)bh * R * DV;
#pragma unroll 2
  for (int i = lane; i < 16 * CPO; i += 32) {
    const int r = 16 * warp + i / CPO, ch = i % CPO, rr = rw + r;
    if (rr < R)
      *reinterpret_cast<uint4*>(ob + row_off(rr, G, Tq) * DV + ch * 8) =
          *reinterpret_cast<const uint4*>(os + sw_chunk_b<SWB, 64>(0, r, ch));
  }
}

// ---------------------------------------------------------------------------
// Host side of the wgmma kernels: K and V as TMA tensor maps.
// ---------------------------------------------------------------------------
// A (BH, Tkv, D) bf16 tensor in boxes of `rows` keys x `cols` columns of one
// BH, swizzled over the box's 2 cols bytes (128 or 32); keys past Tkv fill
// with zeros. Binds the thread's context first: the encoder fails on a
// thread with none.
bool encode_keys(CUtensorMap* map, const void* ptr, int BH, int Tkv, int D, int cols, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  bind_context();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Tkv),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(Tkv) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wg256(const void* q, const void* k, const void* v, void* o, float* lse,
                         int BH, int G, int Tq, int Tkv, int causal, int window, float softcap,
                         int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!encode_keys(&tk, k, BH, Tkv, 256, 64, 64) || !encode_keys(&tv, v, BH, Tkv, 256, 64, 64))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wg256, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (attr != cudaSuccess) return attr;
  // grid y: row blocks longest first, over every BH before the next
  const dim3 grid(BH, (G * Tq + WG_ROWS - 1) / WG_ROWS);
  flash_fwd_wg256<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), lse, G, Tq,
      Tkv, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                      int G, int Tq, int Tkv, int causal, int window, float softcap,
                      int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = fwd_wg_smem<DK, DV>(), NC = FwdWg<DK, DV>::NC;
  constexpr int cols = FwdWg<DK, DV>::SWB / 2;
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
  CUtensorMap tk, tv;
  if (!encode_keys(&tk, k, BH, Tkv, DK, cols, BK) || !encode_keys(&tv, v, BH, Tkv, DV, cols, BK))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wg<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  // grid y: row blocks longest first, over every BH before the next
  const dim3 grid(BH, (G * Tq + 64 * NC - 1) / (64 * NC));
  flash_fwd_wg<DK, DV><<<grid, 128 * (NC + 1), bytes, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), lse, G, Tq,
      Tkv, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------
// The head dims of q/k (DK) and v/o (DV) a kernel takes: DK = DV in {16, 32,
// 64, 80, 128, 256}, or MLA's (192, 128) (deepseek_v2_lite_16b's prefill);
// ffma also takes (24, 16), its reduced config's.
bool dims_ok(int DK, int DV) {
  if (DK == 192) return DV == 128;
  return DK == DV && (DK == 16 || DK == 32 || DK == 64 || DK == 80 || DK == 128 || DK == 256);
}

bool path_fits(int path, int dtype, int DK, int DV, bool aligned) {
  switch (path) {
    case PATH_MMA: return dims_ok(DK, DV) && dtype == 1 && aligned;
    case PATH_FFMA:
      return (dims_ok(DK, DV) || (DK == 24 && DV == 16)) && (dtype == 0 || dtype == 1);
    default: return false;
  }
}

template <class T, int DK, int DV>
cudaError_t launch(int path, const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int G, int Tq, int Tkv, int causal, int window,
                   float softcap, int q_offset, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && DK == 256) {
    if (path == PATH_MMA)
      return launch_wg256(q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset,
                          scale, stream);
  } else if constexpr (sizeof(T) == 2 && (DK == 80 || DK == 128 || DK == 192)) {
    if (path == PATH_MMA)
      return launch_wg<DK, DV>(q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap,
                               q_offset, scale, stream);
  } else if constexpr (sizeof(T) == 2 && DK == DV && DK % 16 == 0) {
    if (path == PATH_MMA) {
      dim3 grid((G * Tq + MMA_ROWS - 1) / MMA_ROWS, BH);
      constexpr int bytes = mma_smem_bytes<DK>();
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_mma<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      flash_fwd_mma<DK><<<grid, MMA_THREADS, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(o), lse, G, Tq, Tkv, causal, window, softcap, q_offset, scale);
      return cudaGetLastError();
    }
  }
  constexpr size_t bytes = smem_floats<DK, DV>() * sizeof(float);
  dim3 grid((G * Tq + ROWS - 1) / ROWS, BH);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_ffma<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_ffma<T, DK, DV><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, G, Tq, Tkv, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int path, int DK, int DV, const void* q, const void* k, const void* v,
                     void* o, float* lse, int BH, int G, int Tq, int Tkv, int causal, int window,
                     float softcap, int q_offset, float scale, cudaStream_t s) {
  if (DK != DV) {  // path_fits: MLA's (192, 128), or (24, 16) on ffma
    return DK == 192
        ? launch<T, 192, 128>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s)
        : launch<T, 24, 16>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
  }
  switch (DK) {
    case 16: return launch<T, 16, 16>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 32: return launch<T, 32, 32>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 64: return launch<T, 64, 64>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 80: return launch<T, 80, 80>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 128: return launch<T, 128, 128>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 256: return launch<T, 256, 256>(path, q, k, v, o, lse, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. (DK, DV), the head dims of q/k and
// of v/o: DK = DV in {16, 32, 64, 80, 128, 256}, or (192, 128), or (24, 16)
// on ffma. path: 0 =
// mma (bf16, q/k/v/o 16-byte aligned), 1 = ffma. lse: float32 (BH, G, Tq)
// or null. Returns the CUDA error of the launch (cudaErrorInvalidValue for a
// path the inputs cannot take); 0 means launched.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int BH, int G, int Tq, int Tkv, int DK, int DV,
                                      int dtype, int causal, int window, float softcap,
                                      int q_offset, float scale, int path, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
                        15) == 0;
  if (!path_fits(path, dtype, DK, DV, aligned)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = dtype == 0
      ? dispatch<float>(path, DK, DV, q, k, v, o, l, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s)
      : dispatch<__nv_bfloat16>(path, DK, DV, q, k, v, o, l, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
  return static_cast<int>(err);
}
