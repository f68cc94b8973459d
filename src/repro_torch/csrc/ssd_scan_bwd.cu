// Hopper ssd_scan_bwd: the gradient of the Mamba-2 SSD chunked scan
// (csrc/ssd_scan.cu). For each (batch, head), with the forward's chunks of
// Q = 64 steps, cum = cumsum(dt a) over the chunk, L[i][j] = exp(cum_i -
// cum_j) for j <= i (else 0), ein = exp(cum), eout = exp(cum_Q - cum), the
// chunk's entry state S (N, P) and G, the gradient of its exit state, the
// chunks are walked backward in time:
//   x_bar  = dt o ((C B^T o L)^T Y_bar + eout o (B G)) + d Y_bar
//   Bt     = (Y_bar X^T o L)^T C + eout o (X G^T)        (B_bar = dt o Bt)
//   C_bar  = (Y_bar X^T o L o dt_j) B + ein o (Y_bar S^T)
//   G     <- exp(cum_Q) G + (C o ein)^T Y_bar            (the entry's gradient)
//   cum_bar_i = c_i . C_bar_i - dt_i (b_i . Bt_i) + [i = Q - 1] <G_exit, S_exit>
//   dA_s   = sum_{i >= s} cum_bar_i                      (reverse cumsum)
//   dt_bar = b . Bt + a dA,  a_bar += sum_s dt_s dA_s,   d_bar += sum Y_bar . X
// The scalar terms come from row dots of the chunk's own outputs (c . C_bar
// carries the intra-chunk and entry-state terms of cum_bar, b . Bt the
// exit-state ones) and <G, S> at the chunk's exit carries exp(cum_Q)'s, so
// no exponential of a negative cum and no division by dt or by a decay is
// ever formed. All sums in float32.
//
// Replaces the gradient of the Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py :: ssd_scan, which has none: the
// reference differentiates its plain ssd_chunked (src/repro/models/mamba2.py)
// with XLA. The plain version is kernels/ssd_scan/ref.py ::
// ssd_scan_bwd_ref, the adjoint of the per-timestep recurrence.
//
// Chunk states: the backward walk reads the state entering each chunk (and
// the final state) from a float32 (Bt, H, nc + 1, N, P), which the forward
// writes when asked (csrc/ssd_scan.cu, chunk_states), as the
// autograd.Function does. probe_ssd_states.py measures the other way, a
// variant of this kernel that first rebuilds them in the block.
//
// Layout: the forward's. x, dy, dx (Bt, T, H, P); dt, dt_bar (Bt, T, H)
// float32; a, d (H,) float32; B, C, B_bar, C_bar (Bt, T, G, N) with head h
// in group h / (H / G); the final-state gradient (Bt, H, N, P) float32 or
// null. Any T: steps past T load as zero with dt = 0, as in the forward, and
// are not stored.
//
// Deterministic, no atomics: a block owns one (batch, head) and all of P, so
// nothing is split over blocks but the sums over heads and batch. A block
// writes its head's B_bar (as Bt, before the dt factor) and C_bar as float32
// partials (Bt, T, H, N), and its a_bar and d_bar as (Bt, H) partials; a
// second kernel sums the heads of each group in a fixed order (and applies
// dt), and the wrapper sums the batch with torch.sum.
//
// What bounds it on an H100: at mamba2_2_7b's training shape (Bt 8, T 512,
// H 80, P 64, N 128, bf16) the function reads x, dy, B, C and dt and writes
// dx, B_bar, C_bar and dt_bar, about 132 MB (153 MB with a state gradient):
// 0.040 ms at 3.35 TB/s. Its own work, the recurrence's adjoint (a step:
// G's update, the x, b and c products, <G, h> and h rebuilt, 6 N P
// multiply-adds), is 32 GFLOP, 0.033 ms on bf16 tensor cores: bound by
// bytes. The chunked form does more (nine products a chunk, 48 GFLOP, about
// twice that again in mma.sync with the hi + lo pairs), and this first
// version reads every operand from shared memory a scalar at a time and
// holds one block an SM, so it is bound by shared-memory loads feeding
// mma.sync, far from either bound. Making it fast (ldmatrix fragments,
// register-resident G, one C B^T for the heads of a group) is later work.
//
// Two paths, as the forward. The wrapper (kernels/ssd_scan/kernel.py ::
// choose_path, the forward's rule) picks one and passes it in; a path the
// inputs cannot take returns cudaErrorInvalidValue, never another path.
//  * mma (bf16, N 64 or 128, P a multiple of 32, 16-byte aligned x, dy,
//    dx, B, C): every product on bf16 tensor cores (mma.sync.m16n8k16,
//    float32 accumulate), a warp a 16 x 32 tile. x, dy, B and C are exact
//    in bf16; every float32 operand (C B^T o L, Y_bar X^T o L, G, S, B o w,
//    C o ein) enters as a bf16 hi + lo pair (hi = bf16(v), lo = bf16(v -
//    hi)), as in the forward: one rounding of them costs a_bar about 40% of
//    its largest entry at small shapes, the pair about 1e-3.
//  * ffma (float32, and bf16 shapes the mma path cannot take): the same
//    walk with every product in true float32 FFMA, a thread a 4 x 4
//    micro-tile, for the 1e-3 parity runs.
// Both: 256 threads a block, one block an SM (shared memory 159 KB in
// bf16, 213 KB in float32 at N = 128, P = 64). Shared memory bounds P: at
// N = 128, mma takes P up to 96 and ffma in float32 P up to 64 (every
// Mamba-2 layer of the zoo has P = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // steps in a chunk, as the forward
constexpr int THREADS = 256;   // 8 warps; ffma: 16 x 16 threads, 4 x 4 each
constexpr int WARPS = THREADS / 32;
constexpr int FPAD = 4;        // floats past each float32 shared row: 16 bytes
constexpr int MAX_SMEM = 232448;

enum Path { PATH_MMA = 0, PATH_FFMA = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory of a block: float32 S, G [N][P + FPAD], C B^T o L and
// Y_bar X^T o L [Q][Q + FPAD], six [Q] vectors and the reduction slots;
// then X, Y_bar [Q][P + pad] and B, C [Q][N + pad] in T.
__host__ __device__ size_t smem_floats(int N, int P) {
  const size_t f = 2 * (size_t)N * (P + FPAD) + 2 * (size_t)Q * (Q + FPAD) + 6 * Q + 32;
  return (f + 3) / 4 * 4;
}
size_t smem_bytes(int N, int P, size_t tsize) {
  const size_t pad = 16 / tsize;
  return sizeof(float) * smem_floats(N, P) + tsize * (2 * (size_t)Q * (P + pad) +
                                                      2 * (size_t)Q * (N + pad));
}

// ---------------------------------------------------------------------------
// Products. out(r, c) for r < R, c < CN is handed to epi(r, c, v1, v2) with
// v1 = sum_{k < K1} a1(r, k) b1(k, c) and v2 = sum_{k < K2} a2(r, k) b2(k, c)
// (K2 = 0 for a single product). Each output element has one owner thread,
// so an epilogue may update it in place.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (the first in the low half), and with SPLIT the
// pair of what that rounding left: hi = bf16(v), lo = bf16(v - hi).
template <bool SPLIT>
__device__ __forceinline__ void pack(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  if constexpr (SPLIT) {
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// acc[j] += A[r0 .. r0 + 15][0 .. K) B[0 .. K)[c0 + 8 j .. c0 + 8 j + 7],
// j < 4, on the m16n8k16 fragments; a split operand adds the products of
// its lo half (hi hi + lo hi + hi lo when both are split).
template <bool SA, bool SB, class FA, class FB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], int r0, int c0, int K, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int ka = k0 + 2 * t4, kb = ka + 8;
    uint32_t ah[4], al[4];
    pack<SA>(a(ra, ka), a(ra, ka + 1), ah[0], al[0]);
    pack<SA>(a(rb, ka), a(rb, ka + 1), ah[1], al[1]);
    pack<SA>(a(ra, kb), a(ra, kb + 1), ah[2], al[2]);
    pack<SA>(a(rb, kb), a(rb, kb + 1), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 8 * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      pack<SB>(b(ka, col), b(ka + 1, col), bh0, bl0);
      pack<SB>(b(kb, col), b(kb + 1, col), bh1, bl1);
      mma_bf16(acc[j], ah, bh0, bh1);
      if constexpr (SA) mma_bf16(acc[j], al, bh0, bh1);
      if constexpr (SB) mma_bf16(acc[j], ah, bl0, bl1);
    }
  }
}

template <bool MMA, bool SA1, bool SB1, bool SA2, bool SB2, class A1, class B1, class A2,
          class B2, class Epi>
__device__ __forceinline__ void product(int R, int CN, int K1, A1 a1, B1 b1, int K2, A2 a2,
                                        B2 b2, Epi epi) {
  const int tid = threadIdx.x;
  if constexpr (MMA) {
    // A warp a 16 x 32 tile (R a multiple of 16, CN of 32).
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int tiles_c = CN / 32, tiles = (R / 16) * tiles_c;
    for (int tile = tid >> 5; tile < tiles; tile += WARPS) {
      const int r0 = (tile / tiles_c) * 16, c0 = (tile % tiles_c) * 32;
      float acc1[4][4] = {}, acc2[4][4] = {};
      mma_tile<SA1, SB1>(acc1, r0, c0, K1, a1, b1);
      if (K2 > 0) mma_tile<SA2, SB2>(acc2, r0, c0, K2, a2, b2);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          epi(r0 + g + (e >> 1) * 8, c0 + 8 * j + 2 * t4 + (e & 1), acc1[j][e], acc2[j][e]);
    }
  } else {
    // 16 x 16 threads, each a 4 x 4 micro-tile of each 64 x 64 output tile.
    const int ty = tid >> 4, tx = tid & 15;
    for (int r0 = 0; r0 < R; r0 += 64)
      for (int c0 = 0; c0 < CN; c0 += 64) {
        int rr[4], cc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rr[i] = min(r0 + ty + 16 * i, R - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) cc[j] = min(c0 + tx + 16 * j, CN - 1);
        float acc1[4][4] = {}, acc2[4][4] = {};
        for (int k = 0; k < K1; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = a1(rr[i], k);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b1(k, cc[j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(av[i], bv[j], acc1[i][j]);
        }
        for (int k = 0; k < K2; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = a2(rr[i], k);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b2(k, cc[j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(av[i], bv[j], acc2[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
            if (r < R && c < CN) epi(r, c, acc1[i][j], acc2[i][j]);
          }
      }
  }
}

// The block's sum of v, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// The backward walk: one block a (batch, head).
// ---------------------------------------------------------------------------
template <class T, bool MMA>
__global__ void __launch_bounds__(THREADS, 1)  // one block an SM: up to 255 registers
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ B, const T* __restrict__ C,
               const float* __restrict__ D, const T* __restrict__ dy,
               const float* __restrict__ dstate, T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ da_part, float* __restrict__ dd_part,
               float* __restrict__ dbp, float* __restrict__ dcp,
               const float* __restrict__ states, int T_len, int H, int G, int N, int P) {
  constexpr int PADT = 16 / (int)sizeof(T);  // elements past each row of T: 16 bytes
  const int LP = P + FPAD, LQ = Q + FPAD, LX = P + PADT, LB = N + PADT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ss = reinterpret_cast<float*>(smem_raw);  // [N][LP] entry state
  float* Gs = Ss + N * LP;                          // [N][LP] exit-state gradient
  float* CBs = Gs + N * LP;                         // [Q][LQ] C B^T o L
  float* DLs = CBs + Q * LQ;                        // [Q][LQ] Y_bar X^T o L
  float* dts = DLs + Q * LQ;                        // [Q] dt
  float* cum = dts + Q;                             // [Q] cumsum(dt a)
  float* ein = cum + Q;                             // [Q] exp(cum)
  float* eout = ein + Q;                            // [Q] exp(cum_Q - cum)
  float* cbar = eout + Q;                           // [Q] gradient of cum
  float* dtd = cbar + Q;                            // [Q] b . Bt
  float* red = dtd + Q;                             // [32] block_sum slots
  T* Xs = reinterpret_cast<T*>(reinterpret_cast<float*>(smem_raw) + smem_floats(N, P));
  T* Ys = Xs + Q * LX;  // [Q][LX] Y_bar
  T* Bs = Ys + Q * LX;  // [Q][LB]
  T* Cs = Bs + Q * LB;  // [Q][LB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, grp = h / (H / G);
  const float a = A[h], dskip = D[h];
  const int nc = (T_len + Q - 1) / Q;
  const size_t xstep = (size_t)H * P, bstep = (size_t)G * N, pstep = (size_t)H * N;
  const size_t xoff = (size_t)b * T_len * xstep + (size_t)h * P;
  const size_t boff = (size_t)b * T_len * bstep + (size_t)grp * N;
  const size_t poff = (size_t)b * T_len * pstep + (size_t)h * N;
  const float* dtb = dt + (size_t)b * T_len * H + h;
  float* ddtb = ddt + (size_t)b * T_len * H + h;
  const float* st = states + (size_t)bh * (nc + 1) * N * P;

  // The chunk at t0: X, Y_bar, B, C and dt; steps past T are zero.
  auto load = [&](int t0) {
    for (int i = tid; i < Q * P; i += THREADS) {
      const int r = i / P, c = i - r * P, t = t0 + r;
      const bool in = t < T_len;
      Xs[r * LX + c] = in ? x[xoff + (size_t)t * xstep + c] : from_f<T>(0.f);
      Ys[r * LX + c] = in ? dy[xoff + (size_t)t * xstep + c] : from_f<T>(0.f);
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, c = i - r * N, t = t0 + r;
      const bool in = t < T_len;
      Bs[r * LB + c] = in ? B[boff + (size_t)t * bstep + c] : from_f<T>(0.f);
      Cs[r * LB + c] = in ? C[boff + (size_t)t * bstep + c] : from_f<T>(0.f);
    }
    if (tid < Q) dts[tid] = t0 + tid < T_len ? dtb[(size_t)(t0 + tid) * H] : 0.f;
  };
  // cum, ein, eout of the loaded chunk: warp 0, two steps a lane, a scan.
  auto scan = [&]() {
    if (warp == 0) {
      const float a0 = dts[2 * lane] * a, a1 = dts[2 * lane + 1] * a;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = c0 + a1;
      const float total = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ein[2 * lane] = expf(c0);
      ein[2 * lane + 1] = expf(c1);
      eout[2 * lane] = expf(total - c0);
      eout[2 * lane + 1] = expf(total - c1);
    }
  };
  auto none = [](int, int) { return 0.f; };

  // 1. Chunk entry states: states[c] is chunk c's, states[nc] the final one.
  {
    const float* fin = st + (size_t)nc * N * P;
    for (int i = tid; i < N * P; i += THREADS) Ss[(i / P) * LP + i % P] = fin[i];
  }
  for (int i = tid; i < N * P; i += THREADS)
    Gs[(i / P) * LP + i % P] = dstate ? dstate[(size_t)bh * N * P + i] : 0.f;
  __syncthreads();

  float dd_acc = 0.f, da_acc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * Q;
    // 2. <G, S> at the chunk's exit: Ss still holds the exit state.
    float part = 0.f;
    for (int i = tid; i < N * P; i += THREADS) {
      const int o = (i / P) * LP + i % P;
      part = fmaf(Gs[o], Ss[o], part);
    }
    const float gs = block_sum(part, red);
    load(t0);
    {
      const float* entry = st + (size_t)c * N * P;
      for (int i = tid; i < N * P; i += THREADS) Ss[(i / P) * LP + i % P] = entry[i];
    }
    __syncthreads();
    scan();
    __syncthreads();

    // 3. C B^T and Y_bar X^T, then both o L (zero above the diagonal).
    product<MMA, false, false, false, false>(
        Q, Q, N, [&](int i, int n) { return to_f(Cs[i * LB + n]); },
        [&](int n, int j) { return to_f(Bs[j * LB + n]); }, 0, none, none,
        [&](int i, int j, float v, float) { CBs[i * LQ + j] = v; });
    product<MMA, false, false, false, false>(
        Q, Q, P, [&](int i, int p) { return to_f(Ys[i * LX + p]); },
        [&](int p, int j) { return to_f(Xs[j * LX + p]); }, 0, none, none,
        [&](int i, int j, float v, float) { DLs[i * LQ + j] = v; });
    __syncthreads();
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e - i * Q;
      const float l = j <= i ? expf(cum[i] - cum[j]) : 0.f;
      CBs[i * LQ + j] *= l;
      DLs[i * LQ + j] *= l;
    }
    __syncthreads();
    if (tid < Q) dd_acc += DLs[tid * LQ + tid];  // L_ii = 1: the step's Y_bar . X

    // 4. x_bar, Bt and C_bar of the chunk's steps.
    product<MMA, true, false, false, true>(
        Q, P, Q, [&](int j, int i) { return CBs[i * LQ + j]; },
        [&](int i, int p) { return to_f(Ys[i * LX + p]); }, N,
        [&](int j, int n) { return to_f(Bs[j * LB + n]); },
        [&](int n, int p) { return Gs[n * LP + p]; },
        [&](int j, int p, float v1, float v2) {
          if (t0 + j < T_len)
            dx[xoff + (size_t)(t0 + j) * xstep + p] =
                from_f<T>(dts[j] * (v1 + eout[j] * v2) + dskip * to_f(Ys[j * LX + p]));
        });
    product<MMA, true, false, false, true>(
        Q, N, Q, [&](int j, int i) { return DLs[i * LQ + j]; },
        [&](int i, int n) { return to_f(Cs[i * LB + n]); }, P,
        [&](int j, int p) { return to_f(Xs[j * LX + p]); },
        [&](int p, int n) { return Gs[n * LP + p]; },
        [&](int j, int n, float v1, float v2) {
          if (t0 + j < T_len) dbp[poff + (size_t)(t0 + j) * pstep + n] = v1 + eout[j] * v2;
        });
    product<MMA, true, false, false, true>(
        Q, N, Q, [&](int i, int j) { return DLs[i * LQ + j] * dts[j]; },
        [&](int j, int n) { return to_f(Bs[j * LB + n]); }, P,
        [&](int i, int p) { return to_f(Ys[i * LX + p]); },
        [&](int p, int n) { return Ss[n * LP + p]; },
        [&](int i, int n, float v1, float v2) {
          if (t0 + i < T_len) dcp[poff + (size_t)(t0 + i) * pstep + n] = v1 + ein[i] * v2;
        });
    __syncthreads();  // Bt and C_bar stored; G read for the last time

    // 5. G <- exp(cum_Q) G + (C o ein)^T Y_bar, the entry state's gradient,
    //    and the row dots c_i . C_bar_i and b_i . Bt_i (a warp a row).
    const float decay = expf(cum[Q - 1]);
    product<MMA, true, false, false, false>(
        N, P, Q, [&](int n, int i) { return to_f(Cs[i * LB + n]) * ein[i]; },
        [&](int i, int p) { return to_f(Ys[i * LX + p]); }, 0, none, none,
        [&](int n, int p, float v, float) { Gs[n * LP + p] = decay * Gs[n * LP + p] + v; });
    for (int i = warp; i < Q; i += WARPS) {
      float cb = 0.f, bb = 0.f;
      if (t0 + i < T_len) {
        const float* cp = dcp + poff + (size_t)(t0 + i) * pstep;
        const float* bp = dbp + poff + (size_t)(t0 + i) * pstep;
        for (int n = lane; n < N; n += 32) {
          cb = fmaf(to_f(Cs[i * LB + n]), cp[n], cb);
          bb = fmaf(to_f(Bs[i * LB + n]), bp[n], bb);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        cb += __shfl_xor_sync(0xffffffffu, cb, o);
        bb += __shfl_xor_sync(0xffffffffu, bb, o);
      }
      if (lane == 0) {
        cbar[i] = cb - dts[i] * bb + (i == Q - 1 ? gs : 0.f);
        dtd[i] = bb;
      }
    }
    __syncthreads();

    // 6. dA = reverse cumsum of cum_bar (warp 0, two steps a lane), then
    //    dt_bar and this chunk's share of a_bar.
    if (warp == 0) {
      const float c0 = cbar[2 * lane], c1 = cbar[2 * lane + 1];
      float s = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, s, o);
        if (lane + o < 32) s += v;
      }
      float after = __shfl_down_sync(0xffffffffu, s, 1);
      if (lane == 31) after = 0.f;
      const float d1 = after + c1, d0 = d1 + c0;
      const int i0 = 2 * lane, i1 = i0 + 1;
      if (t0 + i0 < T_len) ddtb[(size_t)(t0 + i0) * H] = dtd[i0] + a * d0;
      if (t0 + i1 < T_len) ddtb[(size_t)(t0 + i1) * H] = dtd[i1] + a * d1;
      float v = dts[i0] * d0 + dts[i1] * d1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      da_acc += v;
    }
    __syncthreads();  // the next chunk overwrites the shared tiles
  }

  const float dd = block_sum(dd_acc, red);
  if (tid == 0) {
    dd_part[bh] = dd;
    da_part[bh] = da_acc;
  }
}

// B_bar = sum over the group's heads of dt o Bt, C_bar = sum of the C_bar
// partials, in head order; one thread an (batch, step, group, n).
template <class T>
__global__ void ssd_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
                               const float* __restrict__ dt, T* __restrict__ dB,
                               T* __restrict__ dC, size_t total, int H, int G, int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % N, g = (idx / N) % G;
  const size_t bt = idx / ((size_t)N * G);  // b T + t
  const int rep = H / G;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const size_t o = (bt * H + h) * N + n;
    sb = fmaf(dt[bt * H + h], dbp[o], sb);
    sc += dcp[o];
  }
  dB[idx] = from_f<T>(sb);
  dC[idx] = from_f<T>(sc);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------
bool path_fits(int path, int dtype, int N, int P, bool aligned) {
  switch (path) {
    case PATH_MMA:
      return dtype == 1 && (N == 64 || N == 128) && P % 32 == 0 && aligned &&
             smem_bytes(N, P, 2) <= (size_t)MAX_SMEM;
    case PATH_FFMA:
      return (dtype == 0 || dtype == 1) && smem_bytes(N, P, dtype ? 2 : 4) <= (size_t)MAX_SMEM;
    default: return false;
  }
}

template <class T, bool MMA>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   const float* D, const void* dy, const float* dstate, void* dx, float* ddt,
                   float* da_part, float* dd_part, float* dbp, float* dcp, const float* states,
                   void* dB, void* dC, int Bt, int T_len, int H, int G, int N, int P,
                   cudaStream_t s) {
  const size_t bytes = smem_bytes(N, P, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, MMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<T, MMA><<<Bt * H, THREADS, bytes, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<const T*>(dy), dstate, static_cast<T*>(dx), ddt, da_part, dd_part, dbp, dcp,
      states, T_len, H, G, N, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)Bt * T_len * G * N;
  ssd_bwd_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      dbp, dcp, dt, static_cast<T*>(dB), static_cast<T*>(dC), total, H, G, N);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (x, B, C, dy and their gradients): 0 = float32, 1 = bfloat16;
// dt, A, D, their gradients, the state gradient and the scratch are float32.
// dstate may be null (a zero final-state gradient). states (Bt, H, nc + 1,
// N, P) with nc = ceil(T / 64): the chunk states the forward wrote, read
// only. Scratch: dbp, dcp (Bt, T, H, N). da_part and dd_part (Bt, H) are
// the per-(batch, head) sums of a_bar and d_bar. path:
// 0 = mma, 1 = ffma, as ssd_scan_launch. Returns the CUDA error of the
// launches (cudaErrorInvalidValue for a path the inputs cannot take); 0
// means launched.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A, const void* B,
                                   const void* C, const void* D, const void* dy,
                                   const void* dstate, void* dx, void* ddt, void* da_part,
                                   void* dd_part, void* dbp, void* dcp, const void* states,
                                   void* dB, void* dC, int Bt, int T_len, int H, int G, int N,
                                   int P, int dtype, int path, void* stream) {
  if (G <= 0 || H % G != 0 || N <= 0 || P <= 0 || T_len <= 0 || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(B) |
                         reinterpret_cast<uintptr_t>(C)) & 15) == 0;
  if (!path_fits(path, dtype, N, P, aligned)) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_BWD_ARGS                                                                         \
  x, f(dt), f(A), B, C, f(D), dy, f(dstate), dx, w(ddt), w(da_part), w(dd_part), w(dbp),    \
      w(dcp), f(states), dB, dC, Bt, T_len, H, G, N, P, s
  cudaError_t err;
  if (path == PATH_MMA) err = launch<__nv_bfloat16, true>(SSD_BWD_ARGS);
  else if (dtype == 0) err = launch<float, false>(SSD_BWD_ARGS);
  else err = launch<__nv_bfloat16, false>(SSD_BWD_ARGS);
#undef SSD_BWD_ARGS
  return static_cast<int>(err);
}
