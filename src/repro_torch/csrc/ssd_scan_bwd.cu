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
// autograd.Function does: writing them cost the forward 0.029 ms where
// rebuilding them cost the first backward 0.43 ms (H100, PERF.md).
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
// bytes. This design also reads the chunk states (189 MB) and moves the
// per-head partials (168 MB each of B_bar and C_bar, written here and read
// by the head sum): about 0.2 ms of bytes on their own. The chunked form
// does more work (nine products a chunk, about 75 GFLOP of mma.sync with
// the hi + lo pairs).
//
// Two paths. The wrapper (kernels/ssd_scan/kernel.py :: choose_bwd_path)
// picks one and passes it in; a path the inputs cannot take returns
// cudaErrorInvalidValue, never another path.
//  * mma (bf16, N 64 or 128, P 32 or 64, 16-byte aligned x, dy, dx, B, C):
//    every product on bf16 tensor cores (mma.sync.m16n8k16, float32
//    accumulate) from ldmatrix fragments. x, dy, B and C are exact in bf16;
//    every float32 operand enters as a bf16 hi + lo pair (hi = bf16(v), lo =
//    bf16(v - hi)), as in the forward: one rounding of them costs a_bar
//    about 40% of its largest entry at small shapes, the pair about 1e-3.
//    Each is split once: G and S into hi and lo shared tiles a chunk (G's
//    read by two products; Y_bar o ein for G's update reuses S's), and the
//    masked score matrices (C B^T o L)^T, (Y_bar X^T o L)^T and Y_bar X^T o
//    L o dt_j in registers, straight from the accumulators of the products
//    that form them (the m16n8 accumulator layout is the m16n8k16 A
//    layout). The exit factors eout and ein scale accumulators, not
//    operands. Warps 0-3 own the chunk's steps as rows of x_bar and Bt,
//    warps 4-7 as rows of C_bar, and hold G in registers as the accumulator
//    of its own update; the row dots b . Bt and c . C_bar come from the
//    accumulators with two shuffles (a warp owns whole rows). The next
//    chunk's X, Y_bar, B, C, dt and entry state load by cp.async while this
//    one computes. 256 threads, 210 KB of shared memory at N = 128, P = 64:
//    one block an SM.
//  * ffma (float32, and bf16 shapes the mma path cannot take): the same
//    walk with every product in true float32 FFMA, a thread a 4 x 4
//    micro-tile, for the 1e-3 parity runs; 256 threads, one block an SM
//    (shared memory 213 KB in float32 at N = 128, P = 64), so at N = 128
//    it takes P up to 64 in float32 (every Mamba-2 layer of the zoo has
//    P = 64).

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
template <class A1, class B1, class A2, class B2, class Epi>
__device__ __forceinline__ void product(int R, int CN, int K1, A1 a1, B1 b1, int K2, A2 a2,
                                        B2 b2, Epi epi) {
  // 16 x 16 threads, each a 4 x 4 micro-tile of each 64 x 64 output tile.
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  {
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
// ffma: the backward walk in float32 FFMA, one block a (batch, head).
// ---------------------------------------------------------------------------
template <class T>
__global__ void __launch_bounds__(THREADS, 1)  // one block an SM: up to 255 registers
ssd_bwd_ffma(const T* __restrict__ x, const float* __restrict__ dt,
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
    product(
        Q, Q, N, [&](int i, int n) { return to_f(Cs[i * LB + n]); },
        [&](int n, int j) { return to_f(Bs[j * LB + n]); }, 0, none, none,
        [&](int i, int j, float v, float) { CBs[i * LQ + j] = v; });
    product(
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
    product(
        Q, P, Q, [&](int j, int i) { return CBs[i * LQ + j]; },
        [&](int i, int p) { return to_f(Ys[i * LX + p]); }, N,
        [&](int j, int n) { return to_f(Bs[j * LB + n]); },
        [&](int n, int p) { return Gs[n * LP + p]; },
        [&](int j, int p, float v1, float v2) {
          if (t0 + j < T_len)
            dx[xoff + (size_t)(t0 + j) * xstep + p] =
                from_f<T>(dts[j] * (v1 + eout[j] * v2) + dskip * to_f(Ys[j * LX + p]));
        });
    product(
        Q, N, Q, [&](int j, int i) { return DLs[i * LQ + j]; },
        [&](int i, int n) { return to_f(Cs[i * LB + n]); }, P,
        [&](int j, int p) { return to_f(Xs[j * LX + p]); },
        [&](int p, int n) { return Gs[n * LP + p]; },
        [&](int j, int n, float v1, float v2) {
          if (t0 + j < T_len) dbp[poff + (size_t)(t0 + j) * pstep + n] = v1 + eout[j] * v2;
        });
    product(
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
    product(
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

// ---------------------------------------------------------------------------
// mma: bf16 tensor cores. One block a (batch, head), its 8 warps in two
// roles over each chunk: warps 0-3 own the chunk's steps j as rows of x_bar
// and Bt, warps 4-7 own them as rows i of C_bar and hold G in registers.
// Every product is mma.sync.m16n8k16 on fragments that ldmatrix reads from
// padded bf16 tiles, or that an earlier product leaves in registers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (the first in the low half), hi = bf16(v), and
// the pair of what that rounding left, lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

constexpr int MPAD = 8;  // bf16 past each shared row: 16 bytes, conflict-free ldmatrix

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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

// acc[c] (16 x 8 NT) += A (16 x K) B (K x 8 NT) on one warp. A: shared, row-major
// from `a` (AT: stored k-major, a[k * lda + m], read through ldmatrix.trans).
// B: shared, n-major b[n * ldb + k] (BT: k-major b[k * ldb + n]); with SPLIT
// the pair (bh, bl) of a float32 operand, both halves multiplied.
template <int K, int NT, bool AT, bool BT, bool SPLIT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* bh, const __nv_bfloat16* bl,
                                         int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t af[4];
    if constexpr (AT) {
      const int q = lane >> 3;
      ldsm_x4_trans(af, smem_u32(a + (kc * 16 + ((q >> 1) << 3) + (lane & 7)) * lda +
                                 ((q & 1) << 3)));
    } else {
      ldsm_x4(af, smem_u32(a + (lane & 15) * lda + kc * 16 + ((lane >> 4) << 3)));
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      int off;
      if constexpr (BT)
        off = (kc * 16 + (((lane >> 3) & 1) << 3) + (lane & 7)) * ldb + np * 16 +
              ((lane >> 4) << 3);
      else
        off = (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * ldb + kc * 16 +
              (((lane >> 3) & 1) << 3);
      uint32_t bf[4];
      if constexpr (BT) ldsm_x4_trans(bf, smem_u32(bh + off));
      else ldsm_x4(bf, smem_u32(bh + off));
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      if constexpr (SPLIT) {
        if constexpr (BT) ldsm_x4_trans(bf, smem_u32(bl + off));
        else ldsm_x4(bf, smem_u32(bl + off));
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc[c] += F B with F (16 x 64) a split operand in registers (fh + fl, the
// A fragments of its 4 k steps) and B shared as in warp_mma.
template <int NT, bool BT>
__device__ __forceinline__ void frag_mma(float (&acc)[NT][4], const uint32_t (&fh)[4][4],
                                         const uint32_t (&fl)[4][4], const __nv_bfloat16* b,
                                         int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      if constexpr (BT)
        ldsm_x4_trans(bf, smem_u32(b + (kc * 16 + (((lane >> 3) & 1) << 3) + (lane & 7)) * ldb +
                                   np * 16 + ((lane >> 4) << 3)));
      else
        ldsm_x4(bf, smem_u32(b + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * ldb + kc * 16 +
                             (((lane >> 3) & 1) << 3)));
      mma_bf16(acc[2 * np], fh[kc], bf[0], bf[1]);
      mma_bf16(acc[2 * np], fl[kc], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], fh[kc], bf[2], bf[3]);
      mma_bf16(acc[2 * np + 1], fl[kc], bf[2], bf[3]);
    }
}

// A warp's 16 x 64 accumulator (v[c][2h + e]: row g + 8h, column 8c + 2 t4 +
// e) as the hi + lo A fragments of its 4 k steps: the m16n8 accumulator
// layout is the m16n8k16 A layout, so no value leaves its thread.
__device__ __forceinline__ void split_frags(uint32_t (&fh)[4][4], uint32_t (&fl)[4][4],
                                            const float (&v)[8][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    split2(v[c][0], v[c][1], fh[c >> 1][(c & 1) * 2], fl[c >> 1][(c & 1) * 2]);
    split2(v[c][2], v[c][3], fh[c >> 1][(c & 1) * 2 + 1], fl[c >> 1][(c & 1) * 2 + 1]);
  }
}

// Shared memory of the mma kernel, in bf16 elements then floats: two
// stages of X, Y_bar [Q][LX] and B, C [Q][LB]; G and S [N][LX], each as a
// hi and a lo tile (Y_bar o ein's hi and lo [Q][LX] reuse S's once C_bar
// is formed); then the next chunk's entry state as loaded [N][P], dt [2][Q],
// cum, ein, eout, b . Bt, c . C_bar [Q] and a reduction slot a warp.
template <int N, int P>
struct MmaSmem {
  static constexpr int LX = P + MPAD, LB = N + MPAD;
  static constexpr int STAGE = 2 * Q * LX + 2 * Q * LB;
  static constexpr int GH = 2 * STAGE, GL = GH + N * LX, SH = GL + N * LX, SL = SH + N * LX;
  static constexpr int EH = SH, EL = SL, END = SL + N * LX;
  static constexpr size_t BYTES = 2 * (size_t)END + 4 * ((size_t)N * P + 7 * Q + WARPS);
};

template <int N, int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const __nv_bfloat16* __restrict__ B,
            const __nv_bfloat16* __restrict__ C, const float* __restrict__ D,
            const __nv_bfloat16* __restrict__ dy, const float* __restrict__ dstate,
            __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ da_part,
            float* __restrict__ dd_part, float* __restrict__ dbp, float* __restrict__ dcp,
            const float* __restrict__ states, int T_len, int H, int G) {
  using L = MmaSmem<N, P>;
  constexpr int LX = L::LX, LB = L::LB, PT = P / 8, MT = N / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16 *Gh = sm + L::GH, *Gl = sm + L::GL, *Sh = sm + L::SH, *Sl = sm + L::SL;
  __nv_bfloat16 *Eh = sm + L::EH, *El = sm + L::EL;
  float* s_in = reinterpret_cast<float*>(sm + L::END);  // [N][P]: a chunk's entry state
  float* dts = s_in + N * P;                             // [2][Q]
  float* cum = dts + 2 * Q;
  float* ein = cum + Q;
  float* eout = ein + Q;
  float* bbv = eout + Q;  // b_j . Bt_j
  float* ccv = bbv + Q;   // c_i . C_bar_i
  float* red = ccv + Q;   // [4] <G, S> of each G warp
  auto Xs = [&](int st) { return sm + st * L::STAGE; };
  auto Ys = [&](int st) { return sm + st * L::STAGE + Q * LX; };
  auto Bs = [&](int st) { return sm + st * L::STAGE + 2 * Q * LX; };
  auto Cs = [&](int st) { return sm + st * L::STAGE + 2 * Q * LX + Q * LB; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int role = warp >> 2, wr = warp & 3;  // this warp's rows: 16 wr + g + 8h of the chunk
  const int bh = blockIdx.x, b = bh / H, h = bh % H, grp = h / (H / G);
  const float a = A[h], dskip = D[h];
  const int nc = (T_len + Q - 1) / Q;
  const size_t xstep = (size_t)H * P, bstep = (size_t)G * N, pstep = (size_t)H * N;
  const size_t xoff = (size_t)b * T_len * xstep + (size_t)h * P;
  const size_t boff = (size_t)b * T_len * bstep + (size_t)grp * N;
  const size_t poff = (size_t)b * T_len * pstep + (size_t)h * N;
  const float* dtb = dt + (size_t)b * T_len * H + h;
  float* ddtb = ddt + (size_t)b * T_len * H + h;
  const float* stp = states + (size_t)bh * (nc + 1) * N * P;

  // Chunk c's X, Y_bar, B, C and dt into stage st, its entry state into
  // s_in; steps past T are zero.
  auto prefetch = [&](int c, int st) {
    const int t0 = c * Q;
    const float* entry = stp + (size_t)c * N * P;
    for (int i = 4 * tid; i < N * P; i += 4 * THREADS)
      cp_async16(smem_u32(s_in + i), entry + i, true);
    for (int i = tid; i < Q * (P / 8); i += THREADS) {
      const int r = i / (P / 8), col = (i % (P / 8)) * 8, t = t0 + r;
      const bool in = t < T_len;
      const size_t off = xoff + (size_t)(in ? t : 0) * xstep + col;
      cp_async16(smem_u32(Xs(st) + r * LX + col), x + off, in);
      cp_async16(smem_u32(Ys(st) + r * LX + col), dy + off, in);
    }
    for (int i = tid; i < Q * (N / 8); i += THREADS) {
      const int r = i / (N / 8), col = (i % (N / 8)) * 8, t = t0 + r;
      const bool in = t < T_len;
      const size_t off = boff + (size_t)(in ? t : 0) * bstep + col;
      cp_async16(smem_u32(Bs(st) + r * LB + col), B + off, in);
      cp_async16(smem_u32(Cs(st) + r * LB + col), C + off, in);
    }
    if (tid < Q) {
      const int t = t0 + tid;
      cp_async4(smem_u32(dts + st * Q + tid), dtb + (size_t)(t < T_len ? t : 0) * H, t < T_len);
    }
  };

  // G, the gradient of the current chunk's exit state: warps 4-7, rows
  // wr N / 4 + 16 mt + g + 8h, columns 8 pt + 2 t4 + e.
  float Gr[MT][PT][4];
  const int n0 = wr * (N / 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * mt + g + 8 * (e >> 1), p = 8 * pt + 2 * t4 + (e & 1);
        Gr[mt][pt][e] = role == 1 && dstate ? dstate[(size_t)bh * N * P + n * P + p] : 0.f;
      }
  auto write_g = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = (n0 + 16 * mt + g + 8 * hh) * LX + 8 * pt + 2 * t4;
          uint32_t vh, vl;
          split2(Gr[mt][pt][2 * hh], Gr[mt][pt][2 * hh + 1], vh, vl);
          *reinterpret_cast<uint32_t*>(Gh + o) = vh;
          *reinterpret_cast<uint32_t*>(Gl + o) = vl;
        }
  };
  if (role == 1) write_g();
  prefetch(nc - 1, 0);
  cp_async_commit();

  float dd_acc = 0.f, da_acc = 0.f, dt0 = 0.f, dt1 = 0.f;
  int st = 0;
  for (int c = nc - 1; c >= 0; --c, st ^= 1) {
    const int t0 = c * Q;
    cp_async_wait<0>();  // this chunk landed
    __syncthreads();
    // S, the chunk's entry state, into its hi and lo tiles.
    for (int i = 4 * tid; i < N * P; i += 4 * THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(s_in + i);
      const int o = (i / P) * LX + i % P;
      uint2 vh, vl;
      split2(v.x, v.y, vh.x, vl.x);
      split2(v.z, v.w, vh.y, vl.y);
      *reinterpret_cast<uint2*>(Sh + o) = vh;
      *reinterpret_cast<uint2*>(Sl + o) = vl;
    }
    if (warp == 0) {  // cum, ein, eout: two steps a lane, a scan
      dt0 = dts[st * Q + 2 * lane];
      dt1 = dts[st * Q + 2 * lane + 1];
      const float a0 = dt0 * a, a1 = dt1 * a;
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
    __syncthreads();
    if (c > 0) prefetch(c - 1, st ^ 1);  // lands while this chunk computes
    cp_async_commit();
    const __nv_bfloat16 *xs = Xs(st), *ys = Ys(st), *bs = Bs(st), *cs = Cs(st);
    const float* dtc = dts + st * Q;
    int rows[2];
    rows[0] = 16 * wr + g;
    rows[1] = rows[0] + 8;

    if (role == 0) {
      // x_bar_j = dt_j (eout_j (B G)_j + ((C B^T o L)^T Y_bar)_j) + d Y_bar_j.
      float ax[PT][4] = {};
      warp_mma<N, PT, false, true, true>(ax, bs + 16 * wr * LB, LB, Gh, Gl, LX);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[pt][e] *= eout[rows[e >> 1]];
      uint32_t fh[4][4], fl[4][4];
      {
        float v[8][4] = {};  // (B C^T)_ji o L_ij: rows j, columns i
        warp_mma<N, 8, false, false, false>(v, bs + 16 * wr * LB, LB, cs, cs, LB);
#pragma unroll
        for (int ic = 0; ic < 8; ++ic)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * ic + 2 * t4 + (e & 1), j = rows[e >> 1];
            v[ic][e] = j <= i ? v[ic][e] * expf(cum[i] - cum[j]) : 0.f;
          }
        split_frags(fh, fl, v);
      }
      frag_mma<PT, true>(ax, fh, fl, ys, LX);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = rows[hh];
        if (t0 + j >= T_len) continue;
        __nv_bfloat16* out = dx + xoff + (size_t)(t0 + j) * xstep;
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          const int p = 8 * pt + 2 * t4;
          const __nv_bfloat162 yv = *reinterpret_cast<const __nv_bfloat162*>(ys + j * LX + p);
          *reinterpret_cast<__nv_bfloat162*>(out + p) = __floats2bfloat162_rn(
              dtc[j] * ax[pt][2 * hh] + dskip * __low2float(yv),
              dtc[j] * ax[pt][2 * hh + 1] + dskip * __high2float(yv));
        }
      }
      // Bt_j = eout_j (X G^T)_j + ((Y_bar X^T o L)^T C)_j, and b_j . Bt_j, 64
      // columns n at a time.
      {
        float v[8][4] = {};  // (X Y_bar^T)_ji o L_ij
        warp_mma<P, 8, false, false, false>(v, xs + 16 * wr * LX, LX, ys, ys, LX);
#pragma unroll
        for (int ic = 0; ic < 8; ++ic)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * ic + 2 * t4 + (e & 1), j = rows[e >> 1];
            v[ic][e] = j <= i ? v[ic][e] * expf(cum[i] - cum[j]) : 0.f;
          }
        split_frags(fh, fl, v);
      }
      float dot[2] = {0.f, 0.f};
#pragma unroll 1
      for (int n0c = 0; n0c < N; n0c += 64) {
        float ab[8][4] = {};
        warp_mma<P, 8, false, false, true>(ab, xs + 16 * wr * LX, LX, Gh + n0c * LX,
                                           Gl + n0c * LX, LX);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) ab[nt][e] *= eout[rows[e >> 1]];
        frag_mma<8, true>(ab, fh, fl, cs + n0c, LB);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = rows[hh];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int n = n0c + 8 * nt + 2 * t4;
            const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bs + j * LB + n);
            dot[hh] = fmaf(__low2float(bv), ab[nt][2 * hh], dot[hh]);
            dot[hh] = fmaf(__high2float(bv), ab[nt][2 * hh + 1], dot[hh]);
            if (t0 + j < T_len)
              *reinterpret_cast<float2*>(dbp + poff + (size_t)(t0 + j) * pstep + n) =
                  make_float2(ab[nt][2 * hh], ab[nt][2 * hh + 1]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
        dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
        if (t4 == 0) bbv[rows[hh]] = dot[hh];
      }
    } else {
      // C_bar_i = ein_i (Y_bar S^T)_i + ((Y_bar X^T o L o dt_j) B)_i, and
      // c_i . C_bar_i, 64 columns n at a time.
      uint32_t fh[4][4], fl[4][4];
      {
        float v[8][4] = {};  // (Y_bar X^T)_ij o L_ij dt_j: rows i, columns j
        warp_mma<P, 8, false, false, false>(v, ys + 16 * wr * LX, LX, xs, xs, LX);
#pragma unroll
        for (int jc = 0; jc < 8; ++jc)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 8 * jc + 2 * t4 + (e & 1), i = rows[e >> 1];
            if (j == i) dd_acc += v[jc][e];  // L_ii = 1: the step's Y_bar . X
            v[jc][e] = j <= i ? v[jc][e] * expf(cum[i] - cum[j]) * dtc[j] : 0.f;
          }
        split_frags(fh, fl, v);
      }
      float dot[2] = {0.f, 0.f};
#pragma unroll 1
      for (int n0c = 0; n0c < N; n0c += 64) {
        float ac[8][4] = {};
        warp_mma<P, 8, false, false, true>(ac, ys + 16 * wr * LX, LX, Sh + n0c * LX,
                                           Sl + n0c * LX, LX);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) ac[nt][e] *= ein[rows[e >> 1]];
        frag_mma<8, true>(ac, fh, fl, bs + n0c, LB);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = rows[hh];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int n = n0c + 8 * nt + 2 * t4;
            const __nv_bfloat162 cv = *reinterpret_cast<const __nv_bfloat162*>(cs + i * LB + n);
            dot[hh] = fmaf(__low2float(cv), ac[nt][2 * hh], dot[hh]);
            dot[hh] = fmaf(__high2float(cv), ac[nt][2 * hh + 1], dot[hh]);
            if (t0 + i < T_len)
              *reinterpret_cast<float2*>(dcp + poff + (size_t)(t0 + i) * pstep + n) =
                  make_float2(ac[nt][2 * hh], ac[nt][2 * hh + 1]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
        dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
        if (t4 == 0) ccv[rows[hh]] = dot[hh];
      }
      // <G, S> at the chunk's exit, before G moves to the chunk's entry.
      {
        const float* ex = stp + (size_t)(c + 1) * N * P;
        float part = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int pt = 0; pt < PT; ++pt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 sv = *reinterpret_cast<const float2*>(
                  ex + (size_t)(n0 + 16 * mt + g + 8 * hh) * P + 8 * pt + 2 * t4);
              part = fmaf(Gr[mt][pt][2 * hh], sv.x, part);
              part = fmaf(Gr[mt][pt][2 * hh + 1], sv.y, part);
            }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) red[wr] = part;
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // S's tiles read: Y_bar o ein's now
      // Y_bar o ein as a hi and a lo tile, by warps 4-7, then
      // G <- exp(cum_Q) G + C^T (Y_bar o ein) in registers.
      for (int i = tid - 128; i < Q * P / 2; i += 128) {
        const int r = i / (P / 2), p = 2 * (i % (P / 2));
        const __nv_bfloat162 yv = *reinterpret_cast<const __nv_bfloat162*>(ys + r * LX + p);
        uint32_t vh, vl;
        split2(__low2float(yv) * ein[r], __high2float(yv) * ein[r], vh, vl);
        *reinterpret_cast<uint32_t*>(Eh + r * LX + p) = vh;
        *reinterpret_cast<uint32_t*>(El + r * LX + p) = vl;
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      const float decay = expf(cum[Q - 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
#pragma unroll
          for (int e = 0; e < 4; ++e) Gr[mt][pt][e] *= decay;
        warp_mma<Q, PT, true, true, true>(Gr[mt], cs + n0 + 16 * mt, LB, Eh, El, LX);
      }
    }
    __syncthreads();  // G's tiles read for the last time; the row dots and <G, S> are in
    if (role == 1) write_g();
    if (warp == 0) {
      // cum_bar, its reverse cumsum dA, dt_bar and this chunk's share of a_bar.
      const float gs = red[0] + red[1] + red[2] + red[3];
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float c0 = ccv[i0] - dt0 * bbv[i0];
      const float c1 = ccv[i1] - dt1 * bbv[i1] + (i1 == Q - 1 ? gs : 0.f);
      float s = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, s, o);
        if (lane + o < 32) s += v;
      }
      float after = __shfl_down_sync(0xffffffffu, s, 1);
      if (lane == 31) after = 0.f;
      const float d1 = after + c1, d0 = d1 + c0;
      if (t0 + i0 < T_len) ddtb[(size_t)(t0 + i0) * H] = bbv[i0] + a * d0;
      if (t0 + i1 < T_len) ddtb[(size_t)(t0 + i1) * H] = bbv[i1] + a * d1;
      float v = dt0 * d0 + dt1 * d1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      da_acc += v;
    }
  }

  __syncthreads();
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
      return dtype == 1 && (N == 64 || N == 128) && (P == 32 || P == 64) && aligned;
    case PATH_FFMA:
      return (dtype == 0 || dtype == 1) && smem_bytes(N, P, dtype ? 2 : 4) <= (size_t)MAX_SMEM;
    default: return false;
  }
}

// The head sum of B_bar and C_bar, after the walk.
template <class T>
cudaError_t launch_reduce(const float* dbp, const float* dcp, const float* dt, void* dB,
                          void* dC, int Bt, int T_len, int H, int G, int N, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)Bt * T_len * G * N;
  ssd_bwd_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      dbp, dcp, dt, static_cast<T*>(dB), static_cast<T*>(dC), total, H, G, N);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_ffma(const void* x, const float* dt, const float* A, const void* B,
                        const void* C, const float* D, const void* dy, const float* dstate,
                        void* dx, float* ddt, float* da_part, float* dd_part, float* dbp,
                        float* dcp, const float* states, void* dB, void* dC, int Bt, int T_len,
                        int H, int G, int N, int P, cudaStream_t s) {
  const size_t bytes = smem_bytes(N, P, sizeof(T));
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_ffma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_ffma<T><<<Bt * H, THREADS, bytes, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<const T*>(dy), dstate, static_cast<T*>(dx), ddt, da_part, dd_part, dbp, dcp,
      states, T_len, H, G, N, P);
  return launch_reduce<T>(dbp, dcp, dt, dB, dC, Bt, T_len, H, G, N, s);
}

template <int N, int P>
cudaError_t launch_mma(const void* x, const float* dt, const float* A, const void* B,
                       const void* C, const float* D, const void* dy, const float* dstate,
                       void* dx, float* ddt, float* da_part, float* dd_part, float* dbp,
                       float* dcp, const float* states, void* dB, void* dC, int Bt, int T_len,
                       int H, int G, cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr int bytes = (int)MmaSmem<N, P>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_mma<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  ssd_bwd_mma<N, P><<<Bt * H, THREADS, bytes, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<const T*>(dy), dstate, static_cast<T*>(dx), ddt, da_part, dd_part, dbp, dcp,
      states, T_len, H, G);
  return launch_reduce<T>(dbp, dcp, dt, dB, dC, Bt, T_len, H, G, N, s);
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
      w(dcp), f(states), dB, dC, Bt, T_len, H, G
  cudaError_t err;
  if (path == PATH_MMA) {
    if (N == 64)
      err = P == 32 ? launch_mma<64, 32>(SSD_BWD_ARGS, s) : launch_mma<64, 64>(SSD_BWD_ARGS, s);
    else
      err = P == 32 ? launch_mma<128, 32>(SSD_BWD_ARGS, s) : launch_mma<128, 64>(SSD_BWD_ARGS, s);
  } else if (dtype == 0) {
    err = launch_ffma<float>(SSD_BWD_ARGS, N, P, s);
  } else {
    err = launch_ffma<__nv_bfloat16>(SSD_BWD_ARGS, N, P, s);
  }
#undef SSD_BWD_ARGS
  return static_cast<int>(err);
}
