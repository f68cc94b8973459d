// Hopper ssd_scan: Mamba-2 SSD chunked scan (state-space duality). For each
// (batch, head) the sequence is cut into chunks of Q = 64 steps and, with
// cum = cumsum(dt * a) over the chunk and the float32 state S (N, P) carried
// from the previous chunk:
//   y     = ((C B^T) o tril(exp(cum_i - cum_j)) o dt_j) X      intra-chunk
//         + exp(cum) o (C S)                                   inter-chunk
//         + d x                                                skip
//   S    <- exp(cum_Q) S + (B o exp(cum_Q - cum) dt)^T X       hand-off
// All sums in float32; y in x's type, the final state in float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py ::
// ssd_scan (body _kernel). On the TPU the (BH, T/Q) grid runs in order and
// the state lives in VMEM scratch from one chunk step to the next. Here a
// block owns one (batch, head) (and, on the mma path, a slice of P) and loops
// over the chunks itself, so S stays on the SM for the whole sequence and
// never goes to device memory until the final state is written.
//
// Layout: the kernel reads the model's layout directly, so neither the
// reference wrapper's transposes nor its grouped B/C repeat are
// materialised, and the model's contiguous tensors go in as they are: x, y
// (Bt, T, H, P); dt (Bt, T, H) float32; a, d (H,) float32; B, C (Bt, T, G, N)
// with head h reading group h / (H / G); final state (Bt, H, N, P).
// Any T: steps past T in the last chunk load as zero with dt = 0 (decay 1,
// no input), which leaves the state as it is, and their outputs are not
// stored, as ssd_chunked pads its ragged tail.
//
// Chunk states, when asked (a non-null chunk_states, (Bt, H, nc + 1, N, P)
// float32 with nc = ceil(T / 64)): the state entering each chunk, then the
// final state, as csrc/ssd_scan_bwd.cu reads them. The gradient's
// autograd.Function asks for them, so the backward does not rebuild them.
//
// What bounds it on an H100: at the serving shape (Bt 8, T 512, H 80, P 64,
// N 128, bf16) one layer moves about 108 MB (x and y 42 MB each, the float32
// state 21 MB). The function's own work is the recurrence's state update and
// readout, 4 N P a step, 10.7 GFLOP, so it is bound by bytes (0.032 ms). The
// chunked form does more: with the hi + lo pairs below, the mma path runs
// 752 mma.sync a (block, chunk), 31.5 GFLOP at the serving shape. On an
// H100 it takes about 0.25 ms (probe_attention_scan.py), about 130 TFLOP/s
// of mma.sync: leaving out the state update or C B^T saves 12-14% each,
// loading B and C once instead of every chunk (they are shared by all 80
// heads of mamba2_2_7b's one group) 6%, and 64 columns a block (B and C read
// half as often) is 2% slower. So it is bound by how fast ldmatrix and the
// per-chunk chain feed the tensor cores, not by bytes; wgmma, or fewer
// products (one C B^T for the heads of a group), is the next step.
//
// Two paths. The wrapper (kernels/ssd_scan/kernel.py::choose_path) picks one
// from (dtype, N, P, alignment) and passes it in; a path the inputs cannot
// take returns cudaErrorInvalidValue, never another path.
//  * mma (bf16, N 64 or 128, P a multiple of 32, 16-byte aligned x/y/B/C:
//    every serving prefill scan). The chunk's three products run on bf16
//    tensor cores (mma.sync.m16n8k16, float32 accumulate), operands through
//    ldmatrix. A block of 4 warps owns one (batch, head) and 32 columns of P,
//    so the serving shape runs 1280 blocks of 99 KB, two an SM; each block
//    recomputes its chunk's C B^T (10% more work than one block a head).
//    x, B, C and dt of the next chunk load by cp.async while this chunk
//    computes. Warp w owns chunk rows 16w .. 16w + 15: C B^T for keys
//    j < 16 (w + 1) only (the 16 x 16 blocks above the diagonal are
//    skipped), M = (C B^T) o L o dt in float32 on the accumulator fragments,
//    which are the A fragments of M X as they stand, so M never goes
//    through shared memory; the upper triangle of M X is skipped too. x, B
//    and C are exact in bf16, but M, S and B o w are float32: each enters
//    as a bf16 hi + lo pair (hi = bf16(v), lo = bf16(v - hi)), two products
//    summed in one float32 accumulator. One rounding of each misses the
//    1e-3 state bar by about 3x at the serving shape; the pair keeps the
//    state within about 2e-5. The state update S <- exp(cum_Q) S + (B o w)^T
//    X keeps S in float32 registers (warp w owns N / 4 of its rows) for the
//    whole sequence; B o w is formed from ldmatrix.trans fragments of B.
//    After each chunk S is written to shared memory as a hi + lo pair, the
//    col operand of the next chunk's C S. Three barriers a chunk.
//  * ffma (float32, and bf16 shapes the mma path cannot take). The first
//    version, true float32 FFMA for the parity runs: one 256-thread block a
//    (batch, head), each thread a 4 x 4 micro-tile of each of the chunk's
//    three products read from padded shared memory, the chunk's f32 tiles
//    130 KB at N = 128, P = 64, so one block an SM. chip_smoke.py also
//    times it in bf16 beside the mma path.
//
// Deterministic: no atomics, one fixed summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // steps in a chunk (two per lane of warp 0)
constexpr int THREADS = 256;   // ffma: 16 x 16 threads, each a 4 x 4 micro-tile
constexpr int TILE = 64;       // ffma: rows / columns one pass of the block covers
constexpr int MAX_SMEM = 232448;

enum Path { PATH_MMA = 0, PATH_FFMA = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// ffma: float32 FFMA (and bf16 shapes the mma path cannot take).
// ---------------------------------------------------------------------------
size_t ffma_smem_bytes(int N, int P) {
  // X [Q][P], B and C [Q][N + 1], S [N][P], M [Q][Q + 1], cum/w/exp(cum)/dt [Q].
  return sizeof(float) * ((size_t)Q * P + 2 * (size_t)Q * (N + 1) + (size_t)N * P +
                          (size_t)Q * (Q + 1) + 4 * Q);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_ffma(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
        const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ D,
        T* __restrict__ y, float* __restrict__ state, float* __restrict__ chunk_states,
        int T_len, int H, int G, int N, int P) {
  extern __shared__ float smem[];
  const int LN = N + 1, LQ = Q + 1;
  float* Xs = smem;              // [Q][P]
  float* Bs = Xs + Q * P;        // [Q][LN], scaled by w before the hand-off
  float* Cs = Bs + Q * LN;       // [Q][LN]
  float* Ss = Cs + Q * LN;       // [N][P]
  float* Ms = Ss + N * P;        // [Q][LQ]
  float* cum = Ms + Q * LQ;      // [Q]
  float* wgt = cum + Q;          // exp(cum_Q - cum) dt
  float* ein = wgt + Q;          // exp(cum)
  float* dts = ein + Q;          // dt

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / G);
  const float a = A[h], dskip = D[h];
  const size_t xstep = (size_t)H * P, bstep = (size_t)G * N;
  const T* xb = x + (size_t)b * T_len * xstep + (size_t)h * P;
  T* yb = y + (size_t)b * T_len * xstep + (size_t)h * P;
  const T* Bb = B + (size_t)b * T_len * bstep + (size_t)g * N;
  const T* Cb = C + (size_t)b * T_len * bstep + (size_t)g * N;
  const float* dtb = dt + (size_t)b * T_len * H + h;
  const int nc = (T_len + Q - 1) / Q;
  float* csb = chunk_states ? chunk_states + (size_t)bh * (nc + 1) * N * P : nullptr;

  for (int i = tid; i < N * P; i += THREADS) Ss[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += Q) {
    if (csb)  // the state entering this chunk (step 5 writes Ss after a barrier)
      for (int i = tid; i < N * P; i += THREADS) csb[(size_t)(t0 / Q) * N * P + i] = Ss[i];
    // 1. The chunk's X, B, C, dt as float32; steps past T are zero.
    for (int i = tid; i < Q * P; i += THREADS) {
      const int r = i / P, col = i - r * P, t = t0 + r;
      Xs[i] = t < T_len ? to_f(xb[(size_t)t * xstep + col]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, col = i - r * N, t = t0 + r;
      const bool in = t < T_len;
      Bs[r * LN + col] = in ? to_f(Bb[(size_t)t * bstep + col]) : 0.f;
      Cs[r * LN + col] = in ? to_f(Cb[(size_t)t * bstep + col]) : 0.f;
    }
    if (tid < Q) dts[tid] = t0 + tid < T_len ? dtb[(size_t)(t0 + tid) * H] : 0.f;
    __syncthreads();

    // 2. cum = cumsum(dt * a): warp 0, two steps a lane, a shuffle scan.
    if (tid < 32) {
      const float a0 = dts[2 * tid] * a, a1 = dts[2 * tid + 1] * a;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = c0 + a1;
      const float total = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ein[2 * tid] = expf(c0);
      ein[2 * tid + 1] = expf(c1);
      wgt[2 * tid] = expf(total - c0) * dts[2 * tid];
      wgt[2 * tid + 1] = expf(total - c1) * dts[2 * tid + 1];
    }
    __syncthreads();

    // 3. M[i][j] = (C B^T)[i][j] exp(cum_i - cum_j) dt_j for j <= i, else 0.
    {
      float acc[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = Cs[(ty + 16 * i) * LN + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LN + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          Ms[r * LQ + c] = c <= r ? acc[i][j] * expf(cum[r] - cum[c]) * dts[c] : 0.f;
        }
    }
    __syncthreads();

    // 4. y = M X + exp(cum) o (C S) + d x, with S from before this chunk.
    //    B is scaled by w here too: step 3 has read it, step 5 reads it next.
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N;
      Bs[r * LN + i - r * N] *= wgt[r];
    }
    for (int c0 = 0; c0 < P; c0 += TILE) {
      float yd[4][4] = {}, yo[4][4] = {};
      int cc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cc[j] = min(c0 + tx + 16 * j, P - 1);
      for (int k = 0; k < Q; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = Ms[(ty + 16 * i) * LQ + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Xs[k * P + cc[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yd[i][j] = fmaf(av[i], bv[j], yd[i][j]);
      }
      for (int k = 0; k < N; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = Cs[(ty + 16 * i) * LN + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Ss[k * P + cc[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yo[i][j] = fmaf(av[i], bv[j], yo[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (t0 + r >= T_len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          if (c < P)
            yb[(size_t)(t0 + r) * xstep + c] =
                from_f<T>(yd[i][j] + ein[r] * yo[i][j] + dskip * Xs[r * P + c]);
        }
      }
    }
    __syncthreads();

    // 5. S <- exp(cum_Q) S + (B o w)^T X; each S element has one owner.
    const float decay = expf(cum[Q - 1]);
    for (int r0 = 0; r0 < N; r0 += TILE)
      for (int c0 = 0; c0 < P; c0 += TILE) {
        int rr[4], cc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rr[i] = min(r0 + ty + 16 * i, N - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) cc[j] = min(c0 + tx + 16 * j, P - 1);
        float acc[4][4] = {};
        for (int k = 0; k < Q; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = Bs[k * LN + rr[i]];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Xs[k * P + cc[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
            if (r < N && c < P) Ss[r * P + c] = decay * Ss[r * P + c] + acc[i][j];
          }
      }
    __syncthreads();
  }

  float* sb = state + (size_t)bh * N * P;
  for (int i = tid; i < N * P; i += THREADS) {
    sb[i] = Ss[i];
    if (csb) csb[(size_t)nc * N * P + i] = Ss[i];
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 tensor cores with hi + lo pairs, cp.async double buffering.
// ---------------------------------------------------------------------------
constexpr int PB = 32;            // columns of P a block owns, 32 a warp column
constexpr int MMA_WARPS = 4 * (PB / 32);   // 4 row tiles x PB / 32 column halves
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int PAD = 8;            // bf16 elements past each shared row: 16 bytes
constexpr int XLD = PB + PAD;     // row stride of the X and S tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared; zero-filled when !in (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0));
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

// Two floats as bf16 pairs hi = bf16(v) and lo = bf16(v - hi), the first
// float in the low half (the lower column).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A bf16 pair of B (steps t, t + 1 of one state row) times (w_t, w_t+1), split.
__device__ __forceinline__ void scale_split(uint32_t raw, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw);
  split_bf16(__low2float(b) * w0, __high2float(b) * w1, hi, lo);
}

template <int N>
constexpr int mma_smem_bytes() {
  // X [2][Q][XLD], B and C [2][Q][N + PAD], S hi and lo [N][XLD] (bf16);
  // dt [2][Q], cum, exp(cum) and w [Q] (float32).
  return 2 * (2 * Q * XLD + 4 * Q * (N + PAD) + 2 * N * XLD) + 4 * (2 * Q + 3 * Q);
}

template <int N>
__global__ void __launch_bounds__(MMA_THREADS, 256 / MMA_THREADS)
ssd_fwd_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const __nv_bfloat16* __restrict__ B,
            const __nv_bfloat16* __restrict__ C, const float* __restrict__ D,
            __nv_bfloat16* __restrict__ y, float* __restrict__ state,
            float* __restrict__ chunk_states, int T_len, int H, int G, int P) {
  constexpr int BLD = N + PAD;  // row stride of the B and C tiles
  constexpr int KN = N / 16;    // k-steps over the state dimension
  constexpr int MT = N / 64;    // 16-row tiles of S a warp owns
  constexpr int CPB = N / 8;    // 16-byte pieces of a B or C row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][Q][XLD]
  __nv_bfloat16* Bs = Xs + 2 * Q * XLD;                            // [2][Q][BLD]
  __nv_bfloat16* Cs = Bs + 2 * Q * BLD;                            // [2][Q][BLD]
  __nv_bfloat16* Shi = Cs + 2 * Q * BLD;                           // [N][XLD]
  __nv_bfloat16* Slo = Shi + N * XLD;                              // [N][XLD]
  float* dts = reinterpret_cast<float*>(Slo + N * XLD);            // [2][Q]
  float* cum = dts + 2 * Q;                                        // [Q]
  float* ein = cum + Q;                                            // exp(cum)
  float* wgt = ein + Q;                                            // exp(cum_Q - cum) dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp & 3, pc = (warp >> 2) * 32;  // row tile, first column of the warp
  const int bh = blockIdx.x, b = bh / H, h = bh % H, grp = h / (H / G);
  const int p0 = blockIdx.y * PB;
  const float a = A[h], dskip = D[h];
  const size_t xstep = (size_t)H * P, bstep = (size_t)G * N;
  const __nv_bfloat16* xb = x + (size_t)b * T_len * xstep + (size_t)h * P + p0;
  __nv_bfloat16* yb = y + (size_t)b * T_len * xstep + (size_t)h * P + p0;
  const __nv_bfloat16* Bb = B + (size_t)b * T_len * bstep + (size_t)grp * N;
  const __nv_bfloat16* Cb = C + (size_t)b * T_len * bstep + (size_t)grp * N;
  const float* dtb = dt + (size_t)b * T_len * H + h;

  // The chunk at t0 into stage st; steps past T load as zero.
  auto load = [&](int t0, int st) {
    for (int i = tid; i < Q * (PB / 8); i += MMA_THREADS) {
      const int r = i / (PB / 8), c = (i % (PB / 8)) * 8, t = t0 + r;
      const bool in = t < T_len;
      cp_async16(smem_u32(Xs + (st * Q + r) * XLD + c), in ? xb + (size_t)t * xstep + c : xb,
                 in);
    }
    for (int i = tid; i < Q * CPB; i += MMA_THREADS) {
      const int r = i / CPB, c = (i % CPB) * 8, t = t0 + r;
      const bool in = t < T_len;
      const size_t off = in ? (size_t)t * bstep + c : 0;
      cp_async16(smem_u32(Bs + (st * Q + r) * BLD + c), Bb + off, in);
      cp_async16(smem_u32(Cs + (st * Q + r) * BLD + c), Cb + off, in);
    }
    if (tid < Q) {
      const int t = t0 + tid;
      const bool in = t < T_len;
      cp_async4(smem_u32(dts + st * Q + tid), in ? dtb + (size_t)t * H : dtb, in);
    }
  };

  // S = 0: in registers (warp (rt, pc) owns rows n0w .. n0w + N / 4 - 1 of
  // its 32 columns) and as the hi + lo pair the first chunk's C S reads.
  const int n0w = rt * (N / 4);
  float sr[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sr[mt][j][e] = 0.f;
  for (int i = tid; i < 2 * N * XLD / 2; i += MMA_THREADS)
    reinterpret_cast<uint32_t*>(Shi)[i] = 0u;  // Shi and Slo are adjacent

  // S from registers to a (N, P) float32 state at dst (this block's columns).
  auto store_state = [&](float* dst) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0w + mt * 16 + g, c = pc + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dst + (size_t)n * P + c) =
            make_float2(sr[mt][j][0], sr[mt][j][1]);
        *reinterpret_cast<float2*>(dst + (size_t)(n + 8) * P + c) =
            make_float2(sr[mt][j][2], sr[mt][j][3]);
      }
  };
  const int nc = (T_len + Q - 1) / Q;
  float* csb = chunk_states ? chunk_states + (size_t)bh * (nc + 1) * N * P + p0 : nullptr;

  load(0, 0);
  cp_async_commit();

  const int i0 = rt * 16;                // the warp's chunk rows
  const int ia = i0 + g, ib = ia + 8;    // this thread's two of them
  int st = 0;
  for (int t0 = 0; t0 < T_len; t0 += Q, st ^= 1) {
    if (csb) store_state(csb + (size_t)(t0 / Q) * N * P);  // the state entering the chunk
    if (t0 + Q < T_len) load(t0 + Q, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk landed; the next stays in flight
    __syncthreads();     // [A] ... and the previous chunk's S is stored

    const __nv_bfloat16* xs = Xs + st * Q * XLD;
    const __nv_bfloat16* bs = Bs + st * Q * BLD;
    const __nv_bfloat16* cs = Cs + st * Q * BLD;
    const float* dtc = dts + st * Q;

    // 1. cum = cumsum(dt * a): warp 0, two steps a lane, a shuffle scan.
    if (warp == 0) {
      const float a0 = dtc[2 * lane] * a, a1 = dtc[2 * lane + 1] * a;
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
      wgt[2 * lane] = expf(total - c0) * dtc[2 * lane];
      wgt[2 * lane + 1] = expf(total - c1) * dtc[2 * lane + 1];
    }
    __syncthreads();  // [A2]

    // 2. C fragments of the warp's 16 rows (A operand of C B^T and C S).
    uint32_t cf[KN][4];
#pragma unroll
    for (int kc = 0; kc < KN; ++kc)
      ldsm_x4(cf[kc], smem_u32(cs + (i0 + (lane & 15)) * BLD + kc * 16 + ((lane >> 4) << 3)));

    // 3. C B^T for keys j < i0 + 16: 16 x 16 blocks above the diagonal skipped.
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KN; ++kc)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
        if (jp <= rt) {
          uint32_t bq[4];
          const int key = jp * 16 + ((lane >> 4) << 3) + (lane & 7);
          ldsm_x4(bq, smem_u32(bs + key * BLD + kc * 16 + (((lane >> 3) & 1) << 3)));
          mma_bf16(sc[2 * jp], cf[kc], bq[0], bq[1]);
          mma_bf16(sc[2 * jp + 1], cf[kc], bq[2], bq[3]);
        }

    // 4. M = (C B^T) o exp(cum_i - cum_j) o dt_j for j <= i, in float32 on
    //    the fragments, split into hi + lo A fragments of M X (keys 16 kc ..
    //    16 kc + 15 are tiles 2 kc and 2 kc + 1).
    uint32_t mh[4][4], ml[4][4];
    {
      const float cia = cum[ia], cib = cum[ib];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((j >> 1) <= rt) {
          const int j0 = j * 8 + 2 * t4, j1 = j0 + 1;
          const float ca0 = cum[j0], ca1 = cum[j1], d0 = dtc[j0], d1 = dtc[j1];
          const float v0 = j0 <= ia ? sc[j][0] * expf(cia - ca0) * d0 : 0.f;
          const float v1 = j1 <= ia ? sc[j][1] * expf(cia - ca1) * d1 : 0.f;
          const float v2 = j0 <= ib ? sc[j][2] * expf(cib - ca0) * d0 : 0.f;
          const float v3 = j1 <= ib ? sc[j][3] * expf(cib - ca1) * d1 : 0.f;
          split_bf16(v0, v1, mh[j >> 1][(j & 1) * 2], ml[j >> 1][(j & 1) * 2]);
          split_bf16(v2, v3, mh[j >> 1][(j & 1) * 2 + 1], ml[j >> 1][(j & 1) * 2 + 1]);
        }
    }

    // 5. yd = M X over keys j < i0 + 16; yo = C S with S from before this
    //    chunk. X and S enter as col operands through ldmatrix.trans.
    float yd[4][4], yo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yd[j][e] = yo[j][e] = 0.f;
    const int trow = (((lane >> 3) & 1) << 3) + (lane & 7), tcol = (lane >> 4) << 3;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      if (kc <= rt) {
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t bx[4];
          ldsm_x4_trans(bx, smem_u32(xs + (kc * 16 + trow) * XLD + pc + pp * 16 + tcol));
          mma_bf16(yd[2 * pp], mh[kc], bx[0], bx[1]);
          mma_bf16(yd[2 * pp], ml[kc], bx[0], bx[1]);
          mma_bf16(yd[2 * pp + 1], mh[kc], bx[2], bx[3]);
          mma_bf16(yd[2 * pp + 1], ml[kc], bx[2], bx[3]);
        }
      }
#pragma unroll
    for (int kc = 0; kc < KN; ++kc)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t bh_[4], bl_[4];
        ldsm_x4_trans(bh_, smem_u32(Shi + (kc * 16 + trow) * XLD + pc + pp * 16 + tcol));
        ldsm_x4_trans(bl_, smem_u32(Slo + (kc * 16 + trow) * XLD + pc + pp * 16 + tcol));
        mma_bf16(yo[2 * pp], cf[kc], bh_[0], bh_[1]);
        mma_bf16(yo[2 * pp], cf[kc], bl_[0], bl_[1]);
        mma_bf16(yo[2 * pp + 1], cf[kc], bh_[2], bh_[3]);
        mma_bf16(yo[2 * pp + 1], cf[kc], bl_[2], bl_[3]);
      }

    // 6. y = yd + exp(cum) o yo + d x; steps past T are not stored.
    {
      const float ea = ein[ia], eb = ein[ib];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = pc + j * 8 + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = hh ? ib : ia;
          if (t0 + i >= T_len) continue;
          const float e = hh ? eb : ea;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xs + i * XLD + c);
          const float v0 = yd[j][2 * hh] + e * yo[j][2 * hh] + dskip * __low2float(xv);
          const float v1 = yd[j][2 * hh + 1] + e * yo[j][2 * hh + 1] + dskip * __high2float(xv);
          *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)(t0 + i) * xstep + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }

    // 7. S <- exp(cum_Q) S + (B o w)^T X in float32 registers. A = (B o w)^T
    //    comes from ldmatrix.trans of B, scaled by w and split in registers.
    const float decay = expf(cum[Q - 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sr[mt][j][e] *= decay;
    const int brow = ((lane >> 4) << 3) + (lane & 7), bcol = ((lane >> 3) & 1) << 3;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int tk = kc * 16 + 2 * t4;
      const float w0 = wgt[tk], w1 = wgt[tk + 1], w8 = wgt[tk + 8], w9 = wgt[tk + 9];
      uint32_t bx[2][4];
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
        ldsm_x4_trans(bx[pp], smem_u32(xs + (kc * 16 + trow) * XLD + pc + pp * 16 + tcol));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t braw[4], ah[4], al[4];
        ldsm_x4_trans(braw, smem_u32(bs + (kc * 16 + brow) * BLD + n0w + mt * 16 + bcol));
        scale_split(braw[0], w0, w1, ah[0], al[0]);
        scale_split(braw[1], w0, w1, ah[1], al[1]);
        scale_split(braw[2], w8, w9, ah[2], al[2]);
        scale_split(braw[3], w8, w9, ah[3], al[3]);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          mma_bf16(sr[mt][2 * pp], ah, bx[pp][0], bx[pp][1]);
          mma_bf16(sr[mt][2 * pp], al, bx[pp][0], bx[pp][1]);
          mma_bf16(sr[mt][2 * pp + 1], ah, bx[pp][2], bx[pp][3]);
          mma_bf16(sr[mt][2 * pp + 1], al, bx[pp][2], bx[pp][3]);
        }
      }
    }
    __syncthreads();  // [B] every warp has read the previous S and this stage

    // 8. The new S as the hi + lo pair of the next chunk's C S.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0w + mt * 16 + g, c = pc + j * 8 + 2 * t4;
        uint32_t hi, lo;
        split_bf16(sr[mt][j][0], sr[mt][j][1], hi, lo);
        *reinterpret_cast<uint32_t*>(Shi + n * XLD + c) = hi;
        *reinterpret_cast<uint32_t*>(Slo + n * XLD + c) = lo;
        split_bf16(sr[mt][j][2], sr[mt][j][3], hi, lo);
        *reinterpret_cast<uint32_t*>(Shi + (n + 8) * XLD + c) = hi;
        *reinterpret_cast<uint32_t*>(Slo + (n + 8) * XLD + c) = lo;
      }
  }
  cp_async_wait<0>();

  // The final state, (Bt, H, N, P) float32, from registers.
  store_state(state + (size_t)bh * N * P + p0);
  if (csb) store_state(csb + (size_t)nc * N * P);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------
bool path_fits(int path, int dtype, int N, int P, bool aligned) {
  switch (path) {
    case PATH_MMA: return dtype == 1 && (N == 64 || N == 128) && P % PB == 0 && aligned;
    case PATH_FFMA:
      return (dtype == 0 || dtype == 1) && ffma_smem_bytes(N, P) <= (size_t)MAX_SMEM;
    default: return false;
  }
}

template <int N>
cudaError_t launch_mma(const void* x, const float* dt, const float* A, const void* B,
                       const void* C, const float* D, void* y, float* state,
                       float* chunk_states, int Bt, int T_len, int H, int G, int P,
                       cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_mma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  ssd_fwd_mma<N><<<dim3(Bt * H, P / PB), MMA_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), D, static_cast<bf16*>(y), state, chunk_states, T_len, H, G,
      P);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_ffma(const void* x, const float* dt, const float* A, const void* B,
                        const void* C, const float* D, void* y, float* state,
                        float* chunk_states, int Bt, int T_len, int H, int G, int N, int P,
                        cudaStream_t stream) {
  const size_t bytes = ffma_smem_bytes(N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_ffma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd_ffma<T><<<Bt * H, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C),
      D, static_cast<T*>(y), state, chunk_states, T_len, H, G, N, P);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (x, B, C, y): 0 = float32, 1 = bfloat16. dt, A, D and the
// states are float32; chunk_states may be null. H must be a multiple of G.
// path: 0 = mma (bf16, N 64 or 128, P a multiple of 32, x/y/B/C 16-byte
// aligned), 1 = ffma (the block's shared memory, 130 KB at N = 128, P = 64,
// at most 227 KB). Returns the CUDA error of the launch
// (cudaErrorInvalidValue for a path the inputs cannot take); 0 means
// launched.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* D, void* y, void* state,
                               void* chunk_states, int Bt, int T_len, int H, int G, int N,
                               int P, int dtype, int path,
                               void* stream) {
  if (G <= 0 || H % G != 0 || N <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C)) &
                        15) == 0;
  if (!path_fits(path, dtype, N, P, aligned)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  float* cs = static_cast<float*>(chunk_states);
  cudaError_t err;
  if (path == PATH_MMA) {
    err = N == 64 ? launch_mma<64>(x, dtf, Af, B, C, Df, y, sf, cs, Bt, T_len, H, G, P, s)
                  : launch_mma<128>(x, dtf, Af, B, C, Df, y, sf, cs, Bt, T_len, H, G, P, s);
  } else if (dtype == 0) {
    err = launch_ffma<float>(x, dtf, Af, B, C, Df, y, sf, cs, Bt, T_len, H, G, N, P, s);
  } else {
    err = launch_ffma<__nv_bfloat16>(x, dtf, Af, B, C, Df, y, sf, cs, Bt, T_len, H, G, N, P,
                                     s);
  }
  return static_cast<int>(err);
}
