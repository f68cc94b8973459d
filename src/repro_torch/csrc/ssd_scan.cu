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
// the state lives in VMEM scratch from one chunk step to the next. Here one
// block owns one (batch, head) and loops over the chunks itself, so S stays
// in shared memory for the whole sequence and never goes to device memory
// until the final state is written.
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
// What bounds it on an H100, and what the design does about it: at the
// serving shape (Bt 8, T 512, H 80, P 64, N 128, bf16) one layer moves about
// 108 MB (x and y 42 MB each, the float32 state 21 MB). The function's own
// work is the recurrence's state update and readout, 4 N P a step, 10.7
// GFLOP, so with tensor cores it would be bound by bytes (0.032 ms). The
// chunked form does more, 2 Q (N + P) + 4 N P a step (18.8 GFLOP at
// Q = 64), in float32 FFMA here, so this first version is bound by
// operations (0.28 ms at the 67 TFLOP/s float32 rate), and in practice by
// shared-memory reads. Each of the 256 threads keeps a 4 x 4 output
// micro-tile in registers for each of the chunk's three products (C B^T,
// M X + C S, B^T X), reading operands from shared memory padded against bank
// conflicts. The chunk's f32 tiles of X, B, C, M and S take 130 KB at
// N = 128, P = 64, so one block runs on an SM at a time; 640 blocks fill
// the 132 SMs in about five waves. mma.sync or wgmma for the three products,
// and splitting P across blocks for occupancy, are the next steps.
//
// Deterministic: no atomics, one fixed summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // steps in a chunk (two per lane of warp 0)
constexpr int THREADS = 256;   // 16 x 16 threads, each a 4 x 4 micro-tile
constexpr int TILE = 64;       // rows / columns one pass of the block covers
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

size_t smem_bytes(int N, int P) {
  // X [Q][P], B and C [Q][N + 1], S [N][P], M [Q][Q + 1], cum/w/exp(cum)/dt [Q].
  return sizeof(float) * ((size_t)Q * P + 2 * (size_t)Q * (N + 1) + (size_t)N * P +
                          (size_t)Q * (Q + 1) + 4 * Q);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
        const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ D,
        T* __restrict__ y, float* __restrict__ state, int T_len, int H, int G, int N, int P) {
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

  for (int i = tid; i < N * P; i += THREADS) Ss[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += Q) {
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
  for (int i = tid; i < N * P; i += THREADS) sb[i] = Ss[i];
}

template <class T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B,
                   const void* C, const float* D, void* y, float* state, int Bt, int T_len,
                   int H, int G, int N, int P, cudaStream_t stream) {
  const size_t bytes = smem_bytes(N, P);
  if (bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd<T><<<Bt * H, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C),
      D, static_cast<T*>(y), state, T_len, H, G, N, P);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (x, B, C, y): 0 = float32, 1 = bfloat16. dt, A, D and the
// state are float32. H must be a multiple of G, and the block's shared
// memory (130 KB at N = 128, P = 64) at most 227 KB. Returns the CUDA error
// of the launch; 0 means launched.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* D, void* y, void* state, int Bt,
                               int T_len, int H, int G, int N, int P, int dtype,
                               void* stream) {
  if (G <= 0 || H % G != 0 || N <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, dtf, Af, B, C, Df, y, sf, Bt, T_len, H, G, N, P, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, dtf, Af, B, C, Df, y, sf, Bt, T_len, H, G, N, P, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
