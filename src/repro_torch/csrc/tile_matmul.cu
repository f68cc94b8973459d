// Hopper tile_matmul: out(M, N) = act(x(M, K) @ w(K, N) + b(N)), float32
// accumulation, cast to the output type in the epilogue.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tile_matmul/kernel.py ::
// tile_matmul (body _kernel). On the TPU the (M/bm, N/bn, K/bk) grid runs in
// order and the accumulator lives in VMEM across K steps. Here every block
// owns one output tile and walks K itself, so blocks are independent, the sum
// over K has one fixed order (no split-K, no atomics) and the result of a tile
// does not depend on the launch it shares.
//
// What bounds it on an H100, and what the design does about it:
//  * Prefill projections (M = batch * prompt = 4096, K, N in 320..2560) are
//    bound by operations: about 80 GFLOP a layer against 989 TFLOP/s of
//    bf16 tensor-core rate. bf16 runs on the tensor cores through
//    mma.sync.m16n8k16 from a 128x128x32 shared-memory tile (8 warps, 64x32
//    outputs each). No cp.async/TMA pipeline and no wgmma yet: loads and
//    products do not overlap, which is the first thing a faster version fixes.
//  * Decode projections (M = batch = 8) stream the weights once: bound by
//    bytes (629 MB of block weights a token against 3.35 TB/s). The skinny
//    kernel gives each lane one output column for all M rows, coalesced along
//    N, splits K over 16 warps and sums the warps' partials in shared memory
//    in a fixed order.
//  * float32 inputs run in true float32 FFMA (never TF32): 64x64x16 tiles,
//    4x4 outputs a thread.
// Ragged M, N and K edges are masked in every kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_TANH = 1, ACT_RELU = 2, ACT_SILU = 3, ACT_GELU = 4 };

__device__ __forceinline__ float act_apply(float v, int act) {
  switch (act) {
    case ACT_TANH: return tanhf(v);
    case ACT_RELU: return fmaxf(v, 0.f);
    case ACT_SILU: return v / (1.f + expf(-v));
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    default: return v;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <class TOut, class TIn>
__device__ __forceinline__ void store_out(TOut* out, const TIn* b, float acc, int row,
                                          int col, int N, int act) {
  if (b != nullptr) acc += to_f(b[col]);
  out[(size_t)row * N + col] = from_f<TOut>(act_apply(acc, act));
}

// ---------------------------------------------------------------------------
// bf16, M > 16: tensor cores through mma.sync.m16n8k16 (row.col, f32 accum).
// ---------------------------------------------------------------------------
constexpr int MMA_BM = 128, MMA_BN = 128, MMA_BK = 32, MMA_PAD = 8;
constexpr int MMA_THREADS = 256;  // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <class TOut>
__global__ void __launch_bounds__(MMA_THREADS)
tile_matmul_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ b, TOut* __restrict__ out, int M, int N,
                int K, int act, int vec_x) {
  // A tile row-major [m][k]; B tile stored transposed [n][k] so that the
  // k-pairs an mma fragment needs are adjacent. The 8-element pad keeps the
  // fragment reads and the 16-byte stores free of bank conflicts.
  __shared__ __align__(16) __nv_bfloat16 As[MMA_BM][MMA_BK + MMA_PAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[MMA_BN][MMA_BK + MMA_PAD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x 32 cols
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * MMA_BM, n0 = blockIdx.x * MMA_BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // Loader roles: A: row tid/2, 16 contiguous k; B: column tid%128, 16 k.
  const int a_row = tid >> 1, a_col = (tid & 1) * 16;
  const int b_n = tid & 127, b_k = (tid >> 7) * 16;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int k0 = 0; k0 < K; k0 += MMA_BK) {
    {
      const int gm = m0 + a_row, gk = k0 + a_col;
      __nv_bfloat16* dst = &As[a_row][a_col];
      if (vec_x && gm < M && gk + 16 <= K) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
        reinterpret_cast<uint4*>(dst)[0] = src[0];
        reinterpret_cast<uint4*>(dst)[1] = src[1];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          dst[i] = (gm < M && gk + i < K) ? x[(size_t)gm * K + gk + i] : zero;
      }
    }
    {
      const int gn = n0 + b_n;
      __align__(16) __nv_bfloat16 tmp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int gk = k0 + b_k + i;
        tmp[i] = (gn < N && gk < K) ? w[(size_t)gk * N + gn] : zero;
      }
      reinterpret_cast<uint4*>(&Bs[b_n][b_k])[0] = reinterpret_cast<uint4*>(tmp)[0];
      reinterpret_cast<uint4*>(&Bs[b_n][b_k])[1] = reinterpret_cast<uint4*>(tmp)[1];
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < MMA_BK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + t4 * 2]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + t4 * 2]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + t4 * 2 + 8]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + t4 * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][ks + t4 * 2]);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][ks + t4 * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * 64 + i * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn * 32 + j * 8 + t4 * 2 + (r & 1);
        if (row < M && col < N) store_out(out, b, acc[i][j][r], row, col, N, act);
      }
}

// ---------------------------------------------------------------------------
// float32, M > 16: true-float32 FFMA tiles.
// ---------------------------------------------------------------------------
constexpr int FF_BM = 64, FF_BN = 64, FF_BK = 16, FF_THREADS = 256;

template <class TIn, class TOut>
__global__ void __launch_bounds__(FF_THREADS)
tile_matmul_ffma(const TIn* __restrict__ x, const TIn* __restrict__ w,
                 const TIn* __restrict__ b, TOut* __restrict__ out, int M, int N, int K,
                 int act) {
  __shared__ float As[FF_BK][FF_BM + 4];  // k-major: row reads broadcast
  __shared__ float Bs[FF_BK][FF_BN + 4];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * FF_BM, n0 = blockIdx.x * FF_BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FF_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = (tid >> 4) + 16 * i, k = tid & 15;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = (tid >> 6) + 4 * i, n = tid & 63;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FF_BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < M && col < N) store_out(out, b, acc[i][j], row, col, N, act);
    }
}

// ---------------------------------------------------------------------------
// M <= 16 (decode): weight streaming, one output column per lane.
// ---------------------------------------------------------------------------
constexpr int SK_MAXM = 16, SK_COLS = 32, SK_WARPS = 16, SK_UNROLL = 8;

template <class TIn, class TOut>
__global__ void __launch_bounds__(SK_WARPS * 32)
tile_matmul_skinny(const TIn* __restrict__ x, const TIn* __restrict__ w,
                   const TIn* __restrict__ b, TOut* __restrict__ out, int M, int N, int K,
                   int act) {
  __shared__ float red[SK_WARPS][SK_MAXM][SK_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * SK_COLS + lane;
  const int kc = (K + SK_WARPS - 1) / SK_WARPS;
  const int kb = warp * kc, ke = min(K, kb + kc);
  float acc[SK_MAXM];
#pragma unroll
  for (int m = 0; m < SK_MAXM; ++m) acc[m] = 0.f;

  if (n < N) {
    int k = kb;
    for (; k + SK_UNROLL <= ke; k += SK_UNROLL) {
      float wv[SK_UNROLL];
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u) wv[u] = to_f(w[(size_t)(k + u) * N + n]);
#pragma unroll
      for (int m = 0; m < SK_MAXM; ++m) {
        if (m < M) {
#pragma unroll
          for (int u = 0; u < SK_UNROLL; ++u)
            acc[m] = fmaf(to_f(x[(size_t)m * K + k + u]), wv[u], acc[m]);
        }
      }
    }
    for (; k < ke; ++k) {
      const float wv = to_f(w[(size_t)k * N + n]);
#pragma unroll
      for (int m = 0; m < SK_MAXM; ++m)
        if (m < M) acc[m] = fmaf(to_f(x[(size_t)m * K + k]), wv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < SK_MAXM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  for (int idx = threadIdx.x; idx < SK_MAXM * SK_COLS; idx += SK_WARPS * 32) {
    const int m = idx / SK_COLS, c = idx % SK_COLS;
    const int col = blockIdx.x * SK_COLS + c;
    if (m < M && col < N) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < SK_WARPS; ++q) s += red[q][m][c];
      store_out(out, b, s, m, col, N, act);
    }
  }
}

template <class TIn, class TOut>
void launch(const void* x, const void* w, const void* b, void* out, int M, int N, int K,
            int act, cudaStream_t stream) {
  const TIn* xp = static_cast<const TIn*>(x);
  const TIn* wp = static_cast<const TIn*>(w);
  const TIn* bp = static_cast<const TIn*>(b);
  TOut* op = static_cast<TOut*>(out);
  if (M <= SK_MAXM) {
    dim3 grid((N + SK_COLS - 1) / SK_COLS);
    tile_matmul_skinny<TIn, TOut><<<grid, SK_WARPS * 32, 0, stream>>>(xp, wp, bp, op, M, N,
                                                                       K, act);
  } else {
    dim3 grid((N + FF_BN - 1) / FF_BN, (M + FF_BM - 1) / FF_BM);
    tile_matmul_ffma<TIn, TOut><<<grid, FF_THREADS, 0, stream>>>(xp, wp, bp, op, M, N, K,
                                                                  act);
  }
}

template <class TOut>
void launch_bf16(const void* x, const void* w, const void* b, void* out, int M, int N,
                 int K, int act, cudaStream_t stream) {
  if (M <= SK_MAXM) {
    launch<__nv_bfloat16, TOut>(x, w, b, out, M, N, K, act, stream);
    return;
  }
  const int vec_x = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
  tile_matmul_mma<TOut><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<TOut*>(out), M, N, K, act, vec_x);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, w and b share one type).
// Returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int tile_matmul_launch(const void* x, const void* w, const void* b, void* out,
                                  int M, int N, int K, int dtype, int out_dtype, int act,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && out_dtype == 1) {
    launch_bf16<__nv_bfloat16>(x, w, b, out, M, N, K, act, s);
  } else if (dtype == 1 && out_dtype == 0) {
    launch_bf16<float>(x, w, b, out, M, N, K, act, s);
  } else if (dtype == 0 && out_dtype == 0) {
    launch<float, float>(x, w, b, out, M, N, K, act, s);
  } else if (dtype == 0 && out_dtype == 1) {
    launch<float, __nv_bfloat16>(x, w, b, out, M, N, K, act, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
