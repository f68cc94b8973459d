// Hopper flash_attention: causal GQA FlashAttention-2 forward with online
// softmax (m, l, acc in float32), scale 1/sqrt(D), optional logit softcap
// tanh(s/c)*c, causal mask with q_offset, sliding window kv > q - window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// :: flash_attention (body _kernel). The TPU kernel walks KV blocks as the
// innermost sequential grid axis and keeps (m, l, acc) in VMEM scratch; here
// one block owns one (batch * kv-head, row tile) and loops over the KV tiles
// itself, carrying (m, l, acc) in registers.
//
// Layout: q, o (BH, G, Tq, D); k, v (BH, Tkv, D). The G query heads that
// share a KV head are folded into the row dimension as row = t * G + g, so a
// tile of 64 rows covers a contiguous run of query positions of all G heads:
// each K/V tile is loaded once into shared memory and serves all of them
// (GQA's point: K/V traffic divided by G), and G need not be a power of two
// (smollm_360m has G = 3).
//
// What bounds it on an H100, and what the design does about it: causal
// prefill attention at smollm's shapes is about 4 GFLOP against 21 MB a
// layer, so by the card's tensor-core rate it would be bound by bytes. This
// first version computes in float32 FFMA (both S = QK^T and PV), so in
// practice it is bound by FFMA issue and shared-memory reads: each thread
// keeps a 4-row x 8-key score tile and a 4-row x D/8 output tile in
// registers, reads Q and K rows from padded (conflict-free) shared memory,
// and tiles outside the causal/window band are never loaded. mma.sync or
// wgmma for the two products is the next step.
//
// Masking reproduces the reference constants: masked scores are -1e30 (not
// -inf) and l is clamped at 1e-30. Ragged Tq and Tkv tails are masked. P is
// rounded to the input type before PV, as the reference casts p to v.dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;     // (query position, head) rows a block owns
constexpr int BK = 64;       // keys a KV tile holds
constexpr int THREADS = 128; // 16 row groups of 4 rows x 8 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return ROWS * (D + 1) + BK * (D + 1) + BK * D + ROWS * (BK + 1);
}

template <class T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int G, int Tq, int Tkv, int causal, int window,
          float softcap, int q_offset, float scale) {
  constexpr int DJ = D / 8;  // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                   // [ROWS][D + 1]
  float* Ks = Qs + ROWS * (D + 1);    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D]
  float* Ps = Vs + BK * D;            // [ROWS][BK + 1]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, r0 = blockIdx.x * ROWS;
  const int R = G * Tq;
  const T* qb = q + (size_t)bh * R * D;
  const T* kb = k + (size_t)bh * Tkv * D;
  const T* vb = v + (size_t)bh * Tkv * D;
  T* ob = o + (size_t)bh * R * D;

  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, rr = r0 + r;
    float val = 0.f;
    if (rr < R) val = to_f(qb[((size_t)(rr % G) * Tq + rr / G) * D + d]);
    Qs[r * (D + 1) + d] = val;
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
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D, d = idx % D, kp = kv0 + c;
      const bool in = kp < Tkv;
      Ks[c * (D + 1) + d] = in ? to_f(kb[(size_t)kp * D + d]) : 0.f;
      Vs[c * D + d] = in ? to_f(vb[(size_t)kp * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = Ks[(tx + 8 * j) * (D + 1) + d];
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
        const float vv = Vs[c * D + tx + 8 * j];
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
    T* orow = ob + ((size_t)(rr % G) * Tq + rr / G) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 8 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <class T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int G,
                   int Tq, int Tkv, int causal, int window, float softcap, int q_offset,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((G * Tq + ROWS - 1) / ROWS, BH);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), G, Tq, Tkv, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, int BH,
                     int G, int Tq, int Tkv, int causal, int window, float softcap,
                     int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. D in {16, 32, 64, 128}.
// Returns the CUDA error of the launch; 0 means launched.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int G, int Tq, int Tkv, int D, int dtype,
                                      int causal, int window, float softcap, int q_offset,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(D, q, k, v, o, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(D, q, k, v, o, BH, G, Tq, Tkv, causal, window, softcap, q_offset, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
