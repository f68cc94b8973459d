// Hopper tile_matmul: out(M, N) = act(x(M, K) @ w(K, N) + b(N)), float32
// accumulation, cast to the output type in the epilogue.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tile_matmul/kernel.py ::
// tile_matmul (body _kernel). On the TPU the (M/bm, N/bn, K/bk) grid runs in
// order and the accumulator lives in VMEM across K steps. Here every block
// owns its outputs and walks its K range in one fixed order, so the result
// is deterministic (no atomics) and a row's result does not depend on the
// rows launched with it: tiles, BK and the K order depend on (N, K) only.
//
// Four paths. The wrapper (kernels/tile_matmul/kernel.py::choose_path)
// picks one from (M, N, K, dtype, alignment) and passes it in; a path the
// shape cannot take returns cudaErrorInvalidValue, never another path.
//  * wgmma (bf16, M > 16: prefill). Bound by operations (a mamba2_2_7b
//    layer's six projections at M = 4096 are 329 GFLOP against 989 TFLOP/s).
//    A warp-specialised TMA + wgmma GEMM: one producer warp keeps a ring of
//    four 128 x BN x 64 stages in flight (x and w by TMA with the 128-byte
//    swizzle, completion on mbarriers), two consumer warpgroups each run
//    wgmma.m64nBNk16 on 64 rows and keep one wgmma group in flight while
//    the next stage lands. w is read in the reference's (K, N) layout
//    through the wgmma transpose bit (B N-major), so no weight is
//    re-laid. TMA zero-fills the M, N and K tails; bias, activation and the
//    cast are fused in registers and the stores are masked. BN is 128 or
//    256, from N. TMA needs 16-byte row strides and base pointers: K and N
//    multiples of 8, x and w 16-byte aligned. Every serving projection meets
//    that; the rest take mma.
//    Training's gradient products read their operands where they lie,
//    through two more layouts (enum Layout), never through a transposed
//    copy: dx = dz (M, N) @ w^T reads w (K, N) as a K-major B (transpose
//    bit off, one TMA box of BN rows x 64 k), and dw = x^T @ dz reads x
//    (M, K) as an MN-major A (the A transpose bit, which wgmma allows for
//    16-bit types from shared memory; two TMA boxes of 64 k-rows x 64 m).
//    Each block still owns its outputs and walks K in one order: no split-K,
//    no atomics, so dw is deterministic (its long K = tokens is walked by one
//    block a tile).
//  * mma (bf16 shapes TMA cannot address: K or N not a multiple of 8, or an
//    unaligned pointer). mma.sync.m16n8k16 from one 128 x 128 x 32 shared
//    tile, every load and store masked. Slow, and kept only for those shapes.
//  * skinny (M <= 16: decode). Bound by bytes: the weights are read once
//    (80.9 MB a mamba2_2_7b layer against 3.35 TB/s). Each thread loads 16
//    bytes of a weight row, a warp up to 512 contiguous bytes of one row
//    (contiguity is what streams fastest here), and keeps its next batch of
//    rows in flight while it multiplies the current one (registers, no
//    barrier); x's rows are staged in shared memory. K is split over a
//    cluster of up to 8 blocks whose partial sums are added through
//    distributed shared memory in rank order (no atomics, no workspace).
//    Slab width and split are set from N so the grid is one wave of one
//    block an SM: even N = 80 gives 80 blocks.
//  * ffma (float32, M > 16). True float32 FFMA (never TF32) for the float32
//    parity runs: 64 x 64 x 16 tiles, 4 x 4 outputs a thread. It takes the
//    three layouts too, with the tile loads mapped so neighbouring threads
//    read neighbouring addresses in each.
// mma and skinny take only the plain layout: no gradient product reaches
// them (training's M is the token count, and its K and N multiples of 8).
//
// Batched (tile_matmul_launch with batch = E): out(E, M, N) = act(x(E, M, K) @
// w(E, K, N)), one launch for the E experts of a MoE layer's expert
// products (the reference's einsums in models/moe.py::_expert_ffn, which
// run outside its Pallas kernel). The expert is blockIdx.z; wgmma reads x
// and w through 3-D tensor maps (K or N, rows, expert), so TMA zero-fills
// the rows past M of each expert and no tile reads another expert's rows;
// ffma offsets its pointers by the expert. bf16 takes wgmma, float32 ffma,
// whatever M: qwen2_moe_a2_7b's prefill (M = 688 rows an expert, 714 GFLOP
// a layer for the three products) is bound by operations, its decode (M =
// 32) by bytes, each expert's 17.3 MB of weights read once a layer.
// Training's expert gradients take the two transposed layouts batched:
// dx = dz (E, R, N) @ w^T with w stored (E, K, N), and dw = x^T @ dz with x
// stored (E, R, K), whose reduction runs over an expert's R = 688 capacity
// rows. The tensor maps' middle dimension is then the stored rows of one
// expert (N for w^T, R for x^T and dz), so the last K box of each expert
// (688 = 10 x 64 + 48) is zero-filled past R and never reaches the next
// expert's rows; ffma's per-expert strides (M K, K N, M N elements) are the
// same in every layout.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

enum Act { ACT_NONE = 0, ACT_TANH = 1, ACT_RELU = 2, ACT_SILU = 3, ACT_GELU = 4 };
enum Path { PATH_WGMMA = 0, PATH_MMA = 1, PATH_SKINNY = 2, PATH_FFMA = 3 };
// Where the operands of out (M, N) = x' (M, K) @ w' (K, N) lie: x' = x
// stored (M, K) or x^T with x stored (K, M); w' = w stored (K, N) or w^T
// with w stored (N, K). At most one operand is transposed.
enum Layout { PLAIN = 0, W_T = 1, X_T = 2 };

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
// bf16, M > 16, TMA-addressable: warp-specialised TMA + wgmma pipeline.
// ---------------------------------------------------------------------------
constexpr int WG_BM = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_THREADS = 288;  // warps 0-7: two consumer warpgroups; warp 8: producer

template <int BN>
struct WgTile {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;  // 128 rows of 128 bytes
  static constexpr int B_BYTES = WG_BK * BN * 2;     // BN / 64 boxes of 64 rows x 128 bytes
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the ring, its 2 x WG_STAGES mbarriers, and slack to align the ring to 1024
  static constexpr int SMEM = WG_STAGES * STAGE + 2 * WG_STAGES * 8 + 1024;
};

// One TMA box of `map` at (c0 innermost, c1, batch c2) into shared memory
// at `dst`; its bytes count toward the transactions `bar` expects.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// D(64 x BN, f32) += A(64 x 16) * B(16 x BN). TA = 1: A MN-major (else
// K-major); TB = 1: B N-major (else K-major).
template <int BN, int TA, int TB> struct Wgmma;

// The accumulator operands of one wgmma, 16 at a time.
#define TM_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TM_ACC16(i) TM_ACC4(i), TM_ACC4(i + 4), TM_ACC4(i + 8), TM_ACC4(i + 12)

template <int TA, int TB> struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : TM_ACC16(0), TM_ACC16(16), TM_ACC16(32), TM_ACC16(48)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<256, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : TM_ACC16(0), TM_ACC16(16), TM_ACC16(32), TM_ACC16(48),
          TM_ACC16(64), TM_ACC16(80), TM_ACC16(96), TM_ACC16(112)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

#undef TM_ACC16
#undef TM_ACC4
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <int BN, int LAYOUT, class TOut>
__global__ void __launch_bounds__(WG_THREADS, 1)
tile_matmul_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_w,
                  const __nv_bfloat16* __restrict__ b, TOut* __restrict__ out, int M, int N,
                  int K, int act) {
  using T = WgTile<BN>;
  constexpr int TA = LAYOUT == X_T, TB = LAYOUT != W_T;
  extern __shared__ __align__(1024) unsigned char dyn_smem[];
  // Stage s: A at ring + s * STAGE, then B. A, K-major: 128 m-rows of 64 k
  // (128 bytes each); MN-major (X_T): two boxes of (64 k-rows x 64 m), one
  // a warpgroup. B, N-major: BN / 64 boxes of (64 k-rows x 64 n); K-major
  // (W_T): one box of BN n-rows x 64 k. Each box is 128-byte swizzled.
  const uint32_t ring = (smem_u32(dyn_smem) + 1023) & ~1023u;
  const uint32_t full = ring + WG_STAGES * T::STAGE, empty = full + WG_STAGES * 8;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive.expect_tx
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(empty + 8 * s, ((kt / WG_STAGES) & 1) ^ 1);
        const uint32_t sa = ring + s * T::STAGE, sb = sa + T::A_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, T::STAGE);
        if constexpr (TA) {
          tma_load(sa, &tmap_x, bar, m0, kt * WG_BK, z);
          tma_load(sa + WG_BK * 128, &tmap_x, bar, m0 + 64, kt * WG_BK, z);
        } else {
          tma_load(sa, &tmap_x, bar, kt * WG_BK, m0, z);
        }
        if constexpr (TB) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sb + j * (WG_BK * 128), &tmap_w, bar, n0 + 64 * j, kt * WG_BK, z);
        } else {
          tma_load(sb, &tmap_w, bar, kt * WG_BK, n0, z);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(full + 8 * s, (kt / WG_STAGES) & 1);
    const uint32_t stage = ring + s * T::STAGE;
    const uint32_t sa = stage + wg * (64 * 128), sb = stage + T::A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // K-major operand: 16 k = 32 bytes along the swizzled row; 8-row groups
      //   1024 bytes apart.
      // MN-major operand: 16 k-rows = 2048 bytes; 8-row groups 1024 apart
      //   (stride), 64-column boxes WG_BK * 128 bytes apart (leading).
      const uint64_t da = TA ? sw128_desc(sa + 2048 * kk, WG_BK * 128, 1024)
                             : sw128_desc(sa + 32 * kk, 16, 1024);
      const uint64_t db = TB ? sw128_desc(sb + 2048 * kk, WG_BK * 128, 1024)
                             : sw128_desc(sb + 32 * kk, 16, 1024);
      Wgmma<BN, TA, TB>::mma(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    fence_acc(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % WG_STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue. Accumulator fragment: acc[4j + 2h + e] is row 16 (warp % 4) +
  // lane / 4 + 8h, column 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN.
  out += (size_t)z * M * N;
  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col < N) {  // N is even, so col + 1 < N too
      const float b0 = b != nullptr ? __bfloat162float(b[col]) : 0.f;
      const float b1 = b != nullptr ? __bfloat162float(b[col + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < M)
          store2(out + (size_t)r * N + col, act_apply(acc[4 * j + 2 * h] + b0, act),
                 act_apply(acc[4 * j + 2 * h + 1] + b1, act));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 shapes TMA cannot address: mma.sync.m16n8k16 (row.col, f32 accum).
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
                 int act, int layout) {
  __shared__ float As[FF_BK][FF_BM + 4];  // k-major: row reads broadcast
  __shared__ float Bs[FF_BK][FF_BN + 4];
  x += (size_t)blockIdx.z * M * K;  // the expert of a batched launch
  w += (size_t)blockIdx.z * K * N;
  out += (size_t)blockIdx.z * M * N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * FF_BM, n0 = blockIdx.x * FF_BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FF_BK) {
    // Each tile load walks the operand's contiguous axis across neighbouring
    // threads: k for x (M, K) and w^T (N, K), m for x^T, n for w (K, N).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool xt = layout == X_T;
      const int m = xt ? tid & 63 : (tid >> 4) + 16 * i;
      const int k = xt ? (tid >> 6) + 4 * i : tid & 15;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K)
                     ? to_f(x[xt ? (size_t)gk * M + gm : (size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool wt = layout == W_T;
      const int k = wt ? tid & 15 : (tid >> 6) + 4 * i;
      const int n = wt ? (tid >> 4) + 16 * i : tid & 63;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N)
                     ? to_f(w[wt ? (size_t)gn * K + gk : (size_t)gk * N + gn]) : 0.f;
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
// M <= 16 (decode): weight streaming, K split over a cluster of blocks.
// ---------------------------------------------------------------------------
constexpr int SK_MAXM = 16, SK_THREADS = 256, SK_WARPS = SK_THREADS / 32;
constexpr int SK_MAX_SPLIT = 8, SK_MAX_LG = 5, SK_U = 4;  // lanes <= 2^SK_MAX_LG

// Shared memory of one block: x's chunk of XCH rows, then the warps'
// partial sums [SK_WARPS][MT][cols]. XCH = SK_WARPS * (VEC << SK_MAX_LG) is
// a multiple of 256 whatever MT is, so chunking keeps each thread's row order.
template <int MT, int VEC>
constexpr int sk_smem() {
  return SK_WARPS * MT * (VEC << SK_MAX_LG) * static_cast<int>(sizeof(float));
}

// 16 bytes of a weight row as float32: 8 bf16 or 4 float.
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// acc[m][j] += x[m][k] * w[k][col + j] for one row k; xr = x[0..MT)[k].
template <int MT, int VEC>
__device__ __forceinline__ void fma_row(float (&acc)[MT][VEC], uint4 wv, const float* xr) {
  float wf[VEC];
  unpack(wv, wf);
#pragma unroll
  for (int q = 0; q < MT / 4; ++q) {
    const float4 xv = reinterpret_cast<const float4*>(xr)[q];
    const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[4 * q + i][j] = fmaf(xq[i], wf[j], acc[4 * q + i][j]);
  }
}

// Block (slab, rank) of a cluster of `split`: columns [slab * cols, +cols),
// K rows [rank * kc, +kc). Thread (rl, c) owns 16 bytes at column group c
// and walks rows rl, rl + rows, ... in batches of SK_U, the next batch in
// flight while the current one is multiplied; x's rows are staged in
// shared memory XCH rows at a time. lanes = 2^lg_log2, rows = 256 / lanes.
template <class TIn, class TOut, int MT>
__global__ void __launch_bounds__(SK_THREADS, SK_MAXM / MT)
tile_matmul_skinny(const TIn* __restrict__ x, const TIn* __restrict__ w,
                   const TIn* __restrict__ b, TOut* __restrict__ out, int M, int N, int K,
                   int act, int lg_log2, int split) {
  constexpr int VEC = 16 / sizeof(TIn), XCH = SK_WARPS * (VEC << SK_MAX_LG);
  extern __shared__ __align__(1024) unsigned char dyn_smem[];
  float* xs = reinterpret_cast<float*>(dyn_smem);  // K loop: x chunk as [XCH][MT]
  float* red = xs;                                 // then: partials [SK_WARPS][MT][cols]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slab = blockIdx.x / split;
  const int lanes = 1 << lg_log2, rows = SK_THREADS >> lg_log2, cols = lanes * VEC;
  const int tid = threadIdx.x, c = tid & (lanes - 1), rl = tid >> lg_log2;
  const int col = slab * cols + c * VEC;
  const size_t ld = N / VEC;  // a weight row in 16-byte units
  const uint4* wp = reinterpret_cast<const uint4*>(w + col);
  const int kc = (K + split - 1) / split;
  const int kb = min(K, rank * kc), ke = min(K, kb + kc);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += XCH) {
    const int len = min(XCH, ke - k0);
    auto load = [&](uint4 (&r)[SK_U], int first) {
#pragma unroll
      for (int u = 0; u < SK_U; ++u) {
        const int kk = first + u * rows;
        r[u] = (col < N && kk < len) ? __ldg(wp + (size_t)(k0 + kk) * ld)
                                     : make_uint4(0, 0, 0, 0);
      }
    };
    uint4 cur[SK_U];
    load(cur, rl);  // in flight while x is staged
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < len * MT; i += 8 * SK_THREADS) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = i + q * SK_THREADS, m = j % MT;
        v[q] = (j < len * MT && m < M) ? to_f(x[(size_t)m * K + k0 + j / MT]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (i + q * SK_THREADS < len * MT) xs[i + q * SK_THREADS] = v[q];
    }
    __syncthreads();
    for (int kk = rl; kk < len; kk += SK_U * rows) {
      uint4 next[SK_U];
      load(next, kk + SK_U * rows);
#pragma unroll
      for (int u = 0; u < SK_U; ++u)
        if (kk + u * rows < len) fma_row(acc, cur[u], xs + (kk + u * rows) * MT);
#pragma unroll
      for (int u = 0; u < SK_U; ++u) cur[u] = next[u];
    }
  }

  // 1. Row lanes of one warp that share a column group: a fixed butterfly.
  for (int off = 16; off >= lanes; off >>= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  // 2. The block's warps, in warp order, into red[0].
  __syncthreads();  // xs is no longer read
  const int warp = tid >> 5, lane = tid & 31, count = MT * cols;
  if (lane < lanes)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(warp * MT + m) * cols + c * VEC + j] = acc[m][j];
  __syncthreads();
  for (int e = tid; e < count; e += SK_THREADS) {
    float s = red[e];
    for (int q = 1; q < SK_WARPS; ++q) s += red[q * count + e];
    red[e] = s;
  }
  // 3. The cluster's K splits, in rank order; each block finishes 1/split.
  cluster.sync();
  for (int e = rank * SK_THREADS + tid; e < count; e += SK_THREADS * split) {
    float part[SK_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < SK_MAX_SPLIT; ++r)
      part[r] = r < split ? cluster.map_shared_rank(red, r)[e] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < SK_MAX_SPLIT; ++r) s += part[r];
    const int m = e / cols, n = slab * cols + e % cols;
    if (m < M && n < N) store_out(out, b, s, m, n, N, act);
  }
  cluster.sync();  // keep this block's partials alive until every rank has read them
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
// `batch` row-major bf16 (rows, cols) matrices, one after another, read in
// boxes of (box_rows, 64 columns = 128 bytes) of one matrix with the
// 128-byte swizzle; boxes past a matrix's edge fill with zeros.
bool encode_bf16(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                 int batch) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  bind_context();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

template <int BN, int LAYOUT, class TOut>
cudaError_t launch_wgmma(const void* x, const void* w, const void* b, void* out, int M, int N,
                         int K, int act, int batch, cudaStream_t stream) {
  CUtensorMap tx, tw;
  const bool ok_x = LAYOUT == X_T ? encode_bf16(&tx, x, K, M, WG_BK, batch)
                                  : encode_bf16(&tx, x, M, K, WG_BM, batch);
  const bool ok_w = LAYOUT == W_T ? encode_bf16(&tw, w, N, K, BN, batch)
                                  : encode_bf16(&tw, w, K, N, WG_BK, batch);
  if (!ok_x || !ok_w) return cudaErrorInvalidValue;
  auto kernel = tile_matmul_wgmma<BN, LAYOUT, TOut>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgTile<BN>::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + BN - 1) / BN, (M + WG_BM - 1) / WG_BM, batch);
  kernel<<<grid, WG_THREADS, WgTile<BN>::SMEM, stream>>>(
      tx, tw, static_cast<const __nv_bfloat16*>(b), static_cast<TOut*>(out), M, N, K, act);
  return cudaGetLastError();
}

template <class TIn, class TOut, int MT>
cudaError_t launch_skinny(const void* x, const void* w, const void* b, void* out, int M,
                          int N, int K, int act, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TIn);
  // One block an SM: the widest column slab (up to 32 x 16 bytes a row,
  // which streams best) for which a split of 8 still gives that many
  // blocks, then the split (up to 8) that comes nearest below it. Set by N
  // alone.
  const int target = sm_count(), groups = N / VEC;
  int lg = SK_MAX_LG;
  while (lg > 0 && ((groups + (1 << lg) - 1) >> lg) * SK_MAX_SPLIT < target) --lg;
  const int slabs = (groups + (1 << lg) - 1) >> lg;
  const int split = std::min(SK_MAX_SPLIT, std::max(1, target / slabs));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs * split);
  cfg.blockDim = dim3(SK_THREADS);
  constexpr int smem = sk_smem<MT, VEC>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      tile_matmul_skinny<TIn, TOut, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tile_matmul_skinny<TIn, TOut, MT>,
                            static_cast<const TIn*>(x), static_cast<const TIn*>(w),
                            static_cast<const TIn*>(b), static_cast<TOut*>(out), M, N, K, act,
                            lg, split);
}

template <int LAYOUT, class TOut>
cudaError_t launch_wgmma_bn(const void* x, const void* w, const void* b, void* out, int M,
                            int N, int K, int act, int batch, cudaStream_t stream) {
  return N >= 512 ? launch_wgmma<256, LAYOUT, TOut>(x, w, b, out, M, N, K, act, batch, stream)
                  : launch_wgmma<128, LAYOUT, TOut>(x, w, b, out, M, N, K, act, batch, stream);
}

// `batch` products of (M, N, K), one after another in x, w and out: the
// expert axis of a batched launch (1 otherwise), blockIdx.z of the wgmma
// and ffma grids; skinny and mma take only 1 (path_fits).
template <class TIn, class TOut>
cudaError_t launch(int path, int layout, const void* x, const void* w, const void* b,
                   void* out, int M, int N, int K, int act, int batch, cudaStream_t stream) {
  if (path == PATH_SKINNY)
    return M <= 8 ? launch_skinny<TIn, TOut, 8>(x, w, b, out, M, N, K, act, stream)
                  : launch_skinny<TIn, TOut, 16>(x, w, b, out, M, N, K, act, stream);
  if constexpr (std::is_same<TIn, __nv_bfloat16>::value) {
    if (path == PATH_WGMMA) {
      switch (layout) {
        case W_T: return launch_wgmma_bn<W_T, TOut>(x, w, b, out, M, N, K, act, batch, stream);
        case X_T: return launch_wgmma_bn<X_T, TOut>(x, w, b, out, M, N, K, act, batch, stream);
        default:
          return launch_wgmma_bn<PLAIN, TOut>(x, w, b, out, M, N, K, act, batch, stream);
      }
    }
    const int vec_x = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
    tile_matmul_mma<TOut><<<grid, MMA_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), static_cast<TOut*>(out), M, N, K, act, vec_x);
  } else {
    dim3 grid((N + FF_BN - 1) / FF_BN, (M + FF_BM - 1) / FF_BM, batch);
    tile_matmul_ffma<TIn, TOut><<<grid, FF_THREADS, 0, stream>>>(
        static_cast<const TIn*>(x), static_cast<const TIn*>(w), static_cast<const TIn*>(b),
        static_cast<TOut*>(out), M, N, K, act, layout);
  }
  return cudaGetLastError();
}

// Whether `path` can take this shape and layout; the wrapper's choose_path
// mirrors it. TMA needs 16-byte row strides: the stored rows of x and w are
// K long (w^T's too), except x^T's, which are M long (then K counts rows).
bool path_fits(int path, int layout, int M, int N, int K, int dtype, const void* x,
               const void* w, int batch) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int elem = dtype == 1 ? 2 : 4;
  if (layout < PLAIN || layout > X_T || batch < 1 || batch > 65535) return false;
  if (batch > 1 && path != PATH_WGMMA && path != PATH_FFMA) return false;
  switch (path) {
    case PATH_WGMMA:
      return dtype == 1 && K > 0 && N % 8 == 0 && aligned &&
             (layout == X_T ? M % 8 == 0 : K % 8 == 0);
    case PATH_MMA: return dtype == 1 && layout == PLAIN;
    case PATH_SKINNY:
      return M <= SK_MAXM && (N * elem) % 16 == 0 && aligned && layout == PLAIN;
    case PATH_FFMA: return dtype == 0;
    default: return false;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, w and b share one type); path
// codes as enum Path, layout codes as enum Layout; (M, N, K) are the
// product's: out (M, N), reduction K, whatever the layout. `batch` > 1 is a
// batched launch: x (batch, M, K) @ w (batch, K, N) [+ b (N,), the same for
// every expert] -> out (batch, M, N) in any layout (each expert's x and w
// stored as the layout says), wgmma or ffma path.
// Returns cudaGetLastError() after the launch (0 means launched), or
// cudaErrorInvalidValue for a path the shape or layout cannot take.
extern "C" int tile_matmul_launch(const void* x, const void* w, const void* b, void* out,
                                  int M, int N, int K, int dtype, int out_dtype, int act,
                                  int path, int layout, int batch, void* stream) {
  if (dtype < 0 || dtype > 1 || out_dtype < 0 || out_dtype > 1 || M < 1 || N < 1 || K < 0 ||
      !path_fits(path, layout, M, N, K, dtype, x, w, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1 && out_dtype == 1) {
    e = launch<__nv_bfloat16, __nv_bfloat16>(path, layout, x, w, b, out, M, N, K, act, batch, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16, float>(path, layout, x, w, b, out, M, N, K, act, batch, s);
  } else if (out_dtype == 0) {
    e = launch<float, float>(path, layout, x, w, b, out, M, N, K, act, batch, s);
  } else {
    e = launch<float, __nv_bfloat16>(path, layout, x, w, b, out, M, N, K, act, batch, s);
  }
  return static_cast<int>(e);
}
