// Hopper (sm_90a) helpers shared by tile_matmul.cu, flash_attention.cu and
// flash_attention_bwd.cu: shared-memory addresses, mbarriers, wgmma
// descriptors, products and fences, and the TMA tensor-map encoder.
// kernels/_build.py hashes this header with each source, so editing it
// rebuilds every library.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// wgmma: descriptors, fences, products.
// ---------------------------------------------------------------------------
constexpr int SW_ATOM = 64 * 128;  // bytes of a 64-row x 64-column bf16 swizzle atom

// wgmma shared-memory descriptor of an operand swizzled over SWB-byte rows
// (SWB = 128, 64 or 32): start address, leading and stride byte offsets
// (16-byte units), layout 1 = B128, 2 = B64, 3 = B32.
template <int SWB>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(SWB == 128 || SWB == 64 || SWB == 32, "a wgmma swizzle");
  constexpr uint64_t layout = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return sw_desc<128>(addr, lbo, sbo);
}

// A bf16 tile of ROWS rows is stored as boxes of ROWS x SWB bytes (SWB / 2
// columns each, swizzled over SWB-byte rows: the layout a TMA box of that
// width and swizzle writes), box b holding columns b SWB / 2 ..; at D = 80
// (160-byte rows, not a whole number of 128-byte rows) SWB is 32, five boxes.
// K-major operand (k along the row): k step kk (16 columns, 32 bytes) lies in
// box 32 kk / SWB; 8-row groups 8 SWB bytes apart.
template <int SWB, int ROWS>
__device__ __forceinline__ uint64_t desc_kb(uint32_t tile, int kk) {
  return sw_desc<SWB>(tile + (32 * kk / SWB) * ROWS * SWB + (32 * kk) % SWB, 16, 8 * SWB);
}
// MN-major operand (k down the rows, n across the boxes): k step kk is rows
// 16 kk ..; boxes ROWS SWB bytes apart, 8-row groups 8 SWB.
template <int SWB, int ROWS>
__device__ __forceinline__ uint64_t desc_mnb(uint32_t tile, int kk) {
  return sw_desc<SWB>(tile + 16 * SWB * kk, ROWS * SWB, 8 * SWB);
}
// Shared address of 16-byte chunk c (columns 8c ..) of row r of such a tile.
template <int SWB, int ROWS>
__device__ __forceinline__ uint32_t sw_chunk_b(uint32_t tile, int r, int c) {
  constexpr int CB = SWB / 16;  // chunks a box row holds
  return tile + (c / CB) * ROWS * SWB + r * SWB + (((c % CB) ^ ((r * SWB >> 7) & (CB - 1))) << 4);
}
// [rows][256] tiles of four 128-byte atoms (D = 256).
__device__ __forceinline__ uint64_t desc_k256(uint32_t tile, int kk) {
  return desc_kb<128, 64>(tile, kk);
}
__device__ __forceinline__ uint64_t desc_mn256(uint32_t tile, int kk) {
  return desc_mnb<128, 64>(tile, kk);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins an accumulator in place across the asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Keeps register A fragments live until the wgmma that reads them is waited on.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4 * K; ++i) asm volatile("" : "+r"(f[i >> 2][i & 3])::"memory");
}
// Generic-proxy writes (st.shared, cp.async) before async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 2^x by the special-function unit, subnormals flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// A barrier of the 128 threads of one warpgroup (ids 1 and up; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

#define HOPPER_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_ACC16(i) \
  HOPPER_ACC4(i), HOPPER_ACC4(i + 4), HOPPER_ACC4(i + 8), HOPPER_ACC4(i + 12)
#define HOPPER_REGS8(a, b, c, d, e, f, g, h) \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define HOPPER_REGS16(a, b, c, d, e, f, g, h, i, j, k, l, m, n, o, p)                    \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h ", %" #i ", %" #j \
  ", %" #k ", %" #l ", %" #m ", %" #n ", %" #o ", %" #p

// d (64 x 64) = (acc ? d : 0) + A B over 16 k; A and B shared, K-major
// (or MN-major: TA, TB = 1).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      HOPPER_REGS16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_REGS16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_ACC16(0), HOPPER_ACC16(16)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
// d (64 x N) += A B over 16 k; A (64 x 16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B shared and MN-major: N = 64, 80, 128,
// 192, 256.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      HOPPER_REGS16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_REGS16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC16(0), HOPPER_ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs80(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      HOPPER_REGS16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_REGS16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "
      HOPPER_REGS8(32, 33, 34, 35, 36, 37, 38, 39)
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC16(0), HOPPER_ACC16(16), HOPPER_ACC4(32), HOPPER_ACC4(36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      HOPPER_REGS16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_REGS16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "
      HOPPER_REGS16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47) ", "
      HOPPER_REGS16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63)
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC16(0), HOPPER_ACC16(16), HOPPER_ACC16(32), HOPPER_ACC16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      HOPPER_REGS16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_REGS16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "
      HOPPER_REGS16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47) ", "
      HOPPER_REGS16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63) ", "
      HOPPER_REGS16(64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79) ", "
      HOPPER_REGS16(80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95)
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC16(0), HOPPER_ACC16(16), HOPPER_ACC16(32), HOPPER_ACC16(48),
        HOPPER_ACC16(64), HOPPER_ACC16(80)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      HOPPER_REGS16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_REGS16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "
      HOPPER_REGS16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47) ", "
      HOPPER_REGS16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63) ", "
      HOPPER_REGS16(64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79) ", "
      HOPPER_REGS16(80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95) ", "
      HOPPER_REGS16(96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110,
                    111) ", "
      HOPPER_REGS16(112, 113, 114, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, 126,
                    127)
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC16(0), HOPPER_ACC16(16), HOPPER_ACC16(32), HOPPER_ACC16(48),
        HOPPER_ACC16(64), HOPPER_ACC16(80), HOPPER_ACC16(96), HOPPER_ACC16(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int N>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs64(d, a, db);
  else if constexpr (N == 80) wgmma_rs80(d, a, db);
  else if constexpr (N == 128) wgmma_rs128(d, a, db);
  else if constexpr (N == 192) wgmma_rs192(d, a, db);
  else wgmma_rs256(d, a, db);
}
#undef HOPPER_REGS16
#undef HOPPER_REGS8
#undef HOPPER_ACC16
#undef HOPPER_ACC4

// ---------------------------------------------------------------------------
// Host: TMA tensor maps.
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched once through the runtime,
// so the library links against nothing but cudart.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &res);
#endif
    return (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled fails on a thread with no current context, and the
// runtime makes the device's primary context current only at a thread's first
// runtime call: a thread whose first CUDA work is a launch (an ACAN handler
// thread, say) has none yet. cudaFree(nullptr) binds it, once a thread.
inline void bind_context() {
  thread_local const cudaError_t bound = cudaFree(nullptr);
  (void)bound;
}

}  // namespace
