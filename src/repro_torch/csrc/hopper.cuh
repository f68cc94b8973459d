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

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}
// K-major operand of a [rows][256] tile of four atoms: k step kk (16 of the
// 256 columns) is 32 bytes along a 128-byte row of atom kk / 4; 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k256(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * SW_ATOM + 32 * (kk & 3), 16, 1024);
}
// MN-major operand (k down the rows, the 256 columns across the atoms): k
// step kk is 16 rows; atoms SW_ATOM bytes apart.
__device__ __forceinline__ uint64_t desc_mn256(uint32_t tile, int kk) {
  return sw128_desc(tile + 2048 * kk, SW_ATOM, 1024);
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
// A barrier of the 128 threads of one warpgroup (ids 1 and up; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

#define HOPPER_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_ACC16(i) \
  HOPPER_ACC4(i), HOPPER_ACC4(i + 4), HOPPER_ACC4(i + 8), HOPPER_ACC4(i + 12)
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
// d (64 x 256) += A B over 16 k; A (64 x 16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B shared and MN-major.
__device__ __forceinline__ void wgmma_rs256(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
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
#undef HOPPER_REGS16
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
