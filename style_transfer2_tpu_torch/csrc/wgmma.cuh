// Hopper (sm_90a) building blocks shared by the warpgroup-MMA kernels:
// conv3x3_wgmma.cu (the bf16 conv) and style.cu (the bf16 style phases).
// cp.async, bulk and tensor-map (TMA) copies into shared memory,
// mbarriers, the proxy fence that hands generic-proxy writes to wgmma, and
// wgmma.mma_async itself with both operands in shared memory, read through
// descriptors in the no-swizzle layout (core matrices of 8 rows x 16
// contiguous bytes, "rows" running along the operand's contiguous (major)
// dimension) or in the 128-byte swizzle that a TMA box of 128-byte rows
// lands in (8-row atoms of 1024 bytes, each row's 16-byte pieces permuted
// by the row's index mod 8).
//
// Descriptor offsets, as an H100 reads them (conv3x3_wgmma.cu's B and
// style.cu's operands): LBO is the byte distance between core matrices
// adjacent in K, SBO between core matrices adjacent in M (A) or N (B), in
// both majors. K-major (transpose 0): a core matrix is 8 rows of M (or N)
// by 8 contiguous K values; MN-major (transpose 1): 8 rows of K by 8
// contiguous M (or N) values.
//
// In the 128-byte swizzle (style.cu), K-major: SBO is the distance
// between 8-row groups (1024 bytes for rows packed one after the other),
// LBO unused, and a k-step of 16 moves the start address by 32 bytes
// inside the atom. MN-major: SBO between 8-row groups along K, LBO
// between the 64-value (128-byte) blocks along M or N.
//
// Everything is in namespace hopper: style.cu's float32 kernels keep
// helpers of their own under the same names.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;   // 0: no read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// One thread: `bytes` from global src to shared dst by the bulk-copy
// (TMA) engine, completing on the mbarrier bar, which expects them.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Orders the mbarrier inits before their use by the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on the mbarrier bar that also expects `bytes` more bytes
// to complete its phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One thread: the box of the tensor map at coordinates (c0, c1, c2), from
// global to shared dst by the TMA engine, completing on the mbarrier bar.
// The map must live in kernel-parameter, constant or global memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Waits until the mbarrier bar has completed the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Makes this thread's shared-memory writes (cp.async's included, once
// waited for) visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous MMAs that update it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// A shared-memory matrix descriptor in the no-swizzle layout: the start
// address, the leading byte offset (between core matrices adjacent in K)
// and the stride byte offset (adjacent in M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// The same in the 128-byte swizzle; the atoms must start 1024-byte
// aligned (a K-major start moves by 32 bytes a k-step inside one).
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  return smem_desc(addr, lbo, sbo) | (1ull << 62);
}

// d (m64 x 64, float32, the wgmma accumulator layout) = A (m64 x k16
// bf16, desc_a; K-major for TA 0, M-major for TA 1) * B (k16 x 64 bf16,
// N-major in shared memory, desc_b), plus d where scale_d is not 0.
template <int TA>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA));
}

// The same at N = 128.
template <int TA>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA));
}

// d (m64 x BN) = A * B (+ d where scale_d is not 0), BN 64 or 128; A
// K-major (TA 0) or M-major (TA 1), B N-major.
template <int BN, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d = 1) {
  static_assert(BN == 64 || BN == 128, "wgmma_ss: BN 64 or 128");
  if constexpr (BN == 64)
    wgmma_n64<TA>(d, desc_a, desc_b, scale_d);
  else
    wgmma_n128<TA>(d, desc_a, desc_b, scale_d);
}

// A tiled tensor map (cuTensorMapEncodeTiled, a driver entry point found
// through the runtime once, so no -lcuda): interleave none, L2 promotion
// by 256 bytes, zeros for coordinates past the tensor. Returns 0, the
// driver's error, or -2 where the entry point is missing.
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                        cuuint32_t rank, void* addr, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
                        const cuuint32_t* steps, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess ? (Encode)fn : nullptr;
  }();
  if (encode == nullptr) return -2;
  return (int)encode(map, type, rank, addr, dims, strides, box, steps,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
