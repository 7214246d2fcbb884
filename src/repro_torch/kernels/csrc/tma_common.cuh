// Tensor Memory Accelerator (TMA), mbarrier and wgmma helpers shared by the
// attention kernels (flash_attention.cu, decode_attention.cu) and the SSD
// kernel (ssd_scan.cu), sm_90a.
//
// Host: `tensor_map` encodes a tiled tensor map over a strided view (any
// data type, box and swizzle), through `cuTensorMapEncodeTiled`, which is
// fetched from the driver at run time so that a library links nothing but
// libcudart. Device: mbarrier init / arrive / expect-tx / wait, 3-D, 4-D
// and 5-D TMA loads that complete on an mbarrier, a 4-D TMA store in bulk
// async-groups, the proxy fence that orders threads' shared-memory stores
// before asynchronous (wgmma, TMA) reads, wgmma descriptors, fence, commit
// and wait, named barriers, `hold` (registers a pending wgmma uses) and
// `WG_ACC8` (a wgmma's accumulator operands), as inline PTX.
#pragma once

#include <cuda.h>            // CUtensorMap; the encoder is fetched at run time
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// stores of this thread to shared memory, made visible to the async proxy
// (wgmma operands, TMA) before a barrier hands them over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a box of the tensor map at the given element coordinates (innermost
// first) into shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// a box of shared memory at `src` to the tensor map's element coordinates,
// as a bulk async-group of this thread (commit, then wait for its reads
// before `src` is written again and for its end before the block exits)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(m)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// `lbo` and `sbo` are the leading and stride byte offsets. K-major (B3's q
// and K, B5's operands): lbo unused, sbo = 1024 between 8-row groups.
// MN-major (B3's V): lbo = the 64-column blocks' stride, sbo = 1024 between
// groups of 8 k rows
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// named barrier `id` over `n` threads: wait for it, or arrive without
// waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// eight fp32 accumulator operands d[i] .. d[i + 7] of a wgmma's asm
#define WG_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// registers an asynchronous wgmma reads or writes: kept in place (and
// alive) until its wait_group has passed
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void hold(unsigned (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void hold(unsigned (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e]) :: "memory");
}

// cuTensorMapEncodeTiled is a driver function: fetched once through the
// runtime, so that the library links nothing but libcudart
inline PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// a tensor map of `rank` dims of `type` (`elem_bytes` each) over `ptr`:
// extents `dims` and element strides `st` (of dims 1..rank-1), innermost
// first, the innermost contiguous; boxes of `box` elements, `swizzle`, L2
// sectors fetched as `promotion` asks, zero fill out of bounds. A dim of
// extent 1 is never stepped: its stride is set to 16 bytes so the map takes
// any view. False if the encoder is missing or refuses (TMA needs 16-byte
// aligned `ptr` and strides)
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       int elem_bytes, const void* ptr, int rank,
                       const long long* dims, const long long* st,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                       CUtensorMapL2promotion promotion =
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  cuuint64_t gdim[5], gst[4];
  cuuint32_t es[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    es[i] = 1;
  }
  for (int i = 1; i < rank; ++i)
    gst[i - 1] = dims[i] == 1
                     ? 16
                     : static_cast<cuuint64_t>(st[i - 1]) * elem_bytes;
  PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(ptr), gdim, gst,
                const_cast<cuuint32_t*>(box), es,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
