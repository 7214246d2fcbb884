// Tensor Memory Accelerator (TMA) and mbarrier helpers shared by the
// attention kernels (flash_attention.cu, decode_attention.cu), sm_90a.
//
// Host: `tensor_map` encodes a tiled tensor map over a strided view (any
// data type, box and swizzle), through `cuTensorMapEncodeTiled`, which is
// fetched from the driver at run time so that a library links nothing but
// libcudart. Device: mbarrier init / arrive / expect-tx / wait and 4-D and
// 5-D TMA loads that complete on an mbarrier, as inline PTX.
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

// a box of the tensor map at the given element coordinates (innermost
// first) into shared memory at `dst`, completing on `bar`
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
