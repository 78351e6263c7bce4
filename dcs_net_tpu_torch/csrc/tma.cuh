// The Tensor Memory Accelerator and mbarrier helpers that kernel 2's fused
// bf16 gate (conv_same.cu) and kernel 3's staged bf16 body (tapconv.cu)
// share: one thread issues a tensor copy of a box of device memory into
// shared memory, its completion is counted on an mbarrier, and the block
// waits on the barrier's phase. The tensor maps are encoded on the host
// through cuTensorMapEncodeTiled, which the runtime hands out
// (cudaGetDriverEntryPoint): the libraries link no libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// announces `bytes` of copies to come on `bar` and arrives once
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// waits for the phase of parity `parity` to complete; a wait that outlasts
// any copy (about a second) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#pragma unroll 1
  for (int spin = 0; spin < (1 << 25); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// one thread copies a box of the tensor `map` describes, at coordinates
// (c0, .., c2), (c0, .., c3) or (c0, .., c4) (outside the tensor: zeros), to
// shared memory through the TMA unit; completion is counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace
