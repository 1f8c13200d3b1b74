// cp.async helpers of the redesigned kernels: copies from device to
// shared memory that bypass the registers and complete asynchronously,
// grouped per batch. The blend kernels (blend_fwd_sm90.cuh,
// blend_bwd_sm90.cuh) copy 4 bytes at a time, the f32 alignment that
// every slot of the lane-major records has, whatever a tile's offset in
// the stream; T3 (micro_reduce_sm90.cuh) copies 16-byte pieces of whole
// rows.

#pragma once

#include <cuda_runtime.h>

namespace su_async {

__device__ __forceinline__ void copy4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 16 bytes, both addresses 16-byte aligned; cached in L2 only.
__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Close the thread's current group of copies (possibly empty).
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace su_async
