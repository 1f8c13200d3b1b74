// T7/T8's copy, the first design (identity.cu's su_identity_first): a
// grid-stride loop of 16-byte loads and stores with 64-bit indices.
// Shared with identity_split.cu, which runs its body on other grids.

#pragma once

#include <cuda_runtime.h>

namespace su_copy {

template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
copy_int4(const int4* __restrict__ src, int4* __restrict__ dst,
          long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

}  // namespace su_copy
