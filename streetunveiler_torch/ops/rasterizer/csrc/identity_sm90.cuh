// T7/T8's copy redesigned for the H100: dst = src for n int32 values, n a
// multiple of 128 (identity.cu's su_identity; the first design is
// su_identity_first there).
//
// The grid covers n exactly once: each thread moves kVec int4s at
// kThreads apart (all its loads before any store), 32-bit indices, no
// loop and so no loop test, a guard on the last block's tail only.
//
// At the probes' size (tile_offsets padded to 4,864 values, 19,456
// bytes) a copy in a CUDA graph costs its kernel node and one
// load-then-store round trip; `clone` there is a memcpy node, and this
// body trails it by about 0.1 µs in a graph of copies (PERF.md). A
// programmatic launch won that back only when the kernel before it was
// another such copy: after the pad's torch.cat, as on the probes' path,
// it lost 0.2 µs, and it was dropped.
//
// At the street's sorted_surfel (1,352,064 values, 5.4 MB) the copy is
// bound by bytes: 2 · 4 · n over the card's memory rate.

#pragma once

#include <cuda_runtime.h>

namespace su_copy {

constexpr int kThreads = 256;   // a block
constexpr int kVec = 2;         // int4s a thread
constexpr unsigned kPerBlock = kThreads * kVec;
// the largest n / 4 whose block-relative indices fit in 32 bits
constexpr long long kMaxN4 = 0xFFFFFFFFll - kPerBlock;

static __global__ void __launch_bounds__(kThreads)
copy_vec(const int4* __restrict__ src, int4* __restrict__ dst, unsigned n4) {
  const unsigned i = blockIdx.x * kPerBlock + threadIdx.x;
  int4 r[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const unsigned j = i + k * kThreads;
    if (j < n4) r[k] = src[j];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const unsigned j = i + k * kThreads;
    if (j < n4) dst[j] = r[k];
  }
}

// Whether the redesign refuses n values: fewer than 128, not a multiple of
// 128, or more than its 32-bit indices reach.
inline bool bad_length(long long n) {
  return n < 128 || n % 128 != 0 || n / 4 > kMaxN4;
}

// Launch copy_vec on n4 int4s, the fewest blocks that cover them.
inline void launch(const int* src, int* dst, long long n4,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n4 + kPerBlock - 1) / kPerBlock);
  copy_vec<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(dst),
      (unsigned)n4);
}

}  // namespace su_copy
