// T2 — the measurement variants of K2 at nq = 12, G = 5 gated chains (the
// late step's record stream); the variants, the C interface and the
// (6, 0) instantiations are in bisect_bwd.cu, the kernel in blend_bwd.cuh.

#include "blend_bwd.cuh"

namespace su_bwd {

cudaError_t bisect_bwd_g5(int variant, const float* recT, int cap,
                          int gate_row, const int32_t* tile_offsets,
                          int n_tiles, int tiles_x, float znear, float zfar,
                          const float* acc, const int32_t* lk,
                          const float* dacc, float* dgrad, cudaStream_t s) {
  return launch_variant<12, 5>(variant, recT, cap, gate_row, tile_offsets,
                               n_tiles, tiles_x, znear, zfar, acc, lk, dacc,
                               dgrad, s);
}

// The blocks of blend_bwd_kernel<12, 5, kBwdFull> an SM holds at once.
cudaError_t bisect_bwd_g5_occupancy(int* blocks) {
  const size_t smem = smem_bytes<12, 5>();
  cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_kernel<12, 5, kBwdFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, blend_bwd_kernel<12, 5, kBwdFull>, kPix, smem);
}

}  // namespace su_bwd
