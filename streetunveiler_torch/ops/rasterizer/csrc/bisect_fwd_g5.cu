// T1 — the measurement variants of K1 at G = 5 gated chains (the late
// phase's record stream); the variants, the C interface and the G = 0
// instantiations are in bisect_fwd.cu, the kernel in blend_fwd.cuh.

#include "blend_fwd.cuh"

cudaError_t su_bisect_fwd_g5(int variant, const float* recT, int cap, int nq,
                             int gate_row, const int32_t* tile_offsets,
                             int n_tiles, int tiles_x, float znear,
                             float zfar, float t_eps, float* acc, int32_t* lk,
                             cudaStream_t s) {
  return launch_variant<5>(variant, recT, cap, nq, gate_row, tile_offsets,
                           n_tiles, tiles_x, znear, zfar, t_eps, acc, lk, s);
}

// The blocks of blend_fwd_kernel<5, kFull> an SM holds at once.
cudaError_t su_bisect_fwd_g5_occupancy(int nq, int* blocks) {
  const size_t smem = (size_t)(kGeo + nq + staged_rows_extra<5, kFull>()) *
                      kBatch * sizeof(float);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, blend_fwd_kernel<5, kFull>, kPix, smem);
}
