// T1 — the measurement variants of K1 (blend_fwd.cuh) for the bisection
// tool streetunveiler_torch/tools/bisect_fwd.py: every variant at G = 0 in
// this translation unit, at G = 5 in bisect_fwd_g5.cu (so the two build in
// parallel), and the C interface.
//
// Replaces the Pallas kernels of tools/bisect_fwd.py (`make_kernel` :40,
// launched by `build_call` :266-296 at :281), which time K1's body with
// parts swapped out on the real binned stream. The variants and what each
// swaps are listed in blend_fwd.cuh. What bounds each on an H100 is what
// bounds K1: the operations of its evaluated pairs (kFull); the floor is
// bounded by staging the records once, ~0.02 GB at the street scene.

#include "blend_fwd.cuh"

// The G = 5 instantiations, in bisect_fwd_g5.cu.
cudaError_t su_bisect_fwd_g5(int variant, const float* recT, int cap, int nq,
                             int gate_row, const int32_t* tile_offsets,
                             int n_tiles, int tiles_x, float znear,
                             float zfar, float t_eps, float* acc, int32_t* lk,
                             cudaStream_t s);

// As su_blend_fwd, with the variant's index (blend_fwd.cuh's FwdVariant);
// n_gates must be 0 or 5. kFloorNoLk leaves lk unwritten.
extern "C" int su_bisect_fwd(int variant, const float* recT, int rec,
                             int cap, int nq, int n_gates, int gate_row,
                             const int32_t* tile_offsets, int n_tiles,
                             int tiles_x, float znear, float zfar,
                             float t_eps, float* acc, int32_t* lk, int device,
                             void* stream) {
  if (!fwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles) ||
      (n_gates != 0 && n_gates != 5) || variant < 0 ||
      variant >= kNumFwdVariants)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_gates == 5)
    return (int)su_bisect_fwd_g5(variant, recT, cap, nq, gate_row,
                                 tile_offsets, n_tiles, tiles_x, znear, zfar,
                                 t_eps, acc, lk, s);
  return (int)launch_variant<0>(variant, recT, cap, nq, gate_row,
                                tile_offsets, n_tiles, tiles_x, znear, zfar,
                                t_eps, acc, lk, s);
}
