// T1 on K1's H100 design — the measurement variants of
// blend_fwd_sm90.cuh's kernel for the bisection tool
// streetunveiler_torch/tools/bisect_fwd.py (its default design, "sm90"):
// every variant at (nq, G) = (6, 0), the photometric step's stream, in
// this translation unit; at (12, 5), the late step's, in
// bisect_fwd_sm90_g5.cu (so the two build in parallel); the `full`
// variant alone at (12, 0), the semantic step's, here too; and the C
// interface. The first design's variants stay in bisect_fwd.cu
// (su_bisect_fwd, the tool's design "first").
//
// Replaces the Pallas kernels of tools/bisect_fwd.py (`make_kernel` :40,
// launched by `build_call` at :281), which time K1's body with parts
// swapped out on the real binned stream. The variants and what each
// swaps are listed in blend_fwd_sm90.cuh; `full` is the production
// instantiation's template at its default variant, so it is the
// production kernel. What bounds each on an H100 is what bounds K1: the
// operations of its evaluated pairs (kFull); the floors are bounded by
// staging the records once.

#include "blend_fwd_sm90.cuh"

namespace su_fwd90 {

// The (12, 5) instantiations, in bisect_fwd_sm90_g5.cu.
cudaError_t bisect_sm90_g5(int variant, SU_FWD90_PARAMS);

namespace {

bool bisect_built(int variant, int nq, int n_gates) {
  return (nq == 6 && n_gates == 0) || (nq == 12 && n_gates == 5) ||
         (nq == 12 && n_gates == 0 && variant == kFull);
}

cudaError_t bisect_sm90(int variant, int nq, int n_gates, SU_FWD90_PARAMS) {
  if (n_gates == 5) return bisect_sm90_g5(variant, SU_FWD90_ARGS);
  if (nq == 12) return launch<12, 0, kFull>(SU_FWD90_ARGS);
  return launch_variant<6, 0>(variant, SU_FWD90_ARGS);
}

}  // namespace
}  // namespace su_fwd90

// As su_blend_fwd, with the variant's index (blend_fwd_sm90.cuh's
// FwdVariant); (nq, n_gates) must be (6, 0) or (12, 5), or (12, 0) for
// `full`. kFloorNoLk leaves lk unwritten.
extern "C" int su_bisect_fwd_sm90(int variant, const float* recT, int rec,
                                  int cap, int nq, int n_gates, int gate_row,
                                  const int32_t* tile_offsets,
                                  const int32_t* tile_order, int n_tiles,
                                  int tiles_x, float znear, float zfar,
                                  float t_eps, float* acc, int32_t* lk,
                                  int device, void* stream) {
  using namespace su_fwd90;
  if (!fwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles) ||
      variant < 0 || variant >= kNumFwdVariants ||
      !bisect_built(variant, nq, n_gates))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int* blocks_per_sm = nullptr;
  return (int)bisect_sm90(variant, nq, n_gates, SU_FWD90_ARGS);
}

// The blocks of the `full` variant at (nq, n_gates) one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks. Every
// variant has the same launch bounds and shared memory.
extern "C" int su_bisect_fwd_sm90_occupancy(int nq, int n_gates, int device,
                                            int* blocks) {
  using namespace su_fwd90;
  const int variant = kFull;
  if (!fwd_args_ok(kQRow0 + nq + 1, 0, nq, n_gates, kQRow0 + nq, 1) ||
      !bisect_built(variant, nq, n_gates))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* recT = nullptr;
  const int32_t *tile_offsets = nullptr, *tile_order = nullptr;
  float* acc = nullptr;
  int32_t* lk = nullptr;
  const int cap = 0, gate_row = 0, n_tiles = 0, tiles_x = 0;
  const float znear = 0.0f, zfar = 0.0f, t_eps = 0.0f;
  cudaStream_t s = nullptr;
  int* blocks_per_sm = blocks;
  return (int)bisect_sm90(variant, nq, n_gates, SU_FWD90_ARGS);
}
