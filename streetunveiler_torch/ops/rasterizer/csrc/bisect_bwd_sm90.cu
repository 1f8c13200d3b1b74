// T2 on K2's H100 design — the measurement variants of
// blend_bwd_sm90.cuh's kernel for the bisection tool
// streetunveiler_torch/tools/bisect_bwd.py (its default design, "sm90"):
// every variant at (nq, G) = (6, 0), the photometric step's stream, in
// this translation unit; at (12, 5), the late step's, in
// bisect_bwd_sm90_g5.cu (so the two build in parallel); the `full`
// variant alone at (12, 0), the semantic step's, here too; and the C
// interface. The first design's variants stay in bisect_bwd.cu
// (su_bisect_bwd, the tool's design "first").
//
// Replaces the Pallas kernels of tools/bisect_bwd.py (`make_kernel` :36,
// launched at :199 inside `main`), which time K2's body with parts swapped
// out on the real binned stream. The variants and what each swaps are
// listed in blend_bwd_sm90.cuh; `full` is the production instantiation's
// template at its default variant, so it is the production kernel. What
// bounds each on an H100 is what bounds K2: the operations of its
// evaluated and kept pairs (kBwdFull).

#include "blend_bwd_sm90.cuh"

namespace su_bwd90 {

// The (12, 5) instantiations, in bisect_bwd_sm90_g5.cu.
cudaError_t bisect_sm90_g5(int variant, SU_BWD90_PARAMS);

}  // namespace su_bwd90

// As su_blend_bwd, with the variant's index (blend_bwd_sm90.cuh's
// BwdVariant); (nq, n_gates) must be (6, 0) or (12, 5), or (12, 0) for
// `full`. dgrad is zeroed by the caller.
extern "C" int su_bisect_bwd_sm90(int variant, const float* recT, int rec,
                                  int cap, int nq, int n_gates, int gate_row,
                                  const int32_t* tile_offsets,
                                  const int32_t* tile_order, int n_tiles,
                                  int tiles_x, float znear, float zfar,
                                  const float* acc, const int32_t* lk,
                                  const float* dacc, float* dgrad, int device,
                                  void* stream) {
  using namespace su_bwd90;
  const bool built = (nq == 6 && n_gates == 0) ||
                     (nq == 12 && n_gates == 5) ||
                     (nq == 12 && n_gates == 0 && variant == kBwdFull);
  if (!bwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles) || !built ||
      variant < 0 || variant >= kNumBwdVariants)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int* blocks_per_sm = nullptr;
  if (n_gates == 5) return (int)bisect_sm90_g5(variant, SU_BWD90_ARGS);
  if (nq == 12) return (int)launch<12, 0, kBwdFull>(SU_BWD90_ARGS);
  return (int)launch_variant<6, 0>(variant, SU_BWD90_ARGS);
}
