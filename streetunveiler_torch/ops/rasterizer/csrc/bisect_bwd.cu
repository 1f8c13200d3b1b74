// T2 — the measurement variants of K2 (blend_bwd.cuh) for the bisection
// tool streetunveiler_torch/tools/bisect_bwd.py: every variant at
// (nq, G) = (6, 0), the photometric step's stream, in this translation
// unit; at (12, 5), the late step's, in bisect_bwd_g5.cu (so the two build
// in parallel); and the C interface.
//
// Replaces the Pallas kernels of tools/bisect_bwd.py (`make_kernel` :36,
// launched at :199 inside `main`), which time K2's body with parts swapped
// out on the real binned stream. The variants and what each swaps are
// listed in blend_bwd.cuh. What bounds each on an H100 is what bounds K2:
// the operations of its evaluated and kept pairs (kBwdFull).

#include "blend_bwd.cuh"

namespace su_bwd {

// The (12, 5) instantiations, in bisect_bwd_g5.cu.
cudaError_t bisect_bwd_g5(int variant, const float* recT, int cap,
                          int gate_row, const int32_t* tile_offsets,
                          int n_tiles, int tiles_x, float znear, float zfar,
                          const float* acc, const int32_t* lk,
                          const float* dacc, float* dgrad, cudaStream_t s);

}  // namespace su_bwd

// As su_blend_bwd, with the variant's index (blend_bwd.cuh's BwdVariant);
// (nq, n_gates) must be (6, 0) or (12, 5). dgrad is zeroed by the caller.
extern "C" int su_bisect_bwd(int variant, const float* recT, int rec,
                             int cap, int nq, int n_gates, int gate_row,
                             const int32_t* tile_offsets, int n_tiles,
                             int tiles_x, float znear, float zfar,
                             const float* acc, const int32_t* lk,
                             const float* dacc, float* dgrad, int device,
                             void* stream) {
  using namespace su_bwd;
  const bool built = (nq == 6 && n_gates == 0) || (nq == 12 && n_gates == 5);
  if (!bwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles) || !built ||
      variant < 0 || variant >= kNumBwdVariants)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_gates == 5)
    return (int)bisect_bwd_g5(variant, recT, cap, gate_row, tile_offsets,
                              n_tiles, tiles_x, znear, zfar, acc, lk, dacc,
                              dgrad, s);
  return (int)launch_variant<6, 0>(variant, recT, cap, gate_row,
                                   tile_offsets, n_tiles, tiles_x, znear,
                                   zfar, acc, lk, dacc, dgrad, s);
}
