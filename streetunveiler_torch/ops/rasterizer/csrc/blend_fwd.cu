// K1 — 2DGS blend forward: the instantiations without gated chains (nq
// 1..16) and the C interface. The kernel, its math and its design are in
// blend_fwd_sm90.cuh; the gated instantiations are in blend_fwd_gated.cu.

#include "blend_fwd_sm90.cuh"

namespace su_fwd90 {
namespace {

cudaError_t launch_ungated(int nq, SU_FWD90_PARAMS) {
#define SU_FWD_CASE(Q) \
  case Q:              \
    return launch<Q, 0>(SU_FWD90_ARGS);
  switch (nq) {
    SU_FWD_CASE(1) SU_FWD_CASE(2) SU_FWD_CASE(3) SU_FWD_CASE(4)
    SU_FWD_CASE(5) SU_FWD_CASE(6) SU_FWD_CASE(7) SU_FWD_CASE(8)
    SU_FWD_CASE(9) SU_FWD_CASE(10) SU_FWD_CASE(11) SU_FWD_CASE(12)
    SU_FWD_CASE(13) SU_FWD_CASE(14) SU_FWD_CASE(15) SU_FWD_CASE(16)
  }
#undef SU_FWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace su_fwd90

// recT [rec, cap] f32 lane-major records (rec >= 10 + nq, and > gate_row
// with gates), tile_offsets [n_tiles + 1] int32, tile_order [n_tiles]
// int32, a permutation of the tiles (block b runs tile tile_order[b]);
// acc [n_tiles, 512, nq + 6 + 4 n_gates] f32, lk [n_tiles, 512] int32.
// Gated chains are built at nq 6 and 12 only. Returns cudaGetLastError().
extern "C" int su_blend_fwd(const float* recT, int rec, int cap, int nq,
                            int n_gates, int gate_row,
                            const int32_t* tile_offsets,
                            const int32_t* tile_order, int n_tiles,
                            int tiles_x, float znear, float zfar, float t_eps,
                            float* acc, int32_t* lk, int device,
                            void* stream) {
  using namespace su_fwd90;
  if (!fwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int* blocks_per_sm = nullptr;
  if (n_gates > 0) return (int)launch_gated(n_gates, nq, SU_FWD90_ARGS);
  return (int)launch_ungated(nq, SU_FWD90_ARGS);
}

// The blocks of K1's (nq, n_gates) instantiation one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int su_blend_fwd_occupancy(int nq, int n_gates, int device,
                                      int* blocks) {
  using namespace su_fwd90;
  if (!fwd_args_ok(kQRow0 + nq + 1, 0, nq, n_gates, kQRow0 + nq, 1))
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
  if (n_gates > 0) return (int)launch_gated(n_gates, nq, SU_FWD90_ARGS);
  return (int)launch_ungated(nq, SU_FWD90_ARGS);
}
