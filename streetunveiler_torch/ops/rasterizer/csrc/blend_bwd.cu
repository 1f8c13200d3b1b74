// K2 — 2DGS blend backward: the instantiations without gated chains and
// the C interface. The kernel, its math and its design are in
// blend_bwd_sm90.cuh; the gated instantiations are in blend_bwd_gated.cu.

#include "blend_bwd_sm90.cuh"

// recT [rec, cap] f32 lane-major records (rec >= 10 + nq, and > gate_row
// with gates); tile_offsets [n_tiles + 1] int32; tile_order [n_tiles]
// int32, a permutation of the tiles (block b runs tile tile_order[b]);
// acc and dacc [n_tiles, 512, nq + 6 + 4 n_gates] f32; lk [n_tiles, 512]
// int32; dgrad [rec, cap] f32, zeroed by the caller. Returns
// cudaGetLastError().
extern "C" int su_blend_bwd(const float* recT, int rec, int cap, int nq,
                            int n_gates, int gate_row,
                            const int32_t* tile_offsets,
                            const int32_t* tile_order, int n_tiles,
                            int tiles_x, float znear, float zfar,
                            const float* acc, const int32_t* lk,
                            const float* dacc, float* dgrad, int device,
                            void* stream) {
  using namespace su_bwd90;
  if (!bwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int* blocks_per_sm = nullptr;
  if (n_gates > 0)
    return (int)launch_gated(n_gates, nq, SU_BWD90_ARGS);
  return (int)launch_nq<0>(nq, SU_BWD90_ARGS);
}

// The blocks of K2's (nq, n_gates) instantiation one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int su_blend_bwd_occupancy(int nq, int n_gates, int device,
                                      int* blocks) {
  using namespace su_bwd90;
  if (!bwd_args_ok(kQRow0 + nq + 1, 0, nq, n_gates, kQRow0 + nq, 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float *recT = nullptr, *acc = nullptr, *dacc = nullptr;
  const int32_t *tile_offsets = nullptr, *tile_order = nullptr,
                *lk = nullptr;
  float* dgrad = nullptr;
  const int cap = 0, gate_row = 0, n_tiles = 0, tiles_x = 0;
  const float znear = 0.0f, zfar = 0.0f;
  cudaStream_t s = nullptr;
  int* blocks_per_sm = blocks;
  if (n_gates > 0)
    return (int)launch_gated(n_gates, nq, SU_BWD90_ARGS);
  return (int)launch_nq<0>(nq, SU_BWD90_ARGS);
}
