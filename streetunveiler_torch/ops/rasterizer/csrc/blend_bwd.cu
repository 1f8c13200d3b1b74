// K2 — 2DGS blend backward: the instantiations without gated chains and
// the C interface. The kernel, its math and its design are in
// blend_bwd.cuh; the gated instantiations are in blend_bwd_gated.cu.

#include "blend_bwd.cuh"

// recT [rec, cap] f32 lane-major records (rec >= 10 + nq, and > gate_row
// with gates); tile_offsets [n_tiles + 1] int32; acc and dacc [n_tiles,
// 512, nq + 6 + 4 n_gates] f32; lk [n_tiles, 512] int32; dgrad [rec, cap]
// f32, zeroed by the caller. Returns cudaGetLastError().
extern "C" int su_blend_bwd(const float* recT, int rec, int cap, int nq,
                            int n_gates, int gate_row,
                            const int32_t* tile_offsets, int n_tiles,
                            int tiles_x, float znear, float zfar,
                            const float* acc, const int32_t* lk,
                            const float* dacc, float* dgrad, int device,
                            void* stream) {
  using namespace su_bwd;
  if (!bwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_gates > 0)
    return (int)launch_gated(n_gates, nq, recT, cap, gate_row, tile_offsets,
                             n_tiles, tiles_x, znear, zfar, acc, lk, dacc,
                             dgrad, s);
  return (int)launch_nq<0>(nq, recT, cap, gate_row, tile_offsets, n_tiles,
                           tiles_x, znear, zfar, acc, lk, dacc, dgrad, s);
}
