// K1 — 2DGS blend forward: the production instantiations (G = 0..6 gated
// chains, V = kFull) and the C interface. The kernel, its math and its
// design are in blend_fwd.cuh; its measurement variants are instantiated
// in bisect_fwd.cu and bisect_fwd_g5.cu.

#include "blend_fwd.cuh"

// recT [rec, cap] f32 lane-major records (rec >= 10 + nq, and > gate_row
// with gates), tile_offsets [n_tiles + 1] int32; acc [n_tiles, 512,
// nq + 6 + 4 n_gates] f32, lk [n_tiles, 512] int32. Returns
// cudaGetLastError().
extern "C" int su_blend_fwd(const float* recT, int rec, int cap, int nq,
                            int n_gates, int gate_row,
                            const int32_t* tile_offsets, int n_tiles,
                            int tiles_x, float znear, float zfar, float t_eps,
                            float* acc, int32_t* lk, int device,
                            void* stream) {
  if (!fwd_args_ok(rec, cap, nq, n_gates, gate_row, n_tiles))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define SU_FWD_CASE(G)                                                      \
  case G:                                                                   \
    return (int)launch<G, kFull>(recT, cap, nq, gate_row, tile_offsets,    \
                                 n_tiles, tiles_x, znear, zfar, t_eps, acc, \
                                 lk, s);
  switch (n_gates) {
    SU_FWD_CASE(0) SU_FWD_CASE(1) SU_FWD_CASE(2) SU_FWD_CASE(3)
    SU_FWD_CASE(4) SU_FWD_CASE(5) SU_FWD_CASE(6)
  }
#undef SU_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
