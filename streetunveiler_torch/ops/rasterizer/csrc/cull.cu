// The binning's conic cull, C entry (cull_sm90.cuh): the per-surfel tile
// rectangles and the exact conic tile test in one pass, writing the
// per-surfel table that the depth rank gathers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cull_sm90.cuh"

// center2d, ext [n, 2] f32, valid [n] bool, cull [n, 11] f32 (contiguous)
// → table [n, 7] int32 rows (x0, y0, max(nx, 1), nt, small, w0, w1).
// Returns cudaGetLastError() after the launch.
extern "C" int su_cull(const float* center2d, const float* ext,
                       const uint8_t* valid, const float* cull, int n,
                       int width, int height, int tile_w, int tile_h,
                       int max_tiles, int32_t* table, int device,
                       void* stream) {
  if (n < 1 || width < 1 || height < 1 || tile_w < 1 || tile_h < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)su_cull90::launch(center2d, ext, valid, cull, n, width, height,
                                tile_w, tile_h, max_tiles, table, device,
                                (cudaStream_t)stream);
}
