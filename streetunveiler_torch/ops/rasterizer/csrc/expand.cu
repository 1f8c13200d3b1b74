// K3 — duplicate expansion of the depth-ranked surfel table into the
// (tile id, surfel id) stream that the stable sort by tile then groups:
// the C entries of the production kernel (su_expand, expand_sm90.cuh, the
// H100 redesign) and of its first design (su_expand_first, this file's
// kernel), which stays selectable and gives the same bits.
//
// Replaces the Pallas kernel streetunveiler_tpu/ops/rasterizer/tiles.py
// `_expand_kernel` (launched by `_expand_stream`, tiles.py:205-234, from
// `bin_surfels_stream`, tiles.py:356-359), and computes exactly the arrays
// it returns: for every slot below min(total, cap) the tile
// (y0 + k / nx) * tiles_x + x0 + k % nx and the surfel id, where k is the
// slot's rank within its surfel's run (or, for culled small surfels, the
// k-th 4-bit rect position packed in two words); every later slot up to
// capp holds the sentinel (n_tiles, n).
//
// What bounds it on an H100: bytes. Each table row (5 or 8 int32) and
// dup_start are read once and each of the 2 x capp int32 outputs written
// once — about 21 MB at the 300k-surfel street scene, a few microseconds
// at 3.35 TB/s; a nibble pick and one integer divide per slot are nothing
// beside that.
//
// The first design, below: one thread per depth-ranked surfel writes its
// own run of slots starting at its dup_start (the 2DGS CUDA
// `duplicateWithKeys` pattern), so the marks + cumsum + per-slot row
// gather the TPU needed (tiles.py:348-356) do not exist here. The
// sentinel tail is filled by the same launch with a grid-stride loop.
// Integer / and % replace the TPU's f32-divide-plus-fixup divmod (same
// result). Runs are short (<= 16 slots for small surfels, <=
// max_tiles_per_surfel for the rest) and the stores of one thread are
// contiguous; a warp's stores are not (expand_sm90.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "expand_sm90.cuh"

namespace {

constexpr int kCullKmax = 16;
constexpr int kThreads = 256;

__global__ void expand_kernel(const int32_t* __restrict__ tbl, int rows,
                              const int32_t* __restrict__ dup_start, int n,
                              int cap, int capp, int tiles_x, int sentinel,
                              int has_cull, int32_t* __restrict__ tile_id,
                              int32_t* __restrict__ surf_id) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = dup_start[n];
  const int lim = total < cap ? total : cap;
  if (i < n) {
    const int32_t* r = tbl + (size_t)i * rows;
    const int x0 = r[0], y0 = r[1], nx = r[2], start = r[3], sid = r[4];
    const int stop = min(dup_start[i + 1], lim);
    const bool small = has_cull && r[5] > 0;
    const unsigned w0 = has_cull ? (unsigned)r[6] : 0u;
    const unsigned w1 = has_cull ? (unsigned)r[7] : 0u;
    for (int slot = start; slot < stop; ++slot) {
      int k = slot - start;
      if (small) {
        const int kk = min(k, kCullKmax - 1);
        k = (int)(((kk < 8 ? w0 : w1) >> ((kk & 7) * 4)) & 15u);
      }
      const int q = k / nx;
      tile_id[slot] = (y0 + q) * tiles_x + x0 + (k - q * nx);
      surf_id[slot] = sid;
    }
  }
  const int stride = gridDim.x * blockDim.x;
  for (int s = lim + i; s < capp; s += stride) {
    tile_id[s] = sentinel;
    surf_id[s] = n;
  }
}

}  // namespace

extern "C" const char* su_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// tbl [n, rows] int32 (rows 5, or 8 with has_cull), dup_start [n + 1]
// int32; tile_id, surf_id [capp] int32. Returns cudaGetLastError().
extern "C" int su_expand(const int32_t* tbl, int rows,
                         const int32_t* dup_start, int n, int cap, int capp,
                         int tiles_x, int sentinel, int has_cull,
                         int32_t* tile_id, int32_t* surf_id, int device,
                         void* stream) {
  if (n < 1 || rows < (has_cull ? 8 : 5) || cap > capp)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)su_expand90::launch(tbl, rows, dup_start, n, cap, capp,
                                  tiles_x, sentinel, has_cull != 0, tile_id,
                                  surf_id, device, (cudaStream_t)stream);
}

// As su_expand, with the first design's kernel.
extern "C" int su_expand_first(const int32_t* tbl, int rows,
                               const int32_t* dup_start, int n, int cap,
                               int capp, int tiles_x, int sentinel,
                               int has_cull, int32_t* tile_id,
                               int32_t* surf_id, int device, void* stream) {
  if (n < 1 || rows < (has_cull ? 8 : 5) || cap > capp)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int work = n > capp ? n : capp;
  const int blocks = (work + kThreads - 1) / kThreads;
  expand_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tbl, rows, dup_start, n, cap, capp, tiles_x, sentinel, has_cull,
      tile_id, surf_id);
  return (int)cudaGetLastError();
}
