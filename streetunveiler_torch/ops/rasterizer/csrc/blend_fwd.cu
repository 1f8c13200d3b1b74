// K1 — 2DGS blend forward over the tile-grouped, depth-sorted duplicate
// stream.
//
// Replaces the Pallas kernel streetunveiler_tpu/ops/rasterizer/kernel.py
// `_fwd_kernel` (launched by `_blend_fwd_call`, kernel.py:660-696, the
// forward of `blend_stream`). Same outputs: per 16x32 tile the accumulator
// [512, nq + 6] — payload (color, normal, extra), alpha, sum w*t, a spare
// zero channel, m1 = sum w*m, m2 = sum w*m^2, median depth — and lk, the
// stream index of each pixel's last composited duplicate (-1 if none).
// Semantics kept: alpha >= 1/255, alpha <= 0.99, t >= znear, the low-pass
// min(rho3d, rho2d), early termination (the pair that would push T below
// t_eps is dropped and the pixel freezes), median = t of the last pair with
// w > 0 and T_excl > 0.5.
//
// What bounds it on an H100: operations. Every (duplicate, pixel) pair
// that a pixel still needs costs ~30 f32 operations including one exp and
// one divide, ~3e8 pairs at the 300k-surfel street scene, while the bytes
// (records read once, the accumulator written once) are ~0.2 GB.
//
// Design: one thread block per tile, one thread per pixel. The block walks
// the tile's CSR range [tile_offsets[t], tile_offsets[t+1]) in batches of
// kBatch duplicates; each batch is loaded cooperatively (coalesced along
// the lane-major records) into shared memory, and the per-surfel
// coefficients A = r1 x r2, B = r2 x r3, C = r3 x r1 and det M are hoisted
// there once per duplicate, M's third column rebuilt from the center and
// depth rows. Each thread then composites the batch sequentially with a
// running product for T (the TPU's log-space prefix matmuls and
// suffix-count matmuls were matrix-unit workarounds and have no
// counterpart). The block stops as soon as all 512 pixels are done
// (__syncthreads_count). Simple first: no TMA, no warp specialisation.
// The pair math runs in the plain version's order and is built with
// -fmad=false (cuda_lib.py), so each pair's alpha and depth round as they
// do there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kPix = kTileW * kTileH;
constexpr int kBatch = 256;      // duplicates staged per round
constexpr int kQRow0 = 10;       // first payload row of a record
constexpr int kMaxQ = 16;        // payload channels a launch may carry
constexpr int kGeo = 14;         // ax..cz, det, c2dx, c2dy, depth, opacity
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kMedianT = 0.5f;
constexpr float kFilterInvSquare = 2.0f;

__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ recT, int cap, int nq,
                 const int32_t* __restrict__ tile_offsets, int tiles_x,
                 float znear, float zfar, float t_eps,
                 float* __restrict__ acc, int32_t* __restrict__ lk) {
  extern __shared__ float sm[];  // [kGeo + nq][kBatch]
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const float px = (float)(tx * kTileW + p % kTileW) + 0.5f;
  const float py = (float)(ty * kTileH + p / kTileW) + 0.5f;
  const int start = tile_offsets[tile];
  const int end = tile_offsets[tile + 1];
  const float dscale = zfar / (zfar - znear);

  float T = 1.0f;
  bool done = false;
  float accq[kMaxQ];
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k) accq[k] = 0.0f;
  float alpha = 0.0f, deptha = 0.0f, m1 = 0.0f, m2 = 0.0f, med = 0.0f;
  int last = -1;

  for (int base = start; base < end; base += kBatch) {
    // barrier before the batch is overwritten, and the tile-wide exit
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(kBatch, end - base);
    if (p < nb) {
      const float* r = recT + base + p;
      const size_t ld = (size_t)cap;
      const float r1x = r[0 * ld], r2x = r[1 * ld], r3x = r[2 * ld];
      const float r1y = r[3 * ld], r2y = r[4 * ld], r3y = r[5 * ld];
      const float c2dx = r[6 * ld], c2dy = r[7 * ld];
      const float z = r[8 * ld], opac = r[9 * ld];
      const float r1z = c2dx * z, r2z = c2dy * z, r3z = z;
      const float ax = r1y * r2z - r1z * r2y;
      const float ay = r1z * r2x - r1x * r2z;
      const float az = r1x * r2y - r1y * r2x;
      sm[0 * kBatch + p] = ax;
      sm[1 * kBatch + p] = ay;
      sm[2 * kBatch + p] = az;
      sm[3 * kBatch + p] = r2y * r3z - r2z * r3y;
      sm[4 * kBatch + p] = r2z * r3x - r2x * r3z;
      sm[5 * kBatch + p] = r2x * r3y - r2y * r3x;
      sm[6 * kBatch + p] = r3y * r1z - r3z * r1y;
      sm[7 * kBatch + p] = r3z * r1x - r3x * r1z;
      sm[8 * kBatch + p] = r3x * r1y - r3y * r1x;
      sm[9 * kBatch + p] = r3x * ax + r3y * ay + r3z * az;
      sm[10 * kBatch + p] = c2dx;
      sm[11 * kBatch + p] = c2dy;
      sm[12 * kBatch + p] = z;
      sm[13 * kBatch + p] = opac;
      for (int k = 0; k < nq; ++k)
        sm[(kGeo + k) * kBatch + p] = r[(size_t)(kQRow0 + k) * ld];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      const float opac = sm[13 * kBatch + j];
      const float kx = sm[0 * kBatch + j] + px * sm[3 * kBatch + j] +
                       py * sm[6 * kBatch + j];
      const float ky = sm[1 * kBatch + j] + px * sm[4 * kBatch + j] +
                       py * sm[7 * kBatch + j];
      const float kz = sm[2 * kBatch + j] + px * sm[5 * kBatch + j] +
                       py * sm[8 * kBatch + j];
      const float kzs = fabsf(kz) < 1e-12f ? 1e-12f : kz;
      const float rcp = 1.0f / kzs;
      const float rho3d = (kx * kx + ky * ky) * (rcp * rcp);
      const float dx = px - sm[10 * kBatch + j];
      const float dy = py - sm[11 * kBatch + j];
      const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
      const bool use2d = rho3d > rho2d;
      const float rho = use2d ? rho2d : rho3d;
      const float t = use2d ? sm[12 * kBatch + j] : sm[9 * kBatch + j] * rcp;
      const float a = fminf(kAlphaMax, opac * expf(-0.5f * rho));
      if (!(a >= kAlphaEps && t >= znear && opac > 0.0f)) continue;
      const float t_after = T * (1.0f - a);
      if (t_after < t_eps) {
        done = true;
        break;
      }
      const float w = a * T;
#pragma unroll
      for (int k = 0; k < kMaxQ; ++k)
        if (k < nq) accq[k] += w * sm[(kGeo + k) * kBatch + j];
      alpha += w;
      deptha += w * t;
      const float m = dscale * (1.0f - znear / fmaxf(t, 1e-6f));
      m1 += w * m;
      m2 += w * m * m;
      if (w > 0.0f && T > kMedianT) med = t;
      last = base + j;
      T = t_after;
    }
  }

  const int ch = nq + 6;
  float* out = acc + ((size_t)tile * kPix + p) * ch;
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k)
    if (k < nq) out[k] = accq[k];
  out[nq] = alpha;
  out[nq + 1] = deptha;
  out[nq + 2] = 0.0f;
  out[nq + 3] = m1;
  out[nq + 4] = m2;
  out[nq + 5] = med;
  lk[(size_t)tile * kPix + p] = last;
}

}  // namespace

// recT [rec, cap] f32 lane-major records (rec >= 10 + nq), tile_offsets
// [n_tiles + 1] int32; acc [n_tiles, 512, nq + 6] f32, lk [n_tiles, 512]
// int32. Returns cudaGetLastError().
extern "C" int su_blend_fwd(const float* recT, int rec, int cap, int nq,
                            const int32_t* tile_offsets, int n_tiles,
                            int tiles_x, float znear, float zfar, float t_eps,
                            float* acc, int32_t* lk, int device,
                            void* stream) {
  if (nq < 1 || nq > kMaxQ || rec < kQRow0 + nq || n_tiles < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(kGeo + nq) * kBatch * sizeof(float);
  blend_fwd_kernel<<<n_tiles, kPix, smem, (cudaStream_t)stream>>>(
      recT, cap, nq, tile_offsets, tiles_x, znear, zfar, t_eps, acc, lk);
  return (int)cudaGetLastError();
}
