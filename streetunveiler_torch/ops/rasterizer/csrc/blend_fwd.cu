// K1 — 2DGS blend forward over the tile-grouped, depth-sorted duplicate
// stream.
//
// Replaces the Pallas kernel streetunveiler_tpu/ops/rasterizer/kernel.py
// `_fwd_kernel` (launched by `_blend_fwd_call`, kernel.py:660-696, the
// forward of `blend_stream`), its gated per-class chains (kernel.py:332-392)
// and their gate decoding (`_gate_bits`, kernel.py:773-781) included. Same
// outputs: per 16x32 tile the accumulator [512, nq + 6 + 4G] — payload
// (color, normal, extra), alpha, sum w*t, a spare zero channel,
// m1 = sum w*m, m2 = sum w*m^2, median depth, then per gated class
// (alpha_g, m1_g, m2_g, lk_g) — and lk, the stream index of each pixel's
// last composited duplicate (-1 if none). Semantics kept: alpha >= 1/255,
// alpha <= 0.99, t >= znear, the low-pass min(rho3d, rho2d), early
// termination (the pair that would push T below t_eps is dropped and the
// pixel freezes), median = t of the last pair with w > 0 and T_excl > 0.5.
//
// Gated chains (G > 0): record row `gate_row` holds the surfel's class
// bitmask as an exact float; class g runs its own transmittance T_g over
// alpha * bit_g with its own early termination, and stores lk_g as a float
// (exact below 2^24: the wrapper refuses longer streams). The main chain's
// outputs do not depend on the gates, but a gated chain outlives the main
// one whenever a pixel's front surfels are of another class, so a pixel is
// live while any of its chains is: the main chain's termination stops only
// the main accumulation, and the tile exits when no pixel has a live chain.
//
// What bounds it on an H100: operations. Every (duplicate, pixel) pair
// that a pixel still needs costs ~30 f32 operations including one exp and
// one divide, ~3e8 pairs at the 300k-surfel street scene, plus ~8 per pair
// a gated chain composites, while the bytes (records read once, the
// accumulator written once) are ~0.2 GB.
//
// Design: one thread block per tile, one thread per pixel. The block walks
// the tile's CSR range [tile_offsets[t], tile_offsets[t+1]) in batches of
// kBatch duplicates; each batch is loaded cooperatively (coalesced along
// the lane-major records) into shared memory, and the per-surfel
// coefficients A = r1 x r2, B = r2 x r3, C = r3 x r1 and det M are hoisted
// there once per duplicate, M's third column rebuilt from the center and
// depth rows. Each thread then composites the batch sequentially with a
// running product for each T (the TPU's log-space prefix matmuls and
// suffix-count matmuls were matrix-unit workarounds and have no
// counterpart). The block stops as soon as no pixel has a live chain
// (__syncthreads_count). The kernel is templated on G, so the gated state
// lives in registers and G = 0 is the plain forward. Simple first: no TMA,
// no warp specialisation. The pair math (pair_math.cuh, shared with K2)
// runs in the plain version's order and is built with -fmad=false
// (cuda_lib.py), so each pair's alpha and depth round as they do there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"

namespace {

using su_pair::kGeo;
using su_pair::kQRow0;

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kPix = kTileW * kTileH;
constexpr int kBatch = 256;      // duplicates staged per round
constexpr int kMaxQ = 16;        // payload channels a launch may carry
constexpr int kMaxGates = 6;     // gated chains a launch may carry
constexpr int kMaxStream = 1 << 24;   // lk_g is exact below 2^24
constexpr float kMedianT = 0.5f;

template <int G>
__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ recT, int cap, int nq,
                 int gate_row, const int32_t* __restrict__ tile_offsets,
                 int tiles_x, float znear, float zfar, float t_eps,
                 float* __restrict__ acc, int32_t* __restrict__ lk) {
  constexpr int GA = G > 0 ? G : 1;
  constexpr unsigned kAllDone = (1u << G) - 1u;
  extern __shared__ float sm[];  // [kGeo + nq (+ 1 gate row)][kBatch]
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
  // gated chains: transmittance, sums and last kept index per class, and
  // one done bit per class
  float tg[GA], ag[GA], m1g[GA], m2g[GA];
  int lkg[GA];
#pragma unroll
  for (int g = 0; g < GA; ++g) {
    tg[g] = 1.0f;
    ag[g] = m1g[g] = m2g[g] = 0.0f;
    lkg[g] = -1;
  }
  unsigned gdone = 0u;
  const int gate_slot = (kGeo + nq) * kBatch;

  for (int base = start; base < end; base += kBatch) {
    const bool live = !done || gdone != kAllDone;
    // barrier before the batch is overwritten, and the tile-wide exit
    if (__syncthreads_count(live) == 0) break;
    const int nb = min(kBatch, end - base);
    if (p < nb) {
      const float* r = recT + base + p;
      const size_t ld = (size_t)cap;
      su_pair::stage_geometry(r, ld, sm, kBatch, p);
      for (int k = 0; k < nq; ++k)
        sm[(kGeo + k) * kBatch + p] = r[(size_t)(kQRow0 + k) * ld];
      if (G > 0) sm[gate_slot + p] = r[(size_t)gate_row * ld];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nb; ++j) {
      const su_pair::Pair e =
          su_pair::eval_pair(sm, kBatch, j, px, py, znear);
      if (!e.contrib) continue;
      const float a = e.a;
      const float t = e.t;
      const float m = dscale * (1.0f - znear / fmaxf(t, 1e-6f));
      if (!done) {
        const float t_after = T * (1.0f - a);
        if (t_after < t_eps) {
          done = true;
          if (G == 0) break;
        } else {
          const float w = a * T;
#pragma unroll
          for (int k = 0; k < kMaxQ; ++k)
            if (k < nq) accq[k] += w * sm[(kGeo + k) * kBatch + j];
          alpha += w;
          deptha += w * t;
          m1 += w * m;
          m2 += w * m * m;
          if (w > 0.0f && T > kMedianT) med = t;
          last = base + j;
          T = t_after;
        }
      }
      if (G > 0) {
        const int bits = (int)sm[gate_slot + j];
#pragma unroll
        for (int g = 0; g < GA; ++g) {
          if (((bits >> g) & 1) && !((gdone >> g) & 1u)) {
            const float tg_after = tg[g] * (1.0f - a);
            if (tg_after < t_eps) {
              gdone |= 1u << g;
            } else {
              const float w = a * tg[g];
              ag[g] += w;
              m1g[g] += w * m;
              m2g[g] += w * m * m;
              lkg[g] = base + j;
              tg[g] = tg_after;
            }
          }
        }
        if (done && gdone == kAllDone) break;
      }
    }
  }

  const int ch = nq + 6 + 4 * G;
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
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* o = out + nq + 6 + 4 * g;
    o[0] = ag[g];
    o[1] = m1g[g];
    o[2] = m2g[g];
    o[3] = (float)lkg[g];
  }
  lk[(size_t)tile * kPix + p] = last;
}

template <int G>
cudaError_t launch(const float* recT, int cap, int nq, int gate_row,
                   const int32_t* tile_offsets, int n_tiles, int tiles_x,
                   float znear, float zfar, float t_eps, float* acc,
                   int32_t* lk, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kGeo + nq + (G > 0 ? 1 : 0)) * kBatch * sizeof(float);
  blend_fwd_kernel<G><<<n_tiles, kPix, smem, stream>>>(
      recT, cap, nq, gate_row, tile_offsets, tiles_x, znear, zfar, t_eps,
      acc, lk);
  return cudaGetLastError();
}

}  // namespace

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
  if (nq < 1 || nq > kMaxQ || rec < kQRow0 + nq || n_tiles < 0 ||
      n_gates < 0 || n_gates > kMaxGates ||
      (n_gates > 0 && (gate_row < 0 || gate_row >= rec || cap >= kMaxStream)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define SU_FWD_CASE(G)                                                      \
  case G:                                                                   \
    return (int)launch<G>(recT, cap, nq, gate_row, tile_offsets, n_tiles,  \
                          tiles_x, znear, zfar, t_eps, acc, lk, s);
  switch (n_gates) {
    SU_FWD_CASE(0) SU_FWD_CASE(1) SU_FWD_CASE(2) SU_FWD_CASE(3)
    SU_FWD_CASE(4) SU_FWD_CASE(5) SU_FWD_CASE(6)
  }
#undef SU_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
