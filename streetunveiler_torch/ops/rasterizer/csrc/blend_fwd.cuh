// K1 — 2DGS blend forward over the tile-grouped, depth-sorted duplicate
// stream: the kernel template, on the number of gated chains G and a
// measurement variant V. blend_fwd.cu instantiates the production kernel
// (V = kFull) and the C interface; bisect_fwd.cu and bisect_fwd_g5.cu
// instantiate every variant at G = 0 and G = 5 for the bisection tool
// (streetunveiler_torch/tools/bisect_fwd.py). The kernel has internal
// linkage, so each translation unit keeps its own copy.
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
//
// Measurement variants (V), each named after its TPU counterpart in
// tools/bisect_fwd.py:41-263 and each feeding acc or lk, so that nvcc keeps
// what it computes. "Stream chunk" is the TPU tool's visit: the 128 stream
// slots [128c, 128c + 128) of one tile.
//   kFull           the production kernel.
//   kFloor          staging and the CSR walk; per pair fl += opacity * T,
//                   T *= 0.999; every channel = 1e-30 fl, lk = -1; no pixel
//                   terminates, so every pair of the tile is walked.
//   kFloorNoAlldone kFloor with a plain barrier for the tile-wide exit.
//   kFloorNoLk      kFloor without the lk store.
//   kNoPair         eval_pair replaced by a = rec_0 1e-6 + px 1e-8,
//                   t = rec_11 (payload channel 1), a pair contributing
//                   when a > 0.
//   kNoExp          eval_pair's exp(x) replaced by 1 + x.
//   kNoPrefix       no transmittance product: T is frozen within a stream
//                   chunk (w = a T), multiplied by 0.999 at its end, and a
//                   trigger freezes the pixel at the chunk's end.
//   kNoTrigger      no early termination: a trigger drops the rest of its
//                   stream chunk only, and the pixel never freezes.
//   kNoSums         payload, alpha, depth and moment sums replaced by the
//                   weight of one slot: payload channel k takes the pair at
//                   chunk lane k, the other sums the pair at lane 0.
//   kNoMed          no median.
//   kNoLkMax        no last-index tracking: lk starts at 0 (the TPU tool's
//                   first visit) and takes max(lk, T > 2) per pair: 0.

#pragma once

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
constexpr int kChunkShift = 7;   // stream chunk of the TPU tool: 128 slots

enum FwdVariant {
  kFull = 0,
  kFloor,
  kFloorNoAlldone,
  kFloorNoLk,
  kNoPair,
  kNoExp,
  kNoPrefix,
  kNoTrigger,
  kNoSums,
  kNoMed,
  kNoLkMax,
  kNumFwdVariants
};

// Shared rows staged per duplicate: geometry, payload, the gate row, and
// for kNoPair the raw record row 0.
template <int G, int V>
__host__ __device__ constexpr int staged_rows_extra() {
  return (G > 0 ? 1 : 0) + (V == kNoPair ? 1 : 0);
}

template <int G, int V>
__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ recT, int cap, int nq,
                 int gate_row, const int32_t* __restrict__ tile_offsets,
                 int tiles_x, float znear, float zfar, float t_eps,
                 float* __restrict__ acc, int32_t* __restrict__ lk) {
  constexpr int GA = G > 0 ? G : 1;
  constexpr unsigned kAllDone = (1u << G) - 1u;
  constexpr bool kIsFloor =
      V == kFloor || V == kFloorNoAlldone || V == kFloorNoLk;
  constexpr bool kChunked = V == kNoPrefix || V == kNoTrigger;
  extern __shared__ float sm[];  // [kGeo + nq (+ gate row)(+ raw row)][kBatch]
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
  int last = V == kNoLkMax ? 0 : -1;   // kNoLkMax: the TPU's first visit
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
  const int raw_slot = (kGeo + nq + (G > 0 ? 1 : 0)) * kBatch;
  // variants: the floor's sum; the current stream chunk with its pending
  // trigger (kNoPrefix) or freeze (kNoTrigger), per chain
  float fl = 0.0f;
  int chunk = -1;
  bool trig = false;
  unsigned gtrig = 0u;

  for (int base = start; base < end; base += kBatch) {
    const bool live = !done || gdone != kAllDone;
    // barrier before the batch is overwritten, and the tile-wide exit
    if (V == kFloorNoAlldone) {
      __syncthreads();
    } else if (__syncthreads_count(live) == 0) {
      break;
    }
    const int nb = min(kBatch, end - base);
    if (p < nb) {
      const float* r = recT + base + p;
      const size_t ld = (size_t)cap;
      su_pair::stage_geometry(r, ld, sm, kBatch, p);
      for (int k = 0; k < nq; ++k)
        sm[(kGeo + k) * kBatch + p] = r[(size_t)(kQRow0 + k) * ld];
      if (G > 0) sm[gate_slot + p] = r[(size_t)gate_row * ld];
      if (V == kNoPair) sm[raw_slot + p] = r[0];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nb; ++j) {
      if (kIsFloor) {
        fl += sm[13 * kBatch + j] * T;
        T *= 0.999f;
        continue;
      }
      if (kChunked) {
        const int c = (base + j) >> kChunkShift;
        if (c != chunk) {
          if (V == kNoPrefix && chunk >= 0) {
            T *= 0.999f;
            done = done || trig;
#pragma unroll
            for (int g = 0; g < GA; ++g) tg[g] *= 0.999f;
            gdone |= gtrig;
          }
          chunk = c;
          trig = false;
          gtrig = 0u;
        }
      }
      if (V == kNoLkMax) last = max(last, (int)(T > 2.0f));
      float a, t;
      if (V == kNoPair) {
        a = sm[raw_slot + j] * 1e-6f + px * 1e-8f;
        t = sm[(kGeo + 1) * kBatch + j] + py * 0.0f;
        if (!(a > 0.0f)) continue;
      } else {
        const su_pair::Pair e =
            su_pair::eval_pair<V != kNoExp>(sm, kBatch, j, px, py, znear);
        if (!e.contrib) continue;
        a = e.a;
        t = e.t;
      }
      const float m = dscale * (1.0f - znear / fmaxf(t, 1e-6f));
      if (!done && !(V == kNoTrigger && trig)) {
        const float t_after = T * (1.0f - a);
        if (t_after < t_eps) {
          if (kChunked) {
            trig = true;
          } else {
            done = true;
            if (G == 0) break;
          }
        } else {
          const float w = a * T;
          if (V == kNoSums) {
            const int lane = (base + j) & ((1 << kChunkShift) - 1);
#pragma unroll
            for (int k = 0; k < kMaxQ; ++k)
              if (k < nq && k == lane) accq[k] += w;
            if (lane == 0) {
              alpha += w;
              deptha += w * t;
              m1 += w * m;
              m2 += w * m * m;
            }
          } else {
#pragma unroll
            for (int k = 0; k < kMaxQ; ++k)
              if (k < nq) accq[k] += w * sm[(kGeo + k) * kBatch + j];
            alpha += w;
            deptha += w * t;
            m1 += w * m;
            m2 += w * m * m;
          }
          if (V != kNoMed && w > 0.0f && T > kMedianT) med = t;
          if (V != kNoLkMax) last = base + j;
          if (V != kNoPrefix) T = t_after;
        }
      }
      if (G > 0) {
        const int bits = (int)sm[gate_slot + j];
#pragma unroll
        for (int g = 0; g < GA; ++g) {
          if (((bits >> g) & 1) && !((gdone >> g) & 1u) &&
              !(V == kNoTrigger && ((gtrig >> g) & 1u))) {
            const float tg_after = tg[g] * (1.0f - a);
            if (tg_after < t_eps) {
              if (kChunked) {
                gtrig |= 1u << g;
              } else {
                gdone |= 1u << g;
              }
            } else {
              const float w = a * tg[g];
              ag[g] += w;
              m1g[g] += w * m;
              m2g[g] += w * m * m;
              lkg[g] = base + j;
              if (V != kNoPrefix) tg[g] = tg_after;
            }
          }
        }
        if (done && gdone == kAllDone) break;
      }
    }
  }

  const int ch = nq + 6 + 4 * G;
  float* out = acc + ((size_t)tile * kPix + p) * ch;
  if (kIsFloor) {
    for (int k = 0; k < ch; ++k) out[k] = fl * 1e-30f;
    if (V != kFloorNoLk) lk[(size_t)tile * kPix + p] = -1;
    return;
  }
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

template <int G, int V>
cudaError_t launch(const float* recT, int cap, int nq, int gate_row,
                   const int32_t* tile_offsets, int n_tiles, int tiles_x,
                   float znear, float zfar, float t_eps, float* acc,
                   int32_t* lk, cudaStream_t stream) {
  const size_t smem = (size_t)(kGeo + nq + staged_rows_extra<G, V>()) *
                      kBatch * sizeof(float);
  blend_fwd_kernel<G, V><<<n_tiles, kPix, smem, stream>>>(
      recT, cap, nq, gate_row, tile_offsets, tiles_x, znear, zfar, t_eps,
      acc, lk);
  return cudaGetLastError();
}

// launch<G, V> for a variant given at run time
template <int G>
cudaError_t launch_variant(int variant, const float* recT, int cap, int nq,
                           int gate_row, const int32_t* tile_offsets,
                           int n_tiles, int tiles_x, float znear, float zfar,
                           float t_eps, float* acc, int32_t* lk,
                           cudaStream_t s) {
#define SU_BISECT_CASE(V)                                                   \
  case V:                                                                   \
    return launch<G, V>(recT, cap, nq, gate_row, tile_offsets, n_tiles,    \
                        tiles_x, znear, zfar, t_eps, acc, lk, s);
  switch (variant) {
    SU_BISECT_CASE(kFull) SU_BISECT_CASE(kFloor)
    SU_BISECT_CASE(kFloorNoAlldone) SU_BISECT_CASE(kFloorNoLk)
    SU_BISECT_CASE(kNoPair) SU_BISECT_CASE(kNoExp) SU_BISECT_CASE(kNoPrefix)
    SU_BISECT_CASE(kNoTrigger) SU_BISECT_CASE(kNoSums)
    SU_BISECT_CASE(kNoMed) SU_BISECT_CASE(kNoLkMax)
  }
#undef SU_BISECT_CASE
  return cudaErrorInvalidValue;
}

// The arguments every C entry of K1 and its variants checks.
inline bool fwd_args_ok(int rec, int cap, int nq, int n_gates, int gate_row,
                        int n_tiles) {
  return !(nq < 1 || nq > kMaxQ || rec < kQRow0 + nq || n_tiles < 0 ||
           n_gates < 0 || n_gates > kMaxGates ||
           (n_gates > 0 &&
            (gate_row < 0 || gate_row >= rec || cap >= kMaxStream)));
}

}  // namespace
