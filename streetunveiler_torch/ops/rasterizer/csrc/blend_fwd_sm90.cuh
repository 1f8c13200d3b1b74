// K1 — 2DGS blend forward, redesigned for the H100: the production
// kernel template on (nq, G, measurement variant), instantiated at its
// default variant kFull by blend_fwd.cu (no gated chains, nq 1..16, and
// the C interface) and blend_fwd_gated.cu (G = 1..6 gated chains at nq 6
// and 12), and at every variant by bisect_fwd_sm90.cu and
// bisect_fwd_sm90_g5.cu (the bisection tool
// streetunveiler_torch/tools/bisect_fwd.py). The first design,
// blend_fwd.cuh, stays selectable in that tool (its own variants,
// bisect_fwd*.cu); its `kFull` and this kernel agree bit for bit.
//
// Replaces the Pallas kernel streetunveiler_tpu/ops/rasterizer/kernel.py
// `_fwd_kernel` (launched at kernel.py:670, the forward of
// `blend_stream`), its gated per-class chains (kernel.py:332-392) and
// their gate decoding included. The outputs (per 16x32 tile the
// accumulator [512, nq + 6 + 4G] and lk), the semantics (α ≥ 1/255,
// α ≤ 0.99, t ≥ znear, the low-pass, early termination, the median, the
// gated chains' own transmittance and termination) and each pixel's order
// of operations are those written out in blend_fwd.cuh.
//
// What bounds it on an H100: operations (chip_smoke.py's K1 lines): ~30
// f32 operations, one exp and one divide among them, for every pair a
// pixel still needs, plus ~8 for each pair a gated chain composites, at
// the card's 67 TFLOP/s f32. The bytes (records read once, the accumulator
// and lk written once) come to less.
//
// The first design ran at 15-19× that bound. What this one does about it:
// - Exact pair skip. A pixel stays live while any of its chains does, so
//   the gated blend walked 3.3× the pairs of the ungated one and evaluated
//   each. Once the main chain is done, the duplicate's gate bits are read
//   before eval_pair, and the pair is skipped when none of its classes'
//   chains is still live: such a pair changed no output.
// - nq at compile time: the payload sums accq[NQ] hold exactly nq
//   registers, where the first design reserved 16 whatever nq was.
// - Coalesced output. Each pixel's nq + 6 + 4G channels were stored with a
//   stride of one pixel row between neighbouring lanes; the tile's
//   accumulator is one contiguous [512, ch] slab, so the pixels write it
//   into shared memory (an odd row stride: no bank conflicts), and the
//   block copies it out with neighbouring threads on neighbouring
//   addresses.
// - Asynchronous, double-buffered staging: while batch i is composited,
//   cp.async brings batch i+1's raw record rows into the other buffer; the
//   geometry (A, B, C, det M) is hoisted once they land, and the payload
//   and the gate row are read from the buffer. The buffers need more than
//   48 KB at (12, 5), so the launch raises the block's dynamic shared
//   memory limit; the output slab reuses the same memory after the walk.
// - Longest tile first: block b takes tile tile_order[b], the tiles by
//   descending duplicate count (tiles.tile_order, once per binning). A
//   tile's outputs do not depend on when it runs.
// - Two blocks an SM: the launch bounds cap a thread at 64 registers, so
//   that 32 warps hide the pair math's latency. Gated, that spills a few
//   bytes at (12, 5) and still runs faster than one block an SM
//   (PERF.md).
//
// Measurement variants (V), those of the first design (blend_fwd.cuh)
// restated against this one. Each branch is an `if constexpr`, so kFull
// compiles to the production kernel; each feeds acc or lk, so that nvcc
// keeps what it computes; each keeps the exact pair skip, which drops
// only pairs that change no output under the variant's own chain rules.
// "Stream chunk": the 128 absolute slots [128c, 128c + 128) of the stream
// (the TPU tool's visit), whose boundaries fall where the first design
// put them.
//   kFull           the production kernel.
//   kFloor          the cp.async double-buffered staging, the geometry
//                   hoist and the walk: per pair of the tile fl +=
//                   opacity * T, T *= 0.999; every channel = 1e-30 fl
//                   through the output slab, lk = -1; no pixel
//                   terminates, so every pair of the tile is walked.
//   kFloorNoAlldone kFloor with a plain barrier for the tile-wide exit.
//   kFloorNoLk      kFloor without the lk store.
//   kNoPair         eval_pair replaced by a = rec_0 1e-6 + px 1e-8, t =
//                   rec_11 (payload channel 1), both read from the staged
//                   raw rows; a pair contributes when a > 0.
//   kNoExp          eval_pair's exp(x) replaced by 1 + x.
//   kNoPrefix       no transmittance product: T is frozen within a stream
//                   chunk (w = a T), multiplied by 0.999 at its end, and a
//                   trigger freezes the pixel at the chunk's end; the skip
//                   applies from that chunk end on.
//   kNoTrigger      no early termination: a trigger drops the rest of its
//                   stream chunk only, and the pixel never freezes (so
//                   nothing is skipped).
//   kNoSums         payload, alpha, depth and moment sums replaced by the
//                   weight of one slot: payload channel k takes the pair at
//                   chunk lane k, the other sums the pair at lane 0.
//   kNoMed          no median.
//   kNoLkMax        no last-index tracking: lk starts at 0 (the TPU tool's
//                   first visit) and takes max(lk, T > 2) per pair: 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "pair_math.cuh"

namespace su_fwd90 {
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

// Shared memory, in floats: during the walk two buffers of raw record
// rows and the hoisted geometry; after it the output slab.
template <int NQ, int G>
struct Layout {
  static constexpr int kRaw = kQRow0 + NQ + (G > 0 ? 1 : 0);  // rows staged
  static constexpr int kGateRaw = kQRow0 + NQ;   // the gate mask's row
  static constexpr int kCh = NQ + 6 + 4 * G;     // accumulator channels
  static constexpr int kCs = kCh | 1;            // the slab's row stride
  static constexpr int kGeoOff = 2 * kRaw * kBatch;
  static constexpr int kWalk = kGeoOff + kGeo * kBatch;
  static constexpr int kSlab = kPix * kCs;
  static constexpr int kFloats = kWalk > kSlab ? kWalk : kSlab;
};

template <int NQ, int G, int V = kFull>
__global__ void __launch_bounds__(kPix, 2)
blend_fwd_sm90_kernel(const float* __restrict__ recT, int cap, int gate_row,
                      const int32_t* __restrict__ tile_offsets,
                      const int32_t* __restrict__ tile_order, int tiles_x,
                      float znear, float zfar, float t_eps,
                      float* __restrict__ acc, int32_t* __restrict__ lk) {
  using L = Layout<NQ, G>;
  constexpr int GA = G > 0 ? G : 1;
  constexpr unsigned kAllDone = (1u << G) - 1u;
  constexpr bool kIsFloor =
      V == kFloor || V == kFloorNoAlldone || V == kFloorNoLk;
  constexpr bool kChunked = V == kNoPrefix || V == kNoTrigger;
  extern __shared__ __align__(16) float sm[];
  float* geo = sm + L::kGeoOff;             // [kGeo][kBatch]
  const int tile = tile_order[blockIdx.x];
  // an order that is not tiles.tile_order's may name no tile: the
  // block leaves it rather than read or write out of bounds
  if ((unsigned)tile >= gridDim.x) return;
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
  float accq[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) accq[k] = 0.0f;
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
  // variants: the floor's sum; the current stream chunk with its pending
  // trigger (kNoPrefix) or freeze (kNoTrigger), per chain
  float fl = 0.0f;
  int chunk = -1;
  bool trig = false;
  unsigned gtrig = 0u;

  // thread p < n starts the copies of slot base + p's record rows into buf
  const size_t ld = (size_t)cap;
  auto stage = [&](int base, int n, float* buf) {
    if (p < n) {
      const float* r = recT + base + p;
#pragma unroll
      for (int k = 0; k < kQRow0 + NQ; ++k)
        su_async::copy4(buf + k * kBatch + p, r + k * ld);
      if (G > 0)
        su_async::copy4(buf + L::kGateRaw * kBatch + p,
                        r + (size_t)gate_row * ld);
    }
    su_async::commit();
  };

  stage(start, min(kBatch, end - start), sm);
  int it = 0;
  for (int base = start; base < end; base += kBatch, ++it) {
    const bool live = !done || gdone != kAllDone;
    // barrier before the buffers are overwritten, and the tile-wide exit
    if constexpr (V == kFloorNoAlldone) {
      __syncthreads();
    } else {
      if (__syncthreads_count(live) == 0) break;
    }
    const int nb = min(kBatch, end - base);
    const float* cur = sm + (it & 1) * L::kRaw * kBatch;
    stage(base + kBatch, min(kBatch, end - base - kBatch),
          sm + ((it + 1) & 1) * L::kRaw * kBatch);
    su_async::wait<1>();   // this thread's copies of this batch landed
    if (p < nb) su_pair::stage_geometry(cur + p, kBatch, geo, kBatch, p);
    __syncthreads();
    if (!live) continue;
    if constexpr (kIsFloor) {
      for (int j = 0; j < nb; ++j) {
        fl += geo[13 * kBatch + j] * T;
        T *= 0.999f;
      }
      continue;
    }
    for (int j = 0; j < nb; ++j) {
      if constexpr (kChunked) {
        // the chunk's end comes before the skip, so that a frozen chain
        // still sees every chunk boundary
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
      if (G > 0 && done) {
        // the main chain is done: skip the pair if every chain of its
        // classes is done too
        const unsigned bits = (unsigned)(int)cur[L::kGateRaw * kBatch + j];
        if ((bits & ~gdone & kAllDone) == 0u) continue;
      }
      if constexpr (V == kNoLkMax) last = max(last, (int)(T > 2.0f));
      float a, t;
      if constexpr (V == kNoPair) {
        a = cur[j] * 1e-6f + px * 1e-8f;
        t = cur[(kQRow0 + 1) * kBatch + j] + py * 0.0f;
        if (!(a > 0.0f)) continue;
      } else {
        const su_pair::Pair e =
            su_pair::eval_pair<V != kNoExp>(geo, kBatch, j, px, py, znear);
        if (!e.contrib) continue;
        a = e.a;
        t = e.t;
      }
      const float m = dscale * (1.0f - znear / fmaxf(t, 1e-6f));
      if (!done && !(V == kNoTrigger && trig)) {
        const float t_after = T * (1.0f - a);
        if (t_after < t_eps) {
          if constexpr (kChunked) {
            trig = true;
          } else {
            done = true;
            if (G == 0) break;
          }
        } else {
          const float w = a * T;
          if constexpr (V == kNoSums) {
            const int lane = (base + j) & ((1 << kChunkShift) - 1);
#pragma unroll
            for (int k = 0; k < NQ; ++k)
              if (k == lane) accq[k] += w;
            if (lane == 0) {
              alpha += w;
              deptha += w * t;
              m1 += w * m;
              m2 += w * m * m;
            }
          } else {
#pragma unroll
            for (int k = 0; k < NQ; ++k)
              accq[k] += w * cur[(kQRow0 + k) * kBatch + j];
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
        const int bits = (int)cur[L::kGateRaw * kBatch + j];
#pragma unroll
        for (int g = 0; g < GA; ++g) {
          if (((bits >> g) & 1) && !((gdone >> g) & 1u) &&
              !(V == kNoTrigger && ((gtrig >> g) & 1u))) {
            const float tg_after = tg[g] * (1.0f - a);
            if (tg_after < t_eps) {
              if constexpr (kChunked) {
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
  su_async::wait<0>();
  __syncthreads();   // the walk's shared memory becomes the output slab

  float* o = sm + p * L::kCs;
  if constexpr (kIsFloor) {
    for (int k = 0; k < L::kCh; ++k) o[k] = fl * 1e-30f;
    if (V != kFloorNoLk) lk[(size_t)tile * kPix + p] = -1;
  } else {
#pragma unroll
    for (int k = 0; k < NQ; ++k) o[k] = accq[k];
    o[NQ] = alpha;
    o[NQ + 1] = deptha;
    o[NQ + 2] = 0.0f;
    o[NQ + 3] = m1;
    o[NQ + 4] = m2;
    o[NQ + 5] = med;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      o[NQ + 6 + 4 * g] = ag[g];
      o[NQ + 7 + 4 * g] = m1g[g];
      o[NQ + 8 + 4 * g] = m2g[g];
      o[NQ + 9 + 4 * g] = (float)lkg[g];
    }
    lk[(size_t)tile * kPix + p] = last;
  }
  __syncthreads();
  float* out = acc + (size_t)tile * kPix * L::kCh;
  for (int i = p; i < kPix * L::kCh; i += kPix) {
    const int q = i / L::kCh;
    out[i] = sm[q * L::kCs + (i - q * L::kCh)];
  }
}

// Launch on the current stream or, with `blocks_per_sm`, only report the
// blocks of this instantiation an SM holds at once.
template <int NQ, int G, int V = kFull>
cudaError_t launch(const float* recT, int cap, int gate_row,
                   const int32_t* tile_offsets, const int32_t* tile_order,
                   int n_tiles, int tiles_x, float znear, float zfar,
                   float t_eps, float* acc, int32_t* lk, cudaStream_t stream,
                   int* blocks_per_sm) {
  const size_t smem = sizeof(float) * (size_t)Layout<NQ, G>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      blend_fwd_sm90_kernel<NQ, G, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, blend_fwd_sm90_kernel<NQ, G, V>, kPix, smem);
  blend_fwd_sm90_kernel<NQ, G, V><<<n_tiles, kPix, smem, stream>>>(
      recT, cap, gate_row, tile_offsets, tile_order, tiles_x, znear, zfar,
      t_eps, acc, lk);
  return cudaGetLastError();
}

#define SU_FWD90_ARGS                                                      \
  recT, cap, gate_row, tile_offsets, tile_order, n_tiles, tiles_x, znear, \
      zfar, t_eps, acc, lk, s, blocks_per_sm
#define SU_FWD90_PARAMS                                                   \
  const float *recT, int cap, int gate_row, const int32_t *tile_offsets, \
      const int32_t *tile_order, int n_tiles, int tiles_x, float znear,  \
      float zfar, float t_eps, float *acc, int32_t *lk, cudaStream_t s,  \
      int *blocks_per_sm

// launch<NQ, G, V> for a variant given at run time
template <int NQ, int G>
cudaError_t launch_variant(int variant, SU_FWD90_PARAMS) {
#define SU_BISECT_CASE(V) \
  case V:                 \
    return launch<NQ, G, V>(SU_FWD90_ARGS);
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

// The arguments the C entries of K1 check.
inline bool fwd_args_ok(int rec, int cap, int nq, int n_gates, int gate_row,
                        int n_tiles) {
  return !(nq < 1 || nq > kMaxQ || rec < kQRow0 + nq || n_tiles < 0 ||
           n_gates < 0 || n_gates > kMaxGates ||
           (n_gates > 0 &&
            (gate_row < 0 || gate_row >= rec || cap >= kMaxStream)));
}

}  // namespace

// The gated instantiations (G = 1..kMaxGates at nq 6 and 12), in
// blend_fwd_gated.cu; other nq return cudaErrorInvalidValue.
cudaError_t launch_gated(int n_gates, int nq, SU_FWD90_PARAMS);

}  // namespace su_fwd90
