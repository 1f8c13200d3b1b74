// K2 — 2DGS blend backward, redesigned for the H100: the production
// kernel template on (nq, G, measurement variant), instantiated at its
// default variant kBwdFull by blend_bwd.cu (no gated chains, and the C
// interface) and blend_bwd_gated.cu (G gated chains at nq 6 and 12), and
// at every variant by bisect_bwd_sm90.cu and bisect_bwd_sm90_g5.cu (the
// bisection tool streetunveiler_torch/tools/bisect_bwd.py). The first
// design, blend_bwd.cuh, stays selectable in that tool (its own
// variants, bisect_bwd*.cu); its `kBwdFull` and this kernel agree bit for
// bit.
//
// Replaces the Pallas kernel streetunveiler_tpu/ops/rasterizer/kernel.py
// `_bwd_kernel` (launched at kernel.py:725, the custom VJP of
// `blend_stream`), its gated per-class chains (kernel.py:518-567)
// included. The math, the result and the semantics (α ≥ 1/255, α ≤ 0.99,
// the median under stop-grad, lk/lk_g, the telescoped distortion, the
// pair VJP by hand, dgrad [rec, cap] in stream order, zeroed by the
// wrapper, no atomics, the same result on every run) are those written
// out in blend_bwd.cuh, and each pixel's operations run in the same order.
//
// What bounds it on an H100: operations (chip_smoke.py's `k2_ops`): ~33
// f32 operations for every evaluated pair, ~20 + 4 nq more for each pair
// the main chain keeps, ~20 for each pair a gated chain keeps and ~62 for
// the pair VJP and the 14 pixel sums of each pair some chain keeps, at the
// card's 67 TFLOP/s f32. The bytes (records, acc, dacc, lk read once,
// dgrad written once) come to a third of that time.
//
// The first design ran at 23-31× that bound. What this one does about it:
// - Warp reduce-scatter instead of an all-reduce. The first design summed
//   each of the V = 14 + nq values of a kept duplicate over the warp with
//   its own xor butterfly, 5 V shuffles and adds a thread (130 at nq 12),
//   then lane 0 stored all V. Here the values are padded to 32 lanes and
//   in 5 steps (xor 16, 8, 4, 2, 1) each lane sends the half it will not
//   keep and adds the partner's copy of the half it keeps: 31 shuffles;
//   lane i ends with value i's warp sum and stores it. The pairing tree is
//   the butterfly's own and IEEE addition is commutative, so every sum
//   has the butterfly's bits; the 16 warp partials keep their fixed order.
// - Exact pair skip. The gate bits are read first, and eval_pair runs only
//   where a chain still keeps the duplicate: index ≤ lk, or bit g set and
//   index ≤ lk_g for some g. A skipped pair contributed exactly zero.
// - The gated cotangents (3 G a pixel) are loaded once into a [3G][512]
//   shared slab (thread p reads column p: no bank conflicts), not read
//   from dacc, a strided row per pixel, for each kept pair.
// - Asynchronous, double-buffered staging: while batch i is computed,
//   cp.async brings batch i+1's raw record rows (lane-major, so a batch of
//   kB slots is one run per row; 4-byte copies need no alignment beyond
//   the f32's) into the other buffer; the geometry (A, B, C, det M) is
//   hoisted once they land, and the payload, the gate row and the chain's
//   record values are read from the buffer.
// - Longest tile first: block b takes tile tile_order[b], the tiles by
//   descending duplicate count (tiles.tile_order, once per binning), so a
//   long tile does not start last and walk alone. A tile's outputs do not
//   depend on when it runs.
// - Without gated chains two blocks share an SM (64 registers a thread),
//   as for K1, where two blocks' shared memory fits in an SM's (nq <= 9);
//   at a wider payload one block takes the SM whatever its registers, so
//   they are not capped. The gated kernel needs ~118 registers; capped at
//   64 it spilled and ran no faster, so it keeps one block an SM
//   (PERF.md).
// - 64 duplicates a batch, where the first design staged 32: half the
//   barriers and partial-sum passes (the partials of each duplicate are
//   still added in the same order).
//
// Measurement variants (VAR), those of the first design (blend_bwd.cuh)
// restated against this one. Each branch is an `if constexpr`, so kBwdFull
// compiles to the production kernel; each feeds dgrad, so that nvcc keeps
// what it computes; each applies its stand-in to exactly the pairs this
// design evaluates (its exact pair skip). "Stream chunk": the 128 slots
// [128c, 128c + 128) of one tile (the TPU tool's visit).
//   kBwdFull   the production kernel.
//   kBwdFloor  the cp.async double-buffered staging and the walk: per pair
//              the pixel evaluates, fl += opacity * U, U *= 0.999 (U from
//              1); after each batch of kB, thread p < nb stores 1e-30 fl
//              into rows 0..9+nq of the batch's slot p.
//   kNoVjp     the pair VJP replaced by values 1e-30 da (even) and 1e-30
//              dt (odd) of the 14, still reduce-scattered; the chain
//              through the cross products and the payload gradients stay.
//   kNoDq      no payload gradients gq w: V = 14 values a duplicate, the
//              payload rows zero.
//   kNoGqqc    Omega's gq.q replaced by 1e-6 w.
//   kNoSuffmm  no suffix updates: T_excl = U frozen within a stream chunk,
//              S_pair = S + 1e-6 w Omega; at the chunk's end U *= 0.999 and
//              S += the chunk's sum of w Omega (every chain).
//   kBwdNoExp  the division rebuild T = U / (1 - a) replaced by the
//              multiply T = U (1 + a) (every chain).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "pair_math.cuh"

namespace su_bwd90 {
namespace {

using su_pair::kGeo;
using su_pair::kQRow0;

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kPix = kTileW * kTileH;
constexpr int kWarps = kPix / 32;
constexpr int kB = 64;           // duplicates staged per batch
constexpr int kNv = 14;          // summed geometry values per duplicate
constexpr int kMaxQ = 16;        // payload channels a launch may carry
constexpr int kMaxGates = 6;     // gated chains a launch may carry
constexpr int kMaxStream = 1 << 24;   // lk_g is exact below 2^24
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunkShift = 7;   // stream chunk of the TPU tool: 128 slots

enum BwdVariant {
  kBwdFull = 0,
  kBwdFloor,
  kNoVjp,
  kNoDq,
  kNoGqqc,
  kNoSuffmm,
  kBwdNoExp,
  kNumBwdVariants
};

// indices of the summed geometry values (as blend_bwd.cuh)
constexpr int kDA = 0;           // dA (3): d k, summed
constexpr int kDB = 3;           // dB (3): px d k
constexpr int kDC = 6;           // dC (3): py d k
constexpr int kDDet = 9;         // d det M
constexpr int kDCx = 10;         // low-pass center gradient, x
constexpr int kDCy = 11;         //                           y
constexpr int kDZ = 12;          // center depth, through t where use2d
constexpr int kDOp = 13;         // opacity

// Shared memory, in floats: two buffers of raw record rows, the hoisted
// geometry, the warp partials, their sums, and the gated cotangents.
template <int NQ, int G, int VAR = kBwdFull>
struct Layout {
  static constexpr int kRaw = kQRow0 + NQ + (G > 0 ? 1 : 0);  // rows staged
  static constexpr int kGateRaw = kQRow0 + NQ;   // the gate mask's row
  // values summed per slot
  static constexpr int kV = kNv + (VAR == kNoDq ? 0 : NQ);
  static constexpr int kGeoOff = 2 * kRaw * kB;
  static constexpr int kPartOff = kGeoOff + kGeo * kB;
  static constexpr int kRedOff = kPartOff + kWarps * kB * kV;
  static constexpr int kCotOff = kRedOff + kB * kV;
  static constexpr int kFloats = kCotOff + 3 * G * kPix;
  // blocks an SM the launch bounds ask for: two, ungated, where two fit
  // in the H100's 228 KB a SM (1 KB of it reserved a block)
  static constexpr int kMinBlocks =
      G == 0 && 2 * (4 * kFloats + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(kV <= 32, "one value per lane");
};

// One step of the warp reduce-scatter at xor offset O: of v[0..2O), the
// lane keeps the upper half if its bit O is set, else the lower, sends the
// other half to lane ^ O and adds that lane's copy of the half it keeps,
// into v[0..O). O is a template parameter so that every index is a
// constant and v stays in registers.
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32],
                                                    int lane) {
  const bool hi = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = hi ? v[i] : v[i + O];
    const float mine = hi ? v[i + O] : v[i];
    v[i] = mine + __shfl_xor_sync(kFull, send, O);
  }
}

// Warp reduce-scatter of v[0..31] (v[V..31] zero): lane i returns value
// i's sum over the warp, in the xor butterfly's pairing tree (lanes l and
// l^16 first, then l^8, ...), so with its bits.
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

template <int NQ, int G, int VAR = kBwdFull>
__global__ void __launch_bounds__(kPix, Layout<NQ, G, VAR>::kMinBlocks)
blend_bwd_sm90_kernel(const float* __restrict__ recT, int cap, int gate_row,
                      const int32_t* __restrict__ tile_offsets,
                      const int32_t* __restrict__ tile_order, int tiles_x,
                      float znear, float zfar, const float* __restrict__ acc,
                      const int32_t* __restrict__ lk,
                      const float* __restrict__ dacc,
                      float* __restrict__ dgrad) {
  using L = Layout<NQ, G, VAR>;
  constexpr int V = L::kV;
  constexpr int CH = NQ + 6 + 4 * G;
  constexpr int GA = G > 0 ? G : 1;
  extern __shared__ __align__(16) float sm[];
  float* geo = sm + L::kGeoOff;             // [kGeo][kB]
  float* part = sm + L::kPartOff;           // [kWarps][kB][V]
  float* red = sm + L::kRedOff;             // [kB][V]
  float* cot = sm + L::kCotOff;             // [3G][kPix]
  __shared__ int s_maxlk;

  const int tile = tile_order[blockIdx.x];
  // an order that is not tiles.tile_order's may name no tile: the
  // block leaves it rather than read or write out of bounds
  if ((unsigned)tile >= gridDim.x) return;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const float px = (float)(tx * kTileW + p % kTileW) + 0.5f;
  const float py = (float)(ty * kTileH + p / kTileW) + 0.5f;
  const int start = tile_offsets[tile];
  const int end = tile_offsets[tile + 1];
  const size_t pix = (size_t)tile * kPix + p;
  const int my_lk = lk[pix];
  const float* d = dacc + pix * CH;
  const float* accp = acc + pix * CH;

  // gated chains: last kept index, suffix transmittance and suffix sum
  int lkg[GA];
  float ug[GA], sg[GA];
  int my_top = my_lk;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lkg[g] = (int)accp[NQ + 6 + 4 * g + 3];
    ug[g] = 1.0f - accp[NQ + 6 + 4 * g];
    sg[g] = 0.0f;
    my_top = max(my_top, lkg[g]);
  }

  if (p == 0) s_maxlk = -1;
  __syncthreads();
  if (my_top >= 0) atomicMax(&s_maxlk, my_top);
  __syncthreads();
  const int top_all = min(end, s_maxlk + 1);
  if (top_all <= start) return;   // no pixel kept a pair: gradient-free

  float gq[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) gq[k] = d[k];
  const float g_alpha = d[NQ], g_depth = d[NQ + 1];
  const float g_m1 = d[NQ + 3], g_m2 = d[NQ + 4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cot[(3 * g + c) * kPix + p] = d[NQ + 6 + 4 * g + c];
  }
  const float dscale = zfar / (zfar - znear);
  const float dmdt_num = zfar * znear / (zfar - znear);
  // transmittance after the pair
  float U = VAR == kBwdFloor ? 1.0f : 1.0f - accp[NQ];
  float S = 0.0f;                        // sum of w * Omega behind it
  // variants: the floor's sum; kNoSuffmm's stream chunk and the sums of
  // w * Omega it has pending, per chain
  float fl = 0.0f;
  int chunk = -1;
  float s_pend = 0.0f;
  float sg_pend[GA];
#pragma unroll
  for (int g = 0; g < GA; ++g) sg_pend[g] = 0.0f;

  // thread p < n starts the copies of slot base + p's record rows into buf
  const size_t ld = (size_t)cap;
  auto stage = [&](int base, int n, float* buf) {
    if (p < n) {
      const float* r = recT + base + p;
#pragma unroll
      for (int k = 0; k < kQRow0 + NQ; ++k)
        su_async::copy4(buf + k * kB + p, r + k * ld);
      if (G > 0)
        su_async::copy4(buf + L::kGateRaw * kB + p, r + (size_t)gate_row * ld);
    }
    su_async::commit();
  };

  {
    const int base0 = max(start, top_all - kB);
    stage(base0, top_all - base0, sm);
  }
  int it = 0;
  for (int top = top_all; top > start; top -= kB, ++it) {
    const int base = max(start, top - kB);
    const int nb = top - base;
    float* cur = sm + (it & 1) * L::kRaw * kB;
    __syncthreads();   // the previous batch's shared reads are done
    {
      const int nbase = max(start, base - kB);
      stage(nbase, base - nbase, sm + ((it + 1) & 1) * L::kRaw * kB);
    }
    su_async::wait<1>();   // this thread's copies of this batch landed
    if (p < nb) su_pair::stage_geometry(cur + p, kB, geo, kB, p);
    __syncthreads();

    if constexpr (VAR == kBwdFloor) {
      for (int j = nb - 1; j >= 0; --j) {
        const int idx = base + j;
        bool need = idx <= my_lk;
        if (G > 0) {
          const int bits = (int)cur[L::kGateRaw * kB + j];
#pragma unroll
          for (int g = 0; g < GA; ++g)
            need = need || (((bits >> g) & 1) && idx <= lkg[g]);
        }
        if (need) {
          fl += geo[13 * kB + j] * U;
          U *= 0.999f;
        }
      }
      if (p < nb) {
        float* o = dgrad + base + p;
        for (int k = 0; k < kQRow0 + NQ; ++k) o[(size_t)k * ld] = 1e-30f * fl;
      }
      continue;
    }

    for (int j = nb - 1; j >= 0; --j) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.0f;
      bool keep = false;
      const int idx = base + j;
      if constexpr (VAR == kNoSuffmm) {
        const int c = idx >> kChunkShift;
        if (c != chunk) {
          if (chunk >= 0) {
            U *= 0.999f;
            S += s_pend;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              ug[g] *= 0.999f;
              sg[g] += sg_pend[g];
            }
          }
          chunk = c;
          s_pend = 0.0f;
#pragma unroll
          for (int g = 0; g < GA; ++g) sg_pend[g] = 0.0f;
        }
      }
      bool need = idx <= my_lk;
      int bits = 0;
      if (G > 0) {
        bits = (int)cur[L::kGateRaw * kB + j];
#pragma unroll
        for (int g = 0; g < GA; ++g)
          need = need || (((bits >> g) & 1) && idx <= lkg[g]);
      }
      if (need) {
        const su_pair::Pair e =
            su_pair::eval_pair(geo, kB, j, px, py, znear);
        if (e.contrib) {
          const float a = e.a, t = e.t;
          const float one_m = 1.0f - a;
          const float m = dscale * (1.0f - znear / fmaxf(t, 1e-6f));
          const float dmdt = dmdt_num / fmaxf(t * t, 1e-12f);
          float da = 0.0f, dt = 0.0f;
          if (idx <= my_lk) {
            keep = true;
            const float T = VAR == kNoSuffmm   ? U
                            : VAR == kBwdNoExp ? U * (1.0f + a)
                                               : U / one_m;
            if constexpr (VAR != kNoSuffmm) U = T;
            const float w = a * T;
            float gqq = 0.0f;
#pragma unroll
            for (int k = 0; k < NQ; ++k) {
              if constexpr (VAR != kNoGqqc) {
                const float q = cur[(kQRow0 + k) * kB + j];
                gqq += gq[k] * q;
              }
              if constexpr (VAR != kNoDq) v[kNv + k] = gq[k] * w;
            }
            if constexpr (VAR == kNoGqqc) gqq = w * 1e-6f;
            const float omega =
                gqq + g_alpha + g_depth * t + g_m1 * m + g_m2 * m * m;
            if constexpr (VAR == kNoSuffmm) {
              da = T * omega - (S + w * omega * 1e-6f) / one_m;
              s_pend += w * omega;
            } else {
              da = T * omega - S / one_m;
              S += w * omega;
            }
            dt = w * (g_depth + (g_m1 + 2.0f * m * g_m2) * dmdt);
          }
          if (G > 0) {
#pragma unroll
            for (int g = 0; g < GA; ++g) {
              if (((bits >> g) & 1) && idx <= lkg[g]) {
                keep = true;
                const float ga = cot[(3 * g) * kPix + p];
                const float gm1 = cot[(3 * g + 1) * kPix + p];
                const float gm2 = cot[(3 * g + 2) * kPix + p];
                const float T = VAR == kNoSuffmm   ? ug[g]
                                : VAR == kBwdNoExp ? ug[g] * (1.0f + a)
                                                   : ug[g] / one_m;
                if constexpr (VAR != kNoSuffmm) ug[g] = T;
                const float w = a * T;
                const float omega = ga + gm1 * m + gm2 * m * m;
                if constexpr (VAR == kNoSuffmm) {
                  da = da + (T * omega - (sg[g] + w * omega * 1e-6f) / one_m);
                  sg_pend[g] += w * omega;
                } else {
                  da = da + (T * omega - sg[g] / one_m);
                  sg[g] += w * omega;
                }
                dt = dt + w * (gm1 + 2.0f * m * gm2) * dmdt;
              }
            }
          }

          if constexpr (VAR == kNoVjp) {
            if (keep) {
#pragma unroll
              for (int i = 0; i < kNv; ++i)
                v[i] = 1e-30f * ((i & 1) ? dt : da);
            }
          } else if (keep) {
            // VJP of the pair function
            const float opac = geo[13 * kB + j];
            const float dar = e.araw <= su_pair::kAlphaMax ? da : 0.0f;
            v[kDOp] = dar * e.g;
            const float drho = dar * opac * e.g * -0.5f;
            float drho3 = 0.0f, dtis = 0.0f;
            if (e.use2d) {
              // rho2d = 2 |p - c|^2
              const float c = -2.0f * su_pair::kFilterInvSquare * drho;
              v[kDCx] = c * e.dx;
              v[kDCy] = c * e.dy;
              v[kDZ] = dt;
            } else {
              drho3 = drho;
              dtis = dt;
            }
            // rho3d = (kx^2 + ky^2) rcp^2, t = det rcp, rcp = 1 / kz
            const float rcp2 = e.rcp * e.rcp;
            const float dkx = drho3 * 2.0f * e.kx * rcp2;
            const float dky = drho3 * 2.0f * e.ky * rcp2;
            const float drcp =
                drho3 * (e.kx * e.kx + e.ky * e.ky) * 2.0f * e.rcp +
                dtis * geo[9 * kB + j];
            v[kDDet] = dtis * e.rcp;
            const float dkz = fabsf(e.kz) < 1e-12f ? 0.0f : -drcp * rcp2;
            v[kDA + 0] = dkx;
            v[kDA + 1] = dky;
            v[kDA + 2] = dkz;
            v[kDB + 0] = px * dkx;
            v[kDB + 1] = px * dky;
            v[kDB + 2] = px * dkz;
            v[kDC + 0] = py * dkx;
            v[kDC + 1] = py * dky;
            v[kDC + 2] = py * dkz;
          }
        }
      }
      // with no lane keeping the pair every value is zero, and so is v[0]
      const float s = __any_sync(kFull, keep) ? reduce_scatter(v, lane) : v[0];
      if (lane < V) part[(warp * kB + j) * V + lane] = s;
    }
    __syncthreads();

    // the 16 warp partials, added in a fixed order
    for (int i2 = p; i2 < nb * V; i2 += kPix) {
      const int j = i2 / V;
      const int i = i2 - j * V;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[(w * kB + j) * V + i];
      red[j * V + i] = s;
    }
    __syncthreads();

    // one thread per duplicate: chain the sums through the cross products
    if (p < nb) {
      const float* r = cur + p;
      const float* s = red + p * V;
      const float r1x = r[0 * kB], r2x = r[1 * kB], r3x = r[2 * kB];
      const float r1y = r[3 * kB], r2y = r[4 * kB], r3y = r[5 * kB];
      const float c2dx = r[6 * kB], c2dy = r[7 * kB], z = r[8 * kB];
      const float r1z = c2dx * z, r2z = c2dy * z, r3z = z;
      const float ax = r1y * r2z - r1z * r2y;
      const float ay = r1z * r2x - r1x * r2z;
      const float az = r1x * r2y - r1y * r2x;
      const float ddet = s[kDDet];
      // det = r3 . A: d r3 += ddet A, d A += ddet r3
      const float gax = s[kDA + 0] + ddet * r3x;
      const float gay = s[kDA + 1] + ddet * r3y;
      const float gaz = s[kDA + 2] + ddet * r3z;
      const float gbx = s[kDB + 0], gby = s[kDB + 1], gbz = s[kDB + 2];
      const float gcx = s[kDC + 0], gcy = s[kDC + 1], gcz = s[kDC + 2];
      // A = r1 x r2: d r1 += r2 x dA, d r2 += dA x r1
      // B = r2 x r3: d r2 += r3 x dB, d r3 += dB x r2
      // C = r3 x r1: d r3 += r1 x dC, d r1 += dC x r3
      const float d1x = (r2y * gaz - r2z * gay) + (gcy * r3z - gcz * r3y);
      const float d1y = (r2z * gax - r2x * gaz) + (gcz * r3x - gcx * r3z);
      const float d1z = (r2x * gay - r2y * gax) + (gcx * r3y - gcy * r3x);
      const float d2x = (gay * r1z - gaz * r1y) + (r3y * gbz - r3z * gby);
      const float d2y = (gaz * r1x - gax * r1z) + (r3z * gbx - r3x * gbz);
      const float d2z = (gax * r1y - gay * r1x) + (r3x * gby - r3y * gbx);
      const float d3x = ddet * ax + (gby * r2z - gbz * r2y) +
                        (r1y * gcz - r1z * gcy);
      const float d3y = ddet * ay + (gbz * r2x - gbx * r2z) +
                        (r1z * gcx - r1x * gcz);
      const float d3z = ddet * az + (gbx * r2y - gby * r2x) +
                        (r1x * gcy - r1y * gcx);
      float* o = dgrad + base + p;
      o[0 * ld] = d1x;
      o[1 * ld] = d2x;
      o[2 * ld] = d3x;
      o[3 * ld] = d1y;
      o[4 * ld] = d2y;
      o[5 * ld] = d3y;
      // r1z = c2dx z, r2z = c2dy z, r3z = z
      o[6 * ld] = s[kDCx] + d1z * z;
      o[7 * ld] = s[kDCy] + d2z * z;
      o[8 * ld] = s[kDZ] + d1z * c2dx + d2z * c2dy + d3z;
      o[9 * ld] = s[kDOp];
      if constexpr (VAR != kNoDq) {
#pragma unroll
        for (int k = 0; k < NQ; ++k)
          o[(size_t)(kQRow0 + k) * ld] = s[kNv + k];
      }
    }
  }
  su_async::wait<0>();
}

// Launch on the current stream or, with `blocks_per_sm`, only report the
// blocks of this instantiation an SM holds at once.
template <int NQ, int G, int VAR = kBwdFull>
cudaError_t launch(const float* recT, int cap, int gate_row,
                   const int32_t* tile_offsets, const int32_t* tile_order,
                   int n_tiles, int tiles_x, float znear, float zfar,
                   const float* acc, const int32_t* lk, const float* dacc,
                   float* dgrad, cudaStream_t stream, int* blocks_per_sm) {
  const size_t smem = sizeof(float) * (size_t)Layout<NQ, G, VAR>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_sm90_kernel<NQ, G, VAR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, blend_bwd_sm90_kernel<NQ, G, VAR>, kPix, smem);
  blend_bwd_sm90_kernel<NQ, G, VAR><<<n_tiles, kPix, smem, stream>>>(
      recT, cap, gate_row, tile_offsets, tile_order, tiles_x, znear, zfar,
      acc, lk, dacc, dgrad);
  return cudaGetLastError();
}

#define SU_BWD90_ARGS                                                      \
  recT, cap, gate_row, tile_offsets, tile_order, n_tiles, tiles_x, znear, \
      zfar, acc, lk, dacc, dgrad, s, blocks_per_sm
#define SU_BWD90_PARAMS                                                    \
  const float *recT, int cap, int gate_row, const int32_t *tile_offsets,  \
      const int32_t *tile_order, int n_tiles, int tiles_x, float znear,   \
      float zfar, const float *acc, const int32_t *lk, const float *dacc, \
      float *dgrad, cudaStream_t s, int *blocks_per_sm

// Dispatch on nq (1..kMaxQ) for a fixed G.
template <int G>
cudaError_t launch_nq(int nq, SU_BWD90_PARAMS) {
#define SU_BWD_CASE(Q) \
  case Q:              \
    return launch<Q, G>(SU_BWD90_ARGS);
  switch (nq) {
    SU_BWD_CASE(1) SU_BWD_CASE(2) SU_BWD_CASE(3) SU_BWD_CASE(4)
    SU_BWD_CASE(5) SU_BWD_CASE(6) SU_BWD_CASE(7) SU_BWD_CASE(8)
    SU_BWD_CASE(9) SU_BWD_CASE(10) SU_BWD_CASE(11) SU_BWD_CASE(12)
    SU_BWD_CASE(13) SU_BWD_CASE(14) SU_BWD_CASE(15) SU_BWD_CASE(16)
  }
#undef SU_BWD_CASE
  return cudaErrorInvalidValue;
}

// launch<NQ, G, VAR> for a variant given at run time
template <int NQ, int G>
cudaError_t launch_variant(int variant, SU_BWD90_PARAMS) {
#define SU_BISECT_CASE(VAR) \
  case VAR:                 \
    return launch<NQ, G, VAR>(SU_BWD90_ARGS);
  switch (variant) {
    SU_BISECT_CASE(kBwdFull) SU_BISECT_CASE(kBwdFloor) SU_BISECT_CASE(kNoVjp)
    SU_BISECT_CASE(kNoDq) SU_BISECT_CASE(kNoGqqc) SU_BISECT_CASE(kNoSuffmm)
    SU_BISECT_CASE(kBwdNoExp)
  }
#undef SU_BISECT_CASE
  return cudaErrorInvalidValue;
}

// The arguments the C entries of K2 check.
inline bool bwd_args_ok(int rec, int cap, int nq, int n_gates, int gate_row,
                        int n_tiles) {
  return !(nq < 1 || nq > kMaxQ || rec < kQRow0 + nq || n_tiles < 0 ||
           n_gates < 0 || n_gates > kMaxGates ||
           (n_gates > 0 &&
            (gate_row < 0 || gate_row >= rec || cap >= kMaxStream)));
}

}  // namespace

// The gated instantiations (G = 1..kMaxGates at nq 6 and 12), in
// blend_bwd_gated.cu; other nq return cudaErrorInvalidValue.
cudaError_t launch_gated(int n_gates, int nq, SU_BWD90_PARAMS);

}  // namespace su_bwd90
