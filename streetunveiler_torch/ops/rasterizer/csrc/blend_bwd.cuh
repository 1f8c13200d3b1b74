// K2 — 2DGS blend backward over the tile-grouped, depth-sorted duplicate
// stream: the kernel template on (nq, G, measurement variant),
// instantiated by blend_bwd.cu (no gated chains, and the C interface) and
// blend_bwd_gated.cu (G gated chains), so that the two compile in
// parallel, and by bisect_bwd.cu and bisect_bwd_g5.cu (the variants of the
// bisection tool streetunveiler_torch/tools/bisect_bwd.py, at (6, 0) and
// (12, 5)). The kernel has internal linkage, so each translation unit
// keeps its own copy.
//
// Replaces the Pallas kernel streetunveiler_tpu/ops/rasterizer/kernel.py
// `_bwd_kernel` (launched by `_blend_bwd`, kernel.py:709-760, the custom
// VJP of `blend_stream`), its gated per-class chains (kernel.py:518-567)
// included. Same result: dgrad [rec, cap], the gradient of each
// duplicate's packed record in stream order, from the records, the
// forward's accumulator and lk, and the accumulator's cotangent dacc
// [n_tiles, 512, nq + 6 + 4G].
//
// Math, per pixel, walking its tile's duplicates back to front from the
// pixel's deepest last composited one on any chain: U starts at
// 1 - alpha_final and S at 0; for a pair kept by the main chain (alpha > 0
// and index <= lk)
//   T_excl = U / (1 - a),  U <- T_excl,  w = a T_excl,
//   Omega  = gq.q + g_alpha + g_depth t + g_m1 m + g_m2 m^2,
//   da     = T_excl Omega - S / (1 - a),  S <- S + w Omega,
//   dt     = w (g_depth + (g_m1 + 2 m g_m2) dm/dt).
// Gated chain g keeps its own U_g (from 1 - alpha_g), S_g and lk_g; for a
// pair of class g (alpha * bit_g > 0, index <= lk_g) it adds
//   da_g = T_g Omega_g - S_g / (1 - a),  Omega_g = ga_g + gm1_g m + gm2_g m^2,
//   dt_g = w_g (gm1_g + 2 m gm2_g) dm/dt
// to (da, dt) BEFORE the one pair VJP, as the TPU kernel accumulates its
// chains' cotangents before its single pair_vjp (kernel.py:569). Then the
// pair function's VJP maps (da, dt) onto record rows 0-9 and the payload
// rows get dq = gq w (main chain); the gate row's gradient is zero. This is
// kernel.py:465-567 as a running scan: the TPU's log-space suffix matmuls,
// MXU contractions and sum-based any() were Mosaic workarounds and have no
// counterpart. The division rebuild of T_excl needs t_eps > 0 (so U never
// reaches 0) and a <= 0.99.
//
// The pair VJP, by hand (the plain version takes it from autograd of
// blendmath.pair_alpha_depth): the alpha clamp passes the gradient while
// opacity * g <= 0.99 (torch.clamp's rule); rho and t follow the `use2d`
// branch (low-pass: gradient to the center and, through t, the center
// depth; else to k and det M); the kz guard stops the gradient where it
// replaced kz. The alpha >= 1/255 and t >= znear gates decide `contrib`
// exactly as in K1 (pair_math.cuh). Since k = A + px B + py C and
// det M = r3 . A are linear in the per-surfel A, B, C, each thread
// produces dA, dB = px dk, dC = py dk, d det, the low-pass center
// gradient, the center-depth gradient and d opacity (14 values) plus nq
// payload gradients; the block sums them over its 512 pixels and one
// thread per duplicate chains the sums through the cross products onto
// rows 0-9 (M's third column is rebuilt from c2d * z, so rows 6-8 get
// gradient through it: that is how the screen-space gradient for
// densification is read).
//
// What bounds it on an H100: operations. Every evaluated pair (index <=
// the pixel's deepest lk or lk_g) costs the forward recompute, ~33 f32
// operations; a pair the main chain kept ~20 + 4 nq more for its scan
// (gq.q, gq w and its sum), a pair a gated chain kept ~20 more for that
// chain's scan, and every pair some chain kept ~62 for the pair VJP and the
// 14 pixel sums: ~82 + 4 nq per kept pair without gates. Against that,
// the records' rows 0..9+nq (and the gate row), the accumulator channels
// alpha, alpha_g and lk_g, the cotangents of the payload, alpha, depth,
// m1, m2, alpha_g, m1_g and m2_g, and lk are read once and dgrad written
// once (the `bytes` of chip_smoke.py's k2_vs_plain lines).
//
// Design: one block of 512 threads per 16x32 tile, one thread per pixel,
// mirroring K1. The block takes the largest lk (and lk_g) of its pixels
// and skips every duplicate above it; it walks the rest backwards in
// batches of kB duplicates staged in shared memory (the hoisted geometry
// of pair_math.cuh, the payload and the gate row). For each duplicate
// every warp sums its lanes' values with shuffles (skipped when no lane
// kept the pair) and stores one partial per warp; after the batch the 16
// partials are added in a fixed order and written once to dgrad. Every
// slot belongs to one tile, so no atomics are needed and the result does
// not vary from run to run; the wrapper zeroes dgrad, so slots past the
// stream's total, slots of empty tiles and the rows past 10 + nq stay
// zero. Templated on (nq, G): the gated state (U_g, S_g, lk_g) lives in
// registers; the gated cotangents are read from dacc (L1) when a pair of
// that class is kept.
//
// Measurement variants (VAR), each named after its TPU counterpart in
// tools/bisect_bwd.py:71-142 and each feeding dgrad, so that nvcc keeps
// what it computes. "Stream chunk" is the TPU tool's visit: the 128 stream
// slots [128c, 128c + 128) of one tile.
//   kBwdFull   the production kernel.
//   kBwdFloor  staging and the walk from the tile's deepest lk down; per
//              pair fl += opacity * U, U *= 0.999 (U from 1), and each
//              duplicate's rows 0..9+nq = 1e-30 fl after its batch.
//   kNoVjp     the per-pair VJP replaced by summed values 1e-30 da (even)
//              and 1e-30 dt (odd); the chain through the cross products
//              and the payload gradients stay.
//   kNoDq      no payload gradients gq w and no sums of them (rows zero).
//   kNoGqqc    Omega's gq.q replaced by 1e-6 w.
//   kNoSuffmm  no suffix updates: T_excl = U frozen within a stream chunk,
//              S_pair = S + 1e-6 w Omega; at the chunk's end U *= 0.999 and
//              S += the chunk's sum of w Omega (every chain).
//   kBwdNoExp  the division rebuild T = U / (1 - a) replaced by the
//              multiply T = U (1 + a) (the TPU tool's linearised exp of the
//              log-space suffix; every chain).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"

namespace su_bwd {
namespace {

using su_pair::kGeo;
using su_pair::kQRow0;

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kPix = kTileW * kTileH;
constexpr int kWarps = kPix / 32;
constexpr int kB = 32;           // duplicates staged per batch
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

// indices of the summed geometry values
constexpr int kDA = 0;           // dA (3): d k, summed
constexpr int kDB = 3;           // dB (3): px d k
constexpr int kDC = 6;           // dC (3): py d k
constexpr int kDDet = 9;         // d det M
constexpr int kDCx = 10;         // low-pass center gradient, x
constexpr int kDCy = 11;         //                           y
constexpr int kDZ = 12;          // center depth, through t where use2d
constexpr int kDOp = 13;         // opacity

// values summed over the tile's pixels per duplicate
template <int NQ, int VAR>
__host__ __device__ constexpr int summed() {
  return kNv + (VAR == kNoDq ? 0 : NQ);
}

template <int NQ, int G, int VAR = kBwdFull>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kGeo + NQ + (G > 0 ? 1 : 0)) * kB +
          (size_t)kWarps * kB * summed<NQ, VAR>() +
          (size_t)kB * summed<NQ, VAR>());
}

template <int NQ, int G, int VAR>
__global__ void __launch_bounds__(kPix, 1)
blend_bwd_kernel(const float* __restrict__ recT, int cap, int gate_row,
                 const int32_t* __restrict__ tile_offsets, int tiles_x,
                 float znear, float zfar, const float* __restrict__ acc,
                 const int32_t* __restrict__ lk,
                 const float* __restrict__ dacc,
                 float* __restrict__ dgrad) {
  constexpr int V = summed<NQ, VAR>();
  constexpr int CH = NQ + 6 + 4 * G;
  constexpr int GA = G > 0 ? G : 1;
  constexpr int kGate = kGeo + NQ;          // staged row of the gate mask
  extern __shared__ float sm[];
  float* geo = sm;                          // [kGeo + NQ (+1)][kB]
  float* part = geo + (kGeo + NQ + (G > 0 ? 1 : 0)) * kB;  // [kWarps][kB][V]
  float* red = part + kWarps * kB * V;      // [kB][V]
  __shared__ int s_maxlk;

  const int tile = blockIdx.x;
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

  for (int top = top_all; top > start; top -= kB) {
    const int base = max(start, top - kB);
    const int nb = top - base;
    __syncthreads();   // the previous batch's shared reads are done
    if (p < nb) {
      const float* r = recT + base + p;
      const size_t ld = (size_t)cap;
      su_pair::stage_geometry(r, ld, geo, kB, p);
#pragma unroll
      for (int k = 0; k < NQ; ++k)
        geo[(kGeo + k) * kB + p] = r[(size_t)(kQRow0 + k) * ld];
      if (G > 0) geo[kGate * kB + p] = r[(size_t)gate_row * ld];
    }
    __syncthreads();

    if (VAR == kBwdFloor) {
      for (int j = nb - 1; j >= 0; --j) {
        fl += geo[13 * kB + j] * U;
        U *= 0.999f;
      }
      if (p < nb) {
        float* o = dgrad + base + p;
        for (int k = 0; k < kQRow0 + NQ; ++k) o[(size_t)k * cap] = 1e-30f * fl;
      }
      continue;
    }

    for (int j = nb - 1; j >= 0; --j) {
      float v[kNv + NQ];
#pragma unroll
      for (int i = 0; i < kNv + NQ; ++i) v[i] = 0.0f;
      bool keep = false;
      if (VAR == kNoSuffmm) {
        const int c = (base + j) >> kChunkShift;
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
      if (base + j <= my_top) {
        const su_pair::Pair e =
            su_pair::eval_pair(geo, kB, j, px, py, znear);
        if (e.contrib) {
          const float a = e.a, t = e.t;
          const float one_m = 1.0f - a;
          const float m = dscale * (1.0f - znear / fmaxf(t, 1e-6f));
          const float dmdt = dmdt_num / fmaxf(t * t, 1e-12f);
          float da = 0.0f, dt = 0.0f;
          if (base + j <= my_lk) {
            keep = true;
            const float T = VAR == kNoSuffmm   ? U
                            : VAR == kBwdNoExp ? U * (1.0f + a)
                                               : U / one_m;
            if (VAR != kNoSuffmm) U = T;
            const float w = a * T;
            float gqq = 0.0f;
#pragma unroll
            for (int k = 0; k < NQ; ++k) {
              if (VAR != kNoGqqc) {
                const float q = geo[(kGeo + k) * kB + j];
                gqq += gq[k] * q;
              }
              if (VAR != kNoDq) v[kNv + k] = gq[k] * w;
            }
            if (VAR == kNoGqqc) gqq = w * 1e-6f;
            const float omega =
                gqq + g_alpha + g_depth * t + g_m1 * m + g_m2 * m * m;
            if (VAR == kNoSuffmm) {
              da = T * omega - (S + w * omega * 1e-6f) / one_m;
              s_pend += w * omega;
            } else {
              da = T * omega - S / one_m;
              S += w * omega;
            }
            dt = w * (g_depth + (g_m1 + 2.0f * m * g_m2) * dmdt);
          }
          if (G > 0) {
            const int bits = (int)geo[kGate * kB + j];
#pragma unroll
            for (int g = 0; g < GA; ++g) {
              if (((bits >> g) & 1) && base + j <= lkg[g]) {
                keep = true;
                const float* dg = d + NQ + 6 + 4 * g;
                const float ga = dg[0], gm1 = dg[1], gm2 = dg[2];
                const float T = VAR == kNoSuffmm   ? ug[g]
                                : VAR == kBwdNoExp ? ug[g] * (1.0f + a)
                                                   : ug[g] / one_m;
                if (VAR != kNoSuffmm) ug[g] = T;
                const float w = a * T;
                const float omega = ga + gm1 * m + gm2 * m * m;
                if (VAR == kNoSuffmm) {
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

          if (VAR == kNoVjp && keep) {
#pragma unroll
            for (int i = 0; i < kNv; ++i) v[i] = 1e-30f * ((i & 1) ? dt : da);
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
      if (__any_sync(kFull, keep)) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float x = v[i];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
          v[i] = x;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < V; ++i) part[(warp * kB + j) * V + i] = v[i];
      }
    }
    __syncthreads();

    // the 16 warp partials, added in a fixed order
    for (int idx = p; idx < nb * V; idx += kPix) {
      const int j = idx / V;
      const int i = idx - j * V;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[(w * kB + j) * V + i];
      red[j * V + i] = s;
    }
    __syncthreads();

    // one thread per duplicate: chain the sums through the cross products
    if (p < nb) {
      const float* r = recT + base + p;
      const size_t ld = (size_t)cap;
      const float* s = red + p * V;
      const float r1x = r[0 * ld], r2x = r[1 * ld], r3x = r[2 * ld];
      const float r1y = r[3 * ld], r2y = r[4 * ld], r3y = r[5 * ld];
      const float c2dx = r[6 * ld], c2dy = r[7 * ld], z = r[8 * ld];
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
      if (VAR != kNoDq) {
#pragma unroll
        for (int k = 0; k < NQ; ++k)
          o[(size_t)(kQRow0 + k) * ld] = s[kNv + k];
      }
    }
  }
}

template <int NQ, int G, int VAR = kBwdFull>
cudaError_t launch(const float* recT, int cap, int gate_row,
                   const int32_t* tile_offsets, int n_tiles, int tiles_x,
                   float znear, float zfar, const float* acc,
                   const int32_t* lk, const float* dacc, float* dgrad,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<NQ, G, VAR>();
  cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_kernel<NQ, G, VAR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  blend_bwd_kernel<NQ, G, VAR><<<n_tiles, kPix, smem, stream>>>(
      recT, cap, gate_row, tile_offsets, tiles_x, znear, zfar, acc, lk, dacc,
      dgrad);
  return cudaGetLastError();
}

// Dispatch on nq (1..kMaxQ) for a fixed G.
template <int G>
cudaError_t launch_nq(int nq, const float* recT, int cap, int gate_row,
                      const int32_t* tile_offsets, int n_tiles, int tiles_x,
                      float znear, float zfar, const float* acc,
                      const int32_t* lk, const float* dacc, float* dgrad,
                      cudaStream_t s) {
#define SU_BWD_CASE(Q)                                                     \
  case Q:                                                                  \
    return launch<Q, G>(recT, cap, gate_row, tile_offsets, n_tiles,       \
                        tiles_x, znear, zfar, acc, lk, dacc, dgrad, s);
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
cudaError_t launch_variant(int variant, const float* recT, int cap,
                           int gate_row, const int32_t* tile_offsets,
                           int n_tiles, int tiles_x, float znear, float zfar,
                           const float* acc, const int32_t* lk,
                           const float* dacc, float* dgrad, cudaStream_t s) {
#define SU_BISECT_CASE(VAR)                                                \
  case VAR:                                                                \
    return launch<NQ, G, VAR>(recT, cap, gate_row, tile_offsets, n_tiles, \
                              tiles_x, znear, zfar, acc, lk, dacc, dgrad, \
                              s);
  switch (variant) {
    SU_BISECT_CASE(kBwdFull) SU_BISECT_CASE(kBwdFloor) SU_BISECT_CASE(kNoVjp)
    SU_BISECT_CASE(kNoDq) SU_BISECT_CASE(kNoGqqc) SU_BISECT_CASE(kNoSuffmm)
    SU_BISECT_CASE(kBwdNoExp)
  }
#undef SU_BISECT_CASE
  return cudaErrorInvalidValue;
}

// The arguments every C entry of K2 and its variants checks.
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
cudaError_t launch_gated(int n_gates, int nq, const float* recT, int cap,
                         int gate_row, const int32_t* tile_offsets,
                         int n_tiles, int tiles_x, float znear, float zfar,
                         const float* acc, const int32_t* lk,
                         const float* dacc, float* dgrad, cudaStream_t s);

}  // namespace su_bwd
