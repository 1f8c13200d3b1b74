// Pair (surfel x pixel) math shared by the blend forward (K1,
// blend_fwd.cu) and the blend backward (K2, blend_bwd.cu), so that both
// see the same alpha, depth and contributing set: a pair that K1 dropped at
// the alpha >= 1/255 gate and K2 kept would corrupt the backward's suffix
// sums for every earlier pair of that pixel. The formulas and their order
// are those of blendmath.pair_alpha_depth, and the library builds with
// -fmad=false (cuda_lib.py), so each product and sum rounds as it does in
// the plain PyTorch versions.

#pragma once

#include <cuda_runtime.h>

namespace su_pair {

constexpr int kQRow0 = 10;       // first payload row of a record
constexpr int kGeo = 14;         // staged per duplicate: A (3), B (3), C (3),
                                 // det M, c2dx, c2dy, depth, opacity
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kFilterInvSquare = 2.0f;

// Stage one duplicate's geometry into a struct-of-arrays shared buffer
// sm[k * stride + slot]: the record r (lane-major, leading dimension ld)
// holds M's first two columns (rows 0-5), the projected center (6-7), the
// center depth (8) and the opacity (9); M's third column is rebuilt as
// (c2dx * z, c2dy * z, z), and the per-surfel cross products A = r1 x r2,
// B = r2 x r3, C = r3 x r1 and det M = r3 . A are hoisted here.
__device__ __forceinline__ void stage_geometry(const float* __restrict__ r,
                                               size_t ld, float* sm,
                                               int stride, int slot) {
  const float r1x = r[0 * ld], r2x = r[1 * ld], r3x = r[2 * ld];
  const float r1y = r[3 * ld], r2y = r[4 * ld], r3y = r[5 * ld];
  const float c2dx = r[6 * ld], c2dy = r[7 * ld];
  const float z = r[8 * ld], opac = r[9 * ld];
  const float r1z = c2dx * z, r2z = c2dy * z, r3z = z;
  const float ax = r1y * r2z - r1z * r2y;
  const float ay = r1z * r2x - r1x * r2z;
  const float az = r1x * r2y - r1y * r2x;
  sm[0 * stride + slot] = ax;
  sm[1 * stride + slot] = ay;
  sm[2 * stride + slot] = az;
  sm[3 * stride + slot] = r2y * r3z - r2z * r3y;
  sm[4 * stride + slot] = r2z * r3x - r2x * r3z;
  sm[5 * stride + slot] = r2x * r3y - r2y * r3x;
  sm[6 * stride + slot] = r3y * r1z - r3z * r1y;
  sm[7 * stride + slot] = r3z * r1x - r3x * r1z;
  sm[8 * stride + slot] = r3x * r1y - r3y * r1x;
  sm[9 * stride + slot] = r3x * ax + r3y * ay + r3z * az;
  sm[10 * stride + slot] = c2dx;
  sm[11 * stride + slot] = c2dy;
  sm[12 * stride + slot] = z;
  sm[13 * stride + slot] = opac;
}

// One pair's forward values, with what the backward needs of them.
struct Pair {
  float kx, ky, kz;    // k = A + px B + py C
  float rcp;           // 1 / kz (kz guarded away from 0)
  float dx, dy;        // pixel - projected center
  float g;             // exp(-rho / 2)
  float araw;          // opacity * g, before the clamp at kAlphaMax
  float a;             // min(kAlphaMax, araw)
  float t;             // depth: the ray-plane intersection, or the center
                       // depth where the low-pass wins
  bool use2d;          // rho = rho2d (low-pass) rather than rho3d
  bool contrib;        // a >= 1/255, t >= znear, opacity > 0
};

// kExp = false is the measurement variant of csrc/bisect_fwd.cu: exp(x)
// replaced by the linear stand-in 1 + x.
template <bool kExp = true>
__device__ __forceinline__ Pair eval_pair(const float* sm, int stride, int j,
                                          float px, float py, float znear) {
  Pair e;
  const float opac = sm[13 * stride + j];
  e.kx = sm[0 * stride + j] + px * sm[3 * stride + j] +
         py * sm[6 * stride + j];
  e.ky = sm[1 * stride + j] + px * sm[4 * stride + j] +
         py * sm[7 * stride + j];
  e.kz = sm[2 * stride + j] + px * sm[5 * stride + j] +
         py * sm[8 * stride + j];
  const float kzs = fabsf(e.kz) < 1e-12f ? 1e-12f : e.kz;
  e.rcp = 1.0f / kzs;
  const float rho3d = (e.kx * e.kx + e.ky * e.ky) * (e.rcp * e.rcp);
  e.dx = px - sm[10 * stride + j];
  e.dy = py - sm[11 * stride + j];
  const float rho2d = kFilterInvSquare * (e.dx * e.dx + e.dy * e.dy);
  e.use2d = rho3d > rho2d;
  const float rho = e.use2d ? rho2d : rho3d;
  e.t = e.use2d ? sm[12 * stride + j] : sm[9 * stride + j] * e.rcp;
  e.g = kExp ? expf(-0.5f * rho) : 1.0f + -0.5f * rho;
  e.araw = opac * e.g;
  e.a = fminf(kAlphaMax, e.araw);
  e.contrib = e.a >= kAlphaEps && e.t >= znear && opac > 0.0f;
  return e;
}

}  // namespace su_pair
