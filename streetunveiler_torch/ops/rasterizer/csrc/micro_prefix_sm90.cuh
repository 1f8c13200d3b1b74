// T4 redesigned for the H100: the per-chunk prefix-sum probe of
// tools/micro_prefix.py, behind `su_micro_prefix`; the first design
// (micro_prefix.cu, `su_micro_prefix_first`) shares the pair math, the
// tensor-core wrappers and the modes defined here.
//
// The same function and modes as the first design (micro_prefix.cu:6-16):
// rec is [24, n_chunks * 128] f32 lane-major (rows 0-2 are read); chunk c
// adds into tile c / 66 of out [n_chunks / 66, 512, 16]. For pixel `sub`
// = 0..511 and lane s of the chunk a fake pair (u, v, alpha, w0), the
// exclusive lane prefix sums L, A, M1, M2 of log1p(-w0), w0, w0 u and
// w0 u^2, T = exp(L), w = w0 T, and the chunk adds (sum w, sum w u,
// sum w (u^2 A + M2 - 2 u M1), sum w v, then sum w T twelve times).
//
// What bounds it on an H100: operations. 1.11e9 (pixel, lane) pairs at
// n_chunks = 16896, each 44 f32 operations in the serial mode's loop (a
// divide, an exp or a log1p counted as one; sub r3, b r1 and u u once):
// the pair 22 (the fake pair's products and differences 9, the guard on
// kz 2, two divides, rho 3, the scaled exp and its clamp 3, the w0 gate
// 2, log1p), the epilogue 16 (exp(L), w, and the five sums' 14) and the
// four running sums 6; 0.727 ms at 67 TFLOP/s. The rows read, 26 MB, take
// 0.008 ms.
//
// The first design staged each chunk's three rows synchronously, with
// two barriers a chunk, and its tensor-core modes took the whole 128x128
// triangular product (36 k-tiles a quantity for every 8 pixels), rebuilt
// the triangle from index comparisons in every k-tile, and wrote the pair
// values to shared memory to read them back per k-tile, at 8 warps a
// block. What this design does about it:
// - Every mode stages the tile's rows 0-2 of its 66 chunks (101 KB) once,
//   by 16-byte cp.async copies of all threads, then one barrier: no
//   barrier in the walk. serial and warpscan keep each pixel's order of
//   operations, so their outputs equal the first design's bit for bit.
// - The tensor-core modes take a two-level scan with the pair values in
//   registers: D[pixel, lane] = X[pixel, lanes] Tri[lanes, lane] over the
//   8 diagonal 16-lane blocks of a chunk, X (16 pixels x 16 lanes, an
//   m-tile) the A operand and the constant strictly-lower triangle B,
//   the exclusive carry of the earlier blocks the accumulator C, so that
//   D is the exclusive prefix over the chunk's lanes. A block's total is
//   D + X at its lane 15, held by the row's thread t = 3 and passed to the
//   row's four threads by shuffle. 8 diagonal blocks a quantity in place
//   of 36 k-tiles, and no round trip of the pair values.
//   * bf16 m16n8k16 with two n-tiles covering the 16 lanes: a thread's D
//     entries (pixel rows g, g + 8; lanes 2t, 2t+1, 2t+8, 2t+9) are
//     exactly its A entries, so it computes the pair values of those 8
//     (pixel, lane) positions once, packs them as its A fragment and reads
//     their prefixes in its D fragment.
//   * tf32 m16n8k8 (mma_3xtf32): A's k layout (t, t + 4) differs from D's
//     (2t, 2t + 1), so k is permuted: in each 8-lane half h, A column t
//     is lane 8h + 2t and column t + 4 lane 8h + 2t + 1, with the same
//     rows of the triangle; the positions coincide again. (Half 1 adds
//     nothing to n-tile 0: three mma a pass.)
//   * The triangle's B fragments are built once per kernel.
//   * The epilogue consumes each quantity's D as it comes (L first:
//     T, w and the sums of w, w v and w T; then A, M2, M1 into
//     z = u^2 A + M2 - 2 u M1, in that expression's order; then w z), so
//     that few values stay live.
//   * 16 warps a block, each walking two m-tiles of the tile in turn over
//     all 66 chunks, 8 independent pairs a thread in flight. The modes
//     need 87-103 registers, so an SM holds one block; capped at 64 for
//     two blocks an SM they spilled and ran no faster on an H100.
//   Operands are rounded as PRECISION says (bf16, or tf32 hi + lo), with
//   f32 accumulation; only the order of the f32 sums differs from the
//   plain version.
// tests/test_torch_prefix_redesign.py models the fragment maps and the
// two-level scan.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace su_prefix90 {

constexpr int kP = 512;        // pixels per tile
constexpr int kS = 128;        // lanes per chunk
constexpr int kOut = 16;       // output channels
constexpr int kCpt = 66;       // chunks per tile, the TPU tool's constant
constexpr int kTileLanes = kCpt * kS;   // one staged row of a tile

enum PrefixMode {
  kSerial = 0,
  kWarpScan,
  kMmaBf16,
  kMmaBf16x2,
  kMma3xTf32,
  kNumPrefixModes
};

struct PairVals {
  float w0, u, v, logom;
};

__device__ __forceinline__ PairVals pair_vals(float r1, float r2, float r3,
                                              float sub) {
  PairVals o;
  const float a = r1 - sub * r3;
  const float b = r2 - sub * r3;
  const float kx = a * b - r3;
  const float ky = b * r1 - a;
  const float kz = a * r2 - b * r1;
  const float kzs = fabsf(kz) < 1e-12f ? 1e-12f : kz;
  o.u = kx / kzs;
  o.v = ky / kzs;
  const float rho = o.u * o.u + o.v * o.v;
  const float alpha = fminf(0.99f, expf(-0.5f * rho));
  o.w0 = alpha > 1e-3f ? alpha : 0.0f;
  o.logom = log1pf(-o.w0);
  return o;
}

// One pair's additions to the five distinct channels, from its exclusive
// prefix sums.
__device__ __forceinline__ void add_pair(float (&s)[5], const PairVals& e,
                                         float L, float A, float M1,
                                         float M2) {
  const float T = expf(L);
  const float w = e.w0 * T;
  s[0] += w;
  s[1] += w * e.u;
  s[2] += w * (e.u * e.u * A + M2 - 2.0f * e.u * M1);
  s[3] += w * e.v;
  s[4] += w * T;
}

__device__ __forceinline__ void store_out(float* out, int tile, int p,
                                          const float (&acc)[5]) {
  float* o = out + ((size_t)tile * kP + p) * kOut;
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c] = acc[c];
#pragma unroll
  for (int c = 4; c < kOut; ++c) o[c] = acc[4];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Exclusive scan of x over the warp's lanes (Hillis-Steele on the values
// shifted by one lane), plus `carry`; `carry` becomes carry + the total.
__device__ __forceinline__ float warp_excl_scan(float x, float& carry,
                                                int lane) {
  float y = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) y = 0.0f;
  const float incl_last = __shfl_sync(0xffffffffu, x, 31);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float z = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) y += z;
  }
  const float total = __shfl_sync(0xffffffffu, y, 31) + incl_last;
  const float res = carry + y;
  carry += total;
  return res;
}

namespace {

constexpr int kMmaWarps = 16;           // warps a block, tensor-core modes
constexpr int kMTiles = kP / 16;        // m-tiles of 16 pixels a tile
constexpr size_t kStageBytes = sizeof(float) * 3 * kTileLanes;

// Copy the tile's rows 0-2 of its 66 chunks into r [3][kTileLanes] (rec
// and ld 16-byte aligned), then one barrier.
__device__ __forceinline__ void stage_tile(const float* __restrict__ rec,
                                           size_t ld, int tile, float* r,
                                           int tid, int nthreads) {
  constexpr int kPieces = kTileLanes / 4;   // 16-byte pieces a row
  const float* src = rec + (size_t)tile * kTileLanes;
  for (int i = tid; i < 3 * kPieces; i += nthreads) {
    const int row = i / kPieces, col = (i - row * kPieces) * 4;
    su_async::copy16(r + row * kTileLanes + col, src + row * ld + col);
  }
  su_async::commit();
  su_async::wait<0>();
  __syncthreads();
}

// serial: one thread per pixel, running sums over the 128 lanes; each
// pixel's operations in the first design's order.
__global__ void __launch_bounds__(kP, 2)
prefix_serial_sm90(const float* __restrict__ rec, size_t ld,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float r[];   // [3][kTileLanes]
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  stage_tile(rec, ld, tile, r, p, kP);
  const float sub = (float)p;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < kCpt; ++c) {
    const float* rc = r + c * kS;
    float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float L = 0.0f, A = 0.0f, M1 = 0.0f, M2 = 0.0f;
    for (int j = 0; j < kS; ++j) {
      const PairVals e =
          pair_vals(rc[j], rc[kTileLanes + j], rc[2 * kTileLanes + j], sub);
      add_pair(s, e, L, A, M1, M2);
      const float wu = e.w0 * e.u;
      L += e.logom;
      A += e.w0;
      M1 += wu;
      M2 += wu * e.u;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[k] += s[k];
  }
  store_out(out, tile, p, acc);
}

// warpscan: a warp per pixel, 4 lanes a thread, as the first design.
__global__ void __launch_bounds__(kP)
prefix_warpscan_sm90(const float* __restrict__ rec, size_t ld,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float r[];   // [3][kTileLanes]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  stage_tile(rec, ld, tile, r, threadIdx.x, kP);
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // of pixel warp*32+lane
  for (int c = 0; c < kCpt; ++c) {
    const float* rc = r + c * kS;
    for (int i = 0; i < 32; ++i) {
      const float sub = (float)(warp * 32 + i);
      float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float cL = 0.0f, cA = 0.0f, cM1 = 0.0f, cM2 = 0.0f;
#pragma unroll
      for (int q = 0; q < kS / 32; ++q) {
        const int j = q * 32 + lane;
        const PairVals e =
            pair_vals(rc[j], rc[kTileLanes + j], rc[2 * kTileLanes + j], sub);
        const float wu = e.w0 * e.u;
        const float L = warp_excl_scan(e.logom, cL, lane);
        const float A = warp_excl_scan(e.w0, cA, lane);
        const float M1 = warp_excl_scan(wu, cM1, lane);
        const float M2 = warp_excl_scan(wu * e.u, cM2, lane);
        add_pair(s, e, L, A, M1, M2);
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
        if (lane == i) acc[k] += s[k];
      }
    }
  }
  store_out(out, tile, warp * 32 + lane, acc);
}

// The thread's 8 (pixel, lane) positions of a 16 x 16 block, i = 4 r + e:
// pixel row g + 8 r, lane 2t + (e & 1) + 8 (e >> 1). Its D fragments hold
// them as d[e >> 1][2 r + (e & 1)] (n-tile e >> 1).

// The strictly lower triangle [k < n] as B fragments, built once: bf16
// m16n8k16, n-tile j (lanes 8j..8j+7): rows 2t, 2t+1 and 2t+8, 2t+9 of
// column g; tf32 m16n8k8 with k permuted (A column t is lane 8h + 2t,
// t + 4 lane 8h + 2t + 1): rows of half h, column g of n-tile j, for
// (h, j) = (0, 0), (0, 1), (1, 1).
struct Tri {
  uint32_t b[3][2];
};

template <int MODE>
__device__ __forceinline__ Tri make_tri(int g, int t) {
  Tri tri;
  if constexpr (MODE == kMma3xTf32) {
    const uint32_t one = 0x3f800000u;   // tf32 1.0
    const int hj[3][2] = {{0, 0}, {0, 1}, {1, 1}};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int n = 8 * hj[m][1] + g, k = 8 * hj[m][0] + 2 * t;
      tri.b[m][0] = k < n ? one : 0u;
      tri.b[m][1] = k + 1 < n ? one : 0u;
    }
  } else {
    const uint32_t one = 0x3f80u;       // bf16 1.0
    auto bit = [&](int k, int n) { return k < n ? one : 0u; };
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 8 * j + g;
      tri.b[j][0] = bit(2 * t, n) | bit(2 * t + 1, n) << 16;
      tri.b[j][1] = bit(2 * t + 8, n) | bit(2 * t + 9, n) << 16;
    }
    tri.b[2][0] = tri.b[2][1] = 0u;
  }
  return tri;
}

// The exclusive prefix over a 16-lane block of one quantity x (the
// thread's 8 positions), plus the carry of the earlier blocks (rows g, g +
// 8); into d, as above. The carry becomes carry + the block's total, D +
// X at lane 15, which the row's thread t = 3 holds. X is the operand as
// rounded: bf16 (bf16x2 for the quantity `split`), or tf32 hi + lo.
template <int MODE>
__device__ __forceinline__ void block_scan(const float (&x)[8], bool split,
                                           const Tri& tri, float (&carry)[2],
                                           float (&d)[2][4], int leader) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    d[j][0] = d[j][1] = carry[0];
    d[j][2] = d[j][3] = carry[1];
  }
  float last[2];   // the rounded operand at lane 2t + 9, rows g, g + 8
  if constexpr (MODE == kMma3xTf32) {
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hi[i] = to_tf32(x[i]);
      lo[i] = to_tf32(x[i] - __uint_as_float(hi[i]));
    }
    // half h's fragment: (row g, lane 2t), (g + 8, 2t), (g, 2t + 1),
    // (g + 8, 2t + 1) of the half, i.e. positions 2h, 4 + 2h, 2h + 1,
    // 5 + 2h
    auto frag = [](const uint32_t (&v)[8], int h, uint32_t (&a)[4]) {
      a[0] = v[2 * h];
      a[1] = v[4 + 2 * h];
      a[2] = v[2 * h + 1];
      a[3] = v[5 + 2 * h];
    };
    uint32_t a[4];
    frag(hi, 0, a);
    mma_tf32(d[0], a, tri.b[0][0], tri.b[0][1]);
    mma_tf32(d[1], a, tri.b[1][0], tri.b[1][1]);
    frag(lo, 0, a);
    mma_tf32(d[0], a, tri.b[0][0], tri.b[0][1]);
    mma_tf32(d[1], a, tri.b[1][0], tri.b[1][1]);
    frag(hi, 1, a);
    mma_tf32(d[1], a, tri.b[2][0], tri.b[2][1]);
    frag(lo, 1, a);
    mma_tf32(d[1], a, tri.b[2][0], tri.b[2][1]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      last[r] = __uint_as_float(hi[4 * r + 3]) + __uint_as_float(lo[4 * r + 3]);
  } else {
    // bf16 fragment: (g, 2t..2t+1), (g + 8, 2t..2t+1), (g, 2t+8..2t+9),
    // (g + 8, 2t+8..2t+9)
    uint32_t a[4] = {pack_bf16(x[0], x[1]), pack_bf16(x[4], x[5]),
                     pack_bf16(x[2], x[3]), pack_bf16(x[6], x[7])};
    mma_bf16(d[0], a, tri.b[0][0], tri.b[0][1]);
    mma_bf16(d[1], a, tri.b[1][0], tri.b[1][1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) last[r] = bf16_round(x[4 * r + 3]);
    if (MODE == kMmaBf16x2 && split) {
      float xl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xl[i] = x[i] - bf16_round(x[i]);
      const uint32_t al[4] = {pack_bf16(xl[0], xl[1]), pack_bf16(xl[4], xl[5]),
                              pack_bf16(xl[2], xl[3]), pack_bf16(xl[6], xl[7])};
      mma_bf16(d[0], al, tri.b[0][0], tri.b[0][1]);
      mma_bf16(d[1], al, tri.b[1][0], tri.b[1][1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) last[r] += bf16_round(xl[4 * r + 3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    carry[r] = __shfl_sync(0xffffffffu, d[1][2 * r + 1] + last[r], leader);
}

// D entry of position i = 4 r + e
__device__ __forceinline__ float at(const float (&d)[2][4], int i) {
  return d[(i & 3) >> 1][2 * (i >> 2) + (i & 1)];
}

template <int MODE>
__global__ void __launch_bounds__(kMmaWarps * 32)
prefix_mma_sm90(const float* __restrict__ rec, size_t ld,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float r[];   // [3][kTileLanes]
  const int tile = blockIdx.x;
  stage_tile(rec, ld, tile, r, threadIdx.x, kMmaWarps * 32);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int leader = lane | 3;   // the row's thread t = 3
  const Tri tri = make_tri<MODE>(g, t);

  for (int mt = warp; mt < kMTiles; mt += kMmaWarps) {
    const float sub[2] = {(float)(16 * mt + g), (float)(16 * mt + g + 8)};
    float s[2][5] = {};
    for (int c = 0; c < kCpt; ++c) {
      const float* rc = r + c * kS;
      float cL[2] = {}, cA[2] = {}, cM1[2] = {}, cM2[2] = {};
#pragma unroll 1
      for (int b = 0; b < kS / 16; ++b) {
        const int j0 = 16 * b + 2 * t;
        float r1[4], r2[4], r3[4];   // lanes j0, j0 + 1, j0 + 8, j0 + 9
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 a1 = *reinterpret_cast<const float2*>(rc + j0 + 8 * h);
          const float2 a2 = *reinterpret_cast<const float2*>(
              rc + kTileLanes + j0 + 8 * h);
          const float2 a3 = *reinterpret_cast<const float2*>(
              rc + 2 * kTileLanes + j0 + 8 * h);
          r1[2 * h] = a1.x;
          r1[2 * h + 1] = a1.y;
          r2[2 * h] = a2.x;
          r2[2 * h + 1] = a2.y;
          r3[2 * h] = a3.x;
          r3[2 * h + 1] = a3.y;
        }
        float w0[8], u[8], v[8], lg[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const PairVals e = pair_vals(r1[i & 3], r2[i & 3], r3[i & 3],
                                       sub[i >> 2]);
          w0[i] = e.w0;
          u[i] = e.u;
          v[i] = e.v;
          lg[i] = e.logom;
        }
        float d[2][4], w[8], z[8], x[8];
        // L: T = exp(L), w = w0 T; the sums of w, w v, w T
        block_scan<MODE>(lg, true, tri, cL, d, leader);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float T = expf(at(d, i));
          w[i] = w0[i] * T;
          float(&sr)[5] = s[i >> 2];
          sr[0] += w[i];
          sr[1] += w[i] * u[i];
          sr[3] += w[i] * v[i];
          sr[4] += w[i] * T;
        }
        // A, then M2, then M1: z = u^2 A + M2 - 2 u M1
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = w0[i];
        block_scan<MODE>(x, false, tri, cA, d, leader);
#pragma unroll
        for (int i = 0; i < 8; ++i) z[i] = u[i] * u[i] * at(d, i);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = w0[i] * u[i] * u[i];
        block_scan<MODE>(x, false, tri, cM2, d, leader);
#pragma unroll
        for (int i = 0; i < 8; ++i) z[i] = z[i] + at(d, i);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = w0[i] * u[i];
        block_scan<MODE>(x, false, tri, cM1, d, leader);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          z[i] = z[i] - 2.0f * u[i] * at(d, i);
          s[i >> 2][2] += w[i] * z[i];
        }
      }
    }
    // the row's four threads hold its partial sums: fold them, then
    // thread t stores channels 4t..4t+3 of rows g and g + 8
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        s[rr][k] += __shfl_xor_sync(0xffffffffu, s[rr][k], 1);
        s[rr][k] += __shfl_xor_sync(0xffffffffu, s[rr][k], 2);
      }
      const float4 o = t == 0 ? make_float4(s[rr][0], s[rr][1], s[rr][2],
                                            s[rr][3])
                              : make_float4(s[rr][4], s[rr][4], s[rr][4],
                                            s[rr][4]);
      const int pix = 16 * mt + g + 8 * rr;
      *reinterpret_cast<float4*>(out + ((size_t)tile * kP + pix) * kOut +
                                 4 * t) = o;
    }
  }
}

template <class K>
cudaError_t launch_staged(K kernel, int threads, int n_tiles,
                          const float* rec, size_t ld, float* out,
                          cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kStageBytes);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, kStageBytes, s>>>(rec, ld, out);
  return cudaGetLastError();
}

}  // namespace

// The redesign: rec 16-byte aligned with ld % 4 == 0 (the caller checks).
inline cudaError_t run(int mode, const float* rec, size_t ld, int n_tiles,
                       float* out, cudaStream_t s) {
  switch (mode) {
    case kSerial:
      return launch_staged(prefix_serial_sm90, kP, n_tiles, rec, ld, out, s);
    case kWarpScan:
      return launch_staged(prefix_warpscan_sm90, kP, n_tiles, rec, ld, out,
                           s);
    case kMmaBf16:
      return launch_staged(prefix_mma_sm90<kMmaBf16>, kMmaWarps * 32,
                           n_tiles, rec, ld, out, s);
    case kMmaBf16x2:
      return launch_staged(prefix_mma_sm90<kMmaBf16x2>, kMmaWarps * 32,
                           n_tiles, rec, ld, out, s);
    default:
      return launch_staged(prefix_mma_sm90<kMma3xTf32>, kMmaWarps * 32,
                           n_tiles, rec, ld, out, s);
  }
}

}  // namespace su_prefix90
