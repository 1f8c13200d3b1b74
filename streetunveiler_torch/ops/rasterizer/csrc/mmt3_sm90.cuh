// T9 redesigned for the H100: the split-precision contraction of
// tools/probe_mmt3.py, bit for bit with its first design (mmt3.cu,
// `su_mmt3_first`).
//
// The same function: w [512, 128] f32, b [8, 128] f32 (row 7 zero), four
// outputs [512, 7]: the three ways a, b_, c of hi.hi + (hi.lo + lo.hi) on
// mma.sync m16n8k16 (bf16 operands, f32 accumulation) and the truth t, a
// serial f32 dot per output.
//
// What bounds it on an H100: 266 KB read and 57 KB written (0.1 us at
// 3.35 TB/s); a launch costs more. The first design was latency-bound
// inside its launch: 32 blocks of one warp, whose k-loop reloaded B from
// device memory on each of its 8 steps, ran the 9 accumulator chains and
// then up to 4 serial 128-step truth sums a lane in that one warp.
//
// Design: 32 blocks of 7 warps, block i owning rows 16 i .. 16 i + 15.
// - Staging: the block's 16 rows of w and all of b in shared memory, both
//   orientations of b (rows [8][136], transposed [128][12]), by coalesced
//   16-byte loads of all 224 threads, then one barrier.
// - Warps 0, 1, 2 each run one way: its three pass chains (hi.hi, hi.lo,
//   lo.hi) over the 8 k-steps in order, 24 mma, the loop unrolled and
//   every fragment read from shared memory (w and b rows 136 floats apart:
//   a half warp's 8-byte reads hit 32 distinct banks; the transpose 12
//   apart: its 32 scalar reads hit 32 banks).
// - Warps 3-6 take the truth's 16 x 7 = 112 serial sums, one a thread,
//   each over s = 0..127 in order, unfused, beside the ways: the block's
//   longest chain is one 128-step sum. (The truth on the ways' own lanes,
//   after their mma, was measured 0.2-0.3 us slower on an H100.)
// Each accumulator takes the first design's products in the first
// design's order, so all four outputs equal it bit for bit, and the three
// ways equal each other.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace su_mmt3_sm90 {

constexpr int kP = 512;
constexpr int kS = 128;
constexpr int kQ = 7;
constexpr int kN = 8;
constexpr int kRows = 16;          // rows of w a block
constexpr int kWays = 3;           // warps 0-2: a way each
constexpr int kThreads = 224;      // and warps 3-6: the truth
constexpr int kLd = kS + 8;        // w and b rows in shared memory
constexpr int kLdT = 12;           // b transposed: bt[k][n], n < 8

__device__ __forceinline__ float hi8(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// bf16 pair (lo in the low half); exact for hi parts, nearest even for lo
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D += A B, m16n8k16, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One way's three pass chains for rows row0 .. row0 + 15 of `out`: way 0
// reads b's 7 rows with the 8th fragment column zero in registers, way 1
// all 8 rows, way 2 the transpose.
__device__ __forceinline__ void way_chains(int way, int lane, int row0,
                                           const float* ws, const float* bs,
                                           const float* bt, float* out) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float d[3][4];   // [pass: hi.hi, hi.lo, lo.hi][fragment]
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[j][r] = 0.0f;
  const float* ra = ws + g * kLd + 2 * t;
  const float* rb = ra + 8 * kLd;
  const float* br = bs + g * kLd + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kS / 16; ++kk) {
    const int c = kk * 16;
    // A: rows g and g + 8, k = k0, k0 + 1, k0 + 8, k0 + 9
    const float2 p0 = *reinterpret_cast<const float2*>(ra + c);
    const float2 p1 = *reinterpret_cast<const float2*>(rb + c);
    const float2 p2 = *reinterpret_cast<const float2*>(ra + c + 8);
    const float2 p3 = *reinterpret_cast<const float2*>(rb + c + 8);
    const float av[8] = {p0.x, p0.y, p1.x, p1.y, p2.x, p2.y, p3.x, p3.y};
    float ah[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ah[i] = hi8(av[i]);
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a_hi[i] = pack_bf16(ah[2 * i], ah[2 * i + 1]);
      a_lo[i] = pack_bf16(av[2 * i] - ah[2 * i], av[2 * i + 1] - ah[2 * i + 1]);
    }
    // B at column g, k = k0, k0 + 1, k0 + 8, k0 + 9
    float bv[4];
    if (way == 2) {
      const int k0 = c + 2 * t;
      bv[0] = bt[k0 * kLdT + g];
      bv[1] = bt[(k0 + 1) * kLdT + g];
      bv[2] = bt[(k0 + 8) * kLdT + g];
      bv[3] = bt[(k0 + 9) * kLdT + g];
    } else {
      const float2 q0 = *reinterpret_cast<const float2*>(br + c);
      const float2 q1 = *reinterpret_cast<const float2*>(br + c + 8);
      const bool zero = way == 0 && g == kQ;
      bv[0] = zero ? 0.0f : q0.x;
      bv[1] = zero ? 0.0f : q0.y;
      bv[2] = zero ? 0.0f : q1.x;
      bv[3] = zero ? 0.0f : q1.y;
    }
    float bh[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) bh[i] = hi8(bv[i]);
    const uint32_t b_hi0 = pack_bf16(bh[0], bh[1]);
    const uint32_t b_hi1 = pack_bf16(bh[2], bh[3]);
    const uint32_t b_lo0 = pack_bf16(bv[0] - bh[0], bv[1] - bh[1]);
    const uint32_t b_lo1 = pack_bf16(bv[2] - bh[2], bv[3] - bh[3]);
    mma_bf16(d[0], a_hi, b_hi0, b_hi1);
    mma_bf16(d[1], a_hi, b_lo0, b_lo1);
    mma_bf16(d[2], a_lo, b_hi0, b_hi1);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + g + (r >= 2 ? 8 : 0);
    const int col = 2 * t + (r & 1);
    if (col < kQ) out[row * kQ + col] = d[0][r] + (d[1][r] + d[2][r]);
  }
}

__global__ void __launch_bounds__(kThreads)
mmt3_sm90_kernel(const float* __restrict__ w, const float* __restrict__ b,
                 float* __restrict__ oa, float* __restrict__ ob,
                 float* __restrict__ oc, float* __restrict__ ot) {
  __shared__ __align__(16) float ws[kRows * kLd];   // the block's rows of w
  __shared__ __align__(16) float bs[kN * kLd];      // b
  __shared__ float bt[kS * kLdT];                   // bt[k][n] = b[n][k]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const float4* w4 = reinterpret_cast<const float4*>(w + row0 * kS);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  constexpr int kW4 = kRows * kS / 4, kB4 = kN * kS / 4;
  constexpr int kPer = (kW4 + kB4 + kThreads - 1) / kThreads;
  float4 xv[kPer];   // all loads first, then the shared stores
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = tid + n * kThreads;
    if (i < kW4)
      xv[n] = w4[i];
    else if (i < kW4 + kB4)
      xv[n] = b4[i - kW4];
  }
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = tid + n * kThreads;
    if (i < kW4) {
      *reinterpret_cast<float4*>(ws + (i >> 5) * kLd + (i & 31) * 4) = xv[n];
    } else if (i < kW4 + kB4) {
      const int r = (i - kW4) >> 5, c = ((i - kW4) & 31) * 4;
      *reinterpret_cast<float4*>(bs + r * kLd + c) = xv[n];
      bt[c * kLdT + r] = xv[n].x;
      bt[(c + 1) * kLdT + r] = xv[n].y;
      bt[(c + 2) * kLdT + r] = xv[n].z;
      bt[(c + 3) * kLdT + r] = xv[n].w;
    }
  }
  __syncthreads();
  const int warp = tid >> 5;
  if (warp < kWays) {
    way_chains(warp, tid & 31, row0, ws, bs, bt,
               warp == 0 ? oa : warp == 1 ? ob : oc);
    return;
  }
  // the truth: thread j = tid - 96 < 112 takes row row0 + j % 16, column
  // j / 16
  const int j = tid - kWays * 32;
  if (j < kRows * kQ) {
    const int r = j % kRows, k = j / kRows;
    const float4* wr = reinterpret_cast<const float4*>(ws + r * kLd);
    const float4* br = reinterpret_cast<const float4*>(bs + k * kLd);
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kS / 4; ++q) {
      const float4 x = wr[q], y = br[q];
      s = s + x.x * y.x;
      s = s + x.y * y.y;
      s = s + x.z * y.z;
      s = s + x.w * y.w;
    }
    ot[(row0 + r) * kQ + k] = s;
  }
}

inline cudaError_t run(const float* w, const float* b, float* oa, float* ob,
                       float* oc, float* ot, cudaStream_t s) {
  mmt3_sm90_kernel<<<kP / kRows, kThreads, 0, s>>>(w, b, oa, ob, oc, ot);
  return cudaGetLastError();
}

}  // namespace su_mmt3_sm90
