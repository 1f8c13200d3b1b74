// T9 — the three-pass split-precision contraction of tools/probe_mmt3.py
// on an H100.
//
// Replaces the Pallas kernel `kern` of tools/probe_mmt3.py (:30, launched
// at :56), which asked whether the blend's f32-faithful MXU contraction
// `_mmT3` (streetunveiler_tpu/ops/rasterizer/kernel.py:155-168) computes
// what a lane reduction does. The same function: w [512, 128] f32, b
// [8, 128] f32 with row 7 zero, and four outputs [512, 7] f32:
//   t  the truth, t[p, k] = sum_s w[p, s] b[k, s], an f32 dot per thread
//      (serial over s, no multiply-add contraction);
//   a  _mmT3(w, b[:7]);  b_ _mmT3(w, b)[:, :7];  c the same on b^T [128, 8]
//      in the standard form. Each is hi.hi + (hi.lo + lo.hi): hi = the top
//      16 bits of the f32 (a mask, exactly bf16), lo = x - hi rounded to
//      bf16 to nearest even (what a DEFAULT pass does to its operand), each
//      product on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//      accumulation) over the 128-deep contraction; the lo.lo term is
//      dropped (<= 2^-14 relative).
// The three ways differ only in where b comes from, as the TPU's did:
//   a  the 7 rows of b; the fragment's 8th column is a zero in registers;
//   b_ all 8 rows of b from memory, row 7 the zero padding;
//   c  b transposed in shared memory to [128, 8] and loaded from there in
//      the col-major fragment layout (k rows of 8, stride 8).
// They compute the same products in the same order, so they agree to the
// bit.
//
// What bounds it on an H100: 266 KB read and 57 KB written (0.1 us at
// 3.35 TB/s); the operations (9.4 M bf16 on the tensor cores, 0.9 M f32
// for the truth) take less. A launch costs more than either.
//
// Design: 32 blocks of one warp, so that 32 SMs share the loads; block i
// owns rows 16 i .. 16 i + 15. It stages its rows of w in shared memory
// (coalesced 16-byte loads; rows padded to 129 floats so that the 16 rows
// fall in 16 banks) and b transposed, then runs the 3 ways x 3 passes x 8
// k-steps of mma and the truth of its 16 rows (lanes 0-15 columns 0, 2,
// 4, 6 and lanes 16-31 columns 1, 3, 5). A first version ran one block of
// 32 warps reading w from global memory row-strided: its 16 lanes of a
// load touched 16 cache lines, and the one SM took 0.20 ms.
//
// This file keeps that first design (`su_mmt3_first`); the entry `su_mmt3`
// runs its redesign for the H100 (mmt3_sm90.cuh), bit for bit the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mmt3_sm90.cuh"

namespace {

constexpr int kP = 512;
constexpr int kS = 128;
constexpr int kQ = 7;
constexpr int kN = 8;
constexpr int kRows = 16;        // rows of w per block (one warp)
constexpr int kLd = kS + 1;      // padded shared row

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

// The four B values of this lane (k = 2t, 2t+1, 2t+8, 2t+9 at column g)
// → hi and lo fragment registers.
__device__ __forceinline__ void split_b(const float (&x)[4], uint32_t (&h)[2],
                                        uint32_t (&l)[2]) {
  float hv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) hv[i] = hi8(x[i]);
  h[0] = pack_bf16(hv[0], hv[1]);
  h[1] = pack_bf16(hv[2], hv[3]);
  l[0] = pack_bf16(x[0] - hv[0], x[1] - hv[1]);
  l[1] = pack_bf16(x[2] - hv[2], x[3] - hv[3]);
}

__device__ __forceinline__ void store(float* out, int row0, int g, int t,
                                      const float (&hh)[4],
                                      const float (&hl)[4],
                                      const float (&lh)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + g + (r >= 2 ? 8 : 0);
    const int col = 2 * t + (r & 1);
    if (col < kQ) out[row * kQ + col] = hh[r] + (hl[r] + lh[r]);
  }
}

__global__ void __launch_bounds__(32)
mmt3_kernel(const float* __restrict__ w, const float* __restrict__ b,
            float* __restrict__ oa, float* __restrict__ ob,
            float* __restrict__ oc, float* __restrict__ ot) {
  __shared__ float ws[kRows * kLd];  // this block's rows of w
  __shared__ float bt[kS * kN];      // b transposed: bt[k][n] = b[n][k]
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const float4* w4 = reinterpret_cast<const float4*>(w + row0 * kS);
  for (int i = lane; i < kRows * kS / 4; i += 32) {
    const float4 x = w4[i];
    float* d = ws + (i / (kS / 4)) * kLd + (i % (kS / 4)) * 4;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
  for (int i = lane; i < kN * kS; i += 32) bt[(i % kS) * kN + i / kS] = b[i];
  __syncwarp();
  const int g = lane >> 2;
  const int t = lane & 3;

  float d[3][3][4];   // [way][pass: hi.hi, hi.lo, lo.hi][fragment]
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[i][j][r] = 0.0f;

  const float* ra = ws + g * kLd;
  const float* rb = ws + (g + 8) * kLd;
#pragma unroll 1
  for (int kk = 0; kk < kS / 16; ++kk) {
    const int k0 = kk * 16 + 2 * t;
    // A: rows g and g + 8, k = k0, k0 + 1, k0 + 8, k0 + 9
    const float av[8] = {ra[k0], ra[k0 + 1], rb[k0], rb[k0 + 1],
                         ra[k0 + 8], ra[k0 + 9], rb[k0 + 8], rb[k0 + 9]};
    float ah[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ah[i] = hi8(av[i]);
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a_hi[i] = pack_bf16(ah[2 * i], ah[2 * i + 1]);
      a_lo[i] = pack_bf16(av[2 * i] - ah[2 * i], av[2 * i + 1] - ah[2 * i + 1]);
    }
    // B of each way at column g
    const int ks[4] = {k0, k0 + 1, k0 + 8, k0 + 9};
    float bv[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bv[0][i] = g < kQ ? b[g * kS + ks[i]] : 0.0f;   // a: 7 rows
      bv[1][i] = b[g * kS + ks[i]];                   // b_: 8 rows
      bv[2][i] = bt[ks[i] * kN + g];                  // c: b^T
    }
#pragma unroll
    for (int way = 0; way < 3; ++way) {
      uint32_t b_hi[2], b_lo[2];
      split_b(bv[way], b_hi, b_lo);
      mma_bf16(d[way][0], a_hi, b_hi[0], b_hi[1]);
      mma_bf16(d[way][1], a_hi, b_lo[0], b_lo[1]);
      mma_bf16(d[way][2], a_lo, b_hi[0], b_hi[1]);
    }
  }
  store(oa, row0, g, t, d[0][0], d[0][1], d[0][2]);
  store(ob, row0, g, t, d[1][0], d[1][1], d[1][2]);
  store(oc, row0, g, t, d[2][0], d[2][1], d[2][2]);

  // the truth: lanes 0-15 take row row0 + lane at columns 0, 2, 4, 6,
  // lanes 16-31 row row0 + lane - 16 at columns 1, 3, 5
  const float* wr = ws + (lane & 15) * kLd;
  for (int k = lane >> 4; k < kQ; k += 2) {
    float s = 0.0f;
    for (int j = 0; j < kS; ++j) s = s + wr[j] * bt[j * kN + k];
    ot[(row0 + (lane & 15)) * kQ + k] = s;
  }
}

}  // namespace

// w [512, 128] and b [8, 128] f32 (row 7 zero); oa, ob, oc, ot [512, 7]
// f32. Returns cudaGetLastError(). The first design.
extern "C" int su_mmt3_first(const float* w, const float* b, float* oa,
                             float* ob, float* oc, float* ot, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  mmt3_kernel<<<kP / kRows, 32, 0, (cudaStream_t)stream>>>(w, b, oa, ob, oc,
                                                        ot);
  return (int)cudaGetLastError();
}

// The same function and arguments, by the redesign (mmt3_sm90.cuh).
extern "C" int su_mmt3(const float* w, const float* b, float* oa, float* ob,
                       float* oc, float* ot, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)su_mmt3_sm90::run(w, b, oa, ob, oc, ot, (cudaStream_t)stream);
}
