// T3 — the lane-reduction probe of tools/micro_reduce.py on an H100.
//
// Replaces the Pallas kernel of tools/micro_reduce.py (`build` :37,
// launched at :70), which timed the ways a [512, 128] block's k weighted
// row sums can be taken inside a visit kernel. The same function: x is
// [512, nv * 128] f32 (row-major), and per 128-column block v
//   out[p, i] += sum_s x[p, 128 v + s] * (1 + 0.01 i)   for i < k,
// the other columns zero; mode `pair` instead runs a 25-step chain
// y = 1.0001 y + 0.001 on every element and takes one sum into column 0.
//
// Modes (the TPU tool's in brackets):
//   pair    (pair) the chain, then the row sum, a warp per row.
//   thread  (vpu)  one thread per row sums its 128 columns serially, as
//                  K1 sums its payload.
//   warp    (vpu)  a warp per row: a float4 per lane, then k shuffle sums
//                  per block, as K2 sums its 14 + nq values.
//   mma     (mxu, Precision.DEFAULT) the k sums as one tensor-core product
//                  x[16 rows, 128] x W[128, 8 or 16] per block, mma.sync
//                  m16n8k16 with bf16 operands (x and W rounded to bf16,
//                  one pass) and f32 accumulation.
//
// What bounds it on an H100: bytes. x is 1.07 GB at nv = 4096, read once
// (0.32 ms at 3.35 TB/s); the most operations, the pair chain's 50 per
// element, take 0.20 ms at 67 TFLOP/s f32.
//
// Design: the blocks v are split over `nsplit` slices so that the card is
// full (the TPU walked them in one sequential grid); each slice writes
// partial sums [nsplit, 512, 16] and a second kernel adds them in a fixed
// order into out, so the result does not vary from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 512;        // rows
constexpr int kS = 128;        // columns per block
constexpr int kPartW = 16;     // partial-sum columns kept (k <= 13)

enum ReduceMode { kPair = 0, kThread, kWarp, kMma, kNumReduceModes };

// The TPU tool's weights 1.0 + 0.01 i: a double rounded to f32, as JAX
// rounds the Python scalar.
__device__ __forceinline__ float weight(int i) {
  return (float)(1.0 + 0.01 * (double)i);
}

template <int K>
__global__ void __launch_bounds__(kP)
reduce_thread(const float* __restrict__ x, int nv, int vps,
              float* __restrict__ partial) {
  const int p = threadIdx.x;
  const int split = blockIdx.x;
  float c[K], acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    c[i] = weight(i);
    acc[i] = 0.0f;
  }
  const float* row = x + (size_t)p * nv * kS;
  for (int v = split * vps; v < (split + 1) * vps; ++v) {
    const float4* b = reinterpret_cast<const float4*>(row + (size_t)v * kS);
    float bs[K];
#pragma unroll
    for (int i = 0; i < K; ++i) bs[i] = 0.0f;
    for (int q = 0; q < kS / 4; ++q) {
      const float4 f = b[q];
#pragma unroll
      for (int i = 0; i < K; ++i)
        bs[i] += f.x * c[i] + f.y * c[i] + f.z * c[i] + f.w * c[i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] += bs[i];
  }
  float* o = partial + ((size_t)split * kP + p) * kPartW;
#pragma unroll
  for (int i = 0; i < kPartW; ++i) o[i] = i < K ? acc[i] : 0.0f;
}

// K = 0: the pair chain and one sum; else K weighted sums.
template <int K>
__global__ void __launch_bounds__(kP)
reduce_warp(const float* __restrict__ x, int nv, int vps,
            float* __restrict__ partial) {
  constexpr int KA = K > 0 ? K : 1;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.y * (kP / 32) + (threadIdx.x >> 5);
  const int split = blockIdx.x;
  float c[KA], acc[KA];
#pragma unroll
  for (int i = 0; i < KA; ++i) {
    c[i] = weight(i);
    acc[i] = 0.0f;
  }
  const float* row = x + (size_t)p * nv * kS;
  for (int v = split * vps; v < (split + 1) * vps; ++v) {
    const float4 f =
        reinterpret_cast<const float4*>(row + (size_t)v * kS)[lane];
    float bs[KA];
    if (K == 0) {
      float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int step = 0; step < 25; ++step) e[r] = e[r] * 1.0001f + 0.001f;
      bs[0] = e[0] + e[1] + e[2] + e[3];
    } else {
#pragma unroll
      for (int i = 0; i < KA; ++i)
        bs[i] = f.x * c[i] + f.y * c[i] + f.z * c[i] + f.w * c[i];
    }
#pragma unroll
    for (int i = 0; i < KA; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        bs[i] += __shfl_xor_sync(0xffffffffu, bs[i], o);
      acc[i] += bs[i];
    }
  }
  if (lane == 0) {
    float* o = partial + ((size_t)split * kP + p) * kPartW;
#pragma unroll
    for (int i = 0; i < kPartW; ++i) o[i] = i < K ? acc[i] : 0.0f;
    if (K == 0) o[0] = acc[0];
  }
}

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

// A warp per 16 rows; NT n-tiles of 8 weight columns (K <= 8 NT).
template <int K>
__global__ void __launch_bounds__(128)
reduce_mma(const float* __restrict__ x, int nv, int vps,
           float* __restrict__ partial) {
  constexpr int NT = (K + 7) / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;       // group: A/C row, B column
  const int t = lane & 3;        // thread in group
  const int row0 = (blockIdx.y * 4 + (threadIdx.x >> 5)) * 16;
  const int split = blockIdx.x;
  // W[s, n] = weight(n) for n < K, independent of s: each B register holds
  // the same weight twice
  uint32_t bw[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + g;
    const float w = n < K ? weight(n) : 0.0f;
    bw[nt] = pack_bf16(w, w);
  }
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[nt][r] = 0.0f;
  const float* ra = x + (size_t)(row0 + g) * nv * kS;
  const float* rb = x + (size_t)(row0 + g + 8) * nv * kS;
  for (int v = split * vps; v < (split + 1) * vps; ++v) {
#pragma unroll 2
    for (int kk = 0; kk < kS / 16; ++kk) {
      const size_t c0 = (size_t)v * kS + kk * 16 + 2 * t;
      const float2 x00 = *reinterpret_cast<const float2*>(ra + c0);
      const float2 x10 = *reinterpret_cast<const float2*>(rb + c0);
      const float2 x01 = *reinterpret_cast<const float2*>(ra + c0 + 8);
      const float2 x11 = *reinterpret_cast<const float2*>(rb + c0 + 8);
      const uint32_t a[4] = {pack_bf16(x00.x, x00.y), pack_bf16(x10.x, x10.y),
                             pack_bf16(x01.x, x01.y),
                             pack_bf16(x11.x, x11.y)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(d[nt], a, bw[nt], bw[nt]);
    }
  }
  float* oa = partial + ((size_t)split * kP + row0 + g) * kPartW;
  float* ob = partial + ((size_t)split * kP + row0 + g + 8) * kPartW;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    oa[nt * 8 + 2 * t] = d[nt][0];
    oa[nt * 8 + 2 * t + 1] = d[nt][1];
    ob[nt * 8 + 2 * t] = d[nt][2];
    ob[nt * 8 + 2 * t + 1] = d[nt][3];
  }
  if (NT == 1) {   // columns 8..15 of the partial
    oa[8 + 2 * t] = oa[9 + 2 * t] = ob[8 + 2 * t] = ob[9 + 2 * t] = 0.0f;
  }
}

// out[p, i] = sum over the slices of partial[., p, i] in slice order
// (i < 16), zero for i >= 16.
__global__ void __launch_bounds__(kS)
reduce_partials(const float* __restrict__ partial, int nsplit,
                float* __restrict__ out) {
  const int p = blockIdx.x;
  const int i = threadIdx.x;
  float s = 0.0f;
  if (i < kPartW)
    for (int sp = 0; sp < nsplit; ++sp)
      s += partial[((size_t)sp * kP + p) * kPartW + i];
  out[(size_t)p * kS + i] = s;
}

template <int K>
cudaError_t launch_mode(int mode, const float* x, int nv, int nsplit,
                        float* partial, cudaStream_t s) {
  const int vps = nv / nsplit;
  if (mode == kThread) {
    reduce_thread<K><<<nsplit, kP, 0, s>>>(x, nv, vps, partial);
  } else if (mode == kWarp) {
    reduce_warp<K><<<dim3(nsplit, kP / (kP / 32)), kP, 0, s>>>(x, nv, vps,
                                                               partial);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_mma(const float* x, int nv, int nsplit, float* partial,
                       cudaStream_t s) {
  reduce_mma<K><<<dim3(nsplit, kP / 64), 128, 0, s>>>(x, nv, nv / nsplit,
                                                      partial);
  return cudaGetLastError();
}

}  // namespace

// x [512, nv * 128] f32; partial [nsplit, 512, 16] f32 scratch; out
// [512, 128] f32. mode: 0 pair (k = 0), 1 thread and 2 warp (k 4, 8, 13),
// 3 mma (k 8, 13); nv must be a multiple of nsplit. Returns
// cudaGetLastError().
extern "C" int su_micro_reduce(int mode, int k, const float* x, int nv,
                               int nsplit, float* partial, float* out,
                               int device, void* stream) {
  if (nv < 1 || nsplit < 1 || nv % nsplit != 0 || mode < 0 ||
      mode >= kNumReduceModes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kPair) {
    if (k != 0) return (int)cudaErrorInvalidValue;
    reduce_warp<0><<<dim3(nsplit, kP / (kP / 32)), kP, 0, s>>>(
        x, nv, nv / nsplit, partial);
    err = cudaGetLastError();
  } else if (mode == kMma) {
    err = k == 8    ? launch_mma<8>(x, nv, nsplit, partial, s)
          : k == 13 ? launch_mma<13>(x, nv, nsplit, partial, s)
                    : cudaErrorInvalidValue;
  } else {
    err = k == 4    ? launch_mode<4>(mode, x, nv, nsplit, partial, s)
          : k == 8  ? launch_mode<8>(mode, x, nv, nsplit, partial, s)
          : k == 13 ? launch_mode<13>(mode, x, nv, nsplit, partial, s)
                    : cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<kP, kS, 0, s>>>(partial, nsplit, out);
  return (int)cudaGetLastError();
}
