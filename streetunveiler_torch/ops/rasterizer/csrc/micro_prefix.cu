// T4 — the per-chunk prefix-sum probe of tools/micro_prefix.py on an H100.
//
// Replaces the Pallas kernel of tools/micro_prefix.py (the closure `kern`
// :43-102 inside `main`, launched at :105), which timed the ways the
// blend's transmittance and its running moments can be taken as lane
// prefix sums. The same function (micro_prefix.py:50-102): rec is
// [24, n_chunks * 128] f32 lane-major (rows 0-2 are read); chunk c adds
// into tile c / 66 of out [n_chunks / 66, 512, 16], which starts at zero. For pixel `sub` = 0..511 and lane s of chunk c, with r1, r2, r3 the
// record's rows at slot 128 c + s:
//   a = r1 - sub r3, b = r2 - sub r3, kx = a b - r3, ky = b r1 - a,
//   kz = a r2 - b r1 (|kz| < 1e-12 -> 1e-12), u = kx / kz, v = ky / kz,
//   alpha = min(0.99, exp(-(u^2 + v^2) / 2)), w0 = alpha > 1e-3 ? alpha : 0,
//   and the exclusive lane prefix sums L, A, M1, M2 of log1p(-w0), w0,
//   w0 u, w0 u^2; then with T = exp(L) and w = w0 T the chunk adds
//   (sum w, sum w u, sum w (u^2 A + M2 - 2 u M1), sum w v, then sum w T
//   twelve times) to the pixel's 16 channels.
//
// Modes (the TPU tool's in brackets):
//   serial      one thread per pixel, running sums over the 128 lanes, as
//               K1 composites its batch.
//   warpscan    (roll) a warp per pixel, 4 lanes a thread: Hillis-Steele
//               scans with __shfl_up_sync on each 32-lane segment, carried.
//   mma_bf16    (default) the four prefix sums as the exclusive triangular
//               product on tensor cores, mma.sync m16n8k16, operands
//               rounded to bf16, one pass, f32 accumulation.
//   mma_bf16x2  (split2) as mma_bf16, with log1p(-w0) split into bf16
//               hi + lo and two passes (the other three in one).
//   mma_3xtf32  (highest) mma.sync m16n8k8 tf32, each operand split into
//               tf32 hi + lo; the 0/1 triangle is exact in tf32, so of the
//               three products of 3xTF32 the third (A_lo B_hi) is zero and
//               two passes are made.
//
// What bounds it on an H100: operations. ~1.1e9 (pixel, lane) pairs at
// n_chunks = 16896, each ~40 f32 operations with an exp, a divide and a
// log1p (0.66 ms at 67 TFLOP/s), against 26 MB of rows read (0.008 ms).
//
// Design: one block per tile walks its chunks, staging the three rows of
// each chunk in shared memory. The tensor-core modes take the product with
// the roles of the TPU's swapped, D[lane i, pixel n] = sum_j [j < i]
// X[n, j]: the triangle is the A operand, built from indices, and the
// pair values of an 8-pixel group (kept in shared memory) are B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 512;        // pixels per tile
constexpr int kS = 128;        // lanes per chunk
constexpr int kOut = 16;       // output channels
constexpr int kCpt = 66;       // chunks per tile, the TPU tool's constant
constexpr int kMmaWarps = 8;   // warps per block of the tensor-core modes
constexpr int kGroupW = 8;     // pixels per tensor-core n-tile
constexpr int kLd = kS + 4;    // padded row of the shared pair values

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

__device__ __forceinline__ void stage_rows(const float* rec, size_t ld,
                                           int chunk, float* r, int tid,
                                           int nthreads) {
  for (int i = tid; i < 3 * kS; i += nthreads)
    r[i] = rec[(size_t)(i / kS) * ld + (size_t)chunk * kS + i % kS];
}

__global__ void __launch_bounds__(kP)
prefix_serial(const float* __restrict__ rec, size_t ld,
              float* __restrict__ out) {
  __shared__ float r[3 * kS];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float sub = (float)p;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = tile * kCpt; c < (tile + 1) * kCpt; ++c) {
    __syncthreads();
    stage_rows(rec, ld, c, r, p, kP);
    __syncthreads();
    float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float L = 0.0f, A = 0.0f, M1 = 0.0f, M2 = 0.0f;
    for (int j = 0; j < kS; ++j) {
      const PairVals e = pair_vals(r[j], r[kS + j], r[2 * kS + j], sub);
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

__global__ void __launch_bounds__(kP)
prefix_warpscan(const float* __restrict__ rec, size_t ld,
                float* __restrict__ out) {
  __shared__ float r[3 * kS];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // of pixel warp*32+lane
  for (int c = tile * kCpt; c < (tile + 1) * kCpt; ++c) {
    __syncthreads();
    stage_rows(rec, ld, c, r, threadIdx.x, kP);
    __syncthreads();
    for (int i = 0; i < 32; ++i) {
      const float sub = (float)(warp * 32 + i);
      float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float cL = 0.0f, cA = 0.0f, cM1 = 0.0f, cM2 = 0.0f;
#pragma unroll
      for (int q = 0; q < kS / 32; ++q) {
        const int j = q * 32 + lane;
        const PairVals e = pair_vals(r[j], r[kS + j], r[2 * kS + j], sub);
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

// Shared pair values of one warp's 8-pixel group: [4][kGroupW][kLd] for
// log1p(-w0), w0, u, v.
constexpr int kQLogom = 0, kQW0 = 1, kQU = 2, kQV = 3;

// B value of prefix quantity q (log1p(-w0), w0, w0 u, w0 u^2) at (pixel n
// of the group, lane j).
__device__ __forceinline__ float quantity(const float* pv, int q, int n,
                                          int j) {
  const float w0 = pv[(kQW0 * kGroupW + n) * kLd + j];
  const float u = pv[(kQU * kGroupW + n) * kLd + j];
  if (q == 0) return pv[(kQLogom * kGroupW + n) * kLd + j];
  if (q == 1) return w0;
  const float wu = w0 * u;
  return q == 2 ? wu : wu * u;
}

// D_q[lane 16 mm + row, pixel col] for the four quantities: the exclusive
// prefix over the chunk's lanes as A (the triangle [j < i]) times B.
template <int MODE>
__device__ __forceinline__ void prefix_tile(const float* pv, int mm, int g,
                                            int t, float (&d)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[q][r] = 0.0f;
  const int i0 = 16 * mm + g, i1 = i0 + 8;   // the thread's A/D rows
  if (MODE == kMma3xTf32) {
    for (int kk = 0; kk <= 2 * mm + 1; ++kk) {     // k-tiles of 8 lanes
      const int j0 = 8 * kk + t, j1 = j0 + 4;
      const uint32_t one = to_tf32(1.0f);
      const uint32_t a[4] = {j0 < i0 ? one : 0u, j0 < i1 ? one : 0u,
                             j1 < i0 ? one : 0u, j1 < i1 ? one : 0u};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x0 = quantity(pv, q, g, j0);
        const float x1 = quantity(pv, q, g, j1);
        const uint32_t h0 = to_tf32(x0), h1 = to_tf32(x1);
        const uint32_t l0 = to_tf32(x0 - __uint_as_float(h0));
        const uint32_t l1 = to_tf32(x1 - __uint_as_float(h1));
        mma_tf32(d[q], a, h0, h1);
        mma_tf32(d[q], a, l0, l1);
      }
    }
  } else {
    for (int kk = 0; kk <= mm; ++kk) {             // k-tiles of 16 lanes
      const int j0 = 16 * kk + 2 * t;              // B rows j0, j0+1, +8, +9
      const uint32_t one = 0x3f80u;                // bf16 1.0
      auto bit = [&](int j, int i) { return j < i ? one : 0u; };
      const uint32_t a[4] = {
          bit(j0, i0) | bit(j0 + 1, i0) << 16,
          bit(j0, i1) | bit(j0 + 1, i1) << 16,
          bit(j0 + 8, i0) | bit(j0 + 9, i0) << 16,
          bit(j0 + 8, i1) | bit(j0 + 9, i1) << 16};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x0 = quantity(pv, q, g, j0);
        const float x1 = quantity(pv, q, g, j0 + 1);
        const float x8 = quantity(pv, q, g, j0 + 8);
        const float x9 = quantity(pv, q, g, j0 + 9);
        mma_bf16(d[q], a, pack_bf16(x0, x1), pack_bf16(x8, x9));
        if (MODE == kMmaBf16x2 && q == 0) {
          mma_bf16(d[q], a, pack_bf16(x0 - bf16_round(x0), x1 - bf16_round(x1)),
                   pack_bf16(x8 - bf16_round(x8), x9 - bf16_round(x9)));
        }
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kMmaWarps * 32)
prefix_mma(const float* __restrict__ rec, size_t ld,
           float* __restrict__ out) {
  extern __shared__ float smem[];
  float* r = smem;                                   // [3][kS]
  float* acc = r + 3 * kS;                           // [kP][5]
  float* pv = acc + kP * 5 +
              (threadIdx.x >> 5) * 4 * kGroupW * kLd;  // this warp's group
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = threadIdx.x; i < kP * 5; i += blockDim.x) acc[i] = 0.0f;
  for (int c = tile * kCpt; c < (tile + 1) * kCpt; ++c) {
    __syncthreads();
    stage_rows(rec, ld, c, r, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int grp = warp; grp < kP / kGroupW; grp += kMmaWarps) {
      const int p0 = grp * kGroupW;
      __syncwarp();
      for (int e = lane; e < kGroupW * kS; e += 32) {
        const int n = e / kS, j = e % kS;
        const PairVals v =
            pair_vals(r[j], r[kS + j], r[2 * kS + j], (float)(p0 + n));
        pv[(kQLogom * kGroupW + n) * kLd + j] = v.logom;
        pv[(kQW0 * kGroupW + n) * kLd + j] = v.w0;
        pv[(kQU * kGroupW + n) * kLd + j] = v.u;
        pv[(kQV * kGroupW + n) * kLd + j] = v.v;
      }
      __syncwarp();
      // the thread's D entries: lanes 16 mm + g (+ 8), pixels 2t, 2t + 1
      float s[2][5] = {};
      for (int mm = 0; mm < kS / 16; ++mm) {
        float d[4][4];
        prefix_tile<MODE>(pv, mm, g, t, d);
#pragma unroll
        for (int r2 = 0; r2 < 4; ++r2) {
          const int j = 16 * mm + g + (r2 >= 2 ? 8 : 0);
          const int n = 2 * t + (r2 & 1);
          PairVals e;
          e.w0 = pv[(kQW0 * kGroupW + n) * kLd + j];
          e.u = pv[(kQU * kGroupW + n) * kLd + j];
          e.v = pv[(kQV * kGroupW + n) * kLd + j];
          add_pair(s[r2 & 1], e, d[0][r2], d[1][r2], d[2][r2], d[3][r2]);
        }
      }
      // sum over the eight lanes of each group row (same t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 5; ++k)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            s[h][k] += __shfl_xor_sync(0xffffffffu, s[h][k], o);
      if (g == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 5; ++k) acc[(p0 + 2 * t + h) * 5 + k] += s[h][k];
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kP; p += blockDim.x) {
    float a[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) a[k] = acc[p * 5 + k];
    store_out(out, tile, p, a);
  }
}

template <int MODE>
cudaError_t launch_mma(const float* rec, size_t ld, int n_tiles, float* out,
                       cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (3 * kS + kP * 5 + kMmaWarps * 4 * kGroupW * kLd);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_mma<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  prefix_mma<MODE><<<n_tiles, kMmaWarps * 32, smem, s>>>(rec, ld, out);
  return cudaGetLastError();
}

}  // namespace

// rec [rows >= 3, ld] f32 lane-major (ld >= n_chunks * 128); out
// [n_chunks / 66, 512, 16] f32. mode: 0 serial, 1 warpscan, 2 mma_bf16,
// 3 mma_bf16x2, 4 mma_3xtf32. Returns cudaGetLastError().
extern "C" int su_micro_prefix(int mode, const float* rec, long long ld,
                               int n_chunks, float* out, int device,
                               void* stream) {
  if (mode < 0 || mode >= kNumPrefixModes || n_chunks < 0 ||
      n_chunks % kCpt != 0 || ld < (long long)n_chunks * kS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = n_chunks / kCpt;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t l = (size_t)ld;
  switch (mode) {
    case kSerial:
      prefix_serial<<<n_tiles, kP, 0, s>>>(rec, l, out);
      return (int)cudaGetLastError();
    case kWarpScan:
      prefix_warpscan<<<n_tiles, kP, 0, s>>>(rec, l, out);
      return (int)cudaGetLastError();
    case kMmaBf16:
      return (int)launch_mma<kMmaBf16>(rec, l, n_tiles, out, s);
    case kMmaBf16x2:
      return (int)launch_mma<kMmaBf16x2>(rec, l, n_tiles, out, s);
    default:
      return (int)launch_mma<kMma3xTf32>(rec, l, n_tiles, out, s);
  }
}
