// T3 redesigned for the H100: the lane-reduction probe of
// tools/micro_reduce.py, bit for bit with its first design
// (micro_reduce.cu, `su_micro_reduce_first`).
//
// The same function and modes as the first design: x [512, nv * 128] f32
// and per 128-column block v out[p, i] += sum_s x[p, 128 v + s] * w_i for
// i < k (w_i = 1 + 0.01 i), or the 25-step pair chain summed into column
// 0. Each mode keeps its mechanism per block: `thread` a thread sums a
// row's 128 columns serially, `warp` a warp per row with shuffle sums,
// `mma` one mma.sync m16n8k16 product per 16 columns (bf16 operands, f32
// accumulation), `pair` the chain, then a warp's shuffle sum.
//
// What bounds it on an H100: bytes, 1.07 GB at nv = 4096 (0.321 ms at
// 3.35 TB/s). The first design reached 45-77% of that: one block of 512
// threads an SM on 128 of the 132 SMs, each thread one float4 in flight
// (thread), its loads 32 rows apart (thread) or straight from device
// memory as 8-byte pieces of 16 rows (mma), and k five-step butterflies a
// block (warp, 65 shuffles at k 13). Two modes also carry many unfused f32
// instructions an element: pair 50 (0.40 ms at 33.5 T instructions/s),
// thread 2 k (26 at k 13).
//
// Design:
// - A work item is (slice, group of R rows); a thread block takes one.
//   The item's R row segments of each block v (512 contiguous bytes a row)
//   stream through a ring of NS shared-memory stages filled by 16-byte
//   cp.async.cg copies, a warp's 32 copies one whole segment, NS - 1
//   blocks in flight per thread block while it sums the oldest. (Bulk
//   copies completing on mbarriers, from a producer warp, stages of 2 or 4
//   blocks a row, and a persistent grid whose ring runs on from one item
//   into the next were measured no faster on an H100.)
// - Bits: each (row, slice) sums its slice's blocks in order, each block
//   in the first design's per-element order, into the same partials
//   [nsplit, 512, 16], folded over the slices in slice order as
//   reduce_partials does. So every mode's output equals the first
//   design's bit for bit.
// - thread: TPR threads a row, each taking a contiguous share of the k
//   weights (each still sums the row's 128 columns serially for its
//   weights), so that the k sums' instructions spread over TPR times the
//   warps; rows padded to 132 floats, so that 8 lanes' float4 reads of 8
//   rows fall in 8 distinct bank groups.
// - warp: a warp per row; per block the k lane sums by a reduce-scatter
//   that pairs lanes as the first design's butterfly (xor 16, 8, 4, 2, 1):
//   with the k sums padded to N = 2^H slots, H halving steps (each lane
//   keeps half its slots and adds its partner's copy of them), then
//   5 - H butterfly steps on the one sum left: N - 1 + 5 - H shuffles (16
//   at k 13, against 65). Addition is commutative, so each pair's sum has
//   the butterfly's bits. Each lane keeps its slots permuted (slot p holds
//   sum p ^ m, m the sum the lane ends with), so that the half it keeps
//   is always its first and no select is needed.
// - mma: a warp per 16 rows; the A fragments from the staged f32 tile
//   (rows padded to 136 floats: a half warp's 8-byte reads hit 32 distinct
//   banks), rounded to bf16 as before, the same mma.sync per accumulator
//   in the same order.
// - The fold: a warp a row loads every slice's 16 partials at once into
//   shared memory, then 16 lanes add them in slice order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace su_reduce_sm90 {

constexpr int kP = 512;        // rows
constexpr int kS = 128;        // columns per block
constexpr int kPartW = 16;     // partial-sum columns kept (k <= 13)
constexpr unsigned kFull = 0xffffffffu;

enum ReduceMode { kPair = 0, kThread, kWarp, kMma, kNumReduceModes };

// A ring's shape: R rows an item, NT threads, NS stages of one block a
// row; staged rows LD = 128 + PAD floats apart.
template <int R_, int NT_, int NS_, int PAD_>
struct Ring {
  static constexpr int R = R_, NT = NT_, NS = NS_;
  static constexpr int LD = kS + PAD_;
  static constexpr int kStage = R_ * LD;                       // floats
  static constexpr int kSmem = NS_ * kStage * (int)sizeof(float);
};

// The shapes (rows an item, threads a row in thread mode, stages). Pads:
// thread 4 floats (8 lanes' float4 reads of 8 rows hit 8 bank groups),
// mma 8 (a half warp's 8-byte fragment reads hit 32 banks), warp none (a
// warp reads one row).
constexpr int kThreadRows = 32, kThreadParts = 4, kThreadStages = 4;
constexpr int kWarpRows = 4, kWarpStages = 6;
constexpr int kMmaRows = 32, kMmaStages = 4;
using ThreadRing =
    Ring<kThreadRows, kThreadRows * kThreadParts, kThreadStages, 4>;
using WarpRing = Ring<kWarpRows, kWarpRows * 32, kWarpStages, 0>;
using MmaRing = Ring<kMmaRows, kMmaRows * 2, kMmaStages, 8>;

// The TPU tool's weights 1.0 + 0.01 i: a double rounded to f32.
__device__ __forceinline__ float weight(int i) {
  return (float)(1.0 + 0.01 * (double)i);
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

// Block v of rows [row0, row0 + R) into one stage: 16-byte copies,
// consecutive threads on consecutive pieces of a row, so that a warp's 32
// copies are one row's 512 contiguous bytes.
template <class Sh>
__device__ __forceinline__ void stage_rows(float* st, const float* x,
                                           size_t row_len, int row0, int v) {
  static_assert((Sh::R * 32) % Sh::NT == 0, "whole copies per thread");
#pragma unroll
  for (int n = 0; n < Sh::R * 32 / Sh::NT; ++n) {
    const int c = threadIdx.x + n * Sh::NT;
    const int r = c >> 5, q = c & 31;
    su_async::copy16(st + r * Sh::LD + 4 * q,
                     x + (size_t)(row0 + r) * row_len + (size_t)v * kS + 4 * q);
  }
}

// Blocks v0 .. v0 + nblk - 1 of the item's rows through the ring of NS
// stages; consume(tile) sees each block in order, its R rows Sh::LD
// floats apart.
template <class Sh, class Consume>
__device__ __forceinline__ void ring(float* smem, const float* x, int nv,
                                     int row0, int v0, int nblk,
                                     Consume&& consume) {
  static_assert(Sh::NS >= 2, "at least one block in flight");
  const size_t row_len = (size_t)nv * kS;
#pragma unroll
  for (int j = 0; j < Sh::NS - 1; ++j) {
    if (j < nblk)
      stage_rows<Sh>(smem + j * Sh::kStage, x, row_len, row0, v0 + j);
    su_async::commit();
  }
  for (int j = 0; j < nblk; ++j) {
    su_async::wait<Sh::NS - 2>();   // block j has landed (this thread's)
    __syncthreads();                // everyone's; block j - 1 consumed
    const int nxt = j + Sh::NS - 1;
    if (nxt < nblk)
      stage_rows<Sh>(smem + (nxt % Sh::NS) * Sh::kStage, x, row_len, row0,
                     v0 + nxt);
    su_async::commit();
    consume(smem + (j % Sh::NS) * Sh::kStage);
  }
}

// ---- thread: TPR threads a row; part P sums weights [P K / TPR,
// (P + 1) K / TPR).
__host__ __device__ constexpr int max_part(int k, int parts) {
  int m = 0;
  for (int p = 0; p < parts; ++p) {
    const int n = (p + 1) * k / parts - p * k / parts;
    m = n > m ? n : m;
  }
  return m;
}

template <int K, int I0, int KN, int KA>
__device__ __forceinline__ void thread_block(const float4* __restrict__ b,
                                             const float (&c)[K],
                                             float (&acc)[KA]) {
  float bs[KN];
#pragma unroll
  for (int j = 0; j < KN; ++j) bs[j] = 0.0f;
#pragma unroll 8
  for (int q = 0; q < kS / 4; ++q) {
    const float4 f = b[q];
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      const float w = c[I0 + j];
      bs[j] += f.x * w + f.y * w + f.z * w + f.w * w;
    }
  }
#pragma unroll
  for (int j = 0; j < KN; ++j) acc[j] += bs[j];
}

template <int K, int TPR, int KA, int P = 0>
__device__ __forceinline__ void thread_part(int part, const float4* b,
                                            const float (&c)[K],
                                            float (&acc)[KA]) {
  if constexpr (P < TPR) {
    constexpr int lo = P * K / TPR, hi = (P + 1) * K / TPR;
    if (part == P)
      thread_block<K, lo, hi - lo, KA>(b, c, acc);
    else
      thread_part<K, TPR, KA, P + 1>(part, b, c, acc);
  }
}

template <int K, int TPR, class Sh>
__global__ void __launch_bounds__(Sh::NT)
reduce_thread_sm90(const float* __restrict__ x, int nv, int vps,
                   float* __restrict__ partial) {
  constexpr int R = Sh::R;
  static_assert(R % 32 == 0 && Sh::NT == R * TPR,
                "a warp's threads share one part");
  constexpr int KA = max_part(K, TPR);
  extern __shared__ float4 smem4[];
  const int groups = kP / R;
  const int split = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * R;
  const int r = threadIdx.x % R;
  const int part = threadIdx.x / R;
  float c[K], acc[KA];
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = weight(i);
#pragma unroll
  for (int j = 0; j < KA; ++j) acc[j] = 0.0f;
  ring<Sh>(reinterpret_cast<float*>(smem4), x, nv, row0, split * vps, vps,
           [&](const float* tile) {
             thread_part<K, TPR, KA>(
                 part, reinterpret_cast<const float4*>(tile + r * Sh::LD), c,
                 acc);
           });
  float* o = partial + ((size_t)split * kP + row0 + r) * kPartW;
  const int lo = part * K / TPR, n = (part + 1) * K / TPR - lo;
#pragma unroll
  for (int j = 0; j < KA; ++j)
    if (j < n) o[lo + j] = acc[j];
  if (part == TPR - 1)
#pragma unroll
    for (int i = K; i < kPartW; ++i) o[i] = 0.0f;
}

// ---- warp (K >= 1) and pair (K = 0): a warp per row.
__host__ __device__ constexpr int slots(int k) {
  int n = 1;
  while (n < k) n *= 2;
  return n;
}
__host__ __device__ constexpr int log2i(int n) {
  return n > 1 ? 1 + log2i(n / 2) : 0;
}

// Halving step S of the N slots' reduce-scatter: lane keeps slots
// [0, h), adds its xor-16 >> S partner's slots [h, 2h) (h = N >> S + 1).
// A template, so that every slot index is a constant and v stays in
// registers.
template <int N, int S>
__device__ __forceinline__ void halve(float (&v)[N]) {
  if constexpr (S < log2i(N)) {
    constexpr int h = N >> (S + 1);
#pragma unroll
    for (int p = 0; p < h; ++p)
      v[p] = v[p] + __shfl_xor_sync(kFull, v[p + h], 16 >> S);
    halve<N, S + 1>(v);
  }
}

template <int K, class Sh>
__global__ void __launch_bounds__(Sh::NT)
reduce_warp_sm90(const float* __restrict__ x, int nv, int vps,
                 float* __restrict__ partial) {
  static_assert(Sh::NT == Sh::R * 32, "a warp a row");
  constexpr int N = slots(K);     // sums padded to a power of two
  constexpr int H = log2i(N);     // halving steps: xor 16 .. 32 >> H
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = kP / Sh::R;
  const int split = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * Sh::R;
  // the sum this lane ends with: lane bit 4 - s picks the upper half at
  // halving step s; slot p holds sum p ^ m, zero weight past k
  const int m = lane >> (5 - H);
  float c[N];
#pragma unroll
  for (int p = 0; p < N; ++p) c[p] = (p ^ m) < K ? weight(p ^ m) : 0.0f;
  float acc = 0.0f;
  ring<Sh>(
      reinterpret_cast<float*>(smem4), x, nv, row0, split * vps, vps,
      [&](const float* tile) {
        const float4 f =
            reinterpret_cast<const float4*>(tile + warp * Sh::LD)[lane];
        float v[N];
        if constexpr (K == 0) {
          float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int step = 0; step < 25; ++step)
              e[r] = e[r] * 1.0001f + 0.001f;
          v[0] = e[0] + e[1] + e[2] + e[3];
        } else {
#pragma unroll
          for (int p = 0; p < N; ++p)
            v[p] = f.x * c[p] + f.y * c[p] + f.z * c[p] + f.w * c[p];
        }
        halve<N, 0>(v);
#pragma unroll
        for (int s = H; s < 5; ++s)
          v[0] += __shfl_xor_sync(kFull, v[0], 16 >> s);
        acc += v[0];
      });
  float* o = partial + ((size_t)split * kP + row0 + warp) * kPartW;
  if ((lane & ((1 << (5 - H)) - 1)) == 0) o[m] = m < K || K == 0 ? acc : 0.0f;
  if (lane < kPartW - N) o[N + lane] = 0.0f;
}

// ---- mma: a warp per 16 rows; NT n-tiles of 8 weight columns.
template <int K, class Sh>
__global__ void __launch_bounds__(Sh::NT)
reduce_mma_sm90(const float* __restrict__ x, int nv, int vps,
                float* __restrict__ partial) {
  constexpr int NT = (K + 7) / 8;
  constexpr int R = Sh::R;
  static_assert(Sh::NT == R * 2, "a warp per 16 rows");
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;       // group: A/C row, B column
  const int t = lane & 3;        // thread in group
  const int groups = kP / R;
  const int split = blockIdx.x / groups;
  const int item0 = (blockIdx.x % groups) * R;
  const int row0 = item0 + warp * 16;
  // W[s, n] = weight(n) for n < K, independent of s
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
  ring<Sh>(
      reinterpret_cast<float*>(smem4), x, nv, item0, split * vps, vps,
      [&](const float* tile) {
        const float* ra = tile + (warp * 16 + g) * Sh::LD + 2 * t;
        const float* rb = ra + 8 * Sh::LD;
#pragma unroll
        for (int kk = 0; kk < kS / 16; ++kk) {
          const float2 x00 = *reinterpret_cast<const float2*>(ra + kk * 16);
          const float2 x10 = *reinterpret_cast<const float2*>(rb + kk * 16);
          const float2 x01 =
              *reinterpret_cast<const float2*>(ra + kk * 16 + 8);
          const float2 x11 =
              *reinterpret_cast<const float2*>(rb + kk * 16 + 8);
          const uint32_t a[4] = {
              pack_bf16(x00.x, x00.y), pack_bf16(x10.x, x10.y),
              pack_bf16(x01.x, x01.y), pack_bf16(x11.x, x11.y)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(d[nt], a, bw[nt], bw[nt]);
        }
      });
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
// (i < 16), zero for i >= 16: reduce_partials' sums. A warp a row: its
// lanes load up to 128 slices' 16 values into shared memory, 16-byte
// pieces all in flight at once, then 16 lanes add them in order.
constexpr int kFoldRows = 4;   // rows (warps) a thread block
__global__ void __launch_bounds__(kFoldRows * 32)
fold_partials(const float* __restrict__ partial, int nsplit,
              float* __restrict__ out) {
  __shared__ float4 tile[kFoldRows][128 * kPartW / 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kFoldRows + warp;
  float4* t4 = tile[warp];
  const float* t = reinterpret_cast<const float*>(t4);
  float s = 0.0f;
  for (int base = 0; base < nsplit; base += 128) {
    const int n = min(128, nsplit - base);
#pragma unroll 16
    for (int i = lane; i < n * kPartW / 4; i += 32)
      t4[i] = *reinterpret_cast<const float4*>(
          partial + ((size_t)(base + i / (kPartW / 4)) * kP + p) * kPartW +
          4 * (i % (kPartW / 4)));
    __syncwarp();
    if (lane < kPartW)
#pragma unroll 8
      for (int sp = 0; sp < n; ++sp) s += t[sp * kPartW + lane];
    __syncwarp();
  }
  float* o = out + (size_t)p * kS;
  if (lane < kPartW) o[lane] = s;
  if (lane < (kS - kPartW) / 4)
    reinterpret_cast<float4*>(o + kPartW)[lane] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <class Sh, class Kern>
cudaError_t launch_staged(Kern kern, int nsplit, cudaStream_t s,
                          const float* x, int nv, float* partial) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<nsplit * (kP / Sh::R), Sh::NT, Sh::kSmem, s>>>(x, nv, nv / nsplit,
                                                       partial);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_mode(int mode, const float* x, int nv, int nsplit,
                        float* partial, cudaStream_t s) {
  if (mode == kThread)
    return launch_staged<ThreadRing>(
        reduce_thread_sm90<K, kThreadParts, ThreadRing>, nsplit, s, x, nv,
        partial);
  if (mode == kWarp)
    return launch_staged<WarpRing>(reduce_warp_sm90<K, WarpRing>, nsplit, s,
                                   x, nv, partial);
  return cudaErrorInvalidValue;
}

template <int K>
cudaError_t launch_mma(const float* x, int nv, int nsplit, float* partial,
                       cudaStream_t s) {
  return launch_staged<MmaRing>(reduce_mma_sm90<K, MmaRing>, nsplit, s, x,
                                nv, partial);
}

// The redesign; same arguments as the first design's entry.
inline cudaError_t run(int mode, int k, const float* x, int nv, int nsplit,
                       float* partial, float* out, cudaStream_t s) {
  cudaError_t err;
  if (mode == kPair) {
    err = k == 0 ? launch_staged<WarpRing>(reduce_warp_sm90<0, WarpRing>,
                                           nsplit, s, x, nv, partial)
                 : cudaErrorInvalidValue;
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
  if (err != cudaSuccess) return err;
  fold_partials<<<kP / kFoldRows, kFoldRows * 32, 0, s>>>(partial, nsplit,
                                                            out);
  return cudaGetLastError();
}

}  // namespace su_reduce_sm90
