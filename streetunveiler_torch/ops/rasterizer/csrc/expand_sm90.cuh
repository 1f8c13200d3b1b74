// K3 — duplicate expansion, redesigned for the H100: coalesced stores
// through a shared-memory transpose. The C entries are in expand.cu,
// beside the first design (one thread per surfel writing its own run
// straight to global memory), which stays selectable.
//
// Replaces the Pallas kernel streetunveiler_tpu/ops/rasterizer/tiles.py
// `_expand_kernel` (launched at tiles.py:214 by `_expand_stream`) and
// computes what the first design computes, bit for bit: for every slot
// below lim = min(total, cap) the tile (y0 + k / nx) * tiles_x + x0 +
// k % nx and the surfel id of the run that holds the slot, k the slot's
// rank in its run (or, for culled small surfels, the k-th 4-bit rect
// position of two packed words); every later slot up to capp holds the
// sentinel (n_tiles, n).
//
// What bounds it on an H100: bytes — the table rows and dup_start read
// once, 2 capp int32 written once (chip_smoke.py's k3 bound, 6.6 us at the
// 300k-surfel street at 3.35 TB/s).
//
// What held the first design back: a warp's stores at each step went to
// 32 unrelated addresses in two arrays, a warp waited for its longest run,
// and the grid was sized max(n, capp). This one:
// - A block takes kThreads consecutive surfels, one a thread, so it holds
//   a fixed number of runs however many are empty (culled small surfels
//   sit anywhere in depth order, invalid ones at the end: their threads
//   idle). Its runs are consecutive, so its slots are one range,
//   [dup_start[first], dup_start[first + kThreads]) capped at lim. The
//   rows are read coalesced, 16 bytes at a time where they are 8 int32.
// - Each thread writes its run's (tile, surfel) into shared memory at its
//   slot's place in the range, then the block stores the range to
//   tile_id and surf_id coalesced, 16 bytes a lane where a group of 4
//   slots lies inside it (and the arrays are 16-byte aligned), element by
//   element at its two ends. A range longer than kWindow slots goes in
//   windows of kWindow, each thread writing the part of its run inside
//   the window, so no run length is too long (max_tiles_per_surfel 256 at
//   the most a run).
// - The sentinel tail [lim, capp) goes to blocks of their own after the
//   surfel blocks, kSentinelSlots each, with the same stores.
// - A grid of at most the blocks the card holds at once, each taking
//   virtual blocks (surfels, then sentinels) in a block-stride loop, sized
//   for the largest stream (total = cap) because the host does not read
//   the total.
// - The same arithmetic: integer / and %, the nibble pick, as in the first
//   design, so the same bits.
// A merge-path partition over slots and run ends (a block or warp of
// fixed merge items finding its start by a search on dup_start) was built
// first and ran slower at the street: its search and its staging were a
// chain of dependent loads that the expansion's little arithmetic could
// not hide (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace su_expand90 {
namespace {

constexpr int kCullKmax = 16;
constexpr int kThreads = 128;          // surfels a block
constexpr int kWindow = 1024;          // slots staged in shared memory
constexpr int kSentinelSlots = 1024;   // sentinel slots a block

// Store the values of slots [4g, 4g + 4) that lie in [s_lo, s_hi): one
// 16-byte store of each array when all four do and `vec`, else one by one.
__device__ __forceinline__ void store_group(int32_t* __restrict__ tile_id,
                                            int32_t* __restrict__ surf_id,
                                            int g, int s_lo, int s_hi,
                                            const int (&tv)[4],
                                            const int (&sv)[4], bool vec) {
  const int s = 4 * g;
  if (vec && s >= s_lo && s + 4 <= s_hi) {
    reinterpret_cast<int4*>(tile_id)[g] = make_int4(tv[0], tv[1], tv[2],
                                                    tv[3]);
    reinterpret_cast<int4*>(surf_id)[g] = make_int4(sv[0], sv[1], sv[2],
                                                    sv[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (s + q >= s_lo && s + q < s_hi) {
      tile_id[s + q] = tv[q];
      surf_id[s + q] = sv[q];
    }
  }
}

// `vec`: tile_id and surf_id are 16-byte aligned; `vec_rows`: the table's
// rows are 8 int32 and 16-byte aligned.
template <bool CULL>
__global__ void __launch_bounds__(kThreads)
expand_sm90_kernel(const int32_t* __restrict__ tbl, int rows,
                   const int32_t* __restrict__ dup_start, int n, int cap,
                   int capp, int tiles_x, int sentinel, bool vec,
                   bool vec_rows, int32_t* __restrict__ tile_id,
                   int32_t* __restrict__ surf_id) {
  __shared__ int s_tile[kWindow], s_surf[kWindow];
  const int t = threadIdx.x;
  const int total = __ldg(dup_start + n);
  const int lim = min(total, cap);
  const int surfel_blocks = (n + kThreads - 1) / kThreads;
  const int blocks = surfel_blocks +
                     (capp - lim + kSentinelSlots - 1) / kSentinelSlots;

  for (int vb = blockIdx.x; vb < blocks; vb += gridDim.x) {
    if (vb >= surfel_blocks) {
      // the sentinel tail
      const int s0 = lim + (vb - surfel_blocks) * kSentinelSlots;
      const int s1 = min(s0 + kSentinelSlots, capp);
      const int tv[4] = {sentinel, sentinel, sentinel, sentinel};
      const int sv[4] = {n, n, n, n};
      for (int g = (s0 >> 2) + t; g < (s1 + 3) >> 2; g += kThreads)
        store_group(tile_id, surf_id, g, s0, s1, tv, sv, vec);
      continue;
    }
    const int first = vb * kThreads;
    const int i = first + t;
    int x0 = 0, y0 = 0, nx = 1, start = 0, stop = 0, sid = 0, small = 0;
    unsigned w0 = 0u, w1 = 0u;
    if (i < n) {
      const int32_t* r = tbl + (size_t)i * rows;
      if (CULL && vec_rows) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(r));
        const int4 b = __ldg(reinterpret_cast<const int4*>(r) + 1);
        x0 = a.x, y0 = a.y, nx = a.z, start = a.w;
        sid = b.x, small = b.y, w0 = (unsigned)b.z, w1 = (unsigned)b.w;
      } else {
        x0 = __ldg(r), y0 = __ldg(r + 1), nx = __ldg(r + 2);
        start = __ldg(r + 3), sid = __ldg(r + 4);
        if (CULL) {
          small = __ldg(r + 5);
          w0 = (unsigned)__ldg(r + 6), w1 = (unsigned)__ldg(r + 7);
        }
      }
      stop = min(__ldg(dup_start + i + 1), lim);
    }
    // the block's slots, the same for every thread
    const int base = __ldg(dup_start + first);
    const int end = min(__ldg(dup_start + min(first + kThreads, n)), lim);

    for (int lo = base; lo < end; lo += kWindow) {
      const int hi = min(lo + kWindow, end);
      __syncthreads();   // the last window's shared reads are done
      for (int s = max(start, lo); s < min(stop, hi); ++s) {
        int k = s - start;
        if (CULL && small > 0) {
          const int kk = min(k, kCullKmax - 1);
          k = (int)(((kk < 8 ? w0 : w1) >> ((kk & 7) * 4)) & 15u);
        }
        const int q = k / nx;
        s_tile[s - lo] = (y0 + q) * tiles_x + x0 + (k - q * nx);
        s_surf[s - lo] = sid;
      }
      __syncthreads();
      for (int g = (lo >> 2) + t; g < (hi + 3) >> 2; g += kThreads) {
        int tv[4], sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = 4 * g + q;
          const bool in = s >= lo && s < hi;
          tv[q] = in ? s_tile[s - lo] : 0;
          sv[q] = in ? s_surf[s - lo] : 0;
        }
        store_group(tile_id, surf_id, g, lo, hi, tv, sv, vec);
      }
    }
  }
}

// Launch on `stream`: at most the blocks the card holds at once, fewer
// when the largest stream (total = cap) needs fewer virtual blocks.
inline cudaError_t launch(const int32_t* tbl, int rows,
                          const int32_t* dup_start, int n, int cap, int capp,
                          int tiles_x, int sentinel, bool has_cull,
                          int32_t* tile_id, int32_t* surf_id, int device,
                          cudaStream_t stream) {
  static int resident[64][2];   // blocks the card holds, per (device, cull)
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int& held = resident[device][has_cull ? 1 : 0];
  if (held == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = has_cull ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, expand_sm90_kernel<true>, kThreads, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, expand_sm90_kernel<false>, kThreads, 0);
    if (err != cudaSuccess) return err;
    held = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long most = ((long long)n + kThreads - 1) / kThreads +
                         ((long long)capp + kSentinelSlots - 1) /
                             kSentinelSlots;
  const int grid = (int)(most < held ? most : held);
  const bool vec = ((uintptr_t)tile_id % 16 == 0) &&
                   ((uintptr_t)surf_id % 16 == 0);
  const bool vec_rows = rows == 8 && (uintptr_t)tbl % 16 == 0;
  if (has_cull)
    expand_sm90_kernel<true><<<grid, kThreads, 0, stream>>>(
        tbl, rows, dup_start, n, cap, capp, tiles_x, sentinel, vec, vec_rows,
        tile_id, surf_id);
  else
    expand_sm90_kernel<false><<<grid, kThreads, 0, stream>>>(
        tbl, rows, dup_start, n, cap, capp, tiles_x, sentinel, vec, vec_rows,
        tile_id, surf_id);
  return cudaGetLastError();
}

}  // namespace
}  // namespace su_expand90
