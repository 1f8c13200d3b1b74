// The binning's conic cull: each surfel's tile rectangle and, for the
// surfels spanning at most kKmax tiles, the exact conic tile test, in one
// pass that writes the per-surfel table the depth rank gathers
// (ops/rasterizer/tiles.py: `cull_rects_cuda`). The C entry is in cull.cu.
//
// Replaces no Pallas kernel: the JAX package leaves this to XLA, as the
// jnp code of streetunveiler_tpu/ops/rasterizer/tiles.py
// `_tile_can_contribute` (:102) and the rect and cull lines of its
// `bin_surfels_stream` (:237), which XLA fuses into one pass. The port's
// plain version, `tiles.tile_rects` + `tiles.conic_cull` +
// `tiles.surfel_table`, runs it op by op over [N, 16] broadcasts: ~400
// launches and 19 ms a view at 1M surfels on an H100.
//
// It computes, bit for bit, the table [N, 7] int32 of the plain version,
// rows (x0, y0, max(nx, 1), nt, small, w0, w1):
// - x0, x1, y0, y1: floor((c -+ e) * (1 / tile size)) clamped to the
//   tiles and cast to int32 (the card's PyTorch divides by a scalar as a
//   product with its reciprocal; for the power-of-two tile sizes both are
//   exact); nx = x1 - x0 + 1, rect_nt = nx * (y1 - y0 + 1);
// - small = valid and rect_nt <= kKmax; on a small row, rect position k
//   < rect_nt (tile (x0 + k % nx', y0 + k / nx'), nx' = max(nx, 1))
//   passes the test of `_tile_can_contribute`, and nt = min(passing
//   count, max_tiles); elsewhere nt = min(rect_nt, max_tiles) where valid,
//   0 where not;
// - w0, w1: the rect positions, the passing ones first, each group in
//   rect order (the plain version's stable sort of k or 16 + k), as 4-bit
//   nibbles, position j of the list at bits 4j of w0 (j < 8) or 4(j - 8)
//   of w1. On a small row they are the plain version's bits. On the other
//   rows they are 0: K3 reads them only where small is set, and the plain
//   version's words there pack the test of rows it never uses.
// The test evaluates every expression in the plain version's order with
// one IEEE single rounding an operation (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn: no multiply-add contraction), its float32 scalars (1.001f,
// 1e-6f, +-1e-20f, 1e-24f), and torch.clamp's NaN rule (a NaN operand comes
// out as it went in, where fminf/fmaxf would drop it). The per-row
// coefficients (A, B, C, D, E, the threshold) are the plain version's
// [N, 1] columns, computed once a row in the same order.
//
// What bounds it on an H100: bytes. It reads center2d, ext, valid and the
// cull table (61 MB at 1M surfels) and writes the table (28 MB): ~0.027 ms
// at 3.35 TB/s. The test is ~218 float operations a (surfel, rect
// position) pair; at the street's 1920x1280 view it runs on 4.7M pairs
// (~1 GFLOP, ~0.015 ms at 67 TFLOP/s), and the positions past a surfel's
// rectangle and the rows that are not small test nothing. The design:
// - A thread a surfel, in a grid-stride loop over at most the blocks the
//   card holds at once: it loads its inputs, computes the rectangle and
//   the quadratic's coefficients once, and runs the test on its rect
//   positions k < rect_nt in a loop, the tile stepping along the rect's
//   rows, into a 16-bit pass mask; popc of it is the passing count.
// - The compact list by a loop over k: position k goes to the next
//   passing place if its bit is set, else to popc(mask) + the failing
//   ones before it; that is the plain version's stable sort of k or
//   16 + k, without sorting.
// - The row's 7 words stored by the thread, so a warp's stores cover 32
//   consecutive rows. No shared memory, no atomics, no allocation.
// A first design gave a rect position to each of 16 lanes, two surfels a
// warp, with the pass mask from __ballot_sync and the words from xor
// shuffles: 0.362 ms at the 1M-surfel street's 1920x1280 view against this
// design's 0.176 on an H100 (PERF.md), since most lanes idled past rect_nt
// (4.7M tested pairs of 16M lanes) while the warp paid for its widest
// test, and every lane recomputed the rectangle and the coefficients.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace su_cull90 {
namespace {

constexpr int kThreads = 256;
constexpr int kKmax = 16;   // tiles.CULL_KMAX
constexpr int kCols = 7;    // x0, y0, max(nx, 1), nt, small, w0, w1

// torch.clamp(v, lo, hi) on the card, lo and hi not NaN: a NaN v comes
// out as it went in.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// The plain version's safe(q): +-1e-20 where |q| < 1e-20, the sign of q.
__device__ __forceinline__ float safe(float q) {
  const float tiny = q < 0.0f ? -1e-20f : 1e-20f;
  return fabsf(q) < 1e-20f ? tiny : q;
}

// floor(v * inv) clamped to [0, hi - 1], cast to int32 (a NaN casts to 0,
// as PyTorch's copy does on the card).
__device__ __forceinline__ int cell(float v, float inv, int hi) {
  return (int)clamp_nan(floorf(__fmul_rn(v, inv)), 0.0f, (float)(hi - 1));
}

struct Row {
  float ax, ay, az, bx, by, bz, cx, cy, cz, d2max, c2dx, c2dy;
  float A, B, C, D, E, thresh, a2, c2, det, num_x, num_y;
};

// rho3d at (px, py): (kx^2 + ky^2) / max(kz^2, 1e-24), k = a + px b + py c.
__device__ __forceinline__ float rho_at(const Row& r, float px, float py) {
  const float kx = __fadd_rn(__fadd_rn(r.ax, __fmul_rn(px, r.bx)),
                             __fmul_rn(py, r.cx));
  const float ky = __fadd_rn(__fadd_rn(r.ay, __fmul_rn(px, r.by)),
                             __fmul_rn(py, r.cy));
  const float kz = __fadd_rn(__fadd_rn(r.az, __fmul_rn(px, r.bz)),
                             __fmul_rn(py, r.cz));
  const float kz2 = __fmul_rn(kz, kz);
  return __fdiv_rn(__fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky)),
                   isnan(kz2) ? kz2 : fmaxf(kz2, 1e-24f));
}

// `_tile_can_contribute` for tile (tx, ty): the low-pass disc, then rho3d
// at the 4 corners, the 4 edge criticals and the interior stationary
// point. It stops at the first hit (the plain version ORs them all).
__device__ __forceinline__ bool tile_test(const Row& r, int tx, int ty,
                                          int tile_w, int tile_h) {
  const float xs = __fmul_rn((float)tx, (float)tile_w);
  const float ys = __fmul_rn((float)ty, (float)tile_h);
  const float xlo = __fadd_rn(xs, 0.5f);
  const float xhi = __fadd_rn(xs, (float)tile_w - 0.5f);
  const float ylo = __fadd_rn(ys, 0.5f);
  const float yhi = __fadd_rn(ys, (float)tile_h - 0.5f);
  const float dx = __fsub_rn(clamp_nan(r.c2dx, xlo, xhi), r.c2dx);
  const float dy = __fsub_rn(clamp_nan(r.c2dy, ylo, yhi), r.c2dy);
  if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r.d2max)
    return true;
  if (rho_at(r, xlo, ylo) <= r.thresh || rho_at(r, xlo, yhi) <= r.thresh ||
      rho_at(r, xhi, ylo) <= r.thresh || rho_at(r, xhi, yhi) <= r.thresh)
    return true;
  for (int e = 0; e < 2; ++e) {   // dQ/dx = 0 on the horizontal edges
    const float py = e ? yhi : ylo;
    const float px = clamp_nan(
        __fdiv_rn(-__fadd_rn(__fmul_rn(r.B, py), r.D), r.a2), xlo, xhi);
    if (rho_at(r, px, py) <= r.thresh) return true;
  }
  for (int e = 0; e < 2; ++e) {   // dQ/dy = 0 on the vertical edges
    const float px = e ? xhi : xlo;
    const float py = clamp_nan(
        __fdiv_rn(-__fadd_rn(__fmul_rn(r.B, px), r.E), r.c2), ylo, yhi);
    if (rho_at(r, px, py) <= r.thresh) return true;
  }
  const float px = clamp_nan(__fdiv_rn(r.num_x, r.det), xlo, xhi);
  const float py = clamp_nan(__fdiv_rn(r.num_y, r.det), ylo, yhi);
  return rho_at(r, px, py) <= r.thresh;
}

// The quadratic's coefficients of one surfel, in the plain version's
// order: A = bx bx + by by - rho bz bz, B = 2 (bx cx + by cy - rho bz cz),
// ..., thresh = rho 1.001 + 1e-6, and the edge and interior terms.
__device__ __forceinline__ void coefficients(Row& r, float rho) {
  const float rbz = __fmul_rn(rho, r.bz), rcz = __fmul_rn(rho, r.cz);
  const float raz = __fmul_rn(rho, r.az);
  r.A = __fsub_rn(__fadd_rn(__fmul_rn(r.bx, r.bx), __fmul_rn(r.by, r.by)),
                  __fmul_rn(rbz, r.bz));
  r.C = __fsub_rn(__fadd_rn(__fmul_rn(r.cx, r.cx), __fmul_rn(r.cy, r.cy)),
                  __fmul_rn(rcz, r.cz));
  r.B = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(__fmul_rn(r.bx, r.cx),
                                            __fmul_rn(r.by, r.cy)),
                                  __fmul_rn(rbz, r.cz)));
  r.D = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(__fmul_rn(r.ax, r.bx),
                                            __fmul_rn(r.ay, r.by)),
                                  __fmul_rn(raz, r.bz)));
  r.E = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(__fmul_rn(r.ax, r.cx),
                                            __fmul_rn(r.ay, r.cy)),
                                  __fmul_rn(raz, r.cz)));
  r.thresh = __fadd_rn(__fmul_rn(rho, 1.001f), 1e-6f);
  r.a2 = __fmul_rn(2.0f, safe(r.A));
  r.c2 = __fmul_rn(2.0f, safe(r.C));
  r.det = safe(__fsub_rn(__fmul_rn(__fmul_rn(4.0f, r.A), r.C),
                         __fmul_rn(r.B, r.B)));
  r.num_x = __fsub_rn(__fmul_rn(r.B, r.E),
                      __fmul_rn(__fmul_rn(2.0f, r.C), r.D));
  r.num_y = __fsub_rn(__fmul_rn(r.B, r.D),
                      __fmul_rn(__fmul_rn(2.0f, r.A), r.E));
}

__global__ void __launch_bounds__(kThreads)
    cull_sm90_kernel(const float* __restrict__ center2d,
                     const float* __restrict__ ext,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ cull, int n, int tiles_x,
                     int tiles_y, int tile_w, int tile_h, int max_tiles,
                     int32_t* __restrict__ table) {
  const float inv_w = 1.0f / (float)tile_w, inv_h = 1.0f / (float)tile_h;
  for (long long s = (long long)blockIdx.x * kThreads + threadIdx.x; s < n;
       s += (long long)gridDim.x * kThreads) {
    const float cx = __ldg(center2d + 2 * s);
    const float cy = __ldg(center2d + 2 * s + 1);
    const float ex = __ldg(ext + 2 * s), ey = __ldg(ext + 2 * s + 1);
    const bool ok = __ldg(valid + s) != 0;
    const int x0 = cell(__fsub_rn(cx, ex), inv_w, tiles_x);
    const int y0 = cell(__fsub_rn(cy, ey), inv_h, tiles_y);
    const int nx = cell(__fadd_rn(cx, ex), inv_w, tiles_x) - x0 + 1;
    const int rect_nt =
        nx * (cell(__fadd_rn(cy, ey), inv_h, tiles_y) - y0 + 1);
    const bool small = ok && rect_nt <= kKmax;
    const int nxc = nx > 1 ? nx : 1;
    unsigned mask = 0u;
    if (small && rect_nt > 0) {
      const float* q = cull + 11 * s;
      Row r;
      r.ax = __ldg(q), r.ay = __ldg(q + 1), r.az = __ldg(q + 2);
      r.bx = __ldg(q + 3), r.by = __ldg(q + 4), r.bz = __ldg(q + 5);
      r.cx = __ldg(q + 6), r.cy = __ldg(q + 7), r.cz = __ldg(q + 8);
      r.d2max = __ldg(q + 10), r.c2dx = cx, r.c2dy = cy;
      coefficients(r, __ldg(q + 9));
      int dx = 0, dy = 0;
      for (int k = 0; k < rect_nt; ++k) {
        if (tile_test(r, x0 + dx, y0 + dy, tile_w, tile_h)) mask |= 1u << k;
        if (++dx == nxc) dx = 0, ++dy;
      }
    }
    unsigned w0 = 0u, w1 = 0u;
    if (small) {
      int pass = 0, fail = __popc(mask);
#pragma unroll
      for (int k = 0; k < kKmax; ++k) {
        const int place = (mask >> k) & 1u ? pass++ : fail++;
        const unsigned nib = (unsigned)k << (4 * (place & 7));
        if (place < 8) w0 |= nib; else w1 |= nib;
      }
    }
    int32_t* row = table + kCols * s;
    row[0] = x0, row[1] = y0, row[2] = nxc;
    row[3] = small ? min(__popc(mask), max_tiles)
                   : (ok ? min(rect_nt, max_tiles) : 0);
    row[4] = (int)small, row[5] = (int)w0, row[6] = (int)w1;
  }
}

}  // namespace

// center2d, ext [n, 2] f32, valid [n] bool, cull [n, 11] f32 → table
// [n, 7] int32, on `stream`: at most the blocks the card holds at once.
inline cudaError_t launch(const float* center2d, const float* ext,
                          const uint8_t* valid, const float* cull, int n,
                          int width, int height, int tile_w, int tile_h,
                          int max_tiles, int32_t* table, int device,
                          cudaStream_t stream) {
  static int resident[64];   // blocks the card holds, per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int& held = resident[device];
  if (held == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cull_sm90_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    held = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long most = ((long long)n + kThreads - 1) / kThreads;
  const int grid = (int)(most < held ? most : held);
  cull_sm90_kernel<<<grid, kThreads, 0, stream>>>(
      center2d, ext, valid, cull, n, (width + tile_w - 1) / tile_w,
      (height + tile_h - 1) / tile_h, tile_w, tile_h, max_tiles, table);
  return cudaGetLastError();
}

}  // namespace su_cull90
