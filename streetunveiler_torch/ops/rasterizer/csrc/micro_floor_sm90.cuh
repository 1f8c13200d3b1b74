// T5 and T6 redesigned for the H100: the per-step floors of
// tools/micro_floor.py behind `su_micro_floor`; the first design
// (micro_floor.cu's floor_walk, `su_micro_floor_first`) shares the
// constants, flags and variants defined here.
//
// The same function as the first design (micro_floor.cu:1-19): per output
// block, the f32 fold, in stream order, of each adding step's term
// sum(chunk) * 1e-30, reset to zero by a step with first > 0; a block no
// step writes is zero.
//
// What held the first design back (one 512-thread block per output block,
// walking its steps in batches of 64): on the tool's stream (9,589 real
// visits, 4,800 of them zeroing, 9,291 padding steps with first = -1, all
// on tile 0) tile 0's block walks 9,293 steps in 146 batches, each two
// dependent gathers, two barriers and a 64-step serial fold by every
// thread, ~0.55 ms after the other 4,799 blocks are done; every other
// block has ~2 steps, so 2 of its 16 warps load anything and its 24 KB of
// stores (48 KB for base) start only after its reads.
//
// The redesign takes the work apart in two launches on one stream:
// - Phase A, `floor_terms`: a warp per position of the wrapper's CSR
//   (order[i], the steps listed by output block in stream order), across
//   the whole card. A step that adds sums its chunk in the first design's
//   order exactly (per lane rows 0..23, each row's float4s in order of q,
//   (x.x + x.y) + (x.z + x.w); then the xor shuffle tree 16..1; then
//   * 1e-30f, a separate multiply under -fmad=false) and stores the term
//   at term[i]; every position stores its op byte (zero, add). A step
//   with first < 0 loads no chunk. prefetch2's 9,291 padding adds of one
//   chunk are each summed, the repeats served from L1 and L2.
// - Phase B, `floor_fold`: a warp per output block (kBWarps blocks to a
//   thread block), the segments longest first (`seg_order`, as
//   tiles.tile_order orders K1's tiles), so tile 0's long fold starts
//   first and its stores overlap everyone else's. The warp reads its
//   segment in aligned windows of 512 positions, each lane 16 positions
//   as four float4 of terms and one 16-byte word of ops, the next window
//   loaded before the current one is folded. A ballot of the lanes whose
//   16 ops hold any work skips the no-op positions 512 at a time (tile
//   0's 9,291 padding steps are 19 windows); the lanes with work pass
//   their terms and ops by shuffle, lowest lane first, and every lane
//   folds them in order in registers (all lanes hold the same value, so
//   no reduction follows), without a branch a position: a group of 16
//   plain adds (prefetch2, T6, long segments) folds as 16 dependent adds;
//   in a group of adds some of which zero (static_out) the add is a
//   constant and only the zeroing selects. The shuffles of the next lane
//   group with work are issued before the current one is folded; a window
//   whose 512 positions all add is folded by straight-line code instead,
//   all 32 groups in order. Then the warp stores its 24 KB, 48 float4
//   stores a lane (and 24 KB of zeros for base).
// Each variant keeps its mechanism in phase B: base's second output,
// zeroed only; a shared-scratch store at every add (every variant but
// no_scratch and T6): the lane's scratch[lane][0] *= 0.999, carried in a
// register and written through a volatile store that nvcc cannot delete;
// alldone's read of scratch[0][1] gating the add, between the two
// __syncwarp the read needs, at every position of a lane group with work
// (so at every add; the TPU and the first design read it at every step);
// the scratch is the warp's, a row per lane, as the first design's was
// the block's, a row per thread; static_out's whole stream in segment 0,
// one warp folding it; prefetch2's every step adding; T6 at widths 128,
// 256 and 512.
//
// What bounds it on an H100: bytes. The chunks that adding steps read
// (12 KB each; ~9,600 at the tool's size, 118 MB; T6 the whole record
// array, 173 MB) and the output blocks written once (4,800 x 24 KB =
// 118 MB, twice for base). The scratch term/op arrays are 5 bytes a
// position.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace su_floor {

constexpr int kRec = 24;          // record rows summed per step
constexpr int kPix = 512;         // output block: 512 x 12 f32
constexpr int kCh = 12;
constexpr int kScratchW = 8;      // scratch columns, as the TPU's [512, 8]

enum Flags {
  kFirst = 1,      // read first[]: zero at > 0, add at >= 0
  kScratch = 2,    // scratch[p][0] *= 0.999 at every add
  kAlldone = 4,    // the add is gated by scratch[0][1] > 1.5
  kTwoOut = 8,     // a second output, zeroed only
  kLinear = 16,    // step v reads lane block v (T6)
};

enum Variant {
  kBase = 0, kAlldoneV, kOneOut, kStaticOut, kNoScratch, kPrefetch2,
  kLinearV, kNumVariants
};

// The redesign's phases that su_micro_floor runs: both, or one alone
// (phase B on the terms and ops that phase A left in the caller's scratch)
enum Phases { kTerms = 1, kFold = 2, kBothPhases = 3 };

// The flags of each variant (a visit variant's W is 128).
__host__ __device__ constexpr int variant_flags(int variant) {
  return variant == kBase        ? kFirst | kScratch | kTwoOut
         : variant == kAlldoneV  ? kFirst | kScratch | kAlldone
         : variant == kOneOut || variant == kStaticOut ? kFirst | kScratch
         : variant == kNoScratch ? kFirst
         : variant == kPrefetch2 ? kScratch
                                 : kLinear;
}

}  // namespace su_floor

namespace su_floor90 {

using namespace su_floor;

constexpr int kAWarps = 8;        // phase A: positions a block, a warp each
constexpr int kBWarps = 4;        // phase B: output blocks a block
constexpr int kLanePos = 16;      // phase B: positions a lane a window
constexpr int kWin = 32 * kLanePos;

enum Op : unsigned { kOpZero = 1, kOpAdd = 2 };

// Phase A. Position i of the CSR (step v = order[i]): its op byte, and
// for a step that adds its term. W is the lane block's width, F the
// variant's flags (kFirst and kLinear are read here).
template <int W, int F>
__global__ void __launch_bounds__(kAWarps * 32)
floor_terms(const float* __restrict__ rec, long long lanes,
            const int* __restrict__ order, int n_pos,
            const int* __restrict__ chunk_of, const int* __restrict__ first,
            float* __restrict__ term, unsigned char* __restrict__ op) {
  constexpr int kVec = W / 128;   // float4 per lane per row
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kAWarps + (threadIdx.x >> 5);
  if (i >= n_pos) return;
  const int v = order[i];
  const int f = (F & kFirst) ? first[v] : 0;
  const unsigned o = f > 0 ? kOpZero | kOpAdd : f == 0 ? kOpAdd : 0u;
  if (o == 0u) {                  // a no-op step loads nothing more
    if (lane == 0) op[i] = 0;
    return;
  }
  const long long c = (F & kLinear) ? v : chunk_of[v];
  const float* base = rec + c * W;
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < kRec; ++r) {
    const float4* row =
        reinterpret_cast<const float4*>(base + (long long)r * lanes);
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const float4 x = row[lane + 32 * q];
      s += (x.x + x.y) + (x.z + x.w);
    }
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, k);
  if (lane == 0) {
    term[i] = s * 1e-30f;
    op[i] = (unsigned char)o;
  }
}

// The bytes k = 4 j .. 4 j + 3 of a lane's 16 ops that lie in [lo, hi).
__device__ __forceinline__ unsigned keep_bytes(int lo, int hi, int j) {
  unsigned m = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int k = 4 * j + b;
    if (k >= lo && k < hi) m |= 0xffu << (8 * b);
  }
  return m;
}

struct Window {
  float4 t[kLanePos / 4];
  uint4 o;
};

// A lane's 16 positions p0 .. p0 + 15 of a window; nothing past `end`.
__device__ __forceinline__ Window load_window(const float* term,
                                              const unsigned char* op,
                                              int p0, int end) {
  Window w;
  if (p0 < end) {
#pragma unroll
    for (int k = 0; k < kLanePos / 4; ++k)
      w.t[k] = reinterpret_cast<const float4*>(term + p0)[k];
    w.o = *reinterpret_cast<const uint4*>(op + p0);
  } else {
#pragma unroll
    for (int k = 0; k < kLanePos / 4; ++k)
      w.t[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    w.o = make_uint4(0u, 0u, 0u, 0u);
  }
  return w;
}

// The warp's 16-byte stores of one output block's 24 KB.
__device__ __forceinline__ void store_block(float4* p, float4 v, int lane) {
#pragma unroll 4
  for (int k = lane; k < kPix * kCh / 4; k += 32) p[k] = v;
}

// The warp's scratch, [32, kScratchW] with a row per lane, stored column
// by column so that the lanes' stores to one column hit 32 banks.
__device__ __forceinline__ volatile float* scratch_at(volatile float* vs,
                                                      int row, int col) {
  return vs + col * 32 + row;
}

// One position of the fold: op byte o, its term t. The add and the
// scratch store are selected and predicated, not branched around, so a
// lane group's 16 positions run without a branch; with o a constant (a
// group of plain adds) only the adds remain.
template <int F>
__device__ __forceinline__ void fold_step(unsigned o, float t, float& acc,
                                          float& sc, volatile float* vs,
                                          int lane) {
  if (o & kOpZero) acc = 0.0f;
  bool add = (o & kOpAdd) != 0u;
  if (F & kAlldone) {
    // scratch[0][1] gates the add, read after the barrier that orders it
    // after this position's zeroing of column 1 (column 2, which nothing
    // reads, takes the store of a position that does not zero)
    __syncwarp();
    *scratch_at(vs, lane, (o & kOpZero) ? 1 : 2) = 0.0f;
    __syncwarp();
    add = add && !(*scratch_at(vs, 0, 1) > 1.5f);
  }
  const float sum = acc + t;
  acc = add ? sum : acc;
  if (F & kScratch) {
    const float scaled = sc * 0.999f;
    sc = add ? scaled : sc;
    if (add) *scratch_at(vs, lane, 0) = sc;
  }
}

// A lane group: lane src's 16 positions of the window, its ops (with
// the positions outside the segment cleared) and terms, by shuffle.
struct Group {
  unsigned o[4];
  float t[kLanePos];
};

__device__ __forceinline__ Group fetch_group(const Window& cur,
                                             const unsigned (&ow)[4],
                                             int src) {
  Group g;
#pragma unroll
  for (int j = 0; j < 4; ++j) g.o[j] = __shfl_sync(0xffffffffu, ow[j], src);
#pragma unroll
  for (int k = 0; k < kLanePos / 4; ++k) {
    g.t[4 * k] = __shfl_sync(0xffffffffu, cur.t[k].x, src);
    g.t[4 * k + 1] = __shfl_sync(0xffffffffu, cur.t[k].y, src);
    g.t[4 * k + 2] = __shfl_sync(0xffffffffu, cur.t[k].z, src);
    g.t[4 * k + 3] = __shfl_sync(0xffffffffu, cur.t[k].w, src);
  }
  return g;
}

constexpr unsigned kAdds = kOpAdd * 0x01010101u;

// Whether every position of a group's 4 op words adds (kOnlyAdds: adds
// and nothing else).
template <bool kOnlyAdds>
__device__ __forceinline__ bool all_add(const unsigned (&o)[4]) {
  bool r = true;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r = r & (kOnlyAdds ? o[j] == kAdds : (o[j] & kAdds) == kAdds);
  return r;
}

// A group's 16 positions in order. kShape: 2 every position a plain add
// (nothing to select), 1 every position adds (the add a constant; the
// zeroing selects), 0 anything.
template <int F, int kShape>
__device__ __forceinline__ void fold_shape(const Group& g, float& acc,
                                           float& sc, volatile float* vs,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < kLanePos; ++k) {
    const unsigned o = (g.o[k >> 2] >> (8 * (k & 3))) & 0xffu;
    fold_step<F>(kShape == 2   ? (unsigned)kOpAdd
                 : kShape == 1 ? kOpAdd | (o & kOpZero)
                               : o,
                 g.t[k], acc, sc, vs, lane);
  }
}

template <int F>
__device__ __forceinline__ void fold_group(const Group& g, float& acc,
                                           float& sc, volatile float* vs,
                                           int lane) {
  if (all_add<true>(g.o))
    fold_shape<F, 2>(g, acc, sc, vs, lane);
  else if (all_add<false>(g.o))
    fold_shape<F, 1>(g, acc, sc, vs, lane);
  else
    fold_shape<F, 0>(g, acc, sc, vs, lane);
}

// A window whose 512 positions all lie in the segment and all add: its 32
// lane groups folded in order, four to a straight run of code, so that
// one group's shuffles overlap the fold before it and no test runs
// between them.
template <int F, int kShape>
__device__ __forceinline__ void fold_window(const Window& cur,
                                            const unsigned (&ow)[4],
                                            float& acc, float& sc,
                                            volatile float* vs, int lane) {
#pragma unroll 4
  for (int src = 0; src < 32; ++src)
    fold_shape<F, kShape>(fetch_group(cur, ow, src), acc, sc, vs, lane);
}

// Phase B. F is the variant's flags (kScratch, kAlldone and kTwoOut are
// read here).
template <int F>
__global__ void __launch_bounds__(kBWarps * 32)
floor_fold(const int* __restrict__ offsets,
           const int* __restrict__ seg_order, int n_blocks,
           const float* __restrict__ term,
           const unsigned char* __restrict__ op, float* __restrict__ out0,
           float* __restrict__ out1) {
  __shared__ float scratch[(F & kScratch) ? kBWarps * 32 * kScratchW : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kBWarps + warp;
  if (w >= n_blocks) return;
  const int blk = seg_order[w];
  const int s = offsets[blk];
  const int e = offsets[blk + 1];
  volatile float* vs = scratch + warp * 32 * kScratchW;
  float sc = 0.0f;                      // the lane's scratch[lane][0]
  if (F & kScratch) {
#pragma unroll
    for (int k = 0; k < kScratchW; ++k) *scratch_at(vs, lane, k) = 0.0f;
    __syncwarp();
    sc = *scratch_at(vs, lane, 0);
  }
  float acc = 0.0f;
  int w0 = s & ~(kLanePos - 1);         // windows aligned to 16 positions
  Window next = load_window(term, op, w0 + lane * kLanePos, e);
  for (; w0 < e; w0 += kWin) {
    const Window cur = next;
    next = load_window(term, op, w0 + kWin + lane * kLanePos, e);
    const int p0 = w0 + lane * kLanePos;
    const int lo = s - p0, hi = e - p0;
    const unsigned ow[4] = {cur.o.x & keep_bytes(lo, hi, 0),
                            cur.o.y & keep_bytes(lo, hi, 1),
                            cur.o.z & keep_bytes(lo, hi, 2),
                            cur.o.w & keep_bytes(lo, hi, 3)};
    unsigned work =
        __ballot_sync(0xffffffffu, (ow[0] | ow[1] | ow[2] | ow[3]) != 0u);
    if (work == 0u) continue;
    if (__all_sync(0xffffffffu, all_add<true>(ow))) {
      fold_window<F, 2>(cur, ow, acc, sc, vs, lane);
      continue;
    }
    if (__all_sync(0xffffffffu, all_add<false>(ow))) {
      fold_window<F, 1>(cur, ow, acc, sc, vs, lane);
      continue;
    }
    // the lane groups with work, lowest first, each group's shuffles
    // issued before the group before it is folded
    Group g = fetch_group(cur, ow, __ffs(work) - 1);
    work &= work - 1u;
    while (true) {
      const bool more = work != 0u;
      Group h;
      if (more) {
        h = fetch_group(cur, ow, __ffs(work) - 1);
        work &= work - 1u;
      }
      fold_group<F>(g, acc, sc, vs, lane);
      if (!more) break;
      g = h;
    }
  }
  store_block(reinterpret_cast<float4*>(out0 + (size_t)blk * kPix * kCh),
              make_float4(acc, acc, acc, acc), lane);
  if (F & kTwoOut)
    store_block(reinterpret_cast<float4*>(out1 + (size_t)blk * kPix * kCh),
                make_float4(0.0f, 0.0f, 0.0f, 0.0f), lane);
}

template <int W, int F>
cudaError_t launch_terms(const float* rec, long long lanes, const int* order,
                         int n_pos, const int* chunk_of, const int* first,
                         float* term, unsigned char* op, cudaStream_t s) {
  if (n_pos == 0) return cudaSuccess;
  floor_terms<W, F><<<(n_pos + kAWarps - 1) / kAWarps, kAWarps * 32, 0, s>>>(
      rec, lanes, order, n_pos, chunk_of, first, term, op);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_fold(const int* offsets, const int* seg_order,
                        int n_blocks, const float* term,
                        const unsigned char* op, float* out0, float* out1,
                        cudaStream_t s) {
  floor_fold<F><<<(n_blocks + kBWarps - 1) / kBWarps, kBWarps * 32, 0, s>>>(
      offsets, seg_order, n_blocks, term, op, out0, out1);
  return cudaGetLastError();
}

// The phases `phases` of `variant` at width `sblock` (checked by the
// caller).
inline cudaError_t run(int variant, int sblock, const float* rec,
                       long long lanes, const int* order,
                       const int* offsets, const int* seg_order,
                       int n_blocks, int n_pos, const int* chunk_of,
                       const int* first, float* term, unsigned char* op,
                       float* out0, float* out1, int phases,
                       cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (phases & kTerms) {
    switch (variant) {
      case kPrefetch2:
        err = launch_terms<128, kScratch>(rec, lanes, order, n_pos, chunk_of,
                                          first, term, op, s);
        break;
      case kLinearV:
        err = sblock == 128
                  ? launch_terms<128, kLinear>(rec, lanes, order, n_pos,
                                               chunk_of, first, term, op, s)
              : sblock == 256
                  ? launch_terms<256, kLinear>(rec, lanes, order, n_pos,
                                               chunk_of, first, term, op, s)
                  : launch_terms<512, kLinear>(rec, lanes, order, n_pos,
                                               chunk_of, first, term, op, s);
        break;
      default:
        err = launch_terms<128, kFirst>(rec, lanes, order, n_pos, chunk_of,
                                        first, term, op, s);
    }
    if (err != cudaSuccess) return err;
  }
  if (!(phases & kFold)) return cudaSuccess;
  constexpr int kMask = kScratch | kAlldone | kTwoOut;
  switch (variant_flags(variant) & kMask) {
    case kScratch | kTwoOut:
      return launch_fold<kScratch | kTwoOut>(offsets, seg_order, n_blocks,
                                             term, op, out0, out1, s);
    case kScratch | kAlldone:
      return launch_fold<kScratch | kAlldone>(offsets, seg_order, n_blocks,
                                              term, op, out0, out1, s);
    case kScratch:
      return launch_fold<kScratch>(offsets, seg_order, n_blocks, term, op,
                                   out0, out1, s);
    default:
      return launch_fold<0>(offsets, seg_order, n_blocks, term, op, out0,
                            out1, s);
  }
}

}  // namespace su_floor90
