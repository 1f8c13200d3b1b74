// T5 and T6 — the per-step floors of tools/micro_floor.py on an H100:
// their first design (`su_micro_floor_first`) and the C interface of both
// designs (`su_micro_floor` runs the redesign, micro_floor_sm90.cuh, which
// also holds the constants, flags and variants the two share).
//
//
// Replaces the two Pallas kernels of tools/micro_floor.py: the visit-stream
// floor (`build_visit` :60, kernel `kern` :67-105, launched at :115) and
// the linear walk (`build_linear` :140, kernel :145-146, launched at :149).
// They timed what one grid step of a walk over the record stream costs
// when the body does almost nothing. The function, with what the TPU
// leaves undefined defined as the Pallas interpreter runs it (outputs and
// scratch start at zero; a block that a step maps to but does not write
// keeps its value):
//   for each step v in stream order, with block = the step's output block
//   (tile_of[v], or 0 for `static_out`, or tile_map[v] for the linear walk)
//     first[v] > 0:  out[block] = 0 (every output)
//     first[v] >= 0: out[block] += sum(rec[:, chunk*W : (chunk+1)*W]) * 1e-30
//                    (added to each of the block's 512 x 12 elements)
//   `prefetch2` and the linear walk have no `first`: every step adds.
// So each output block holds one value, the f32 sum of its steps' terms
// folded in stream order after its last zeroing; a block no step writes
// stays zero.
//
// The TPU variants and their mechanism here (the variant index of
// su_micro_floor in brackets):
//   base       [0] the fold, plus a second output, zeroed only: 118 MB more
//                  stores.
//   alldone    [1] the add is gated by a scalar read of shared scratch
//                  (scratch[0][1] > 1.5, never true), two __syncthreads a
//                  step around it, as the TPU read vector scratch into a
//                  scalar register.
//   one_out    [2] the fold with scratch: each step scales the thread's
//                  scratch[p][0] by 0.999 through a volatile shared store.
//   static_out [3] every step maps to block 0: one thread block walks the
//                  whole stream in order (the wrapper's CSR puts every
//                  step in segment 0), so nothing races.
//   no_scratch [4] the fold without the scratch store.
//   prefetch2  [5] no `first` array: every step adds (the padding steps
//                  add the last chunk to tile 0).
//   linear     [6] T6: step v reads lane block v of width W = 128, 256 or
//                  512 and adds into tile_map[v]; no scratch.
// The scratch's value feeds no output, and nvcc deletes stores nothing
// reads: the scratch is written through a volatile pointer so that each
// step's store stays, as the TPU's VMEM store did.
//
// The first design: one thread block per output block walks its steps, which the
// wrapper lists in stream order as a CSR (a stable sort of the steps by
// block, as the port's binning does for K1). Tile 0's steps need not be
// contiguous in the stream (prefetch2 puts its padding steps at the end),
// so nothing assumes a run. The block takes its steps in batches of 64:
// each warp sums the chunks of 4 steps (float4 loads, a row at a time,
// then shuffle sums), lane 0 stores the sum in shared memory, and after
// a barrier every thread folds the batch in order into its own copy of
// the block's value (the same in every thread). Then the block stores its
// value to all 512 x 12 elements of its output block (and zeros to the
// second output for `base`).
//
// What bounds it on an H100: bytes. Each chunk a step adds is read once
// (24 x 128 f32, 12 KB; ~9,600 chunks at the tool's size, 118 MB), each
// output block written once (4,800 x 24 KB = 118 MB each); the sums are
// one add per element read. The linear walk reads the whole record array
// (173 MB). Steps that add nothing (padding with first = -1) load no
// chunk, but the block that owns them still walks them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "micro_floor_sm90.cuh"

namespace {

using namespace su_floor;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;        // steps per batch (4 per warp)

template <int W, int F>
__global__ void __launch_bounds__(kThreads)
floor_walk(const float* __restrict__ rec, long long lanes,
           const int* __restrict__ order, const int* __restrict__ offsets,
           const int* __restrict__ chunk_of, const int* __restrict__ first,
           float* __restrict__ out0, float* __restrict__ out1) {
  constexpr int kVec = W / 128;   // float4 per lane per row
  __shared__ float sums[kBatch];
  __shared__ int firsts[kBatch];
  __shared__ float scratch[(F & kScratch) ? kPix * kScratchW : 1];
  volatile float* vs = scratch;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int v0 = offsets[blk];
  const int v1 = offsets[blk + 1];
  if (F & kScratch) {
#pragma unroll
    for (int i = 0; i < kScratchW; ++i) vs[tid * kScratchW + i] = 0.0f;
  }
  float acc = 0.0f;
  for (int b0 = v0; b0 < v1; b0 += kBatch) {
    const int nb = min(kBatch, v1 - b0);
    for (int j = warp; j < nb; j += kWarps) {
      const int v = order[b0 + j];
      const int f = (F & kFirst) ? first[v] : 0;
      float s = 0.0f;
      if (f >= 0) {
        const long long c = (F & kLinear) ? v : chunk_of[v];
        const float* base = rec + c * W;
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
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      if (lane == 0) {
        sums[j] = s;
        firsts[j] = f;
      }
    }
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const int f = firsts[j];
      if ((F & kFirst) && f > 0) acc = 0.0f;
      bool add = f >= 0;
      if (F & kAlldone) {
        __syncthreads();   // every read of the step before is done
        if (f > 0) vs[tid * kScratchW + 1] = 0.0f;
        __syncthreads();
        add = add && !(vs[1] > 1.5f);
      }
      if (add) {
        acc = acc + sums[j] * 1e-30f;
        if (F & kScratch) vs[tid * kScratchW] = vs[tid * kScratchW] * 0.999f;
      }
    }
    __syncthreads();       // before the next batch overwrites sums
  }
  const float4 a4 = make_float4(acc, acc, acc, acc);
  float4* o = reinterpret_cast<float4*>(out0 + (size_t)blk * kPix * kCh);
  for (int i = tid; i < kPix * kCh / 4; i += kThreads) o[i] = a4;
  if (F & kTwoOut) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4* o1 = reinterpret_cast<float4*>(out1 + (size_t)blk * kPix * kCh);
    for (int i = tid; i < kPix * kCh / 4; i += kThreads) o1[i] = z;
  }
}

template <int W, int F>
cudaError_t launch(const float* rec, long long lanes, const int* order,
                   const int* offsets, int n_blocks, const int* chunk_of,
                   const int* first, float* out0, float* out1,
                   cudaStream_t s) {
  floor_walk<W, F><<<n_blocks, kThreads, 0, s>>>(rec, lanes, order, offsets,
                                                 chunk_of, first, out0, out1);
  return cudaGetLastError();
}

}  // namespace

// rec [24, lanes] f32 (row-major); order [steps] and offsets [n_blocks + 1]
// int32, the CSR of the steps by output block in stream order; chunk_of
// and first [steps] int32 (first unused by prefetch2, neither by the
// linear walk); out0 (and out1 for base) [n_blocks, 512, 12] f32, every
// element written. variant: 0 base, 1 alldone, 2 one_out, 3 static_out,
// 4 no_scratch, 5 prefetch2 (sblock 128), 6 linear (sblock 128, 256 or
// 512). lanes must be a multiple of sblock. Returns cudaGetLastError().
// The first design.
extern "C" int su_micro_floor_first(int variant, int sblock, const float* rec,
                                    long long lanes, const int* order,
                                    const int* offsets, int n_blocks,
                                    const int* chunk_of, const int* first,
                                    float* out0, float* out1, int device,
                                    void* stream) {
  if (variant < 0 || variant >= kNumVariants || n_blocks < 1 ||
      lanes < sblock || lanes % sblock != 0 ||
      (variant != kLinearV && sblock != 128) ||
      (variant == kBase && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  using Launch = cudaError_t (*)(const float*, long long, const int*,
                                 const int*, int, const int*, const int*,
                                 float*, float*, cudaStream_t);
  Launch fn = nullptr;
  switch (variant) {
    case kBase: fn = launch<128, variant_flags(kBase)>; break;
    case kAlldoneV: fn = launch<128, variant_flags(kAlldoneV)>; break;
    case kOneOut:
    case kStaticOut: fn = launch<128, variant_flags(kOneOut)>; break;
    case kNoScratch: fn = launch<128, variant_flags(kNoScratch)>; break;
    case kPrefetch2: fn = launch<128, variant_flags(kPrefetch2)>; break;
    default:
      fn = sblock == 128   ? launch<128, kLinear>
           : sblock == 256 ? launch<256, kLinear>
           : sblock == 512 ? launch<512, kLinear>
                           : nullptr;
  }
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(rec, lanes, order, offsets, n_blocks, chunk_of, first, out0,
                 out1, (cudaStream_t)stream);
}

// The same function by the redesign (micro_floor_sm90.cuh): the first
// design's arguments, and seg_order [n_blocks] int32 (the order in which
// phase B takes the output blocks, a permutation); n_pos = offsets[n_blocks],
// the CSR's positions; work, the scratch of the two phases, 16-byte
// aligned: term f32 then op uint8, each n_pos rounded up to 16 long (5
// bytes a position). phases: su_floor::Phases, both (kBothPhases) or one
// alone (kFold reads the terms and ops that kTerms left in work).
extern "C" int su_micro_floor(int variant, int sblock, const float* rec,
                              long long lanes, const int* order,
                              const int* offsets, const int* seg_order,
                              int n_blocks, int n_pos, const int* chunk_of,
                              const int* first, void* work, float* out0,
                              float* out1, int phases, int device,
                              void* stream) {
  if (variant < 0 || variant >= kNumVariants || n_blocks < 1 || n_pos < 0 ||
      lanes < sblock || lanes % sblock != 0 ||
      (variant != kLinearV && sblock != 128) ||
      (variant == kLinearV && sblock != 128 && sblock != 256 &&
       sblock != 512) ||
      (variant == kBase && out1 == nullptr) || phases < 1 ||
      phases > kBothPhases || (uintptr_t)work % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  float* term = static_cast<float*>(work);
  unsigned char* op =
      static_cast<unsigned char*>(work) + 4 * (size_t)((n_pos + 15) & ~15);
  return (int)su_floor90::run(variant, sblock, rec, lanes, order, offsets,
                              seg_order, n_blocks, n_pos, chunk_of, first,
                              term, op, out0, out1, phases,
                              (cudaStream_t)stream);
}
