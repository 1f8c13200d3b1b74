// T7 and T8 — the identity copies of tools/probe_compose4.py and
// tools/probe_tax.py on an H100.
//
// Replaces the Pallas kernels of `pallas_identity` (probe_compose4.py:39,
// body `k` :48, launched at :51) and `_pallas_identity` (probe_tax.py:66,
// body `k` :72, launched at :75). On the TPU they re-produced the blend
// kernel's visit arrays as a custom call, to ask whether the producer of a
// scalar-prefetch operand changes what the blend kernel costs. The same
// function: dst = src for n int32 values (the wrappers pad each array with
// zeros to a multiple of 128 and stack several first, as the tools do).
//
// What bounds it on an H100: bytes, n * 4 read and n * 4 written; at the
// probes' sizes (tens of kB) the launch dominates. Two designs:
// su_identity is the redesign (identity_sm90.cuh: a grid that covers n
// once, two int4s a thread); su_identity_first the first design, a
// grid-stride loop of 16-byte loads and stores with 64-bit indices.
// The measurement of a copy in a CUDA graph against `clone`'s memcpy node
// lives apart, in identity_split.cu.

#include <cuda_runtime.h>

#include "identity_first.cuh"
#include "identity_sm90.cuh"

// src, dst [n] int32, n a positive multiple of 128. Returns
// cudaGetLastError().
extern "C" int su_identity(const int* src, int* dst, long long n, int device,
                           void* stream) {
  if (su_copy::bad_length(n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  su_copy::launch(src, dst, n / 4, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The first design, with the same arguments: 256 threads a block, as many
// blocks as cover n up to 1,024, each thread striding over the rest.
extern "C" int su_identity_first(const int* src, int* dst, long long n,
                                 int device, void* stream) {
  if (n < 128 || n % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n4 = n / 4;
  const long long blocks = (n4 + 255) / 256;
  su_copy::copy_int4<256><<<(int)(blocks < 1024 ? blocks : 1024), 256, 0,
                             (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(dst), n4);
  return (int)cudaGetLastError();
}
