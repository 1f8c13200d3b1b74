// The measurement of T7/T8's copy in a CUDA graph against `clone`'s memcpy
// node (chip_smoke.py's identity_gap_split and identity_path): the parts
// of a copy's cost on their own, and what a captured graph holds. Nothing
// but that measurement calls these entries.

#include <cuda_runtime.h>

#include "identity_first.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// The parts of a copy in a graph, for the measurement: kind 0 an empty
// kernel at <<<blocks, threads>>> (src, dst and n unused); kind 1 the
// first design's body at <<<blocks, threads>>>, threads up to 1,024, on
// n int32 values (a positive multiple of 128).
extern "C" int su_identity_split(int kind, int blocks, int threads,
                                 const int* src, int* dst, long long n,
                                 int device, void* stream) {
  if (kind < 0 || kind > 1 || blocks < 1 || threads < 1 || threads > 1024 ||
      (kind == 1 && (n < 128 || n % 128 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    empty_kernel<<<blocks, threads, 0, s>>>();
  else
    su_copy::copy_int4<1024><<<blocks, threads, 0, s>>>(
        reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(dst),
        n / 4);
  return (int)cudaGetLastError();
}

// What a captured CUDA graph holds: for each of its first `max` nodes its
// cudaGraphNodeType in types[i] and in info[2i], info[2i + 1] a kernel
// node's blocks and threads (-1 where the runtime cannot read them) or a
// memcpy node's bytes (and 0); for each of its first `max` edges its
// cudaGraphDependencyType (1: programmatic).
// *n_nodes and *n_edges get the counts. Returns a CUDA error code.
extern "C" int su_graph_nodes(void* graph, int max, int* types,
                              long long* info, int* n_nodes,
                              int* edge_types, int* n_edges) {
  if (max < 1 || max > 256) return (int)cudaErrorInvalidValue;
  cudaGraph_t g = (cudaGraph_t)graph;
  cudaGraphNode_t nodes[256];
  size_t n = max;
  cudaError_t err = cudaGraphGetNodes(g, nodes, &n);
  if (err != cudaSuccess) return (int)err;
  *n_nodes = (int)n;
  for (size_t i = 0; i < n && i < (size_t)max; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) return (int)err;
    types[i] = (int)t;
    info[2 * i] = info[2 * i + 1] = 0;
    if (t == cudaGraphNodeTypeKernel) {
      cudaKernelNodeParams p;
      if (cudaGraphKernelNodeGetParams(nodes[i], &p) == cudaSuccess) {
        info[2 * i] = (long long)p.gridDim.x * p.gridDim.y * p.gridDim.z;
        info[2 * i + 1] =
            (long long)p.blockDim.x * p.blockDim.y * p.blockDim.z;
      } else {
        // a kernel of another module (PyTorch's): its grid is not read
        cudaGetLastError();
        info[2 * i] = info[2 * i + 1] = -1;
      }
    } else if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p;
      err = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
      if (err != cudaSuccess) return (int)err;
      info[2 * i] = (long long)(p.extent.width * p.extent.height *
                                p.extent.depth);
    }
  }
  cudaGraphNode_t from[256], to[256];
  cudaGraphEdgeData data[256];
  size_t ne = max;
  err = cudaGraphGetEdges_v2(g, from, to, data, &ne);
  if (err != cudaSuccess) return (int)err;
  *n_edges = (int)ne;
  for (size_t i = 0; i < ne && i < (size_t)max; ++i)
    edge_types[i] = (int)data[i].type;
  return 0;
}
