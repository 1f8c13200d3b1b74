// K2 — 2DGS blend backward with G = 1..kMaxGates gated per-class chains:
// the instantiations, one per (nq, G). The kernel, its math and its design
// are in blend_bwd_sm90.cuh.
//
// Gated chains are built only at the payload widths the port blends them
// with: nq = 6 (colour and normal) and nq = 12 (with the 6-class semantic
// payload of the late training step); any other nq is refused, as the
// wrapper's GATED_NQ says. Each (nq, G) pair is a full copy of the kernel,
// so every width more costs the build six instantiations.

#include "blend_bwd_sm90.cuh"

namespace su_bwd90 {

template <int NQ>
static cudaError_t launch_g(int n_gates, SU_BWD90_PARAMS) {
#define SU_BWD_GATES(G) \
  case G:               \
    return launch<NQ, G>(SU_BWD90_ARGS);
  switch (n_gates) {
    SU_BWD_GATES(1) SU_BWD_GATES(2) SU_BWD_GATES(3) SU_BWD_GATES(4)
    SU_BWD_GATES(5) SU_BWD_GATES(6)
  }
#undef SU_BWD_GATES
  return cudaErrorInvalidValue;
}

cudaError_t launch_gated(int n_gates, int nq, SU_BWD90_PARAMS) {
  if (nq == 6) return launch_g<6>(n_gates, SU_BWD90_ARGS);
  if (nq == 12) return launch_g<12>(n_gates, SU_BWD90_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace su_bwd90
