// K1 — 2DGS blend forward with G = 1..kMaxGates gated per-class chains:
// the instantiations, one per (nq, G). The kernel, its math and its design
// are in blend_fwd_sm90.cuh.
//
// Gated chains are built at the payload widths the port blends them with,
// as for K2 (blend_bwd_gated.cu): nq = 6 (colour and normal) and nq = 12
// (with the 6-class semantic payload of the late training step); any
// other nq is refused, as the wrapper's GATED_NQ says.

#include "blend_fwd_sm90.cuh"

namespace su_fwd90 {

template <int NQ>
static cudaError_t launch_g(int n_gates, SU_FWD90_PARAMS) {
#define SU_FWD_GATES(G) \
  case G:               \
    return launch<NQ, G>(SU_FWD90_ARGS);
  switch (n_gates) {
    SU_FWD_GATES(1) SU_FWD_GATES(2) SU_FWD_GATES(3) SU_FWD_GATES(4)
    SU_FWD_GATES(5) SU_FWD_GATES(6)
  }
#undef SU_FWD_GATES
  return cudaErrorInvalidValue;
}

cudaError_t launch_gated(int n_gates, int nq, SU_FWD90_PARAMS) {
  if (nq == 6) return launch_g<6>(n_gates, SU_FWD90_ARGS);
  if (nq == 12) return launch_g<12>(n_gates, SU_FWD90_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace su_fwd90
