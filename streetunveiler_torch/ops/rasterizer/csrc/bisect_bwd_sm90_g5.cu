// T2 on K2's H100 design — the measurement variants of
// blend_bwd_sm90.cuh's kernel at nq = 12, G = 5 gated chains (the late
// step's record stream); the C interface and the (6, 0) instantiations
// are in bisect_bwd_sm90.cu.

#include "blend_bwd_sm90.cuh"

namespace su_bwd90 {

cudaError_t bisect_sm90_g5(int variant, SU_BWD90_PARAMS) {
  return launch_variant<12, 5>(variant, SU_BWD90_ARGS);
}

}  // namespace su_bwd90
