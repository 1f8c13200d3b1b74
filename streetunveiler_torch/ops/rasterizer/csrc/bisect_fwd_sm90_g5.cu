// T1 on K1's H100 design — the measurement variants of
// blend_fwd_sm90.cuh's kernel at nq = 12, G = 5 gated chains (the late
// step's record stream); the C interface and the (6, 0) instantiations
// are in bisect_fwd_sm90.cu.

#include "blend_fwd_sm90.cuh"

namespace su_fwd90 {

cudaError_t bisect_sm90_g5(int variant, SU_FWD90_PARAMS) {
  return launch_variant<12, 5>(variant, SU_FWD90_ARGS);
}

}  // namespace su_fwd90
