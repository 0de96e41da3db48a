// The fused SQP kernel for the serial arms (`mahi_arm`, `two_link_arm`)
// under the forward-Euler step, NQ = 2 and 4: the group body
// (fused_sqp_group.cuh, four threads an instance) for the nq-row policy
// FastNq<ArmModel<NQ>>, and for NQ = 4 at small batch the block body
// (fused_sqp_block.cuh, a block an instance).  The kernels and the
// launcher: fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kArmFast)
