// The fused SQP kernel for the serial arms (`mahi_arm`, `two_link_arm`)
// under the forward-Euler step, NQ = 2 and 4: the group body
// (fused_sqp_group.cuh, four threads an instance) for the nq-row policy
// FastNq<ArmModel<NQ>>.  The kernels and the launcher:
// fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kArmFast)
