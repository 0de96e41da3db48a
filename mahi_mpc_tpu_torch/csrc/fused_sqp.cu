// The fused SQP kernel for the serial arms (`mahi_arm`, `two_link_arm`)
// under the forward-Euler step: the nq-row policy FastNq<ArmModel<NQ>>,
// NQ = 2 and 4.  The kernel and its launcher: fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kArmFast)
