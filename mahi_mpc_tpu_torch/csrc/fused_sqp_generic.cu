// The fused SQP kernel for the serial arms under midpoint and RK4: the
// group body (fused_sqp_group.cuh, four threads an instance) for the
// generic nx-row policy Generic<ArmModel<NQ>>, NQ = 2 and 4, with the
// integrator a runtime argument.  The kernel and its launcher:
// fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kArmGeneric)
