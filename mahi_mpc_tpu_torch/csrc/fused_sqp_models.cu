// The fused SQP kernel for the closed-form models (pendulum, cartpole,
// double_pendulum, acrobot; model_dynamics.cuh): the nq-row policy under
// Euler and the generic nx-row policy under midpoint and RK4, for each.
// The two-lane group body (fused_sqp_group.cuh) serves the generic policy
// of the cart-pole, the double pendulum and the acrobot and the nq-row
// policy of the double pendulum, and the block body (fused_sqp_block.cuh)
// that policy at small batch; the one-thread body (fused_sqp.cuh) the
// others (`GroupBody` and `BlockBody` say why).  The kernels and the launcher:
// fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kModels)
