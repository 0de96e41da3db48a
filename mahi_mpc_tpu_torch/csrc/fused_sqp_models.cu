// The fused SQP kernel for the closed-form models (pendulum, cartpole,
// double_pendulum, acrobot; model_dynamics.cuh): the nq-row policy under
// Euler and the generic nx-row policy under midpoint and RK4, for each.
// The kernel and its launcher: fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kModels)
