// The fused SQP kernel in LTV mode (reference C8): the affine policy
// Ltv<NX, NU> for the (nx, nu) of the registered models, (8, 4), (4, 2),
// (4, 1) and (2, 1).  The kernel and its launcher: fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kLtvShapes)
