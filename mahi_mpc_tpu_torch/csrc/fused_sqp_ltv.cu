// The fused SQP kernel in LTV mode (reference C8): the affine policy
// Ltv<NX, NU> for the (nx, nu) of the registered models.  (8, 4) runs the
// group body (fused_sqp_group.cuh, four threads an instance, the affine
// step held in the group's tile), and at small batch the block body
// (fused_sqp_block.cuh, a block an instance: the LTV single robot); (4, 2),
// (4, 1) and (2, 1) run the one-thread body (fused_sqp.cuh): the group
// body lost there on four lanes and on two (`GroupBody`).
// The kernels and the launcher: fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kLtvShapes)
