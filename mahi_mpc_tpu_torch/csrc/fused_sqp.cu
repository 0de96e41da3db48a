// The fused SQP kernel for the serial arms (`mahi_arm`, `two_link_arm`)
// under the forward-Euler step, NQ = 2 and 4: the group body
// (fused_sqp_group.cuh, four threads an instance) for the nq-row policy
// FastNq<ArmModel<NQ>>.  The kernels and the launcher:
// fused_sqp_launch.cuh.
#include "fused_sqp_launch.cuh"

MPC_FUSED_LIBRARY(mpc::kArmFast)

// Blocks of the group kernel that fit on one SM at once (registers and
// shared memory), for NQ = 2 or 4; -1 for another NQ, or the CUDA error
// code negated.
extern "C" int mpc_fused_group_blocks_per_sm(int nq) {
  auto query = [](auto kernel, size_t smem) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return -(int)e;
    }
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kGroupThreads, smem);
    return e == cudaSuccess ? n : -(int)e;
  };
  auto smem = [](int size) {
    return sizeof(float) * size * kGroupsPerBlock;
  };
  if (nq == 2)
    return query(fused_sqp_group_kernel<2>,
                 smem(mpc::GroupTile<4, 2, 2>::kSize));
  if (nq == 4)
    return query(fused_sqp_group_kernel<4>,
                 smem(mpc::GroupTile<8, 4, 4>::kSize));
  return -1;
}
