"""Scenario-batch meshes, multi-process runs and horizon sharding (port of
``mahi_mpc_tpu/parallel``)."""

from .mesh import (Mesh, batch_spec, gather_batch, make_fused_sharded_solver,
                   make_mesh, make_sharded_solver, scaling_report,
                   shard_params, split_batch)
from .distributed import (global_batch_mesh, initialize_distributed,
                          local_devices, make_global_array, process_allgather,
                          scaling_table, shard_params_global)
from .time_shard import enable_time_shard_backend, solve_lqr_time_sharded

__all__ = [
    "make_mesh", "batch_spec", "shard_params", "make_sharded_solver",
    "scaling_report",
    "initialize_distributed", "global_batch_mesh", "make_global_array",
    "shard_params_global", "scaling_table",
    "solve_lqr_time_sharded",
    "Mesh", "split_batch", "gather_batch", "make_fused_sharded_solver",
    "local_devices", "process_allgather", "enable_time_shard_backend",
]
