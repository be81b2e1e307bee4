"""Data-parallel training over ``torch.distributed`` (counterpart of
``vid2player3d_tpu/parallel``).

The reference trains with one simulator per GPU rank and Horovod
all-reduces; the JAX package runs one SPMD program over a device mesh. Here
each rank is a process: it owns a block of the envs, keeps a replica of the
params and the optimizer state, and runs the collectives the JAX partitioner
would insert (the gradient sum, the batch statistics, the local-SGD average)
explicitly. `shard` on the envs and `mesh=` on the learners select it;
``python -m vid2player3d_torch --n_devices D`` starts the ranks.
"""

from .mesh import (  # noqa: F401
    DataParallelMesh,
    EnvShard,
    all_gather_rows,
    all_reduce_sum,
    barrier,
    cross_shard_mean,
    data_parallel_mesh,
    draw_rows,
    flat_all_reduce,
    global_rows,
    init_process_group,
    initialize_distributed,
    replicate,
    shard_leading_axis,
    spawn,
)

__all__ = [
    "DataParallelMesh",
    "EnvShard",
    "all_gather_rows",
    "all_reduce_sum",
    "barrier",
    "cross_shard_mean",
    "data_parallel_mesh",
    "draw_rows",
    "flat_all_reduce",
    "global_rows",
    "init_process_group",
    "initialize_distributed",
    "replicate",
    "shard_leading_axis",
    "spawn",
]
