"""Data parallelism over ``torch.distributed`` (PyTorch port of
:mod:`nerfacc_tpu.parallel`): one process per chip, a mesh of process
groups, ray batches sharded, parameters and the grid replicated,
gradients all-reduced and the grid's updates merged by MAX."""

from .sharding import (
    make_mesh,
    replicate,
    shard_batch,
    data_parallel,
    psum_grads,
    update_grid_distributed,
)
from .multihost import (
    init_distributed,
    make_host_mesh,
    batch_axes,
    shard_host_batch,
    psum_hierarchical,
)

__all__ = [
    "make_mesh",
    "replicate",
    "shard_batch",
    "data_parallel",
    "psum_grads",
    "update_grid_distributed",
    "init_distributed",
    "make_host_mesh",
    "batch_axes",
    "shard_host_batch",
    "psum_hierarchical",
]
