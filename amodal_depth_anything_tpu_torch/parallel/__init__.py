"""Scale-out on `torch.distributed`: the rank mesh, the sharding rules,
the GPipe trunk and the multi-process runtime (the JAX package's
`parallel/`)."""

from .mesh import MeshConfig, make_mesh
from .multihost import (gather_metrics, initialize, is_main_process,
                        process_count, process_index, sync_processes)
from .pipeline import pipeline_vit_blocks
from .sharding import (batch_sharding, param_sharding, replicate,
                       shard_batch, shard_params)

__all__ = ["MeshConfig", "make_mesh", "batch_sharding", "param_sharding",
           "replicate", "shard_batch", "shard_params",
           "initialize", "is_main_process", "process_index",
           "process_count", "sync_processes", "gather_metrics",
           "pipeline_vit_blocks"]
