"""The port's device mesh: sharded segment batches and their combine.

Counterpart of pinot_tpu/parallel: a (segments, docs) mesh of torch
devices in one process (mesh.py), and the fixed-shape sharded query step
(distributed_query.py). The sharded and merged kernels live in
ops/kernels.py and ops/collective.py, the engine's mesh path in
ops/engine.py.
"""
from pinot_tpu_torch.parallel.mesh import (Mesh, ShardedBlock,
                                           default_devices, device_label,
                                           distinct_devices, make_mesh,
                                           segments_mesh, shard_block,
                                           shard_segments)

__all__ = ["Mesh", "ShardedBlock", "default_devices", "device_label",
           "distinct_devices", "make_mesh", "segments_mesh", "shard_block",
           "shard_segments", "distributed_query_step"]


def __getattr__(name):
    # distributed_query builds on ops/kernels.py, which imports this
    # package's mesh module: bind it on first use
    if name == "distributed_query_step":
        from pinot_tpu_torch.parallel.distributed_query import \
            distributed_query_step
        return distributed_query_step
    raise AttributeError(name)
