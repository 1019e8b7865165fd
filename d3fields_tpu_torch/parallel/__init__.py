"""Multi-device inference and training: meshes of devices, placement,
collectives and the field query split over devices (counterpart of
``d3fields_tpu/parallel``)."""

from d3fields_tpu_torch.parallel.mesh import (
    Mesh, ViewShards, gather_leading, initialize_distributed, make_mesh, replicate,
    shard_leading, shard_leading_checked)
from d3fields_tpu_torch.parallel.ops import (
    all_gather_points, average_gradients, broadcast_tensors, sync_batch_norm)
from d3fields_tpu_torch.parallel.sharded import sharded_batch_eval

__all__ = ["Mesh", "ViewShards", "all_gather_points", "average_gradients",
           "broadcast_tensors", "gather_leading",
           "initialize_distributed", "make_mesh", "replicate", "shard_leading",
           "shard_leading_checked", "sharded_batch_eval", "sync_batch_norm"]
