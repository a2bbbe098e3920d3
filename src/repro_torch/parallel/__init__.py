"""Tensor parallelism on ``torch.distributed``: meshes and ranks, and
the serving replicas' device rows (``mesh``), logical-axis sharding
rules (``sharding``) and the collective edges (``collectives``)."""

from .mesh import (BATCH_AXES, DATA_AXIS, MODEL_AXIS, POD_AXIS, Mesh,
                   active_mesh, axis_group, batch_shards, dp_submeshes,
                   host_devices, make_host_mesh, mesh_axis_sizes,
                   single_device_mesh, spawn, use_mesh)
from .sharding import (DECODE_TP_RULES, DEFAULT, ShardingRules,
                       local_shape, resolve_spec, shard_leaf, tree_count,
                       tree_nbytes, tree_specs)

__all__ = [
    "BATCH_AXES", "DATA_AXIS", "MODEL_AXIS", "POD_AXIS", "Mesh",
    "active_mesh", "axis_group", "batch_shards", "dp_submeshes",
    "host_devices", "make_host_mesh", "mesh_axis_sizes", "single_device_mesh", "spawn", "use_mesh",
    "DECODE_TP_RULES", "DEFAULT", "ShardingRules", "local_shape",
    "resolve_spec", "shard_leaf", "tree_count", "tree_nbytes", "tree_specs",
]
