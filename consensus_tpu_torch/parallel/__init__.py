"""Device meshes, sharding layout, the data-parallel train step and ring
attention (PyTorch port of ``consensus_tpu/parallel``).

One process drives every card of the mesh, as one JAX controller drives
``jax.devices()``.  The serving path (``TorchBackend(dp=N)`` ->
``DecodeEngine`` -> ``serve``) runs data-parallel over the mesh's dp
shards; tensor parallelism is layout only here (ROADMAP.md, queue A15).
"""

from consensus_tpu_torch.parallel.mesh import (
    PARTITION_RULES,
    MeshPlan,
    batch_sharding,
    make_mesh,
    match_partition_rules,
    param_shardings,
    parse_mesh_spec,
    shard_batch,
    shard_params,
)
from consensus_tpu_torch.parallel.train import init_train_state, lm_loss, train_step

__all__ = [
    "PARTITION_RULES",
    "MeshPlan",
    "batch_sharding",
    "make_mesh",
    "match_partition_rules",
    "param_shardings",
    "parse_mesh_spec",
    "shard_batch",
    "shard_params",
    "train_step",
    "init_train_state",
    "lm_loss",
]
