"""Device meshes, sharding layout, tensor parallelism, the mesh train step
and ring attention (PyTorch port of ``consensus_tpu/parallel``).

One process drives every card of the mesh, as one JAX controller drives
``jax.devices()``.  The serving path (``TorchBackend(mesh="dp=N,tp=M")`` ->
``DecodeEngine`` -> ``serve``) runs data-parallel over the mesh's dp
shards, and each shard's model tensor-parallel over its row of tp cards
(``parallel/tensor.py``).
"""

from consensus_tpu_torch.parallel.tensor import (
    Ranked,
    TPParams,
    all_reduce,
    check_tp,
    gather_vocab,
    kv_heads_of_rank,
    local_config,
    q_columns_of_rank,
    q_heads_of_rank,
    replicate,
    tp_group,
    tp_params,
)
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
    unshard_params,
)

#: The train step imports the transformer, which imports this package's
#: ``tensor`` module: it loads on first use.
_TRAIN_NAMES = ("train_step", "init_train_state", "lm_loss")


def __getattr__(name):
    if name in _TRAIN_NAMES:
        from consensus_tpu_torch.parallel import train

        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PARTITION_RULES",
    "MeshPlan",
    "Ranked",
    "TPParams",
    "all_reduce",
    "batch_sharding",
    "check_tp",
    "gather_vocab",
    "kv_heads_of_rank",
    "local_config",
    "make_mesh",
    "match_partition_rules",
    "param_shardings",
    "parse_mesh_spec",
    "q_columns_of_rank",
    "q_heads_of_rank",
    "replicate",
    "shard_batch",
    "shard_params",
    "tp_group",
    "tp_params",
    "unshard_params",
    "train_step",
    "init_train_state",
    "lm_loss",
]
