"""Training across cards (port of ``kmunet_tpu/parallel/``): the device mesh,
its sharding rules and the collectives the trainer runs over it."""

from kmunet_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    MeshSpec,
    batch_sharding,
    init_distributed,
    make_mesh,
    param_sharding_rules,
    replicated,
    shard_params,
)

__all__ = [
    "Axis",
    "Mesh",
    "MeshSpec",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_params",
    "param_sharding_rules",
    "init_distributed",
]
