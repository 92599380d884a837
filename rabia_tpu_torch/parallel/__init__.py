"""Device meshes, replica-parallel consensus and the device SMR engine."""

from rabia_tpu_torch.parallel.mesh import (
    REPLICA_AXIS,
    SHARD_AXIS,
    Mesh,
    MeshArray,
    MeshPhaseKernel,
    MeshPhaseState,
    ShardedClusterKernel,
    make_mesh,
)
from rabia_tpu_torch.parallel.mesh_engine import MeshBlockFuture, MeshEngine, MeshFuture

__all__ = [
    "REPLICA_AXIS",
    "SHARD_AXIS",
    "Mesh",
    "MeshArray",
    "MeshBlockFuture",
    "MeshEngine",
    "MeshFuture",
    "MeshPhaseKernel",
    "MeshPhaseState",
    "ShardedClusterKernel",
    "make_mesh",
]
