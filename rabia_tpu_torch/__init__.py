"""rabia_tpu_torch: the PyTorch/CUDA port of rabia_tpu.

Same layout as the reference package (``core/``, ``kernel/``,
``parallel/``, ``apps/``, and the transport engine's ``engine/``,
``net/``, ``persistence/``, ``obs/``, ``testing/``). It imports torch
and numpy, never jax and nothing of ``rabia_tpu``. Entry points
(``ClusterKernel``, ``MeshPhaseKernel``, ``MeshEngine``) run on CUDA
unless the caller passes ``device="cpu"``; the CUDA kernels
(``csrc/*.cu``) build with nvcc at their first launch. The transport
engine (``rabia_tpu_torch.engine.RabiaEngine``) is host code.
"""

from rabia_tpu_torch.kernel.phase_driver import ClusterKernel, ClusterState
from rabia_tpu_torch.parallel.mesh import MeshPhaseKernel, MeshPhaseState
from rabia_tpu_torch.parallel.mesh_engine import MeshEngine, MeshFuture

__all__ = [
    "ClusterKernel",
    "ClusterState",
    "MeshEngine",
    "MeshFuture",
    "MeshPhaseKernel",
    "MeshPhaseState",
]
