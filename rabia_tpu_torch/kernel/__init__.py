"""Device kernels of the port: the weak-MVC phase driver (its rounds,
slot pipelines and start_slot a CUDA kernel, ``cluster_round``, + plain
versions), one node's kernel (``NodeKernel``: a tick a launch of the
CUDA kernel ``node_kernel``, + plain versions), the
fused fault-free window (CUDA kernels for both vote layouts + plain
versions), the packed window and its packers (CUDA kernels + plain versions), the mesh
window (CUDA kernel) and the device KV table's wave scan (CUDA kernel,
with the window's decision folded in + plain versions)."""

from rabia_tpu_torch.kernel.phase_driver import (  # noqa: F401
    R1_WAIT,
    R2_WAIT,
    ClusterKernel,
    ClusterState,
    NodeKernel,
    NodeOutbox,
    NodeState,
    coin_threshold,
    device_coin,
    pack_phase,
    unpack_phase,
)
