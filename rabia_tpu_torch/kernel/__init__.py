"""Device kernels of the port: the weak-MVC phase driver (its rounds and
slot pipelines a CUDA kernel, ``cluster_round``, + plain versions), the
fused fault-free window (CUDA kernels for both vote layouts + plain
versions), the packed window (CUDA kernel + plain version), the mesh
window (CUDA kernel) and the device KV table's wave scan (CUDA kernel,
with the window's decision folded in + plain versions)."""

from rabia_tpu_torch.kernel.phase_driver import (  # noqa: F401
    R1_WAIT,
    R2_WAIT,
    ClusterKernel,
    ClusterState,
    coin_threshold,
    device_coin,
    pack_phase,
    unpack_phase,
)
