"""Device kernels of the port: the weak-MVC phase driver, the fused
fault-free window (CUDA kernel + plain version), the packed window and
the device KV table's wave scan (CUDA kernel + plain version)."""

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
