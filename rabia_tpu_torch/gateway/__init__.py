"""Client gateway subsystem: the cluster's front door.

Exactly-once client sessions, linearizable read-index reads, and
admission control over the native transport — see
:mod:`rabia_tpu_torch.gateway.server` for the service and
:mod:`rabia_tpu_torch.gateway.client` for the client library.

The port's copy of the reference's ``rabia_tpu/gateway/__init__.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from rabia_tpu_torch.gateway.client import (
    BackpressureError,
    GatewayError,
    RabiaClient,
    admin_fetch,
)
from rabia_tpu_torch.gateway.server import (
    GatewayConfig,
    GatewayEndpoint,
    GatewayServer,
    GatewayStats,
    devkv_read_handler,
    kv_read_handler,
)
from rabia_tpu_torch.gateway.session import (
    CachedResult,
    GatewaySession,
    SessionTable,
)

__all__ = [
    "BackpressureError",
    "CachedResult",
    "GatewayConfig",
    "GatewayEndpoint",
    "GatewayError",
    "GatewayServer",
    "GatewaySession",
    "GatewayStats",
    "RabiaClient",
    "SessionTable",
    "admin_fetch",
    "devkv_read_handler",
    "kv_read_handler",
]
