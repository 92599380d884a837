"""Typed SMR applications: counter, sharded KV store, banking.

The port's copy of the reference's ``rabia_tpu/apps``: the counter, the
KV store with its notifications and binary op codec, banking, the
shard-routing state machine and the sharded KV service, the columnar
vector KV store and (in :mod:`rabia_tpu_torch.apps.device_kv`) the
device-resident KV table. The native apply plane
(``apps/native_store.py``) is not ported yet (ROADMAP Queue 1 item 7.3).
"""

from rabia_tpu_torch.apps.banking import (
    Account,
    BankCommand,
    BankingSMR,
    BankOp,
    BankResponse,
)
from rabia_tpu_torch.apps.counter import (
    CounterCommand,
    CounterOp,
    CounterResponse,
    CounterSMR,
    CounterState,
)
from rabia_tpu_torch.apps.kvstore import (
    ChangeNotification,
    ChangeType,
    KVOperation,
    KVOpType,
    BatchResult,
    KVResult,
    KVResultKind,
    OperationBatch,
    KVStore,
    KVStoreSMR,
    NotificationBus,
    NotificationFilter,
    StoreError,
    StoreErrorKind,
    shard_for_key,
)
from rabia_tpu_torch.apps.sharded import (
    ShardedKVService,
    ShardedStateMachine,
    make_sharded_kv,
)
from rabia_tpu_torch.apps.vector_kv import (
    VectorKVStore,
    VectorShardedKV,
)

__all__ = [
    "Account",
    "BankCommand",
    "BankOp",
    "BankResponse",
    "BankingSMR",
    "ChangeNotification",
    "ChangeType",
    "CounterCommand",
    "CounterOp",
    "CounterResponse",
    "CounterSMR",
    "CounterState",
    "KVOpType",
    "KVOperation",
    "BatchResult",
    "KVResult",
    "KVResultKind",
    "OperationBatch",
    "KVStore",
    "KVStoreSMR",
    "NotificationBus",
    "NotificationFilter",
    "ShardedKVService",
    "ShardedStateMachine",
    "StoreError",
    "StoreErrorKind",
    "VectorKVStore",
    "VectorShardedKV",
    "make_sharded_kv",
    "shard_for_key",
]
