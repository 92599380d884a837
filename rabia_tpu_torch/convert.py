"""State carried between the reference package and the port.

The port has no weights: what carries across is protocol state and the
engine checkpoint. Everything crosses as plain numpy arrays, ints and
bytes, so neither package imports the other:

- ``cluster_state_from_numpy`` / ``cluster_state_to_numpy`` convert the
  fields of a ``ClusterState`` (the reference's field names and dtypes)
  to and from the port's tensors, so a reference state taken
  mid-protocol continues under the port's ``round_step``;
- ``mesh_state_from_numpy`` / ``mesh_state_to_numpy`` do the same for
  ``MeshPhaseState``, ``mesh_state_to_blocks`` / ``mesh_state_from_blocks``
  cut its full ``[S, R]`` fields into a mesh's blocks and join them
  back, and ``node_state_from_numpy`` /
  ``node_state_to_numpy`` for one node's ``NodeState``;
- ``engine_state_from_jax`` builds the port's ``PersistedEngineState``
  from the plain fields of a reference ``MeshEngine.checkpoint()``, so a
  reference engine's checkpoint restores into a port engine;
- ``device_table_from_numpy`` / ``device_table_to_numpy`` convert the
  seven arrays of a device KV table (a reference ``DeviceKVTable.state``
  fetched as numpy, u32 words and all) to and from the port's
  ``KVTable``, so a reference table loads into the port and the two are
  compared field by field; ``device_table_to_blocks`` /
  ``device_table_from_blocks`` cut them into a mesh's shard blocks (the
  layout ``DeviceKVTable`` keeps over a mesh, and the reference's
  ``P("shard")``) and join them back.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from rabia_tpu_torch.core.device import DeviceLike
from rabia_tpu_torch.core.persistence import PersistedEngineState
from rabia_tpu_torch.core.state_machine import Snapshot
from rabia_tpu_torch.kernel.kv_window import KVTable
from rabia_tpu_torch.kernel.phase_driver import ClusterState, NodeState
from rabia_tpu_torch.parallel.mesh import MeshPhaseState

_CLUSTER_DTYPES = {
    "slot": torch.int32,
    "phase": torch.int32,
    "stage": torch.int8,
    "my_r1": torch.int8,
    "my_r2": torch.int8,
    "prev_r1": torch.int8,
    "prev_r2": torch.int8,
    "led1": torch.int8,
    "led2": torch.int8,
    "decided": torch.int8,
    "decided_phase": torch.int32,
    "done": torch.bool,
    "active": torch.bool,
}
_NODE_DTYPES = {
    "slot": torch.int32,
    "phase": torch.int32,
    "stage": torch.int8,
    "my_r1": torch.int8,
    "my_r2": torch.int8,
    "led1": torch.int8,
    "led2": torch.int8,
    "decided": torch.int8,
    "done": torch.bool,
    "active": torch.bool,
}
_MESH_DTYPES = {
    "slot": torch.int32,
    "phase": torch.int32,
    "my_r1": torch.int8,
    "decided": torch.int8,
}


def _from_numpy(fields: Mapping[str, np.ndarray], dtypes: dict, device) -> dict:
    missing = set(dtypes) - set(fields)
    if missing:
        raise ValueError(f"state fields missing: {sorted(missing)}")
    return {
        name: torch.tensor(np.asarray(fields[name]), device=device).to(dtype)
        for name, dtype in dtypes.items()
    }


def cluster_state_from_numpy(
    fields: Mapping[str, np.ndarray], device: DeviceLike
) -> ClusterState:
    """A ``ClusterState`` on ``device`` from numpy arrays keyed by field."""
    return ClusterState(**_from_numpy(fields, _CLUSTER_DTYPES, device))


def cluster_state_to_numpy(state: ClusterState) -> dict[str, np.ndarray]:
    return {name: getattr(state, name).cpu().numpy() for name in ClusterState._fields}


def node_state_from_numpy(
    fields: Mapping[str, np.ndarray], device: DeviceLike
) -> NodeState:
    """A ``NodeState`` on ``device`` from numpy arrays keyed by field
    (ledgers ``[S, R]``, as the reference's ``NodeKernel`` keeps them)."""
    return NodeState(**_from_numpy(fields, _NODE_DTYPES, device))


def node_state_to_numpy(state: NodeState) -> dict[str, np.ndarray]:
    return {name: getattr(state, name).cpu().numpy() for name in NodeState._fields}


def mesh_state_from_numpy(
    fields: Mapping[str, np.ndarray], device: DeviceLike
) -> MeshPhaseState:
    """A ``MeshPhaseState`` on ``device`` from numpy arrays keyed by field."""
    return MeshPhaseState(**_from_numpy(fields, _MESH_DTYPES, device))


def mesh_state_to_numpy(state: MeshPhaseState) -> dict[str, np.ndarray]:
    return {name: getattr(state, name).cpu().numpy() for name in MeshPhaseState._fields}


def mesh_state_to_blocks(fields: Mapping[str, np.ndarray], mesh) -> MeshPhaseState:
    """A ``MeshPhaseState`` over ``mesh`` from full ``[S, R]`` numpy arrays
    keyed by field: each field cut in ``[S/a, R/b]`` blocks, each block on
    its position's device (the layout ``MeshPhaseKernel`` keeps over a
    mesh, and the reference's ``P("shard", "replica")``)."""
    from rabia_tpu_torch.parallel.mesh import MeshArray

    missing = set(_MESH_DTYPES) - set(fields)
    if missing:
        raise ValueError(f"state fields missing: {sorted(missing)}")
    return MeshPhaseState(**{
        name: MeshArray.cut(mesh, np.asarray(fields[name]), 0, 1, dtype)
        for name, dtype in _MESH_DTYPES.items()
    })


def mesh_state_from_blocks(state: MeshPhaseState) -> dict[str, np.ndarray]:
    """The full ``[S, R]`` numpy arrays of a blocked ``MeshPhaseState``
    (one controller: every block is local)."""
    return {name: getattr(state, name).numpy() for name in MeshPhaseState._fields}


def engine_state_from_jax(ckpt: Mapping) -> PersistedEngineState:
    """The port's engine checkpoint from a reference checkpoint's fields:
    ``per_shard_committed`` (list of ints), ``state_version`` (int), and
    the snapshot's ``snapshot_data`` (bytes), ``snapshot_version`` and
    ``snapshot_checksum`` (ints; the data may be None for no snapshot).
    The snapshot's checksum is verified."""
    committed = [int(x) for x in ckpt["per_shard_committed"]]
    snapshot = None
    if ckpt.get("snapshot_data") is not None:
        snapshot = Snapshot(
            version=int(ckpt["snapshot_version"]),
            data=bytes(ckpt["snapshot_data"]),
            checksum=int(ckpt["snapshot_checksum"]),
        )
        snapshot.verify()
    return PersistedEngineState(
        current_phase=max(committed, default=0),
        last_committed_phase=sum(committed),
        state_version=int(ckpt["state_version"]),
        snapshot=snapshot,
        per_shard_phase=list(committed),
        per_shard_committed=committed,
    )


def _table_arrays(fields, n_shards: Optional[int] = None) -> list[np.ndarray]:
    """The seven table arrays in the port's dtypes (bool, and int32 bit
    patterns), from a mapping keyed by ``KVTable`` field names or a
    sequence in ``KVTable`` order."""
    if isinstance(fields, Mapping):
        arrays = [fields[name] for name in KVTable._fields]
    else:
        arrays = list(fields)
        if len(arrays) != len(KVTable._fields):
            raise ValueError(f"expected {len(KVTable._fields)} table arrays, got {len(arrays)}")
    out = []
    for name, a in zip(KVTable._fields, arrays):
        a = np.asarray(a)
        if n_shards is not None:
            a = a[:n_shards]
        if name == "used":
            a = a.astype(bool)
        elif a.dtype.itemsize == 4:
            a = a.view(np.int32)
        else:
            a = a.astype(np.int32)
        out.append(np.ascontiguousarray(a))
    return out


def device_table_from_numpy(fields, device: DeviceLike, n_shards: Optional[int] = None) -> KVTable:
    """A ``KVTable`` on ``device`` from the seven table arrays: a mapping
    keyed by ``KVTable`` field names, or a sequence in the reference's
    ``DeviceKVTable.state`` order (used, key words, key length, version,
    value words, value length, shard version). Key and value words keep
    their bits as int32. ``n_shards`` drops the shard columns past it
    (the reference pads its shards to its mesh)."""
    return KVTable(*(torch.from_numpy(a).to(device) for a in _table_arrays(fields, n_shards)))


def device_table_to_numpy(table: KVTable) -> dict[str, np.ndarray]:
    """The seven table arrays as numpy, keyed by ``KVTable`` field name
    (key and value words as int32 bit patterns)."""
    return {name: getattr(table, name).cpu().numpy() for name in KVTable._fields}


def device_table_to_blocks(fields, mesh) -> KVTable:
    """A ``KVTable`` over ``mesh`` from the seven full table arrays (as
    :func:`device_table_from_numpy` takes them, all S shards, S padded to
    the mesh's shard axis): each field a ``MeshArray`` cut in shard
    blocks, block i (shards ``[i*S/a, (i+1)*S/a)``) on shard row i's
    first local device, the layout ``DeviceKVTable`` keeps over a mesh."""
    from rabia_tpu_torch.parallel.mesh import MeshArray

    return KVTable(*(MeshArray.cut(mesh, a, 0) for a in _table_arrays(fields)))


def device_table_from_blocks(table: KVTable) -> dict[str, np.ndarray]:
    """The seven full table arrays of a blocked ``KVTable`` (one
    controller: every block is local), keyed by field name."""
    return {name: getattr(table, name).numpy() for name in KVTable._fields}
