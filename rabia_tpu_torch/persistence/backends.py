"""InMemory + atomic-file persistence backends.

Reference parity: rabia-persistence/src/in_memory.rs:11-43 (single-slot
RwLock store) and file_system.rs:26-94 (one `state.dat`, atomic write via
`.tmp` + rename). Writes go through the running event loop's default
executor (``asyncio.get_running_loop()`` — ``get_event_loop()`` is
deprecated from coroutines and could bind an orphan loop when called off
the engine's thread) so fsync never blocks the consensus round loop.

The port of the reference's ``rabia_tpu/persistence/backends.py``: the
files it writes are the reference's, so a state saved by either package
loads in the other. The WAL backend is ``persistence/native_wal.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import os
from pathlib import Path
from typing import Optional

from rabia_tpu_torch.core.errors import PersistenceError
from rabia_tpu_torch.core.persistence import PersistenceLayer

# unique per-write tmp-file sequence (see _atomic_write)
_TMP_SEQ = itertools.count()

STATE_FILE = "state.dat"


class InMemoryPersistence(PersistenceLayer):
    """Single-slot volatile store (in_memory.rs:11-43)."""

    def __init__(self) -> None:
        self._blob: Optional[bytes] = None
        self._aux: dict[str, bytes] = {}
        self.saves = 0
        self.loads = 0
        self.aux_saves = 0

    async def save_state(self, data: bytes) -> None:
        self._blob = bytes(data)
        self.saves += 1

    async def load_state(self) -> Optional[bytes]:
        self.loads += 1
        return self._blob

    async def save_aux(self, key: str, data: bytes) -> None:
        self._aux[key] = bytes(data)
        self.aux_saves += 1

    async def load_aux(self, key: str) -> Optional[bytes]:
        return self._aux.get(key)

    def clear(self) -> None:
        self._blob = None
        self._aux.clear()


class FileSystemPersistence(PersistenceLayer):
    """One `state.dat` per node dir; atomic tmp+rename (file_system.rs:62-78).

    The rename is atomic on POSIX, so a crash mid-save leaves either the old
    or the new state — never a torn file. fsync before rename makes the
    write durable, fsync of the directory makes the rename durable.
    """

    def __init__(self, directory: str | os.PathLike) -> None:
        self.dir = Path(directory)
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise PersistenceError(f"cannot create state dir: {e}") from None
        self.path = self.dir / STATE_FILE
        # sweep tmp orphans from crashed saves (tmp names are unique per
        # write, so a crash-looping process would otherwise accumulate
        # them forever). Tmp names embed the writer's pid: skip OUR OWN
        # pid's files — a second instance constructed on the same dir
        # (an explicit checkpointer, a test harness) must not unlink a
        # sibling's in-flight aux write out from under its os.replace.
        own = f".tmp{os.getpid()}."
        for orphan in self.dir.glob("*.tmp*"):
            if own in orphan.name:
                continue
            try:
                orphan.unlink()
            except OSError:
                pass

    def _atomic_write(self, path: Path, data: bytes) -> None:
        """tmp + fsync + rename + directory fsync: crash leaves either the
        old or the new file, and the rename itself is durable.

        The tmp name is unique per write: concurrent saves of the same
        file (an explicit checkpoint racing the engine's periodic one, in
        separate executor threads) must not share a tmp path — the loser's
        rename would fail with ENOENT after the winner consumed it."""
        tmp = path.with_suffix(f".tmp{os.getpid()}.{next(_TMP_SEQ)}")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError as e:
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            raise PersistenceError(f"save failed: {e}") from None

    def _save_sync(self, data: bytes) -> None:
        self._atomic_write(self.path, data)

    def _load_sync(self) -> Optional[bytes]:
        try:
            return self.path.read_bytes()
        except FileNotFoundError:
            return None
        except OSError as e:
            raise PersistenceError(f"load failed: {e}") from None

    async def save_state(self, data: bytes) -> None:
        await asyncio.get_running_loop().run_in_executor(None, self._save_sync, data)

    async def load_state(self) -> Optional[bytes]:
        return await asyncio.get_running_loop().run_in_executor(None, self._load_sync)

    # -- aux blobs (one file per key; same atomic discipline) ---------------

    def _aux_path(self, key: str) -> Path:
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in key)
        return self.dir / f"aux_{safe}.dat"

    async def save_aux(self, key: str, data: bytes) -> None:
        await asyncio.get_running_loop().run_in_executor(
            None, self._atomic_write, self._aux_path(key), data
        )

    async def load_aux(self, key: str) -> Optional[bytes]:
        def _load() -> Optional[bytes]:
            try:
                return self._aux_path(key).read_bytes()
            except FileNotFoundError:
                return None
            except OSError as e:
                raise PersistenceError(f"aux load failed: {e}") from None

        return await asyncio.get_running_loop().run_in_executor(None, _load)

    # sync wrappers (file_system.rs:80-94 "sync constructor" analog)
    def save_state_sync(self, data: bytes) -> None:
        self._save_sync(data)

    def load_state_sync(self) -> Optional[bytes]:
        return self._load_sync()
