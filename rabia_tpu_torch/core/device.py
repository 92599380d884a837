"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from rabia_tpu_torch.core.tracing import span

DeviceLike = Union[str, torch.device, None]


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, as a copy. To a card it goes through
    pinned memory without blocking the host: an upload must not wait for
    the work already queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def to_device_all(arrays, device: torch.device) -> list[torch.Tensor]:
    """Host arrays on ``device`` as one copy: their bytes are packed into
    one buffer (each at a 16-byte boundary; pinned memory for a card),
    which goes over in one transfer that does not block the host, and
    each array comes back as a view of the device buffer."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, n = [], 0
    for a in arrays:
        offsets.append(n)
        n += (a.nbytes + 15) // 16 * 16
    on_card = device.type == "cuda"
    host = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=on_card)
    hv = host.numpy()
    for a, o in zip(arrays, offsets):
        hv[o : o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True) if on_card else host
    return [
        buf[o : o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
        for a, o in zip(arrays, offsets)
    ]


class HostFetch:
    """Device tensors copied to the host without blocking the caller. On
    a card the copies go into pinned buffers behind the work already
    queued on the stream, and an event marks their end; ``result()``
    waits for that event alone and returns numpy arrays."""

    __slots__ = ("_host", "_event")

    def __init__(self, *tensors: torch.Tensor) -> None:
        self._event = None
        if tensors[0].device.type == "cuda":
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def result(self):
        """The arrays (one array when one tensor was fetched)."""
        with span("device.wait"):
            if self._event is not None:
                self._event.synchronize()
            out = [h.numpy() for h in self._host]
        return out[0] if len(out) == 1 else tuple(out)


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and no card
    is present: the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
