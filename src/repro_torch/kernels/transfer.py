"""Host <-> device copies that do not wait for the compute stream.

A copy from pageable host memory made with ``non_blocking=False`` (what
``torch.as_tensor(a).to("cuda")`` does) synchronises the current stream:
the host waits until every kernel queued before the copy has run.  The
serving path uploads small host arrays on every pass (page tables, index
lists, packing layouts), so each such copy would drain the card.

``upload`` stages the array in pinned memory and copies it with
``non_blocking=True``.  PyTorch's caching host allocator records an
event on the pinned block with the copy and hands the block out again
only once that event has passed, so the buffer stays alive and
unmodified until its copy is done, whenever the caller drops it.
``HostCopy`` is the reverse: a non-blocking copy into a pinned host
buffer and an event behind it; ``result()`` waits for that event only.

Every uploaded tensor keeps the host array it was made from
(``host_of``), so a precondition that would compare the tensor on the
device (``ops``: 'positions-match', 'segments-match', 'page-range') is
checked on that array instead.  The twin holds while the tensor's
version counter is unchanged: an in-place write drops it, and the check
then compares on the device again.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NUMPY = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
          torch.float32: np.float32}


def with_host(t: torch.Tensor, host: np.ndarray) -> torch.Tensor:
    """Record ``host`` as the host array equal to ``t``; returns ``t``."""
    t._cs_host = (host, t._version)
    return t


def host_of(t: torch.Tensor) -> Optional[np.ndarray]:
    """The host array ``t`` was made from, or None if it has none or was
    written in place since."""
    twin = getattr(t, "_cs_host", None)
    if twin is None or twin[1] != t._version:
        return None
    return twin[0]


def upload(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of host array ``a`` on ``device`` (as ``dtype``), carrying
    its host twin; on the card through pinned memory, without a sync."""
    host = np.array(a, dtype=None if dtype is None else _NUMPY[dtype])
    t = torch.from_numpy(host)
    device = torch.device(device)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return with_host(t, host)


def nonzero(host: np.ndarray, device) -> tuple:
    """``torch.nonzero(..., as_tuple=True)`` of a mask whose value is
    known on the host: found there and uploaded, so the device is not
    synced for the count."""
    return tuple(upload(i, device, torch.int64) for i in np.nonzero(host))


class HostCopy:
    """A tensor on its way to the host: on the card a non-blocking copy
    into pinned memory with an event recorded behind it on the current
    stream (work queued after it does not delay ``result``)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t.detach().clone()

    def result(self) -> np.ndarray:
        """The host values; on the card waits for the copy's event."""
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()
