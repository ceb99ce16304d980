"""Typed scheduler events + scheduler errors.

``Scheduler.step()`` returns (and ``Scheduler.events()`` yields) these
events.  The per-stream protocol every consumer may rely on:

    StreamAdmitted -> StreamThrottled* -> WindowDone* -> StreamDone

``WindowDone`` events of one stream arrive in window order, and
``StreamDone`` is emitted exactly once per stream, after its last
``WindowDone`` (``n_windows=0`` for zero-window streams).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from .api import WindowResult, WindowStats


@dataclasses.dataclass(frozen=True)
class SchedulerEvent:
    """Base class: every event names the session it concerns."""

    sid: int
    stream_id: Any


@dataclasses.dataclass(frozen=True)
class StreamAdmitted(SchedulerEvent):
    """The session was admitted (holds a concurrency slot and will claim
    slab pages at its first fresh window)."""


@dataclasses.dataclass(frozen=True)
class StreamThrottled(SchedulerEvent):
    """Admission was refused for now; the stream stays queued.  Emitted
    once per throttling episode."""

    reason: str = "kv-pool"


@dataclasses.dataclass(frozen=True)
class WindowDone(SchedulerEvent):
    """One window of the stream was served end-to-end."""

    result: WindowResult = None          # type: ignore[assignment]

    @property
    def window(self) -> int:
        return self.result.window

    @property
    def stats(self) -> WindowStats:
        return self.result.stats


@dataclasses.dataclass(frozen=True)
class StreamDone(SchedulerEvent):
    """Every window of the stream has been served (its KV state is
    already released; results stay readable until ``close``)."""

    n_windows: int = 0


class SchedulerError(RuntimeError):
    """A scheduling invariant was violated; carries the stream ids."""

    def __init__(self, message: str, *, stream_ids: Sequence[int] = ()):
        self.stream_ids = tuple(stream_ids)
        if self.stream_ids:
            message = f"{message} [streams {list(self.stream_ids)}]"
        super().__init__(message)
