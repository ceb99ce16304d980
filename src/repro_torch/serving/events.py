"""Typed scheduler events + scheduler errors.

``Scheduler.step()`` returns (and ``Scheduler.events()`` yields) these
events.  The per-stream protocol every consumer may rely on:

    StreamAdmitted -> StreamThrottled* -> WindowDone* -> StreamDone

  * ``StreamAdmitted`` for a stream precedes every other event of that
    stream except ``StreamThrottled`` (a throttled stream may see
    ``StreamThrottled`` first, then ``StreamAdmitted``; never after).
  * ``WindowDone`` events of one stream arrive in window order.
  * ``StreamDone`` is emitted exactly once per stream, after its last
    ``WindowDone``, with ``n_windows`` equal to the windows reported
    (``n_windows=0`` for zero-window streams).

:class:`EventProtocolValidator` checks the protocol at run time; tests
and ``chip_smoke.py`` wrap it around ``Scheduler.events()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, Sequence, Set

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


class EventProtocolError(SchedulerError):
    """The event stream violated the per-stream protocol of this module's
    docstring; raised by :class:`EventProtocolValidator` at the first
    offending event."""


class EventProtocolValidator:
    """Runtime checker of the per-stream event protocol.

    Wrap it around any event source::

        validator = EventProtocolValidator()
        for ev in validator.wrap(sched.events()):
            ...
        validator.assert_complete()

    or feed events one at a time with :meth:`check`.  State is per
    stream id (``sid``): a set lookup and an integer compare per event.
    """

    def __init__(self) -> None:
        self._admitted: Set[int] = set()
        self._windows: Dict[int, int] = {}     # sid -> windows seen
        self._done: Dict[int, int] = {}        # sid -> n_windows

    def check(self, event: SchedulerEvent) -> SchedulerEvent:
        sid = event.sid
        if sid in self._done:
            raise EventProtocolError(
                f"{type(event).__name__} after terminal StreamDone", stream_ids=[sid])
        if isinstance(event, StreamAdmitted):
            if sid in self._admitted:
                raise EventProtocolError("duplicate StreamAdmitted", stream_ids=[sid])
            self._admitted.add(sid)
        elif isinstance(event, StreamThrottled):
            if sid in self._admitted:
                raise EventProtocolError(
                    "StreamThrottled after StreamAdmitted — throttle events only "
                    "precede admission", stream_ids=[sid])
        elif isinstance(event, WindowDone):
            if sid not in self._admitted:
                raise EventProtocolError("WindowDone before StreamAdmitted", stream_ids=[sid])
            expect = self._windows.get(sid, 0)
            if event.window != expect:
                raise EventProtocolError(
                    f"WindowDone out of order: window {event.window}, expected {expect}",
                    stream_ids=[sid])
            self._windows[sid] = expect + 1
        elif isinstance(event, StreamDone):
            if sid not in self._admitted:
                raise EventProtocolError("StreamDone before StreamAdmitted", stream_ids=[sid])
            seen = self._windows.get(sid, 0)
            if event.n_windows != seen:
                raise EventProtocolError(
                    f"StreamDone.n_windows={event.n_windows} but {seen} WindowDone "
                    "event(s) were delivered", stream_ids=[sid])
            self._done[sid] = event.n_windows
        return event

    def wrap(self, events: Iterable[SchedulerEvent]) -> Iterator[SchedulerEvent]:
        for ev in events:
            yield self.check(ev)

    def assert_complete(self) -> None:
        """Every admitted stream must have reached ``StreamDone``."""
        open_streams = sorted(self._admitted - set(self._done))
        if open_streams:
            raise EventProtocolError(
                "event stream ended with admitted stream(s) missing their terminal "
                "StreamDone", stream_ids=open_streams)
