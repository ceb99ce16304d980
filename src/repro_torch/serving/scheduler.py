"""Multi-stream scheduler over the serving pipeline (lockstep engine).

``submit`` performs codec ingest (stage 1) and queues the session; up to
``max_concurrent`` sessions are admitted (hold KV state) at a time, and
admission the paged KV pool cannot back is refused (``StreamThrottled``).
Each ``step`` serves the largest ready group of same-phase windows (all
fresh, or all incremental; ``cacheblend``'s incremental windows alone)
through the synchronous ``serve_batch``, fully synced before the next
step.  Under int8 cold pages the pool admits streams staggered: the next
one when the previous one has demoted.  The JAX package's stage-pipelined
engine (ingest threads, overlapped stages) is not ported yet.

Drive the scheduler with ``events()`` / ``step()`` (typed
``SchedulerEvent``s) or ``run()``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import Caches
from .api import ServingPipeline, StreamRequest, StreamSession, WindowResult
from .config import SchedulerCfg
from .events import (
    SchedulerError, SchedulerEvent, StreamAdmitted, StreamDone,
    StreamThrottled, WindowDone,
)

STAGES = ("ingest", "encode", "prefill", "decode", "finalize")


def _concat_states(states: List[Dict[str, Any]],
                   sids: Sequence[int] = ()) -> Dict[str, Any]:
    """Stack per-session (batch=1) states into one batched state: page
    rows and host arrays with numpy, per-stream ``caches`` along their
    batch axis 1 (a copy: the dense staging cost the paged slab avoids),
    other tensors along axis 0; python scalars must agree across the
    group."""
    out: Dict[str, Any] = {}
    for key in states[0]:
        vals = [s[key] for s in states]
        if key == "caches":
            out[key] = Caches(tuple(
                type(blks[0])(*(torch.cat(leaves, dim=1) for leaves in zip(*blks)))
                for blks in zip(*(c.blocks for c in vals))), None)
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.concatenate(vals, axis=0)
        elif isinstance(vals[0], (int, float)):
            if not all(v == vals[0] for v in vals):
                raise SchedulerError(
                    f"cannot fuse windows: scalar state {key!r} differs "
                    f"across the group ({vals})", stream_ids=sids)
            out[key] = vals[0]
        else:
            out[key] = torch.cat(vals, dim=0)
    return out


def _split_state(state: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Inverse of ``_concat_states``: n per-session batch=1 states."""
    outs: List[Dict[str, Any]] = [dict() for _ in range(n)]
    for key, val in state.items():
        for i in range(n):
            if key == "caches":
                outs[i][key] = Caches(tuple(
                    type(blk)(*(leaf[:, i: i + 1] for leaf in blk))
                    for blk in val.blocks), None)
            else:
                outs[i][key] = val if isinstance(val, (int, float)) else val[i: i + 1]
    return outs


def _staged_bytes(state: Optional[Dict[str, Any]]) -> int:
    """Bytes one session contributes to fused-call state staging."""
    if not state:
        return 0
    total = 0
    for key, val in state.items():
        if key == "caches":
            total += sum(leaf.numel() * leaf.element_size()
                         for blk in val.blocks for leaf in blk)
        elif isinstance(val, torch.Tensor):
            total += val.numel() * val.element_size()
        elif hasattr(val, "nbytes"):
            total += int(val.nbytes)
    return total


class Scheduler:
    """Admits N concurrent ``StreamSession``s and serves ready windows of
    same-layout streams in batched calls, one fused group per step."""

    def __init__(self, pipeline: ServingPipeline,
                 cfg: Optional[SchedulerCfg] = None, *,
                 max_concurrent: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 pipelined: Optional[bool] = None):
        cfg = cfg or SchedulerCfg()
        overrides = {
            k: v for k, v in dict(max_concurrent=max_concurrent,
                                  max_batch=max_batch,
                                  pipelined=pipelined).items()
            if v is not None
        }
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if cfg.pipelined:
            raise NotImplementedError(
                "the stage-pipelined engine is not ported; use pipelined=False")
        if cfg.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.cfg = cfg
        self.pipeline = pipeline
        self.max_concurrent = cfg.max_concurrent
        self.max_batch = cfg.max_batch or cfg.max_concurrent
        # size the shared KV slab for the concurrency ceiling once
        pipeline.ensure_capacity(cfg.max_concurrent)
        self._queue: deque[StreamSession] = deque()
        self._active: Dict[int, StreamSession] = {}
        self._sessions: Dict[int, StreamSession] = {}
        self._event_buffer: List[SchedulerEvent] = []
        self._throttled: set = set()
        self._t_submit: Dict[int, float] = {}
        self._next_sid = 0
        # -- fleet metrics ---------------------------------------------
        self.windows_served = 0
        self.t_serve = 0.0               # wall time inside step()
        self.vit_patches = 0
        self.vit_slots = 0
        self.stage_busy: Dict[str, float] = {s: 0.0 for s in STAGES}
        self.window_latencies: Dict[int, List[float]] = {}
        self.ttft: Dict[int, float] = {}

    # -- session lifecycle ---------------------------------------------
    def submit(self, request: StreamRequest) -> int:
        """Open a session (codec ingest) and queue it for admission."""
        stream = self.pipeline.frontend.open(request.frames)
        sess = StreamSession(self._next_sid, request, stream)
        self._next_sid += 1
        self._sessions[sess.sid] = sess
        self._queue.append(sess)
        self._t_submit[sess.sid] = time.perf_counter()
        return sess.sid

    def session(self, sid: int) -> StreamSession:
        return self._sessions[sid]

    def close(self, sid: int) -> List[WindowResult]:
        """Release the session's KV state; returns its window results."""
        sess = self._sessions.pop(sid)
        self._active.pop(sid, None)
        self._throttled.discard(sid)
        try:
            self._queue.remove(sess)
        except ValueError:
            pass
        self.pipeline.release_state(sess.state)
        sess.state = None
        return sess.results

    @property
    def idle(self) -> bool:
        return not self._queue and all(s.done for s in self._active.values())

    # -- admission -----------------------------------------------------
    def _admit(self, events: List[SchedulerEvent]) -> None:
        for sid in [s for s, sess in self._active.items() if sess.done]:
            del self._active[sid]
        # an admitted session claims its slab pages at its first fresh
        # window: count sessions not yet holding pages
        n_unbacked = sum(
            1 for sess in self._active.values()
            if not (sess.state and "pages" in sess.state)
        )
        while self._queue and len(self._active) < self.max_concurrent:
            if not self.pipeline.can_admit(n_unbacked + 1):
                head = self._queue[0]
                if head.sid not in self._throttled:
                    self._throttled.add(head.sid)
                    events.append(StreamThrottled(head.sid, head.request.stream_id))
                break                    # wait for a stream to release
            sess = self._queue.popleft()
            self._throttled.discard(sess.sid)
            events.append(StreamAdmitted(sess.sid, sess.request.stream_id))
            if not sess.done:            # zero-window streams finish here
                self._active[sess.sid] = sess
                n_unbacked += 1
            else:
                events.append(StreamDone(sess.sid, sess.request.stream_id,
                                         n_windows=0))

    # -- event-driven API ----------------------------------------------
    def step(self) -> List[SchedulerEvent]:
        """Advance by one fused group; returns the events it produced."""
        events = self._event_buffer
        self._event_buffer = []
        t0 = time.perf_counter()
        self._admit(events)
        self._serve_one_group(events)
        self.t_serve += time.perf_counter() - t0
        return events

    def events(self) -> Iterator[SchedulerEvent]:
        """Drive the scheduler to idle, yielding events as they occur.
        Raises ``SchedulerError`` if admission stalls with nothing to do."""
        stalls = 0
        while True:
            evs = self.step()
            yield from evs
            if self.idle and not self._event_buffer:
                return
            stalls = 0 if evs else stalls + 1
            if stalls >= 3:
                raise SchedulerError(
                    "scheduler stalled: admission blocked and no work "
                    "in flight (KV pool too small for one stream?)",
                    stream_ids=sorted(
                        [s.sid for s in self._queue] + list(self._active)),
                )

    def run(self) -> Dict[int, List[WindowResult]]:
        """Drain every open session; per-session window results."""
        for _ in self.events():
            pass
        return {sid: sess.results for sid, sess in self._sessions.items()}

    # -- lockstep engine -----------------------------------------------
    def _ready_groups(self) -> List[List[StreamSession]]:
        groups: Dict[tuple, List[StreamSession]] = {}
        for sess in self._active.values():
            if sess.done:
                continue
            groups.setdefault(self.pipeline.batch_key(sess.state), []).append(sess)
        return list(groups.values())

    def _bump_stage(self, stage: str, dt: float) -> None:
        self.stage_busy[stage] += dt

    def _serve_one_group(self, events: List[SchedulerEvent]) -> List[WindowResult]:
        """Serve the largest ready group through ``serve_batch``."""
        groups = self._ready_groups()
        if not groups:
            return []
        group = max(groups, key=len)[: self.max_batch]
        t_poll0 = time.perf_counter()

        frames_l, metas, t_codecs = [], [], []
        for sess in group:
            wf, wm, tc = self.pipeline.frontend.window(sess.stream, sess.next_window)
            frames_l.append(wf)
            metas.append(wm)
            t_codecs.append(tc)
        frames = torch.stack(frames_l, 0)
        self._bump_stage("ingest", time.perf_counter() - t_poll0)

        fresh = group[0].state is None
        staged = [_staged_bytes(sess.state) for sess in group]
        tot_staged = sum(staged)
        t0 = time.perf_counter()
        if fresh:
            state = None
        elif len(group) == 1:
            state = group[0].state
        else:
            state = _concat_states([s.state for s in group], sids=[s.sid for s in group])
        t_stage = time.perf_counter() - t0

        stats, new_state = self.pipeline.serve_batch(frames, metas, state)

        t0 = time.perf_counter()
        if not self.pipeline.reuse:
            # modes without reuse never read state: keep no dead caches
            per_states = [None] * len(group)
        elif len(group) == 1:
            per_states = [new_state]
        else:
            per_states = _split_state(new_state, len(group))
        t_stage += time.perf_counter() - t0

        results = []
        now = time.perf_counter()
        for i, sess in enumerate(group):
            st = stats[i]
            st.t_codec += t_codecs[i]
            share = staged[i] / tot_staged if tot_staged else 1 / len(group)
            st.t_overhead += t_stage * share
            res = WindowResult(sess.request.stream_id, sess.sid, sess.next_window, st)
            sess.results.append(res)
            window = sess.next_window
            sess.next_window += 1
            # finished sessions release their slab pages at once
            if sess.done:
                self.pipeline.release_state(per_states[i])
                sess.state = None
            else:
                sess.state = per_states[i]
            results.append(res)
            self.vit_patches += st.vit_patches
            self.vit_slots += st.vit_slots
            self._bump_stage("encode", st.t_vit)
            self._bump_stage("prefill", st.t_prefill)
            self._bump_stage("decode", st.t_decode)
            self.window_latencies.setdefault(sess.sid, []).append(now - t_poll0)
            if window == 0:
                self.ttft[sess.sid] = now - self._t_submit[sess.sid]
            events.append(WindowDone(sess.sid, sess.request.stream_id, res))
            if sess.done:
                events.append(StreamDone(sess.sid, sess.request.stream_id,
                                         n_windows=sess.next_window))
        self.windows_served += len(results)
        return results

    # -- fleet metrics -------------------------------------------------
    def kv_memory(self) -> Dict[str, int]:
        """Slab bytes of the paged pool (0 for per-stream caches) and the
        steady-state KV bytes of one stream."""
        pool = self.pipeline.backend.pool
        return {
            "slab_bytes": int(pool.slab_bytes) if pool is not None else 0,
            "bytes_per_stream": int(self.pipeline.kv_bytes_per_stream()),
        }

    @property
    def vit_pack_utilization(self) -> float:
        return self.vit_patches / max(self.vit_slots, 1)

    def latency_quantiles(self) -> Dict[str, float]:
        """p50/p99/mean of per-window serving latency (group-serve wall),
        seconds."""
        flat = [v for ls in self.window_latencies.values() for v in ls]
        if not flat:
            return {}
        return {"p50": float(np.percentile(flat, 50)),
                "p99": float(np.percentile(flat, 99)),
                "mean": float(np.mean(flat))}

    def ttft_quantiles(self) -> Dict[str, float]:
        """p50/p99/mean of per-stream time to first answer (submit ->
        first window served), seconds."""
        vals = list(self.ttft.values())
        if not vals:
            return {}
        return {"p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)),
                "mean": float(np.mean(vals))}

    def stage_occupancy(self) -> Dict[str, float]:
        """Per-stage busy seconds per scheduler wall second (a lockstep
        run sums to about 1.0: no overlap by construction)."""
        wall = max(self.t_serve, 1e-9)
        return {k: v / wall for k, v in self.stage_busy.items()}
