"""Stage-pipelined multi-stream scheduler over the serving pipeline.

Two engines behind one event-driven API:

  * **pipelined** (default) — per-stage queues with overlapped
    execution.  Ingest worker threads (``SchedulerCfg.ingest_workers``,
    pool ``codec-ingest``) slice each window from the stream's decode
    buffer and make its prune decision (``ServingPipeline.decide``, on a
    side CUDA stream of the worker: its one device-to-host copy waits
    for that stream only) while the main thread dispatches earlier
    windows.  Each stage forms its own fused groups from whatever is
    ready, so a stream's window k+1 can be in encode while its window k
    is in prefill and decode.  The stage surfaces only dispatch; a
    group's answers are fetched by a non-blocking copy queued behind its
    decode, and the scheduler waits for that copy's event one tick after
    the dispatch, when the next tick's prefill and decode are queued
    behind it, so the card does not drain while the host finalizes.
  * **lockstep** (``SchedulerCfg(pipelined=False)``) — one fused group
    per step through the synchronous ``serve_batch``, synced before the
    next: the A/B baseline.

Ordering and streams: every prefill, reuse (``reuse_pool_caches`` with
``rope_shift``), int8 demotion and decode runs on one compute stream in
dispatch order.  The paged slab, the per-stream caches and the SSM
states are written in place, so stream order is what keeps window k+1's
prefill behind window k's decode (the JAX package threads the slab
through its calls instead); no side stream touches them.  An ingest
future's exception propagates through ``fut.result()``.

Grouping (both engines): fused calls only join windows that share a
batch key (fresh vs incremental; recurrent states also by offset;
``cacheblend``'s incremental windows alone, since each ranks its own
refresh set).  The pipelined encode groups by fresh vs incremental, and
encodes ``cacheblend``'s incremental windows one stream per call as its
prefill serves them, so both engines pack the same frames together and
give bitwise the same answers when their groups are the same.  When a
prefill group is exactly an encode group, the batched arrays pass
straight through.

Drive the scheduler with ``events()`` / ``step()`` (typed
``SchedulerEvent``s) or ``run()``; ``poll()`` survives as a deprecated
lockstep shim.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import Caches
from .api import (
    DecodedWindows, EncodedWindows, PrefilledWindows, ServingPipeline, StreamRequest,
    StreamSession, WindowResult,
)
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


# ----------------------------------------------------------------------
# per-stream pipeline program (pipelined engine bookkeeping)
# ----------------------------------------------------------------------
class _EncRow(NamedTuple):
    """One stream's row of a fused encode call, queued for the prefill
    stage.  It keeps the whole batched encode output (``enc``, ``idx``)
    instead of slicing it: when the prefill group is exactly the encode
    group (the steady state) the batched arrays pass straight through."""

    window: int
    enc: EncodedWindows              # the fused encode output (batched)
    idx: int                         # this stream's row in ``enc``
    fresh: bool
    t_codec: float                   # amortized codec time (stage 1)
    t_enq: float                     # ingest-enqueue timestamp (latency)


class _Inflight(NamedTuple):
    """One fused prefill+decode group dispatched but not yet finalized."""

    progs: List["_Program"]
    rows: List[_EncRow]
    pf: PrefilledWindows
    dec: DecodedWindows
    t_stage: float                   # state (de)staging wall time
    shares: List[float]              # per-stream staging attribution
    tick: int                        # scheduler tick that dispatched it


@dataclasses.dataclass
class _Program:
    """Stage cursors of one admitted session.

    ``next_ingest``/``next_encode``/``next_prefill`` are the first window
    index the stage has NOT yet taken; ``sess.next_window`` (the finalize
    cursor) advances only when a window's results are synced.
    """

    sess: StreamSession
    t_submit: float
    futs: Dict[int, Any] = dataclasses.field(default_factory=dict)
    enc_rows: Dict[int, _EncRow] = dataclasses.field(default_factory=dict)
    next_ingest: int = 0
    next_encode: int = 0
    next_prefill: int = 0


def _chunks(seq: List[Any], n: int) -> Iterator[List[Any]]:
    for i in range(0, len(seq), n):
        yield seq[i: i + n]


# ----------------------------------------------------------------------
class Scheduler:
    """Admits N concurrent ``StreamSession``s and serves ready windows of
    same-layout streams in batched, stage-pipelined calls.

    Usage::

        sched = Scheduler(pipeline, SchedulerCfg(max_concurrent=8))
        sid = sched.submit(StreamRequest("cam-0", frames))
        for ev in sched.events():
            ...                           # WindowDone, StreamDone, ...
        results = sched.close(sid)        # per-stream window results
    """

    def __init__(self, pipeline: ServingPipeline,
                 cfg: Optional[SchedulerCfg] = None, *,
                 max_concurrent: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 pipelined: Optional[bool] = None,
                 ingest_workers: Optional[int] = None,
                 lookahead: Optional[int] = None):
        cfg = cfg or SchedulerCfg()
        overrides = {
            k: v for k, v in dict(max_concurrent=max_concurrent, max_batch=max_batch,
                                  pipelined=pipelined, ingest_workers=ingest_workers,
                                  lookahead=lookahead).items()
            if v is not None
        }
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
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
        self._programs: Dict[int, _Program] = {}
        self._inflight: deque[_Inflight] = deque()
        self._event_buffer: List[SchedulerEvent] = []
        self._throttled: set = set()
        self._t_submit: Dict[int, float] = {}
        self._executor: Optional[ThreadPoolExecutor] = None
        # guards stage_busy, the one accumulator the ingest threads and
        # the main loop both write (everything else is main-thread only)
        self._metrics_lock = threading.Lock()
        self._next_sid = 0
        self._tick = 0
        # -- fleet metrics ---------------------------------------------
        self.windows_served = 0
        self.t_serve = 0.0               # wall time inside step()/poll()
        self.vit_patches = 0
        self.vit_slots = 0
        # kernel calls the card refuses, over every batched stage call
        # (rows of one call share the count: added once per call); 0 on
        # the card, where such a call raises
        self.kernel_fallbacks = 0
        # busy seconds per stage: device spans of encode, prefill and
        # decode on the card (host wall on the CPU), host wall of ingest
        # (summed over worker threads), staging and the finalize wait
        self.stage_busy: Dict[str, float] = {s: 0.0 for s in STAGES}
        # per-stream serving latency: submit -> first answer (TTFT) and
        # per window enqueue -> finalize (group serve wall in lockstep)
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
        """Release the session's KV state; returns its window results.

        Closing a stream with dispatched but unfinalized windows first
        finalizes every inflight group up to and including its last one
        (oldest first, so other streams' window order holds); their
        events are delivered by the next ``step()``."""
        sess = self._sessions.pop(sid)
        while any(p.sess.sid == sid for g in self._inflight for p in g.progs):
            self._finalize_group(self._inflight.popleft(), self._event_buffer)
        self._active.pop(sid, None)
        self._programs.pop(sid, None)
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
        return (not self._queue and not self._inflight
                and all(s.done for s in self._active.values()))

    # -- admission -----------------------------------------------------
    def _admit(self, events: List[SchedulerEvent]) -> None:
        for sid in [s for s, sess in self._active.items() if sess.done]:
            del self._active[sid]
            self._programs.pop(sid, None)
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
                self._programs[sess.sid] = _Program(sess, self._t_submit[sess.sid])
                n_unbacked += 1
            else:
                events.append(StreamDone(sess.sid, sess.request.stream_id, n_windows=0))

    # ==================================================================
    # event-driven API
    # ==================================================================
    def step(self) -> List[SchedulerEvent]:
        """Advance the scheduler by one tick; returns the events it
        produced (possibly none)."""
        events = self._event_buffer
        self._event_buffer = []
        t0 = time.perf_counter()
        self._admit(events)
        if not self.cfg.pipelined:
            self._serve_one_group(events)
        else:
            # windows whose encode landed last tick go to prefill+decode
            # first, then the next windows' encode queues behind them,
            # then the oldest inflight group is synced: by then the card
            # is busy with this tick's work and the ingest threads with
            # the next windows
            did_prefill = self._prefill_pass()
            did_encode = self._encode_pass()
            if did_encode and not did_prefill:
                did_prefill = self._prefill_pass()     # first-window catch-up
            # groups dispatched this tick are synced next tick, unless
            # nothing was dispatched: then drain, so the loop progresses
            self._finalize_pass(events, drain=not (did_prefill or did_encode))
            self._tick += 1
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
                self._shutdown_ingest()
                return
            # a dispatch-only tick (results sync next tick) can yield no
            # events once; three in a row means nothing is moving
            stalls = 0 if evs else stalls + 1
            if stalls >= 3:
                raise SchedulerError(
                    "scheduler stalled: admission blocked and no work "
                    "in flight (KV pool too small for one stream?)",
                    stream_ids=sorted(
                        [s.sid for s in self._queue] + list(self._active)),
                )

    def run(self) -> Dict[int, List[WindowResult]]:
        """Drain every open session; per-session window results (sessions
        already ``close``d are not included)."""
        for _ in self.events():
            pass
        return {sid: sess.results for sid, sess in self._sessions.items()}

    # -- deprecated pull API -------------------------------------------
    def poll(self) -> List[WindowResult]:
        """Deprecated: serve ONE fused group synchronously (lockstep
        semantics whatever ``cfg.pipelined``); [] when nothing is ready.
        Use ``step()``/``events()`` instead."""
        warnings.warn(
            "Scheduler.poll() is deprecated; drive the scheduler with "
            "step()/events()/run()", DeprecationWarning, stacklevel=2)
        t0 = time.perf_counter()
        self._finalize_pass(self._event_buffer)     # flush pipelined work
        for prog in self._programs.values():
            # drop stage-ahead work so a window dispatched by step() is
            # never served again by the lockstep path
            prog.enc_rows.clear()
            prog.futs.clear()
            prog.next_ingest = prog.next_encode = prog.next_prefill = \
                prog.sess.next_window
        # poll returns raw results, but its events still go to the
        # buffer the next step() delivers: a consumer that mixes poll()
        # with events() must see admission before the windows
        self._admit(self._event_buffer)
        results = self._serve_one_group(self._event_buffer)
        for prog in self._programs.values():
            # resync the cursors after serving: programs this poll
            # admitted start at window 0, and the lockstep serve moved
            # sess.next_window only
            prog.next_ingest = prog.next_encode = prog.next_prefill = \
                prog.sess.next_window
        self.t_serve += time.perf_counter() - t0
        return results

    # ==================================================================
    # lockstep engine (A/B baseline and poll shim)
    # ==================================================================
    def _ready_groups(self) -> List[List[StreamSession]]:
        groups: Dict[tuple, List[StreamSession]] = {}
        for sess in self._active.values():
            if sess.done:
                continue
            groups.setdefault(self.pipeline.batch_key(sess.state), []).append(sess)
        return list(groups.values())

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
        self.kernel_fallbacks += stats[0].kernel_fallbacks
        self.windows_served += len(results)
        return results

    # ==================================================================
    # pipelined engine (per-stage passes)
    # ==================================================================
    def _ingest_pool(self) -> Optional[ThreadPoolExecutor]:
        if self.cfg.ingest_workers <= 0:
            return None
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self.cfg.ingest_workers, thread_name_prefix="codec-ingest")
        return self._executor

    def _shutdown_ingest(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def _bump_stage(self, stage: str, dt: float) -> None:
        """Accumulate stage busy time under ``_metrics_lock``: ingest
        threads and the main loop both write ``stage_busy``, and a bare
        ``+=`` on the shared float would lose updates."""
        with self._metrics_lock:
            self.stage_busy[stage] += dt

    def _ingest_one(self, sess: StreamSession, k: int):
        """Stage 1 of window k: its slice of the decode buffer and its
        prune decision (on this thread's side stream on the card)."""
        t0 = time.perf_counter()
        frames, meta, tc = self.pipeline.frontend.window_host(sess.stream, k)
        fresh = k == 0 or not self.pipeline.reuse
        dec = self.pipeline.decide([meta], fresh)
        self._bump_stage("ingest", time.perf_counter() - t0)
        return frames, meta, tc, None if dec is None else dec[0]

    def _ensure_ingest(self, prog: _Program) -> None:
        """Submit windows to the worker pool up to the lookahead bound
        (ingest runs one window ahead of encode)."""
        bound = min(prog.sess.stream.n_windows,
                    prog.next_prefill + 1 + self.cfg.lookahead)
        pool = self._ingest_pool()
        while prog.next_ingest < bound:
            k = prog.next_ingest
            fut = pool.submit(self._ingest_one, prog.sess, k) if pool is not None else None
            prog.futs[k] = (fut, time.perf_counter())
            prog.next_ingest += 1

    def _take_ingest(self, prog: _Program, k: int):
        fut, t_enq = prog.futs.pop(k)
        out = self._ingest_one(prog.sess, k) if fut is None else fut.result()
        return out + (t_enq,)

    def _encode_key(self, prog: _Program, fresh: bool) -> tuple:
        if fresh:
            return ("fresh",)
        if self.pipeline.is_streaming_family or self.pipeline.backend.batchable_step:
            return ("inc",)
        return ("inc", prog.sess.sid)    # cacheblend: encoded as it is prefilled

    def _encode_pass(self) -> bool:
        """Fuse and dispatch the ViT encode of every stream whose next
        window is within the lookahead bound."""
        ready: Dict[tuple, List[_Program]] = {}
        for prog in self._programs.values():
            self._ensure_ingest(prog)
            w = prog.next_encode
            if w >= prog.sess.stream.n_windows or w > prog.next_prefill + self.cfg.lookahead:
                continue
            fresh = w == 0 or not self.pipeline.reuse
            ready.setdefault(self._encode_key(prog, fresh), []).append(prog)
        did = False
        for key, progs in ready.items():
            for chunk in _chunks(progs, self.max_batch):
                self._encode_group(chunk, key[0] == "fresh")
                did = True
        return did

    def _encode_group(self, progs: List[_Program], fresh: bool) -> None:
        taken = [self._take_ingest(prog, prog.next_encode) for prog in progs]
        frames, metas, t_codecs, decs, t_enqs = (list(x) for x in zip(*taken))
        enc = self.pipeline.encode_windows(
            torch.stack(frames, 0), metas, fresh, None if decs[0] is None else decs)
        self.kernel_fallbacks += enc.fallbacks
        for i, prog in enumerate(progs):
            w = prog.next_encode
            prog.enc_rows[w] = _EncRow(window=w, enc=enc, idx=i, fresh=fresh,
                                       t_codec=t_codecs[i], t_enq=t_enqs[i])
            prog.next_encode += 1

    def _prefill_pass(self) -> bool:
        """Fuse and dispatch prefill AND decode for every stream whose
        next window is encoded (its state is ready by construction:
        window k-1's decode was dispatched before ``next_prefill`` moved
        to k, and on the one stream it runs first)."""
        groups: Dict[tuple, List[_Program]] = {}
        for prog in self._programs.values():
            row = prog.enc_rows.get(prog.next_prefill)
            if row is None:
                continue
            key = ("fresh",) if row.fresh else self.pipeline.batch_key(prog.sess.state)
            groups.setdefault(key, []).append(prog)
        did = False
        for progs in groups.values():
            for chunk in _chunks(progs, self.max_batch):
                self._dispatch_group(chunk)
                did = True
        return did

    def _dispatch_group(self, progs: List[_Program]) -> None:
        rows = [prog.enc_rows.pop(prog.next_prefill) for prog in progs]
        S = len(progs)
        fresh = rows[0].fresh
        src = rows[0].enc
        if (all(r.enc is src for r in rows) and [r.idx for r in rows] == list(range(S))
                and src.vis.shape[0] == S):
            enc_g = src     # prefill group == encode group: no re-staging
        else:
            enc_g = EncodedWindows(
                vis=torch.cat([r.enc.vis[r.idx: r.idx + 1] for r in rows], 0),
                vval=torch.cat([r.enc.vval[r.idx: r.idx + 1] for r in rows], 0),
                qe=torch.cat([r.enc.qe[r.idx: r.idx + 1] for r in rows], 0),
                patches=np.array([r.enc.patches[r.idx] for r in rows]),
                slots=np.array([r.enc.slots[r.idx] for r in rows]),
                fresh=fresh, t_vit=None,
            )
        staged = [_staged_bytes(p.sess.state) for p in progs]
        tot_staged = sum(staged)
        t0 = time.perf_counter()
        if fresh:
            state = None
        elif S == 1:
            state = progs[0].sess.state
        else:
            state = _concat_states([p.sess.state for p in progs],
                                   sids=[p.sess.sid for p in progs])
        t_stage = time.perf_counter() - t0

        pf = self.pipeline.prefill_windows(enc_g, state)
        dec = self.pipeline.decode_windows(pf)
        self.kernel_fallbacks += pf.fallbacks + dec.fallbacks

        t0 = time.perf_counter()
        if not self.pipeline.reuse:
            per_states = [None] * S
        elif S == 1:
            per_states = [pf.pr.state]
        else:
            per_states = _split_state(pf.pr.state, S)
        t_stage += time.perf_counter() - t0
        # the new state is live as soon as it is dispatched: window k+1's
        # prefill follows it on the same stream (done streams release at
        # finalize)
        for prog, st in zip(progs, per_states):
            prog.sess.state = st
        shares = [b / tot_staged if tot_staged else 1 / S for b in staged]
        self._inflight.append(_Inflight(list(progs), rows, pf, dec, t_stage, shares,
                                        self._tick))
        for prog in progs:
            prog.next_prefill += 1

    def _finalize_pass(self, events: List[SchedulerEvent], drain: bool = True) -> None:
        """Sync and emit inflight groups, oldest first.  With
        ``drain=False`` only groups dispatched on an EARLIER tick: this
        tick's stay queued on the card while the host waits."""
        while self._inflight and (drain or self._inflight[0].tick < self._tick):
            self._finalize_group(self._inflight.popleft(), events)

    def _finalize_group(self, g: _Inflight, events: List[SchedulerEvent]) -> None:
        """Wait for one fused group's answers and emit its ``WindowDone``
        (and possibly ``StreamDone``) events."""
        pipe = self.pipeline
        t0 = time.perf_counter()
        host = g.dec.host.result()       # the group's only wait
        t_sync = time.perf_counter() - t0
        self._bump_stage("finalize", t_sync)
        now = time.perf_counter()
        S = len(g.progs)
        t_prefill = pipe.prefill_seconds(g.pf)
        t_decode = pipe.decode_seconds(g.dec, t_sync)
        self._bump_stage("prefill", t_prefill + g.t_stage)
        self._bump_stage("decode", t_decode)
        for i, (prog, row) in enumerate(zip(g.progs, g.rows)):
            sess = prog.sess
            patches, slots = row.enc.patches[row.idx], row.enc.slots[row.idx]
            t_vit = row.enc.t_vit.seconds / len(row.enc.patches)
            st = pipe.window_stats(
                g.pf, g.dec, host, i, patches, slots, t_vit, t_prefill / S, t_decode / S,
                g.pf.pr.t_select / S + g.t_stage * g.shares[i], row.enc.fallbacks)
            st.t_codec = row.t_codec
            self._bump_stage("encode", t_vit)
            res = WindowResult(sess.request.stream_id, sess.sid, row.window, st)
            sess.results.append(res)
            sess.next_window += 1
            self.windows_served += 1
            self.vit_patches += st.vit_patches
            self.vit_slots += st.vit_slots
            self.window_latencies.setdefault(sess.sid, []).append(now - row.t_enq)
            if row.window == 0:
                self.ttft[sess.sid] = now - prog.t_submit
            events.append(WindowDone(sess.sid, sess.request.stream_id, res))
            if sess.done:
                pipe.release_state(sess.state)
                sess.state = None
                events.append(StreamDone(sess.sid, sess.request.stream_id,
                                         n_windows=sess.next_window))

    # ==================================================================
    # fleet metrics
    # ==================================================================
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
        """p50/p99/mean of per-window serving latency (enqueue -> finalize
        in the pipelined engine, group serve wall in lockstep), seconds."""
        flat = [v for ls in self.window_latencies.values() for v in ls]
        if not flat:
            return {}
        return {"p50": float(np.percentile(flat, 50)),
                "p99": float(np.percentile(flat, 99)),
                "mean": float(np.mean(flat))}

    def ttft_quantiles(self) -> Dict[str, float]:
        """p50/p99/mean of per-stream time to first answer (submit ->
        first window finalized), seconds."""
        vals = list(self.ttft.values())
        if not vals:
            return {}
        return {"p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)),
                "mean": float(np.mean(vals))}

    def stage_occupancy(self) -> Dict[str, float]:
        """Per-stage busy seconds per scheduler wall second.  Ingest can
        exceed 1.0 with several worker threads; the stages of a lockstep
        run sum to about 1.0 at most (no overlap by construction)."""
        wall = max(self.t_serve, 1e-9)
        with self._metrics_lock:
            busy = dict(self.stage_busy)
        return {k: v / wall for k, v in busy.items()}
