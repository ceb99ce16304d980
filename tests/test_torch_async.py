"""The port's stage-pipelined scheduler (its default engine), on the CPU.

* async == lockstep, bitwise: three streams x 24 frames at 112^2 (gop 4,
  window 16, stride 4: one fresh and two incremental windows each), all
  admitted at once, so both engines fuse the same groups.  Equal: every
  window's yes/no logits and answer, the token and ViT accounting, the
  FLOP ledger and each stream's event sequence; across codecflow and
  cacheblend on the paged slab and on per-stream caches, codecflow with
  int8 cold pages (keep 1.0, streams admitted staggered),
  mamba2-2.7b-smoke codecflow and olmoe-1b-7b-smoke codecflow (the MoE
  family on the paged slab; the hybrid family: ``test_torch_hybrid.py``).
* the port's async engine against the JAX package's async engine on a
  staggered fleet: four streams of 32, 20, 20 and 24 frames (5, 2, 2 and
  3 windows) with ``max_concurrent=3``, so the fourth is admitted while
  the first is mid-stream.  Same weights (the JAX package's random init,
  bridged).  Equal: the event sequence and the accounting.  Yes/no
  logits within LOGIT_TOL = 8e-3 (``test_torch_serving.py``: twice the
  largest gap measured at this size; bf16 matmuls round at other points
  in the two frameworks); answers equal where the JAX margin exceeds
  twice that.
* the event protocol: every run is wrapped in ``EventProtocolValidator``;
  its rejections (a mirror of the JAX package's), throttling under a
  pinned pool, the zero-window stream, ``poll()`` then ``events()``, the
  ``poll()`` shim, ``close()`` mid-flight.
* ``Engine.run_stream`` against the JAX package's ``Engine`` on both
  smoke archs (internvl3-14b-smoke logits within 8e-3, mamba2-2.7b-smoke
  within 5e-3 as in ``test_torch_recurrent.py``).
* the host twins that keep the stage surfaces free of syncs on the card:
  uploads carry their host array, an in-place write drops it, and the
  'positions-match', 'segments-match' and 'page-range' checks still
  raise when they run on it.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import CodecCfg as JCodecCfg  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import StreamRequest as JStreamRequest  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import CodecCfg, get_config  # noqa: E402
from repro_torch.data.pipeline import anomaly_dataset  # noqa: E402
from repro_torch.kernels import ops, transfer  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401
from repro_torch.kernels.flash_packed import build_pack_map  # noqa: E402
from repro_torch.kernels.flash_refresh import build_block_map  # noqa: E402
from repro_torch.launch.serve import build_engine, build_pipeline, default_vit  # noqa: E402
from repro_torch.models.init import from_numpy_tree  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine, EngineCfg, EventProtocolError, EventProtocolValidator, KVCfg, Scheduler,
    SchedulerCfg, ServingPipeline, StreamAdmitted, StreamDone, StreamRequest,
    StreamThrottled, WindowDone,
)

ARCH = "internvl3-14b-smoke"
SSM_ARCH = "mamba2-2.7b-smoke"
CODEC = dict(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
LOGIT_TOL = 8e-3
SSM_LOGIT_TOL = 5e-3
STATS = ("answer", "logits_yes_no", "tokens_vis", "tokens_valid", "tokens_refreshed",
         "vit_patches", "vit_slots", "flops_vit", "flops_prefill", "flops_decode",
         "kv_bytes_per_stream")
ACCOUNTING = tuple(f for f in STATS if f not in ("answer", "logits_yes_no"))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The ingest threads call torch beside the main thread.  With one
    intra-op thread each, this module does not oversubscribe a host whose
    cores the other test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def base(arch: str):
    """The port's pipeline of ``arch`` with random weights (seed 0)."""
    return build_pipeline(arch, "codecflow", CodecCfg(**CODEC), device="cpu")


@functools.lru_cache(maxsize=None)
def videos(n: int = 3, frames: int = 24):
    return tuple(anomaly_dataset(n, frames, 112, 112))


def pipeline(arch, mode="codecflow", keep=0.5, params=None, **kv):
    b = base(arch)
    lm, vit = params or (b.params, b.vparams)
    return ServingPipeline(b.cfg, b.v, lm, vit, EngineCfg(
        mode=mode, codec=CodecCfg(**dict(CODEC, keep_ratio=keep)), kv=KVCfg(**kv)),
        device="cpu")


def drain(sched):
    """Drive ``events()`` to idle under the runtime protocol validator."""
    validator = EventProtocolValidator()
    events = list(validator.wrap(sched.events()))
    validator.assert_complete()
    return events


def serve(pipe, vids, pipelined, max_concurrent=3, request=StreamRequest, sched_cls=Scheduler,
          cfg_cls=SchedulerCfg):
    """(events as (kind, sid, window), per-sid window stats) of one run."""
    sched = sched_cls(pipe, cfg_cls(max_concurrent=max_concurrent, pipelined=pipelined))
    sids = [sched.submit(request(i, np.asarray(f), tag=lab)) for i, (f, lab) in enumerate(vids)]
    events = [(type(e).__name__, e.sid, getattr(e, "window", None)) for e in drain(sched)]
    stats = {sid: [(r.window, r.stats) for r in sched.session(sid).results] for sid in sids}
    return events, stats, sched


def per_stream(events):
    return {sid: [(k, w) for k, s, w in events if s == sid] for _, sid, _ in events}


CASES = {
    "codecflow-paged": (ARCH, "codecflow", 0.5, {}),
    "codecflow-stream": (ARCH, "codecflow", 0.5, dict(paged_kv=False)),
    "cacheblend-paged": (ARCH, "cacheblend", 0.5, {}),
    "cacheblend-stream": (ARCH, "cacheblend", 0.5, dict(paged_kv=False)),
    "codecflow-int8": (ARCH, "codecflow", 1.0, dict(stale_page_dtype="int8")),
    "mamba2-codecflow": (SSM_ARCH, "codecflow", 0.5, {}),
    "olmoe-codecflow-paged": ("olmoe-1b-7b-smoke", "codecflow", 0.5, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_equals_lockstep_bitwise(case):
    arch, mode, keep, kv = CASES[case]
    ev_l, st_l, _ = serve(pipeline(arch, mode, keep, **kv), videos(), pipelined=False)
    pipe = pipeline(arch, mode, keep, **kv)
    ev_a, st_a, sched = serve(pipe, videos(), pipelined=True)
    assert per_stream(ev_a) == per_stream(ev_l)
    assert sorted(st_a) == sorted(st_l) == [0, 1, 2]
    for sid in st_l:
        assert [w for w, _ in st_a[sid]] == [w for w, _ in st_l[sid]] == [0, 1, 2]
        for (_, a), (_, b) in zip(st_a[sid], st_l[sid]):
            for f in STATS:
                assert getattr(a, f) == getattr(b, f), (case, sid, f)
    if pipe.backend.pool is not None:
        assert pipe.backend.pool.free_pages == pipe.backend.pool.n_pages
    if kv.get("stale_page_dtype") == "int8":
        assert any(k == "StreamThrottled" for k, _, _ in ev_a)
    assert sched.idle and sched._executor is None and not sched._inflight


# ----------------------------------------------------------------------
# against the JAX package's async engine, on a staggered fleet
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_weights(arch: str):
    jp = jserve.build_pipeline(arch, "codecflow", JCodecCfg(**CODEC))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return jp, (from_numpy_tree(to_np(jp.params)), from_numpy_tree(to_np(jp.vparams)))


def staggered():
    return tuple((f[:n], lab) for (f, lab), n in zip(videos(4, 32), (32, 20, 20, 24)))


def test_async_serves_a_staggered_fleet_like_jax():
    jp, params = jax_weights(ARCH)
    ev_j, st_j, _ = serve(jp, staggered(), True, request=JStreamRequest,
                          sched_cls=JScheduler, cfg_cls=JSchedulerCfg)
    ev_t, st_t, sched = serve(pipeline(ARCH, params=params), staggered(), True)
    assert ev_t == ev_j
    assert [len(st_t[s]) for s in range(4)] == [5, 2, 2, 3]
    for sid, rows in st_j.items():
        for (wj, a), (wt, b) in zip(rows, st_t[sid]):
            assert wj == wt
            for f in ACCOUNTING:
                assert getattr(a, f) == getattr(b, f), (f, sid, wj)
            lj, lt = np.asarray(a.logits_yes_no), np.asarray(b.logits_yes_no)
            assert np.isfinite(lt).all()
            assert np.abs(lj - lt).max() <= LOGIT_TOL, (sid, wj, lj, lt)
            if abs(lj[0] - lj[1]) > 2 * LOGIT_TOL:
                assert a.answer == b.answer
    # the fourth stream's fresh window was served beside stream 0's
    # incremental group, not after it
    done_0 = ev_t.index(("StreamDone", 0, None))
    assert ev_t.index(("WindowDone", 3, 0)) < done_0
    assert sched.ttft and set(sched.latency_quantiles()) == {"p50", "p99", "mean"}


# ----------------------------------------------------------------------
# event protocol
# ----------------------------------------------------------------------
def test_throttle_events_under_a_pinned_pool():
    """pool_streams=1 pins the slab below the fleet: admission surfaces as
    StreamThrottled (once per episode), every throttled stream is later
    admitted and finishes, and every page comes back."""
    pipe = pipeline(ARCH, pool_streams=1)
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=2))
    sids = [sched.submit(StreamRequest(i, np.asarray(f))) for i, (f, _) in enumerate(videos())]
    events = drain(sched)
    throttled = [e.sid for e in events if isinstance(e, StreamThrottled)]
    assert throttled and len(throttled) == len(set(throttled))
    assert set(throttled) <= {e.sid for e in events if isinstance(e, StreamAdmitted)}
    assert {e.sid for e in events if isinstance(e, StreamDone)} == set(sids)
    assert pipe.backend.pool.free_pages == pipe.backend.pool.n_pages


def test_zero_window_stream_emits_done():
    sched = Scheduler(pipeline(ARCH), SchedulerCfg(max_concurrent=1))
    sid = sched.submit(StreamRequest("short", np.zeros((15, 112, 112), np.float32)))
    events = drain(sched)
    assert [type(e) for e in events] == [StreamAdmitted, StreamDone]
    assert events[1].sid == sid and events[1].n_windows == 0


def _window_done(sid, k):
    return WindowDone(sid, "s", result=SimpleNamespace(window=k))


@pytest.mark.parametrize("case", ["before-admission", "out-of-order", "throttle-after",
                                  "after-done", "count", "incomplete"])
def test_event_protocol_validator_rejects(case):
    v = EventProtocolValidator()
    if case == "before-admission":
        with pytest.raises(EventProtocolError, match="before StreamAdmitted"):
            v.check(_window_done(0, 0))
        return
    v.check(StreamAdmitted(0, "s"))
    if case == "out-of-order":
        v.check(_window_done(0, 0))
        with pytest.raises(EventProtocolError, match="out of order"):
            v.check(_window_done(0, 2))
    elif case == "throttle-after":
        with pytest.raises(EventProtocolError, match="only precede admission"):
            v.check(StreamThrottled(0, "s"))
    elif case == "after-done":
        v.check(_window_done(0, 0))
        v.check(StreamDone(0, "s", n_windows=1))
        with pytest.raises(EventProtocolError, match="after terminal"):
            v.check(_window_done(0, 1))
    elif case == "count":
        with pytest.raises(EventProtocolError, match="n_windows=2"):
            v.check(StreamDone(0, "s", n_windows=2))
    else:
        with pytest.raises(EventProtocolError, match="missing") as err:
            v.assert_complete()
        assert err.value.stream_ids == (0,)


def test_poll_then_events_stays_protocol_valid():
    """poll() serves one group with its events buffered: the next
    events() delivers admission and the poll-served windows in order."""
    sched = Scheduler(pipeline(ARCH), SchedulerCfg(max_concurrent=3))
    sids = [sched.submit(StreamRequest(i, np.asarray(f))) for i, (f, _) in enumerate(videos())]
    with pytest.warns(DeprecationWarning, match="poll"):
        assert sched.poll()
    events = drain(sched)
    assert {e.sid for e in events if isinstance(e, StreamDone)} == set(sids)
    for sid in sids:
        assert [e.window for e in events if isinstance(e, WindowDone) and e.sid == sid] == [0, 1, 2]


def test_poll_shim_serves_everything():
    sched = Scheduler(pipeline(ARCH), SchedulerCfg(max_concurrent=3))
    sids = [sched.submit(StreamRequest(i, np.asarray(f))) for i, (f, _) in enumerate(videos())]
    results = []
    with pytest.warns(DeprecationWarning, match="poll"):
        while not sched.idle:
            results.extend(sched.poll())
    assert len(results) == 9
    _, expect, _ = serve(pipeline(ARCH), videos(), pipelined=False)
    for sid in sids:
        got = sorted((r for r in results if r.session_id == sid), key=lambda r: r.window)
        assert [r.stats.logits_yes_no for r in got] == [s.logits_yes_no for _, s in expect[sid]]


def test_close_mid_flight_drains_its_groups():
    """close() of a stream with dispatched windows finalizes the inflight
    groups holding it first: its results include them, none is left in
    flight, its pages come back, and the other streams finish."""
    pipe = pipeline(ARCH)
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=3))
    for i, (f, _) in enumerate(videos()):
        sched.submit(StreamRequest(i, np.asarray(f)))
    validator = EventProtocolValidator()
    events = []
    while not any(p.sess.sid == 0 for g in sched._inflight for p in g.progs):
        events += [validator.check(ev) for ev in sched.step()]
    dispatched = sched._programs[0].next_prefill
    results = sched.close(0)
    assert dispatched >= 1 and [r.window for r in results] == list(range(dispatched))
    assert not any(p.sess.sid == 0 for g in sched._inflight for p in g.progs)
    events += [validator.check(e) for e in sched.events()]
    assert [e.window for e in events if isinstance(e, WindowDone) and e.sid == 0] == \
        list(range(dispatched))
    assert {e.sid for e in events if isinstance(e, StreamDone)} == {1, 2}
    with pytest.raises(EventProtocolError, match="missing"):
        validator.assert_complete()
    assert pipe.backend.pool.free_pages == pipe.backend.pool.n_pages


def test_ingest_failure_propagates():
    """An ingest worker's exception reaches the caller; the scheduler
    neither slices inline instead nor falls back to lockstep."""
    pipe = pipeline(ARCH)

    def broken(metas, fresh):
        raise RuntimeError("ingest broke")
    pipe.decide = broken
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=1))
    sched.submit(StreamRequest(0, np.asarray(videos()[0][0])))
    with pytest.raises(RuntimeError, match="ingest broke"):
        list(sched.events())
    sched._shutdown_ingest()


def test_pipelined_is_the_default_engine():
    assert SchedulerCfg().pipelined and Scheduler(pipeline(ARCH)).cfg.pipelined
    assert not Scheduler(pipeline(ARCH), pipelined=False).cfg.pipelined


# ----------------------------------------------------------------------
# Engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", [ARCH, SSM_ARCH])
def test_engine_runs_a_stream_like_jax(arch):
    jp, (lm, vit) = jax_weights(arch)
    frames = np.asarray(videos()[1][0])
    want = JEngine.from_pipeline(jp).run_stream(frames)
    tcfg = get_config(arch)
    eng = Engine(tcfg, default_vit(tcfg), lm, vit,
                 EngineCfg(mode="codecflow", codec=CodecCfg(**CODEC)), device="cpu")
    got = eng.run_stream(frames)
    tol = SSM_LOGIT_TOL if arch == SSM_ARCH else LOGIT_TOL
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        for f in ACCOUNTING:
            assert getattr(a, f) == getattr(b, f), (arch, f)
        lj, lt = np.asarray(a.logits_yes_no), np.asarray(b.logits_yes_no)
        assert np.abs(lj - lt).max() <= tol, (arch, lj, lt)
        if abs(lj[0] - lj[1]) > 2 * tol:
            assert a.answer == b.answer
    pool = eng.pipeline.backend.pool
    assert pool is None or pool.free_pages == pool.n_pages


def test_build_engine_serves_what_the_scheduler_serves():
    eng = build_engine(ARCH, "codecflow", CodecCfg(**CODEC), device="cpu")
    frames = np.asarray(videos()[0][0])
    got = [s.logits_yes_no for s in eng.run_stream(frames)]
    sched = Scheduler(eng.pipeline, SchedulerCfg(max_concurrent=1))
    sched.submit(StreamRequest(0, frames))
    drain(sched)
    assert got == [r.stats.logits_yes_no for r in sched.session(0).results]


# ----------------------------------------------------------------------
# host twins: the checks that no longer sync
# ----------------------------------------------------------------------
def test_upload_keeps_its_host_array_until_written():
    a = np.arange(6).reshape(2, 3)
    t = transfer.upload(a, "cpu", torch.int32)
    assert t.dtype == torch.int32 and np.array_equal(transfer.host_of(t), a)
    a[0, 0] = 7                              # the caller's array is not the twin
    assert transfer.host_of(t)[0, 0] == 0
    t[0, 0] = 5
    assert transfer.host_of(t) is None
    assert transfer.host_of(torch.zeros(2)) is None
    copy = transfer.HostCopy(torch.tensor([1.5, 2.5]))
    assert np.array_equal(copy.result(), [1.5, 2.5])


def test_host_nonzero_equals_torch():
    m = np.array([[True, False, True], [False, False, True]])
    got = transfer.nonzero(m, "cpu")
    want = torch.nonzero(torch.from_numpy(m), as_tuple=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_checks_on_host_twins_still_raise():
    """'positions-match', 'page-range' and 'segments-match' run on the
    operands' host arrays where they have one, and still refuse."""
    q = torch.randn(1, 4, 4, 16)
    slab = torch.randn(256, 2, 16)
    kvv = torch.ones(1, 256, dtype=torch.bool)
    bm = build_block_map([3, 4, 5, 6], 256)
    good_pt = transfer.upload([[1, 0]], "cpu", torch.int32)
    bad_qp = transfer.upload([[3, 4, 5, 7]], "cpu", torch.long)
    with pytest.raises(ops.KernelContractError, match="positions-match"):
        ops.flash_refresh_paged(q, slab, slab, bad_qp, kvv, good_pt, block_map=bm)
    qp = transfer.upload([[3, 4, 5, 6]], "cpu", torch.long)
    with pytest.raises(ops.KernelContractError, match="page-range"):
        ops.flash_refresh_paged(q, slab, slab, qp, kvv,
                                transfer.upload([[1, 2]], "cpu", torch.int32), block_map=bm)
    ops.flash_refresh_paged(q, slab, slab, qp, kvv, good_pt, block_map=bm)
    seg = np.full((1, 128), -1, np.int32)
    seg[0, :60], seg[0, 60:100] = 0, 1
    pm = build_pack_map(seg)
    other = seg.copy()
    other[0, 99] = -1
    qk = torch.randn(1, 128, 4, 16)
    with pytest.raises(ops.KernelContractError, match="segments-match"):
        ops.flash_packed(qk, qk, qk, transfer.upload(other, "cpu"), pm)
    ops.flash_packed(qk, qk, qk, transfer.upload(seg, "cpu"), pm)
