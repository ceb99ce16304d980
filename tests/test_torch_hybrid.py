"""The hybrid family (attention + Mamba-2 + MoE in one stack) served by
the port and by the JAX package.

``jamba-v0.1-52b-smoke`` (16 layers: per period of 8, one attention
layer at position 4 and seven SSD mixers, MoE FFNs at odd positions, 4
experts top-2; d 256, 4/4 heads of 64, d_state 16, chunk 16) with the
JAX package's random weights (seed 0) and the launcher's default ViT at
112^2, 2 streams x 24 frames, gop 4, window 16, stride 4: three windows
per stream, through both lockstep schedulers, in codecflow (the
boundary state carried and extended) and fullcomp (every window from
scratch).  Both prefill through ``RecurrentPrefill``; the attention
layers keep per-stream caches of the reference's ``max_hist`` slots.

In f32 the stack is the reference's to 1e-5 (three appends with
validity masks; measured 2.6e-6), so the two compute the same function.
In bf16 they round at other points, and the SSD mixers carry that
through 16 layers and three windows.  Equal: event order, token
accounting and the FLOP ledger.  Some tokens pick other experts on near
ties (``torch_moe_routes``, reported with their gate margins); the port
is then served again on the reference's choices.  On that run: yes/no
logits within 4e-2 (1.5x the largest gap measured, 2.6e-2 in fullcomp;
the two-layer SSM stack of ``test_torch_recurrent.py`` reads 2.6e-3,
and a 16-layer SSD stack with no MoE 1.6e-2 at one window); the
boundary state after every served group, three windows deep, with the
RMS of its difference within 0.15 of the reference's RMS for conv
tails, SSD states and the attention layers' K/V up to the offset
(measured 5.6e-2, 9.0e-2 and 4.9e-2; another window's state reads 1.28,
a zeroed one 1).
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import CodecCfg  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import ServingPipeline as JServingPipeline  # noqa: E402
from repro.serving import StreamRequest as JStreamRequest  # noqa: E402
from repro.training import checkpoint  # noqa: E402
from repro_torch.configs import CodecCfg as TCodecCfg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import anomaly_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_refresh import build_block_map  # noqa: E402
from repro_torch.launch.serve import default_vit  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    from_numpy_tree, init_lm_params, load_npz_params,
)
from repro_torch.serving import (  # noqa: E402
    Engine, EngineCfg, EventProtocolValidator, Scheduler, SchedulerCfg, ServingPipeline,
    StreamRequest,
)
from torch_mode_parity import STATS, assert_no_refusals  # noqa: E402
import torch_moe_routes as routes  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

ARCH = "jamba-v0.1-52b-smoke"
CODEC = dict(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
N_FRAMES = 24                       # three windows per stream
PATHS = ("codecflow", "fullcomp")
LOGIT_TOL = 4e-2
STATE_TOL = 0.15
F32_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def weights():
    jp = jserve.build_pipeline(ARCH, "codecflow", CodecCfg(**CODEC))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (jp.cfg, jp.v, jp.params, jp.vparams,
            from_numpy_tree(to_np(jp.params)), from_numpy_tree(to_np(jp.vparams)))


@functools.lru_cache(maxsize=None)
def videos(n: int = 2, frames: int = N_FRAMES):
    return tuple(anomaly_dataset(n, frames, 112, 112))


def port_pipeline(mode: str, **codec) -> ServingPipeline:
    *_, tparams, tvparams = weights()
    cfg = get_config(ARCH)
    return ServingPipeline(cfg, default_vit(cfg), tparams, tvparams,
                           EngineCfg(mode=mode, codec=TCodecCfg(**dict(CODEC, **codec))),
                           device="cpu")


def _np_state(state):
    """(offset, per position: the leaves of its cache as f32 numpy)."""
    return state["offset"], [tuple(np.asarray(leaf.float() if isinstance(leaf, torch.Tensor)
                                              else leaf, np.float32).copy() for leaf in blk)
                             for blk in state["caches"].blocks]


def _drive(pipe, sched, request_cls):
    """Run to idle; (events, per-sid results, boundary state after each
    served group)."""
    states = []
    serve_batch = pipe.serve_batch

    def logged(frames, metas, state):
        stats, new_state = serve_batch(frames, metas, state)
        states.append(_np_state(new_state))
        return stats, new_state
    pipe.serve_batch = logged
    for i, (frames, label) in enumerate(videos()):
        sched.submit(request_cls(i, np.asarray(frames), tag=label))
    events = [(type(e).__name__, e.sid, getattr(e, "window", None)) for e in sched.events()]
    results = {sid: sched.session(sid).results for sid in range(len(videos()))}
    return events, results, states


def _port_run(mode, choices, force=None):
    pipe = port_pipeline(mode)
    ops.reset_dispatch_counts()
    with routes.port_choices(choices, force=force):
        out = _drive(pipe, Scheduler(pipe, SchedulerCfg(max_concurrent=2, pipelined=False)),
                     StreamRequest)
    return out + (ops.dispatch_counts(), pipe)


@functools.lru_cache(maxsize=None)
def served(mode: str):
    """(JAX run, port run, port run on the JAX choices or None, flips of
    the port's run, flips it would have made on the JAX choices)."""
    cfg, v, params, vparams, _, _ = weights()
    jlog = []
    with routes.jax_choices(jlog):
        jpipe = JServingPipeline(cfg, v, params, vparams,
                                 JEngineCfg(mode=mode, codec=CodecCfg(**CODEC)))
        j = _drive(jpipe, JScheduler(jpipe, JSchedulerCfg(max_concurrent=2, pipelined=False)),
                   JStreamRequest)
    tlog = []
    t = _port_run(mode, tlog)
    found = routes.flips(jlog, tlog)
    forced, forced_flips = None, []
    if found:
        flog = []
        forced = _port_run(mode, flog, force=jlog)
        forced_flips = routes.flips(jlog, flog)
    return j, t, forced, found, forced_flips


def _close(a, b, rel, what):
    """RMS of a - b within ``rel`` of b's RMS (exact where b is zero)."""
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.sqrt(np.mean(np.square(a - b, dtype=np.float64))))
    scale = float(np.sqrt(np.mean(np.square(b, dtype=np.float64))))
    assert err <= rel * scale, (what, err / scale if scale else err, rel)


def _same_accounting(j, t, n_windows):
    assert t[0] == j[0]
    for sid, res_j in j[1].items():
        res_t = t[1][sid]
        assert [r.window for r in res_t] == [r.window for r in res_j] == list(range(n_windows))
        for a, b in zip(res_j, res_t):
            for f in STATS:
                assert getattr(a.stats, f) == getattr(b.stats, f), (f, sid, a.window)
            assert np.isfinite(np.asarray(b.stats.logits_yes_no)).all()


@pytest.mark.parametrize("mode", PATHS)
def test_hybrid_serves_like_jax(mode):
    j, t, forced, found, forced_flips = served(mode)
    _same_accounting(j, t, 3)
    routes.assert_near_ties(forced_flips)
    run = forced or t
    _same_accounting(j, run, 3)
    for sid, res_j in j[1].items():
        for a, b in zip(res_j, run[1][sid]):
            lj = np.asarray(a.stats.logits_yes_no)
            lt = np.asarray(b.stats.logits_yes_no)
            assert np.abs(lj - lt).max() <= LOGIT_TOL, (mode, sid, a.window, lj, lt)
            if abs(lj[0] - lj[1]) > 2 * LOGIT_TOL:
                assert a.stats.answer == b.stats.answer
    if found:
        print(f"{mode}: {len(found)} tokens chose other experts in the port's run; "
              f"on the reference's choices {len(forced_flips)} would, with margins "
              f"{[round(f[4], 6) for f in forced_flips]}")


def test_f32_stack_is_the_reference_function():
    """jamba-smoke in f32 through three contiguous appends (160, 40 and 40
    tokens, a fifth of them invalid) into per-stream caches: logits, the
    last hidden state, every conv tail, SSD state and attention K/V
    within 1e-5 of the reference's largest magnitude."""
    jc = dataclasses.replace(j_get_config(ARCH), dtype="float32")
    tc = dataclasses.replace(get_config(ARCH), dtype="float32")
    params, _ = jtfm.init_params(jc, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params))
    S, slots, off = 2, 768, 0
    rng = np.random.default_rng(3)
    jc_caches = jtfm.init_caches(jc, S, slots, dtype=jax.numpy.float32)
    tc_caches = tfm.init_caches(tc, S, slots, dtype=torch.float32)
    step = jax.jit(lambda p, c, e, v, o: jtfm.prefill(
        jc, p, jax.numpy.zeros(e.shape[:2], jax.numpy.int32), c, valid=v, inputs_embeds=e,
        cache_offset=o))
    for T in (160, 40, 40):
        x = rng.normal(size=(S, T, jc.d_model)).astype(np.float32)
        valid = rng.random((S, T)) < 0.8
        lj, jc_caches, hj = step(params, jc_caches, x, valid, off)
        lt, tc_caches, ht = tfm.prefill(
            tc, tp, torch.zeros((S, T), dtype=torch.long), tc_caches,
            valid=torch.from_numpy(valid), inputs_embeds=torch.from_numpy(x),
            cache_offset=off, block_map=build_block_map(np.arange(off, off + T), slots))
        off += T
        pairs = [(lt, lj), (ht, hj)] + [
            (leaf_t, leaf_j) for blk_t, blk_j in zip(tc_caches.blocks, jc_caches.blocks)
            for leaf_t, leaf_j in zip(blk_t, blk_j)]
        for a, b in pairs:
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= F32_TOL * np.abs(b).max()


def test_boundary_state_matches_jax():
    """The state each codecflow group leaves for the next window, three
    windows deep: same offsets; conv tails, SSD states and the attention
    layers' K/V up to the offset within tolerance."""
    j, t, forced, _, _ = served("codecflow")
    run = forced or t
    cfg = get_config(ARCH)
    assert len(run[2]) == len(j[2]) == 3
    for (off_j, caches_j), (off_t, caches_t) in zip(j[2], run[2]):
        assert off_t == off_j
        for pos, (blk_j, blk_t) in enumerate(zip(caches_j, caches_t)):
            if cfg.block_kind(pos)[0] == "attn":
                for leaf_j, leaf_t, name in zip(blk_j, blk_t, "kv"):
                    _close(leaf_t[:, :, :off_t], leaf_j[:, :, :off_j], STATE_TOL, name)
            else:
                _close(blk_t[0], blk_j[0], STATE_TOL, "conv")
                _close(blk_t[1], blk_j[1], STATE_TOL, "ssm")


def test_query_and_decode_stay_past_the_offset():
    """The query's and decode's K/V are written past the boundary state's
    offset, where the next window's append overwrites them before any
    pass reads them: there the port's slots hold them and the reference's
    (forked) boundary cache holds zeros; up to the offset both hold the
    same keys (``test_boundary_state_matches_jax``)."""
    j, t, forced, _, _ = served("codecflow")
    run = forced or t
    attn = get_config(ARCH).block_pattern.index("attn")
    lay = run[4].layout
    for (off_j, caches_j), (off_t, caches_t) in zip(j[2], run[2]):
        end = off_t + lay.query_len + run[4].ecfg.max_new_tokens
        k_j, k_t = caches_j[attn][0], caches_t[attn][0]
        assert np.abs(k_j[:, :, off_j:]).max() == 0
        assert (np.abs(k_t[:, :, off_t:end]).max(axis=(0, 3, 4)) > 0).all()
        assert np.abs(k_t[:, :, end:]).max() == 0


@pytest.mark.parametrize("mode", PATHS)
def test_hybrid_dispatches_its_kernels_plainly_on_cpu(mode):
    _, t, _, _, _ = served(mode)
    counts, pipe = t[3], t[4]
    want = {"mv_sad", "ssd_scan", "flash_refresh"} | ({"flash_packed"} if pipe.prune else set())
    assert pipe.kernels == want
    assert set(counts) == want, counts
    for op, c in counts.items():
        assert set(c) == {"backend:ok"}, (op, c)
    assert pipe.kv_bytes_per_stream() == 0 and pipe.can_admit(64)


@pytest.mark.parametrize("mode", PATHS)
def test_hybrid_windows_report_no_kernel_fallbacks(mode):
    assert_no_refusals(served(mode)[1][1])


def test_attention_caches_hold_max_hist_slots():
    """The attention caches hold the reference's ``default_max_hist()``
    slots, rounded up to 128-row tiles; decode maps cover the same slots."""
    cfg, v, params, vparams, _, _ = weights()
    jpipe = JServingPipeline(cfg, v, params, vparams,
                             JEngineCfg(mode="codecflow", codec=CodecCfg(**CODEC)))
    pipe = port_pipeline("codecflow")
    mh = jpipe.backend.default_max_hist()
    assert pipe.backend.max_hist == mh
    assert pipe.cache_slots == pipe.backend.cache_slots == -(-mh // 128) * 128
    assert pipe.decoder.decode_map(mh - 1, pipe.cache_slots).kv_len == pipe.cache_slots
    caches = tfm.init_caches(get_config(ARCH), 2, pipe.cache_slots)
    jcaches = jtfm.init_caches(cfg, 2, pipe.cache_slots)
    for blk_t, blk_j in zip(caches.blocks, jcaches.blocks):
        assert type(blk_t).__name__ == type(blk_j).__name__
        for leaf_t, leaf_j in zip(blk_t, blk_j):
            assert tuple(leaf_t.shape) == leaf_j.shape
            assert str(leaf_t.dtype).endswith(str(leaf_j.dtype))


def test_overflow_past_max_hist_raises():
    """Accepted difference: where the reference's contiguous write would
    clamp silently (its JAX arrays cannot grow), the port raises before
    any work.  A window that ends exactly at ``max_hist`` is served."""
    pipe = port_pipeline("codecflow")
    b, lay = pipe.backend, pipe.layout
    n_new = lay.shift_tokens
    d = get_config(ARCH).d_model
    vis = torch.zeros((1, n_new, d), dtype=torch.bfloat16)
    vval = torch.ones((1, n_new), dtype=torch.bool)
    qe = pipe._query_embeds(1)
    last = b.max_hist - n_new - lay.query_len - pipe.ecfg.max_new_tokens
    for offset, raises in ((last, False), (last + 1, True)):
        state = {"caches": tfm.init_caches(get_config(ARCH), 1, b.cache_slots),
                 "offset": offset}
        if raises:
            with pytest.raises(ValueError, match="max_hist"):
                b.step(vis, vval, qe, state)
        else:
            assert b.step(vis, vval, qe, state).state["offset"] == offset + n_new


@pytest.fixture()
def one_intra_op_thread():
    """The async engine's ingest threads call torch beside the main thread:
    one intra-op thread each keeps the shared host from oversubscribing
    (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_run(pipelined: bool, vids, max_concurrent: int):
    pipe = port_pipeline("codecflow")
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=max_concurrent, pipelined=pipelined))
    groups = []
    prefill = pipe.prefill_windows

    def logged(enc, state):
        groups.append((enc.vis.shape[0], -1 if state is None else state["offset"]))
        return prefill(enc, state)
    pipe.prefill_windows = logged
    for i, (f, lab) in enumerate(vids):
        sched.submit(StreamRequest(i, np.asarray(f), tag=lab))
    validator = EventProtocolValidator()
    events = [(type(e).__name__, e.sid, getattr(e, "window", None))
              for e in validator.wrap(sched.events())]
    validator.assert_complete()
    stats = {sid: [r.stats for r in sched.session(sid).results] for sid in range(len(vids))}
    return events, stats, groups


def test_async_equals_lockstep_bitwise(one_intra_op_thread):
    """Both engines fuse the same groups on this fleet (3 streams x 24
    frames), so every stat, the yes/no logits included, is equal."""
    vids = videos(3, 24)
    ev_l, st_l, g_l = _engine_run(False, vids, 3)
    ev_a, st_a, g_a = _engine_run(True, vids, 3)
    assert sorted(g_a) == sorted(g_l)
    per = lambda ev: {s: [(k, w) for k, s2, w in ev if s2 == s] for _, s, _ in ev}  # noqa: E731
    assert per(ev_a) == per(ev_l)
    for sid in st_l:
        assert len(st_a[sid]) == len(st_l[sid]) == 3
        for a, b in zip(st_a[sid], st_l[sid]):
            assert a.logits_yes_no == b.logits_yes_no and a.answer == b.answer
            for f in STATS:
                assert getattr(a, f) == getattr(b, f), (sid, f)


def test_sessions_batch_on_equal_offsets(one_intra_op_thread):
    """Streams of 24, 32 and 24 frames with two admitted at a time: the
    third joins mid-way, at another offset than the second, so groups
    fuse only streams whose boundary states end at the same offset; the
    answers equal each stream served alone (``Engine.run_stream``), as in
    the reference's ``test_scheduler_streaming_family``."""
    vids = (videos(3, 24)[0], videos(3, 32)[1], videos(3, 24)[2])
    eng = Engine.from_pipeline(port_pipeline("codecflow"))
    alone = [eng.run_stream(np.asarray(frames)) for frames, _ in vids]
    for pipelined in (False, True):
        _, stats, groups = _engine_run(pipelined, vids, 2)
        assert any(n > 1 for n, off in groups if off >= 0)     # fused at one offset
        assert len({off for n, off in groups if n == 1 and off >= 0}) >= 2   # apart
        for sid in range(len(vids)):
            assert [s.answer for s in stats[sid]] == [s.answer for s in alone[sid]]
            for a, b in zip(stats[sid], alone[sid]):
                assert np.abs(np.asarray(a.logits_yes_no)
                              - np.asarray(b.logits_yes_no)).max() <= LOGIT_TOL


# ----------------------------------------------------------------------
# weights and the launcher
# ----------------------------------------------------------------------
def test_hybrid_weight_bridge_and_npz_round_trip(tmp_path):
    """The JAX package's jamba tree bridges leaf for leaf, and a checkpoint
    of it loads back exactly: mamba's A_log, D, dt_bias and gated norm
    and every norm scale f32, the rest bf16."""
    _, _, params, _, tparams, _ = weights()
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tparams))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        assert tuple(flat_t[path].shape) == leaf.shape
        assert str(flat_t[path].dtype).endswith(str(leaf.dtype)), path
    path = str(tmp_path / "jamba.npz")
    checkpoint.save(path, params)
    loaded = load_npz_params(path, get_config(ARCH))
    flat_l = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(flat_l) == len(flat_t)
    for p, leaf in flat_l:
        assert leaf.dtype == flat_t[p].dtype and torch.equal(leaf, flat_t[p]), p
    mamba_moe = loaded["blocks"][1]
    assert mamba_moe["mixer"]["A_log"].dtype == torch.float32
    assert mamba_moe["ffn"]["router"].dtype == torch.bfloat16
    assert mamba_moe["ln2"]["scale"].dtype == torch.float32


def test_random_hybrid_params_match_jax_structure():
    """``init_lm_params`` builds every block kind of the configs with the
    JAX package's paths, shapes and dtypes: (mamba, dense), (mamba, moe),
    (attn, dense) here, and (mamba, none) for the SSM family."""
    for arch in (ARCH, "mamba2-2.7b-smoke"):
        jp, _ = jtfm.init_params(j_get_config(arch), jax.random.PRNGKey(0))
        tp = init_lm_params(get_config(arch), seed=0, device="cpu")
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        flat_t = jax.tree_util.tree_leaves_with_path(tp)
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t], arch
        for (p, lj), (_, lt) in zip(flat_j, flat_t):
            assert lj.shape == tuple(lt.shape) and str(lt.dtype).endswith(str(lj.dtype)), p
    kinds = {get_config(ARCH).block_kind(pos) for pos in range(get_config(ARCH).period)}
    assert kinds == {("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")}


def test_launch_serve_jamba_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--videos", "2", "--streams", "2",
                "--frames", "20"])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["arch"] == ARCH and report["windows_total"] == 4
    assert report["scheduler"] == "pipelined" and report["GFLOP_per_window"] > 0

