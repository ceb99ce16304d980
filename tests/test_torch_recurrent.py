"""The SSM family served by the port and by the JAX package.

``mamba2-2.7b-smoke`` (2 mixer-only SSD layers, d 256, 16 heads of 32,
d_state 16, chunk 16) with the JAX package's random weights (seed 0)
bridged by ``from_numpy_tree``, and the launcher's default ViT at 112^2;
2 streams x 24 frames, gop 4, window 16, stride 4: one fresh and two
incremental windows per stream (where the mode reuses), through both
lockstep schedulers, in each of the six modes (every mode prefills
through ``RecurrentPrefill``; pruning and reuse follow the mode).

Equal: event order, token accounting and the FLOP ledger.  Within
tolerance: yes/no logits 5e-3, twice the largest gap measured (2.6e-3,
``torch_logit_gap.py``; bf16 matmuls round at other points in the two
frameworks, as for the attention family); the boundary state carried
into the next window, conv tails and SSD states, each to a
share of the reference's largest magnitude: 2e-2 where the mode prunes
(f32 sums over bf16 operands that rounded at those points, carried
across windows; the SSD states read 1.64e-2 there, and the conv tails
are exactly zero in both frameworks) and 3e-2 where it does not (SSD
states 2.19e-2, conv tails 1.41e-2): there every frame goes through the
dense ViT, whose tokens already differ by up to 5e-2 of their scale
between the frameworks (``test_torch_models.py``) before they enter the
stack.  A wrong state reads far above these limits: a zeroed state 1, a
state with its layers swapped 1.03, and a boundary state that the query
and decode entered (no fork copy) 0.96 or more.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import CodecCfg  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import ServingPipeline as JServingPipeline  # noqa: E402
from repro.serving import StreamRequest as JStreamRequest  # noqa: E402
from repro.training import checkpoint  # noqa: E402
from repro_torch.configs import CodecCfg as TCodecCfg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import default_vit  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    from_numpy_tree, init_lm_params, load_npz_params,
)
from repro_torch.serving import (  # noqa: E402
    MODES, EngineCfg, Scheduler, SchedulerCfg, ServingPipeline, StreamRequest,
)
from torch_mode_parity import STATS, assert_no_refusals, videos  # noqa: E402

ARCH = "mamba2-2.7b-smoke"
CODEC = dict(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
LOGIT_TOL = 5e-3
STATE_TOL = {True: 2e-2, False: 3e-2}      # by whether the mode prunes


@functools.lru_cache(maxsize=None)
def weights():
    jp = jserve.build_pipeline(ARCH, "codecflow", CodecCfg(**CODEC))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (jp.cfg, jp.v, jp.params, jp.vparams,
            from_numpy_tree(to_np(jp.params)), from_numpy_tree(to_np(jp.vparams)))


def _np_caches(caches):
    return [tuple(np.asarray(leaf.float() if isinstance(leaf, torch.Tensor) else leaf,
                             np.float32).copy() for leaf in blk) for blk in caches.blocks]


def _drive(pipe, sched, request_cls):
    """Run to idle; (events, per-sid results, boundary states after each
    served group)."""
    states = []
    serve_batch = pipe.serve_batch

    def logged(frames, metas, state):
        stats, new_state = serve_batch(frames, metas, state)
        states.append((new_state["offset"], _np_caches(new_state["caches"])))
        return stats, new_state
    pipe.serve_batch = logged
    for i, (frames, label) in enumerate(videos()):
        sched.submit(request_cls(i, np.asarray(frames), tag=label))
    events = [(type(e).__name__, e.sid, getattr(e, "window", None)) for e in sched.events()]
    results = {sid: sched.session(sid).results for sid in range(len(videos()))}
    return events, results, states


@functools.lru_cache(maxsize=None)
def serve(mode: str):
    """(jax, port) runs of one mode on the same weights and videos."""
    cfg, v, params, vparams, tparams, tvparams = weights()
    jpipe = JServingPipeline(cfg, v, params, vparams,
                             JEngineCfg(mode=mode, codec=CodecCfg(**CODEC)))
    j = _drive(jpipe, JScheduler(jpipe, JSchedulerCfg(max_concurrent=2, pipelined=False)),
               JStreamRequest)
    tcfg = get_config(ARCH)
    tpipe = ServingPipeline(tcfg, default_vit(tcfg), tparams, tvparams,
                            EngineCfg(mode=mode, codec=TCodecCfg(**CODEC)), device="cpu")
    ops.reset_dispatch_counts()
    t = _drive(tpipe, Scheduler(tpipe, SchedulerCfg(max_concurrent=2, pipelined=False)),
               StreamRequest)
    return j, t, ops.dispatch_counts(), tpipe


def _close(a, b, rel, what):
    """max |a - b| within ``rel`` of max |b| (exact where b is zero)."""
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    assert err <= rel * scale, (what, err / scale if scale else err, rel)


@pytest.mark.parametrize("mode", MODES)
def test_ssm_serves_like_jax(mode):
    j, t, _, _ = serve(mode)
    assert t[0] == j[0]
    n_windows = 3
    for sid, res_j in j[1].items():
        res_t = t[1][sid]
        assert [r.window for r in res_t] == [r.window for r in res_j] == list(range(n_windows))
        for a, b in zip(res_j, res_t):
            for f in STATS:
                assert getattr(a.stats, f) == getattr(b.stats, f), (f, sid, a.window)
            lj = np.asarray(a.stats.logits_yes_no)
            lt = np.asarray(b.stats.logits_yes_no)
            assert np.isfinite(lt).all()
            assert np.abs(lj - lt).max() <= LOGIT_TOL, (mode, sid, a.window, lj, lt)
            if abs(lj[0] - lj[1]) > 2 * LOGIT_TOL:
                assert a.stats.answer == b.stats.answer


@pytest.mark.parametrize("mode", MODES)
def test_boundary_state_matches_jax(mode):
    """The state each served group leaves for the next window: same
    offsets, conv tails and SSD states within tolerance; the query and
    decode never entered it."""
    j, t, _, pipe = serve(mode)
    tol = STATE_TOL[pipe.prune]
    assert len(t[2]) == len(j[2]) == 3
    for (off_j, caches_j), (off_t, caches_t) in zip(j[2], t[2]):
        assert off_t == off_j
        for blk_j, blk_t in zip(caches_j, caches_t):
            _close(blk_t[0], blk_j[0], tol, "conv")
            _close(blk_t[1], blk_j[1], tol, "ssm")


@pytest.mark.parametrize("mode", MODES)
def test_ssm_dispatches_its_kernels_plainly_on_cpu(mode):
    _, _, counts, pipe = serve(mode)
    want = {"mv_sad", "ssd_scan"} | ({"flash_packed"} if pipe.prune else set())
    assert pipe.kernels == want
    assert set(counts) == want, counts
    for op, c in counts.items():
        assert set(c) == {"backend:ok"}, (op, c)
    assert pipe.kv_bytes_per_stream() == 0 and pipe.can_admit(64)


@pytest.mark.parametrize("mode", MODES)
def test_ssm_windows_report_no_kernel_fallbacks(mode):
    """ssd_scan at mamba2-smoke's bf16 serving shapes: the card takes
    every call of every window."""
    assert_no_refusals(serve(mode)[1][1])


def test_npz_round_trip_keeps_mamba_f32_leaves(tmp_path):
    """A checkpoint written by the JAX package's ``training/checkpoint.py``
    loads leaf for leaf: A_log, D, dt_bias, the gated norm and the norm
    scales stay f32, the rest bf16, all values exact."""
    _, _, params, _, tparams, _ = weights()
    path = str(tmp_path / "mamba.npz")
    checkpoint.save(path, params)
    loaded = load_npz_params(path, get_config(ARCH))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tparams))
    flat_l = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(flat_l) == len(flat_t)
    for p, leaf in flat_l:
        assert leaf.dtype == flat_t[p].dtype, p
        assert torch.equal(leaf, flat_t[p]), p
    mixer = loaded["blocks"][0]["mixer"]
    for name in ("A_log", "D", "dt_bias", "norm"):
        assert mixer[name].dtype == torch.float32, name
    assert mixer["in_proj"].dtype == torch.bfloat16


def test_random_mamba_params_match_jax_structure():
    """``init_lm_params`` builds the JAX package's mamba tree: the same
    paths, shapes and dtypes, A_log and dt_bias as ``init_mamba`` makes
    them."""
    _, _, params, _, _, _ = weights()
    tp = init_lm_params(get_config(ARCH), seed=0, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (p, lj), (_, lt) in zip(flat_j, flat_t):
        assert lj.shape == tuple(lt.shape) and str(lt.dtype).endswith(str(lj.dtype)), p
    mixer_j, mixer_t = params["blocks"][0]["mixer"], tp["blocks"][0]["mixer"]
    for name in ("A_log", "dt_bias", "D", "norm"):
        np.testing.assert_allclose(mixer_t[name].numpy(), np.asarray(mixer_j[name]), rtol=1e-6)


def test_launch_serve_mamba_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--videos", "1", "--frames", "20"])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["arch"] == ARCH and report["windows_total"] == 2
    assert report["GFLOP_per_window"] > 0
