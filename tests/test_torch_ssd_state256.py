"""mamba2-2.7b at an SSD state width of 256, served and trained by the port
and by the JAX package.

``mamba2-2.7b-smoke`` (2 mixer-only SSD layers, d 256, 16 heads of 32,
chunk 16) re-cut to ``SSMCfg.d_state = 256`` with ``dataclasses.replace``
in both packages, as ``chip_smoke.py`` phases 7(h) and 8(g) cut the
full-size model: its in_proj is 2 x 240 columns wider and its conv runs
over d_inner + 512 channels.  The JAX package's random weights (seed 0)
are carried across by ``from_numpy_tree``; the ViT is the launcher's
default at 112^2.

* Served in codecflow and fullcomp, 2 streams x 24 frames through both
  lockstep schedulers: events, token accounting and the FLOP ledger
  equal; yes/no logits within ``test_torch_recurrent.py``'s 5e-3, the
  answers equal where the margin exceeds twice it; the boundary state
  each served group leaves (conv tails and SSD states, (2, 16, 32, 256)
  a layer) within its limits (2e-2 where the mode prunes, 3e-2 where it
  does not); every scan call one the card takes (no kernel fallback).
* One f32 training step (remat, batch 2, seq 32): loss, grad norm, every
  gradient leaf and the AdamW moments within 1e-5, the limit
  ``test_torch_train.py`` holds f32 configs to.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import CodecCfg  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import vit as jvitm  # noqa: E402
from repro.models.init import ParamBuilder, split_tree  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import ServingPipeline as JServingPipeline  # noqa: E402
from repro.serving import StreamRequest as JStreamRequest  # noqa: E402
from repro_torch.configs import CodecCfg as TCodecCfg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd_scan as S  # noqa: E402
from repro_torch.launch.serve import default_vit  # noqa: E402
from repro_torch.models.init import from_numpy_tree  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineCfg, Scheduler, SchedulerCfg, ServingPipeline, StreamRequest,
)
from torch_mode_parity import STATS, assert_no_refusals, videos  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401
from torch_train_parity import batch_arrays, jax_step, port_step, step_gaps  # noqa: E402

ARCH = "mamba2-2.7b-smoke"
D_STATE = 256
CODEC = dict(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
LOGIT_TOL = 5e-3
STATE_TOL = {True: 2e-2, False: 3e-2}      # by whether the mode prunes
MODES = ("codecflow", "fullcomp")


def wide(cfg, **kw):
    """``cfg`` with its SSD state re-cut to D_STATE (and ``kw``)."""
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, d_state=D_STATE), **kw)


@functools.lru_cache(maxsize=None)
def weights():
    jcfg = wide(j_get_config(ARCH))
    v = jserve.default_vit(jcfg)
    params, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    vparams, _ = split_tree(jvitm.init_vit(ParamBuilder(jax.random.PRNGKey(1)), v,
                                           jcfg.d_model))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (jcfg, v, params, vparams, from_numpy_tree(to_np(params)),
            from_numpy_tree(to_np(vparams)))


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
    jcfg, v, params, vparams, tparams, tvparams = weights()
    jpipe = JServingPipeline(jcfg, v, params, vparams,
                             JEngineCfg(mode=mode, codec=CodecCfg(**CODEC)))
    j = _drive(jpipe, JScheduler(jpipe, JSchedulerCfg(max_concurrent=2, pipelined=False)),
               JStreamRequest)
    tcfg = wide(get_config(ARCH))
    tpipe = ServingPipeline(tcfg, default_vit(tcfg), tparams, tvparams,
                            EngineCfg(mode=mode, codec=TCodecCfg(**CODEC)), device="cpu")
    t = _drive(tpipe, Scheduler(tpipe, SchedulerCfg(max_concurrent=2, pipelined=False)),
               StreamRequest)
    return j, t, tpipe


def _close(a, b, rel, what):
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= rel * scale, (what, err / scale if scale else err, rel)


def test_the_state_is_256_wide_and_runs_on_the_wide_build():
    tcfg = wide(get_config(ARCH))
    s = tcfg.ssm
    assert s.d_state == D_STATE and S.build_width(s.d_state) == 256
    assert S.column_slabs(s.d_state) == 2
    _, _, params, _, tparams, _ = weights()
    mixer, jmixer = tparams["blocks"][0]["mixer"], params["blocks"][0]["mixer"]
    di, gn = s.d_inner(tcfg.d_model), s.n_groups * D_STATE
    assert tuple(mixer["in_proj"].shape) == np.asarray(jmixer["in_proj"]).shape == (
        tcfg.n_layers, tcfg.d_model, 2 * di + 2 * gn + s.n_heads(tcfg.d_model))
    assert tuple(mixer["conv_w"].shape) == (tcfg.n_layers, s.d_conv, di + 2 * gn)


@pytest.mark.parametrize("mode", MODES)
def test_serves_like_jax(mode):
    j, t, _ = serve(mode)
    assert t[0] == j[0]
    for sid, res_j in j[1].items():
        res_t = t[1][sid]
        assert [r.window for r in res_t] == [r.window for r in res_j] == [0, 1, 2]
        for a, b in zip(res_j, res_t):
            for f in STATS:
                assert getattr(a.stats, f) == getattr(b.stats, f), (f, sid, a.window)
            lj, lt = np.asarray(a.stats.logits_yes_no), np.asarray(b.stats.logits_yes_no)
            assert np.isfinite(lt).all()
            assert np.abs(lj - lt).max() <= LOGIT_TOL, (mode, sid, a.window, lj, lt)
            if abs(lj[0] - lj[1]) > 2 * LOGIT_TOL:
                assert a.stats.answer == b.stats.answer
    assert_no_refusals(t[1])


@pytest.mark.parametrize("mode", MODES)
def test_boundary_state_matches_jax(mode):
    j, t, pipe = serve(mode)
    tol = STATE_TOL[pipe.prune]
    assert len(t[2]) == len(j[2]) == 3
    for (off_j, caches_j), (off_t, caches_t) in zip(j[2], t[2]):
        assert off_t == off_j
        for blk_j, blk_t in zip(caches_j, caches_t):
            assert blk_t[1].shape[-1] == D_STATE
            _close(blk_t[0], blk_j[0], tol, "conv")
            _close(blk_t[1], blk_j[1], tol, "ssm")


def test_f32_train_step_matches_jax():
    jcfg = wide(j_get_config(ARCH), dtype="float32")
    tcfg = wide(get_config(ARCH), dtype="float32")
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
    a = batch_arrays(jcfg, 2, 32)
    g = step_gaps(jax_step(jcfg, jp, a, remat=True), port_step(tcfg, tp, a, remat=True))
    assert max(g["loss"], g["grad_norm"], g["grad"], g["mu"], g["nu"]) <= 1e-5, g


def test_chip_smoke_phase_7h_case_is_the_full_model_at_d_state_256():
    """chip_smoke's phase 7(h) serves mamba2-2.7b at full size re-cut to
    d_state 256 (the registry's config but for the state), 2 x 40 frames
    of codecflow; the dispatch audit's third table takes its every call,
    the scan at (H 80, P 64, N 256) on the kernel."""
    import importlib.util
    from pathlib import Path
    from repro_torch.kernels import audit
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    key, arch, cfg, modes, frames, _ = {m[0]: m for m in cs.family_models()}["(h)"]
    full = get_config("mamba2-2.7b")
    assert (key, arch, modes, frames) == ("(h)", "mamba2-2.7b, d_state 256", ("codecflow",), 40)
    assert cfg == wide(full) and cfg.ssm.d_state == cs.WIDE_STATE == D_STATE
    assert cfg.n_layers == full.n_layers == 64
    rows = [r for r in audit.variant_rows() if r.arch == arch]
    assert {r.op for r in rows} == {"mv_sad", "flash_packed", "ssd_scan"}
    assert all(r.verdict == "kernel" for r in rows), rows
    assert [r.geometry for r in rows if r.op == "ssd_scan"] == [
        "H 80, P 64, N 256, chunk 256, bfloat16"]
