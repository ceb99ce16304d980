"""Serve one configuration through the JAX package's lockstep scheduler and
the port's, on the same weights and videos, and record what the parity
tests compare: events, window stats, refresh sets, demotions, kernel
dispatch.

internvl3-14b-smoke unless ``arch`` names another config (a model
without a ViT takes the launchers' default 112^2 ViT), 2 streams x 24
frames at 112^2, gop 4, window 16, stride 4: one fresh and two
incremental windows per stream.  Weights are the JAX package's random
init (seed 0), bridged to the port as numpy; QKV biases, zero at init,
are drawn from a seeded normal (scale 0.5) so that they count.
"""
import functools

import numpy as np

import jax

from repro.configs import CodecCfg
from repro.launch import serve as jserve
from repro.serving import EngineCfg as JEngineCfg
from repro.serving import KVCfg as JKVCfg
from repro.serving import PruneCfg as JPruneCfg
from repro.serving import Scheduler as JScheduler
from repro.serving import SchedulerCfg as JSchedulerCfg
from repro.serving import ServingPipeline as JServingPipeline
from repro.serving import StreamRequest as JStreamRequest
from repro_torch.configs import CodecCfg as TCodecCfg
from repro_torch.configs import get_config
from repro_torch.data.pipeline import anomaly_dataset
from repro_torch.kernels import ops
from repro_torch.launch.serve import default_vit
from repro_torch.models.init import from_numpy_tree
from repro_torch.serving import (
    REUSE_MODES, EngineCfg, KVCfg, PruneCfg, Scheduler, SchedulerCfg, ServingPipeline,
    StreamRequest,
)

ARCH = "internvl3-14b-smoke"
CODEC = dict(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
# largest yes/no logit gap over the parity configurations (measured by
# ``torch_logit_gap.py``):
# 1.16e-2 (cacheblend, whose refresh set breaks ties on the last bits of
# the layer-0 keys; 8.3e-3 for the others); 1.5x that
LOGIT_TOL = 1.75e-2
STATS = ("tokens_vis", "tokens_valid", "tokens_refreshed", "vit_patches",
         "vit_slots", "flops_vit", "flops_prefill", "flops_decode",
         "kv_bytes_per_stream")


def _random_biases(params, seed: int = 0):
    """The LM tree with every QKV bias drawn from a seeded normal."""
    rng = np.random.default_rng(seed)
    blocks = []
    for blk in params["blocks"]:
        mixer = dict(blk["mixer"])
        for name in ("bq", "bk", "bv"):
            b = mixer[name]
            mixer[name] = jax.numpy.asarray(
                rng.normal(scale=0.5, size=b.shape).astype(np.float32)).astype(b.dtype)
        blocks.append(dict(blk, mixer=mixer))
    return dict(params, blocks=tuple(blocks))


@functools.lru_cache(maxsize=None)
def weights(arch: str = ARCH):
    jp = jserve.build_pipeline(arch, "codecflow", CodecCfg(**CODEC))
    params = _random_biases(jp.params) if jp.cfg.qkv_bias else jp.params
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (jp.cfg, jp.v, params, jp.vparams,
            from_numpy_tree(to_np(params)), from_numpy_tree(to_np(jp.vparams)))


@functools.lru_cache(maxsize=None)
def videos():
    return tuple(anomaly_dataset(2, 24, 112, 112))


def _record(obj, name, log):
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append(np.asarray(out).copy())
        return out
    setattr(obj, name, wrapped)


def _drive(pipe, sched, request_cls, deviations=None):
    """Run to idle; (events as (kind, sid, window), per-sid results,
    refresh sets, demotions).  ``deviations`` collects cacheblend's
    probe values where given."""
    refresh, demoted = [], []
    if hasattr(pipe.backend, "refresh_indices"):      # not the recurrent backend
        _record(pipe.backend, "refresh_indices", refresh)
    if deviations is not None:
        _record(pipe.backend, "cacheblend_deviation", deviations)
    if getattr(pipe.backend, "pool", None) is not None:
        _record(pipe.backend.pool, "demote", demoted)
    for i, (frames, label) in enumerate(videos()):
        sched.submit(request_cls(i, np.asarray(frames), tag=label))
    events = [(type(e).__name__, e.sid, getattr(e, "window", None))
              for e in sched.events()]
    results = {sid: sched.session(sid).results for sid in range(len(videos()))}
    return events, results, refresh, demoted


def jax_pipeline(mode: str, paged: bool, stale: str = "bf16", keep_ratio: float = 0.5,
                 arch: str = ARCH, packed_vit: bool = True):
    """The JAX package's pipeline of one configuration (modes without
    reuse never page their KV there)."""
    cfg, v, params, vparams, _, _ = weights(arch)
    codec = CodecCfg(**dict(CODEC, keep_ratio=keep_ratio))
    return JServingPipeline(cfg, v, params, vparams, JEngineCfg(
        mode=mode, codec=codec, prune=JPruneCfg(packed_vit=packed_vit),
        kv=JKVCfg(paged_kv=paged and mode in REUSE_MODES, stale_page_dtype=stale)))


def port_pipeline(mode: str, paged: bool, stale: str = "bf16", keep_ratio: float = 0.5,
                  arch: str = ARCH, packed_vit: bool = True):
    """The port's pipeline of one configuration, on the CPU, with the
    same weights."""
    _, _, _, _, params, vparams = weights(arch)
    cfg = get_config(arch)
    codec = TCodecCfg(**dict(CODEC, keep_ratio=keep_ratio))
    return ServingPipeline(cfg, default_vit(cfg), params, vparams, EngineCfg(
        mode=mode, codec=codec, prune=PruneCfg(packed_vit=packed_vit),
        kv=KVCfg(paged_kv=paged, stale_page_dtype=stale)), device="cpu")


@functools.lru_cache(maxsize=None)
def _serve_jax(mode, paged, stale, keep_ratio, arch, packed_vit):
    pipe = jax_pipeline(mode, paged, stale, keep_ratio, arch, packed_vit)
    sched = JScheduler(pipe, JSchedulerCfg(max_concurrent=2, pipelined=False))
    return _drive(pipe, sched, JStreamRequest)


@functools.lru_cache(maxsize=None)
def serve(mode: str, paged: bool, stale: str = "bf16", keep_ratio: float = 0.5,
          arch: str = ARCH, packed_vit: bool = True):
    """(jax, port) runs of one configuration; each is (events, results,
    refresh sets, demotions), the port's also its dispatch counts, its
    pipeline and cacheblend's deviations.  ``packed_vit=False`` serves
    both on the padded ViT."""
    # modes without reuse never page their KV: the JAX runs are the same
    j = _serve_jax(mode, paged and mode in REUSE_MODES, stale, keep_ratio, arch,
                   packed_vit)
    pipe = port_pipeline(mode, paged, stale, keep_ratio, arch, packed_vit)
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=2, pipelined=False))
    ops.reset_dispatch_counts()
    devs = [] if mode == "cacheblend" else None
    t = _drive(pipe, sched, StreamRequest, devs)
    return j, t + (ops.dispatch_counts(), pipe, devs)


def assert_parity(j, t, exact_refresh: bool = True, tol: float = LOGIT_TOL):
    """Event order, stats, refresh sets and demotions equal; logits within
    ``tol`` (LOGIT_TOL unless given); answers equal where the JAX margin
    exceeds 2 x ``tol``.
    With ``exact_refresh`` off the refresh sets are held to their size
    and their part past the overlap (the new stride and query)."""
    assert t[0] == j[0]
    assert len(t[2]) == len(j[2])
    for arr_t, arr_j in zip(t[2], j[2]):
        if exact_refresh:
            np.testing.assert_array_equal(arr_t, arr_j)
        else:
            ov = t[5].layout.overlap_tokens
            assert arr_t.shape == arr_j.shape
            np.testing.assert_array_equal(arr_t[arr_t >= ov], arr_j[arr_j >= ov])
    assert len(t[3]) == len(j[3])
    for arr_t, arr_j in zip(t[3], j[3]):
        np.testing.assert_array_equal(arr_t, arr_j)
    for sid, res_j in j[1].items():
        res_t = t[1][sid]
        assert [r.window for r in res_t] == [r.window for r in res_j] == [0, 1, 2]
        for a, b in zip(res_j, res_t):
            for f in STATS:
                assert getattr(a.stats, f) == getattr(b.stats, f), (f, sid, a.window)
            lj = np.asarray(a.stats.logits_yes_no)
            lt = np.asarray(b.stats.logits_yes_no)
            assert np.isfinite(lt).all()
            assert np.abs(lj - lt).max() <= tol, (sid, a.window, lj, lt)
            if abs(lj[0] - lj[1]) > 2 * tol:
                assert a.stats.answer == b.stats.answer


def assert_no_refusals(results):
    """Every window of a run (per-sid results) reports 0 kernel calls
    the card would refuse."""
    fb = [r.stats.kernel_fallbacks for res in results.values() for r in res]
    assert fb and fb == [0] * len(fb), fb


def assert_plain_dispatch(t):
    """On the CPU every op of the port's run ran its plain version, and
    exactly the kernels its pipeline names were dispatched."""
    counts, pipe = t[4], t[5]
    assert set(counts) == set(pipe.kernels), counts
    for op, c in counts.items():
        assert set(c) == {"backend:ok"}, (op, c)
