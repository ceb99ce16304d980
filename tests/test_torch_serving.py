"""The slice end to end: the port's lockstep ``Scheduler`` against the JAX
package's (the async engines: ``test_torch_async.py``), on
internvl3-14b-smoke with the same weights (bridged from the JAX trees)
and the same videos.

2 streams x 24 frames at 112^2 with the serve defaults (gop 4, window
16, stride 4, keep 0.5): one fresh and two incremental windows each.

Equal: per-window frame accounting (tokens_vis / tokens_valid /
tokens_refreshed), ViT patches and packed slots, the FLOP ledger, the
event order.  Yes/no logits: within LOGIT_TOL = 8e-3, twice the largest
gap measured at this size (4.05e-3, ``torch_logit_gap.py``): both keep the LM head's f32 result,
and the rest of the model runs in bf16, whose matmul outputs round at
other points in the two frameworks.  Answers: equal wherever the JAX
margin exceeds twice LOGIT_TOL.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import CodecCfg  # noqa: E402
from repro.data.pipeline import anomaly_dataset as j_anomaly_dataset  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import StreamRequest as JStreamRequest  # noqa: E402
from repro_torch.configs import CodecCfg as TCodecCfg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import anomaly_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.init import from_numpy_tree  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineCfg, Scheduler, SchedulerCfg, ServingPipeline, StreamAdmitted, StreamDone,
    StreamRequest, WindowDone,
)

ARCH = "internvl3-14b-smoke"
CODEC = dict(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
LOGIT_TOL = 8e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def served():
    videos = anomaly_dataset(2, 24, 112, 112)
    for (a, la), (b, lb) in zip(videos, j_anomaly_dataset(2, 24, 112, 112)):
        np.testing.assert_array_equal(a, b)
        assert la == lb
    jp = jserve.build_pipeline(ARCH, "codecflow", CodecCfg(**CODEC))
    js = JScheduler(jp, JSchedulerCfg(max_concurrent=2, pipelined=False))
    for i, (f, lab) in enumerate(videos):
        js.submit(JStreamRequest(i, np.asarray(f), tag=lab))
    jres = js.run()

    cfg = get_config(ARCH)
    pipe = ServingPipeline(cfg, cfg.vit, from_numpy_tree(np_tree(jp.params)),
                           from_numpy_tree(np_tree(jp.vparams)),
                           EngineCfg(mode="codecflow", codec=TCodecCfg(**CODEC)),
                           device="cpu")
    ts = Scheduler(pipe, SchedulerCfg(max_concurrent=2, pipelined=False))
    ops.reset_dispatch_counts()
    for i, (f, lab) in enumerate(videos):
        ts.submit(StreamRequest(i, np.asarray(f), tag=lab))
    events = list(ts.events())
    tres = {sid: ts.session(sid).results for sid in range(2)}
    return jres, tres, events, ts, ops.dispatch_counts()


def _pairs(served):
    jres, tres = served[0], served[1]
    assert sorted(jres) == sorted(tres) == [0, 1]
    for sid in jres:
        assert [r.window for r in jres[sid]] == [r.window for r in tres[sid]] == [0, 1, 2]
        yield from zip(jres[sid], tres[sid])


def test_answers_and_logits_match_jax(served):
    for a, b in _pairs(served):
        lj, lt = np.asarray(a.stats.logits_yes_no), np.asarray(b.stats.logits_yes_no)
        assert np.isfinite(lt).all()
        assert np.abs(lj - lt).max() <= LOGIT_TOL, (a.window, lj, lt)
        if abs(lj[0] - lj[1]) > 2 * LOGIT_TOL:
            assert a.stats.answer == b.stats.answer


def test_token_accounting_and_flop_ledger_equal(served):
    fields = ("tokens_vis", "tokens_valid", "tokens_refreshed", "vit_patches",
              "vit_slots", "flops_vit", "flops_prefill", "flops_decode",
              "kv_bytes_per_stream")
    for a, b in _pairs(served):
        for f in fields:
            assert getattr(a.stats, f) == getattr(b.stats, f), (f, a.window)


def test_event_protocol(served):
    events = served[2]
    for sid in (0, 1):
        mine = [e for e in events if e.sid == sid]
        assert isinstance(mine[0], StreamAdmitted)
        assert [e.window for e in mine if isinstance(e, WindowDone)] == [0, 1, 2]
        assert isinstance(mine[-1], StreamDone) and mine[-1].n_windows == 3
        assert sum(isinstance(e, StreamDone) for e in mine) == 1


def test_pages_released_and_fleet_metrics(served):
    ts = served[3]
    pool = ts.pipeline.backend.pool
    assert pool.used_pages == 0 and pool.free_pages == pool.n_pages
    assert ts.windows_served == 6 and ts.idle
    assert ts.kv_memory()["slab_bytes"] == pool.slab_bytes
    assert 0 < ts.vit_pack_utilization <= 1
    assert set(ts.latency_quantiles()) == {"p50", "p99", "mean"}
    assert len(ts.ttft) == 2 and set(ts.ttft_quantiles()) == {"p50", "p99", "mean"}
    occ = ts.stage_occupancy()
    assert 0 < sum(occ.values()) <= 1.0 + 1e-6


def test_cpu_run_dispatches_plain_versions_only(served):
    """codecflow on the paged bf16 slab dispatches exactly its four
    kernels, each to its plain version."""
    counts = served[4]
    assert set(counts) == {"mv_sad", "rope_shift", "flash_refresh_paged", "flash_packed"}
    assert set(counts) < set(ops.KERNELS)
    for op, c in counts.items():
        assert set(c) == {"backend:ok"}, (op, c)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingPipeline(cfg, cfg.vit, {}, {}, EngineCfg(codec=TCodecCfg(**CODEC)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_pipeline(ARCH, "codecflow", TCodecCfg(**CODEC))


def test_unported_options_raise():
    """The padded ViT is not ported (every mode, both KV layouts and int8
    cold pages are: test_torch_modes.py, test_torch_variants.py; the SSM
    family: test_torch_recurrent.py; MoE and hybrid: test_torch_moe.py,
    test_torch_hybrid.py; the encoder-decoder family and training:
    test_torch_whisper.py, test_torch_train.py)."""
    cfg = get_config(ARCH)
    from repro_torch.serving import PruneCfg
    codec = TCodecCfg(**CODEC)
    with pytest.raises(NotImplementedError):
        ServingPipeline(cfg, cfg.vit, {}, {},
                        EngineCfg(prune=PruneCfg(packed_vit=False), codec=codec), device="cpu")


def test_launch_serve_main_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--videos", "1", "--frames", "20"])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["windows_total"] == 2 and report["scheduler"] == "pipelined"
    assert report["arch"] == ARCH and report["GFLOP_per_window"] > 0


def test_launch_serve_main_lockstep_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--videos", "2", "--streams", "2", "--frames", "20",
                 "--lockstep", "--ingest-workers", "0"])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["windows_total"] == 4 and report["scheduler"] == "lockstep"
    assert 0 < sum(report["stage_occupancy"].values()) <= 1.0 + 1e-6
