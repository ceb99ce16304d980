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
from torch_threads import torch_one_thread  # noqa: E402,F401

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


def test_windows_report_no_kernel_fallbacks(served):
    """The main path in bf16: the card takes every kernel call."""
    assert [b.stats.kernel_fallbacks for _, b in _pairs(served)] == [0] * 6
    assert served[3].kernel_fallbacks == 0


def _serve_heads(d: int):
    """A 2-layer LM and ViT with 2 heads of ``d`` served on the CPU, one
    stream of 12 frames (one fresh and one incremental window): (results,
    scheduler, card verdicts)."""
    from repro_torch.configs import ModelCfg, ViTCfg
    from repro_torch.models.init import init_lm_params, init_vit_params

    cfg = ModelCfg(name=f"d{d}", family="vlm", n_layers=2, d_model=2 * d, n_heads=2, n_kv=1,
                   d_ff=128, vocab=64, tied_embeddings=True)
    vit = ViTCfg(n_layers=2, d_model=2 * d, n_heads=2, d_ff=128, patch=14, image=112, group=2)
    pipe = ServingPipeline(cfg, vit, init_lm_params(cfg, 0, "cpu"),
                           init_vit_params(vit, cfg.d_model, 1, "cpu"),
                           EngineCfg(mode="codecflow", codec=TCodecCfg(
                               gop=4, window_frames=8, stride_frames=4, keep_ratio=0.4)),
                           device="cpu")
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=1))
    ops.reset_card_verdicts()
    ops.reset_dispatch_counts()
    frames, label = anomaly_dataset(1, 12, 112, 112)[0]
    sched.submit(StreamRequest(0, np.asarray(frames), tag=label))
    results = sched.run()[0]
    assert all(set(c) == {"backend:ok"} for c in ops.dispatch_counts().values())
    assert all(np.isfinite(r.stats.logits_yes_no).all() for r in results)
    return results, sched, ops.card_verdicts()


def test_a_serve_the_card_refuses_counts_its_fallbacks(monkeypatch):
    """ViT packing tiles of 64 (``VisualEncoder.PACK_TILE``), whose maps
    the card refuses by the ``map-tile`` rule (its tiles are 128 x 128):
    on the CPU every window counts the calls the card would refuse, by
    rule, and the plain versions serve it; the other ops stay ``ok``."""
    from repro_torch.serving.api import VisualEncoder
    monkeypatch.setattr(VisualEncoder, "PACK_TILE", 64)
    results, sched, verdicts = _serve_heads(32)
    fb = [r.stats.kernel_fallbacks for r in results]
    assert len(fb) == 2 and all(n > 0 for n in fb)
    assert sched.kernel_fallbacks == sum(fb)
    assert set(verdicts["flash_packed"]) == {"map-tile"}, verdicts
    for op in ("flash_refresh_paged", "rope_shift", "mv_sad"):
        assert set(verdicts[op]) == {"ok"}, verdicts


def test_a_serve_at_head_dim_264_has_no_fallbacks():
    """Head dim 264, refused until the D-512 build took every head dim
    from 257 to 512: every call is one the card takes."""
    results, sched, verdicts = _serve_heads(264)
    assert [r.stats.kernel_fallbacks for r in results] == [0, 0]
    assert sched.kernel_fallbacks == 0
    assert set(verdicts) == {"mv_sad", "flash_packed", "flash_refresh_paged", "rope_shift"}
    assert all(set(c) == {"ok"} for c in verdicts.values()), verdicts


def test_a_serve_at_head_dim_1040_has_no_fallbacks():
    """Head dim 1040, refused until the DEEP build took every head dim
    past 512 (five depth chunks of Q K^T, five column slabs of V and O):
    every call is one the card takes."""
    results, sched, verdicts = _serve_heads(1040)
    assert [r.stats.kernel_fallbacks for r in results] == [0, 0]
    assert sched.kernel_fallbacks == 0
    assert set(verdicts) == {"mv_sad", "flash_packed", "flash_refresh_paged", "rope_shift"}
    assert all(set(c) == {"ok"} for c in verdicts.values()), verdicts


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingPipeline(cfg, cfg.vit, {}, {}, EngineCfg(codec=TCodecCfg(**CODEC)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_pipeline(ARCH, "codecflow", TCodecCfg(**CODEC))


def test_unported_options_raise():
    """Once the one option left unported, the padded ViT
    (``PruneCfg(packed_vit=False)``) now serves like the JAX package's
    padded pipeline: prune_only and codecflow, every event, stat (the ViT
    slots count the padded capacity) and refresh set equal, logits within
    ``torch_mode_parity.LOGIT_TOL``, and no ``flash_packed`` dispatch.
    (Every mode, both KV layouts and int8 cold pages:
    test_torch_modes.py, test_torch_variants.py; the SSM family:
    test_torch_recurrent.py; MoE and hybrid: test_torch_moe.py,
    test_torch_hybrid.py; the encoder-decoder family and training:
    test_torch_whisper.py, test_torch_train.py.)"""
    from torch_mode_parity import assert_parity, assert_plain_dispatch, serve
    for mode in ("prune_only", "codecflow"):
        j, t = serve(mode, paged=True, packed_vit=False)
        assert_parity(j, t)
        assert_plain_dispatch(t)
        assert "flash_packed" not in t[4]


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


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports nothing of torch)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["DENSE_ARCH", "WIDE_MOE_ARCH"])
def test_families_phase_cases_on_cpu(which):
    """chip_smoke's phase 7 cases (c) deepseek-7b and (d)
    moonshot-v1-16b-a3b, built as the card builds them but on the CPU and
    without weights: full depth, codecflow on the paged slab over the
    launcher's 112^2 ViT (total_len 168, vis_len 160, query 8, 256 cache
    slots), the dense model past the MoE probe (its weights line names its
    dense FFN), moonshot's probe at the largest call (2 x 168 rows: cap
    40) and a decode step's, the paged kernel's cases at deepseek-7b's
    heads (H 32 = Hkv 32, D 128; bf16 and f32 queries; moonshot's are
    olmoe's, H 16 = Hkv 16), and the registry taking every kernel call either config makes."""
    from repro_torch.kernels import audit
    cs = _chip_smoke()
    arch = getattr(cs, which)
    models = {m[1]: m for m in cs.family_models()}
    key, _, cfg, modes, frames, _ = models[arch]
    assert key == {"DENSE_ARCH": "(c)", "WIDE_MOE_ARCH": "(d)"}[which]
    assert modes == ("codecflow",) and frames == cs.MOE_FRAMES == 24
    assert cfg == get_config(arch) and cfg.n_layers == {"DENSE_ARCH": 30,
                                                        "WIDE_MOE_ARCH": 48}[which]
    pipe = ServingPipeline(cfg, tserve.default_vit(cfg), {}, {},
                           cs.path_ecfg("codecflow", {}), device="cpu")
    lay = pipe.layout
    assert (lay.total_len, lay.vis_len, lay.query_len, pipe.cache_slots) == (168, 160, 8, 256)
    assert not pipe.is_streaming_family and pipe.backend.paged
    assert set(pipe.kernels) == {"mv_sad", "flash_packed", "flash_refresh_paged", "rope_shift"}
    assert cs.family_label(arch, "codecflow", False) == f"{arch} codecflow, paged bf16"
    largest = 2 * lay.total_len
    if cfg.moe is None:
        assert cs.moe_probe_rows(cfg, largest) == ()
        assert "dense FFN d_ff 11008" in cs.model_widths(cfg)
    else:
        m = cfg.moe
        assert cs.moe_probe_rows(cfg, largest) == (336, 2)
        assert int(m.capacity_factor * 336 * m.top_k / m.n_experts) + 1 == 40
        assert "64 experts top-6" in cs.model_widths(cfg)
    paged = {label: (c, lay_, slots, *q_dt) for label, c, lay_, slots, *q_dt in
             cs.family_kernel_cases(device="cpu")[0]}
    if cfg.moe is None:
        for label in (arch, f"{arch}, f32 q"):     # phase 7's (c) and (e)
            c, lay_, slots, *q_dt = paged[label]
            assert (c.n_heads, c.n_kv, c.d_head) == (32, 32, 128)
            assert (lay_.total_len, lay_.vis_len, lay_.query_len, slots) == (168, 160, 8, 256)
            assert q_dt == ([torch.float32] if label != arch else [])
    else:
        olmoe = paged[cs.MOE_ARCH][0]
        assert (cfg.n_heads, cfg.n_kv, cfg.d_head) == (olmoe.n_heads, olmoe.n_kv,
                                                       olmoe.d_head) == (16, 16, 128)
    rows = audit.config_rows([arch])
    assert {r.op for r in rows} == {"mv_sad", "flash_packed", "flash_refresh",
                                    "flash_refresh_paged", "rope_shift"}
    assert all(r.verdict == "kernel" for r in rows), rows
