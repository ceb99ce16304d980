"""Serving launcher: codec-guided streaming analytics over synthetic CCTV
streams, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl3-14b \
        --hw 448 --mode codecflow --streams 2 --videos 2 --frames 24

Same flags and JSON report as ``repro.launch.serve``.  ``--mode`` is
``codecflow`` or one of the paper's baselines (``fullcomp``,
``prune_only``, ``refresh_only``, ``cacheblend``, ``vlcache``); the
reuse modes keep their KV in the paged slab, whose stale overlap pages
``--stale-dtype int8`` demotes to int8 cold pages (streams then admit
staggered).  The scheduler runs the stage-pipelined engine, with
``--ingest-workers`` host threads slicing windows and making their prune
decisions; ``--lockstep`` runs one fused group per step, synced before
the next.
Weights are random (tensor by tensor on the device, from ``--seed``)
unless ``--ckpt`` names an npz written by the JAX package's
``training/checkpoint.py`` (LM weights; the ViT stays random).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode cacheblend --streams 2 --videos 2 --frames 24
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --streams 2 --videos 2 --frames 24 --keep-ratio 1.0 --stale-dtype int8

``--arch`` takes every config of ``configs/registry.py`` but whisper
(not ported), and its ``-smoke`` variant.  The MoE family (olmoe-1b-7b,
moonshot-v1-16b-a3b, arctic-480b) serves like the dense one; the SSM
family (mamba2-2.7b) and the hybrid one (jamba-v0.1-52b: attention,
Mamba-2 and MoE in one stack) serve every mode through the recurrent
prefill.  Models without a ViT of their own take the default one below
(112^2 frames, so ``--hw 112``, the default):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --streams 2 --videos 2 --frames 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --streams 2 --videos 2 --frames 40
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch jamba-v0.1-52b-smoke --streams 2 --videos 2 --frames 24

jamba-v0.1-52b itself (103 GB of bf16 weights) does not fit one 80 GB
card; ``chip_smoke.py`` serves it at full width with 16 of its 32 layers.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..configs import CodecCfg, ViTCfg, get_config
from ..data.pipeline import anomaly_dataset
from ..models.init import init_lm_params, init_vit_params, load_npz_params
from ..serving import (
    MODES, Engine, EngineCfg, KVCfg, Scheduler, SchedulerCfg, ServingPipeline,
    StreamRequest, StreamThrottled, WindowDone, precision_recall_f1,
    resolve_device, video_prediction,
)


def default_vit(cfg) -> ViTCfg:
    return cfg.vit or ViTCfg(
        n_layers=2, d_model=128, n_heads=4, d_ff=256, patch=14,
        image=112, group=2,
    )


def build_pipeline(arch: str, mode: str, codec: CodecCfg,
                   ckpt: str | None = None, seed: int = 0,
                   stale_dtype: str = "bf16", device="cuda") -> ServingPipeline:
    """The serving pipeline of ``arch`` with random weights made on
    ``device`` from ``seed`` (LM) and ``seed + 1`` (ViT)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    v = default_vit(cfg)
    params = (load_npz_params(ckpt, cfg, dev) if ckpt
              else init_lm_params(cfg, seed, dev))
    vparams = init_vit_params(v, cfg.d_model, seed + 1, dev)
    return ServingPipeline(
        cfg, v, params, vparams,
        EngineCfg(mode=mode, codec=codec, kv=KVCfg(stale_page_dtype=stale_dtype)),
        device=dev)


def build_engine(arch: str, mode: str, codec: CodecCfg, ckpt: str | None = None,
                 seed: int = 0, device="cuda") -> Engine:
    """The single-stream entry point (a batch-1 view of the stages)."""
    return Engine.from_pipeline(build_pipeline(arch, mode, codec, ckpt, seed,
                                               device=device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl3-14b-smoke")
    ap.add_argument("--mode", default="codecflow", choices=MODES)
    ap.add_argument("--videos", type=int, default=4)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--hw", type=int, default=112)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--gop", type=int, default=4)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--keep-ratio", type=float, default=0.5)
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent sessions admitted by the scheduler; "
                         ">1 batches same-phase windows across streams")
    ap.add_argument("--lockstep", action="store_true",
                    help="disable the stage-pipelined async engine (one "
                         "fused group per step, fully synced)")
    ap.add_argument("--ingest-workers", type=int, default=2,
                    help="host threads slicing codec windows and making their "
                         "prune decisions while the card runs earlier groups")
    ap.add_argument("--stale-dtype", default="bf16", choices=("bf16", "int8"),
                    help="storage dtype for stale (non-refreshed) KV pages; "
                         "int8 demotes them to the cold slab")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    codec = CodecCfg(
        gop=args.gop, window_frames=args.window, stride_frames=args.stride,
        keep_ratio=args.keep_ratio,
    )
    pipeline = build_pipeline(args.arch, args.mode, codec, args.ckpt,
                              seed=args.seed, stale_dtype=args.stale_dtype,
                              device=args.device)
    videos = list(anomaly_dataset(args.videos, args.frames, args.hw, args.hw))

    sched = Scheduler(pipeline, SchedulerCfg(
        max_concurrent=max(1, args.streams),
        pipelined=not args.lockstep,
        ingest_workers=args.ingest_workers,
    ))
    t0 = time.time()
    sids = [
        sched.submit(StreamRequest(i, np.asarray(frames), tag=label))
        for i, (frames, label) in enumerate(videos)
    ]
    n_throttled = 0
    for ev in sched.events():
        if isinstance(ev, StreamThrottled):
            n_throttled += 1
        elif isinstance(ev, WindowDone) and ev.window == 0:
            print(f"# stream {ev.stream_id}: first answer {ev.stats.answer}")
    wall = time.time() - t0

    preds, truths = [], []
    agg = dict(flops=0.0, t_vit=0.0, t_prefill=0.0, t_decode=0.0,
               t_overhead=0.0, windows=0)
    for sid in sids:
        sess = sched.session(sid)
        preds.append(video_prediction([r.stats.answer for r in sess.results]))
        truths.append(sess.request.tag)
        for r in sess.results:
            s = r.stats
            agg["flops"] += s.flops_vit + s.flops_prefill + s.flops_decode
            agg["t_vit"] += s.t_vit
            agg["t_prefill"] += s.t_prefill
            agg["t_decode"] += s.t_decode
            agg["t_overhead"] += s.t_overhead
            agg["windows"] += 1
    p, r, f1 = precision_recall_f1(preds, truths)
    lat = sched.latency_quantiles()
    ttft = sched.ttft_quantiles()
    out = {
        "arch": args.arch, "mode": args.mode, "streams": args.streams,
        "scheduler": "lockstep" if args.lockstep else "pipelined",
        "precision": p, "recall": r, "f1": f1,
        "window_latency_p50_s": lat.get("p50", 0.0),
        "window_latency_p99_s": lat.get("p99", 0.0),
        "ttft_p50_s": ttft.get("p50", 0.0),
        "ttft_p99_s": ttft.get("p99", 0.0),
        "stage_occupancy": {k: round(v, 4)
                            for k, v in sched.stage_occupancy().items()},
        "streams_throttled": n_throttled,
        "GFLOP_per_window": agg["flops"] / max(agg["windows"], 1) / 1e9,
        "latency_per_window_s": (agg["t_vit"] + agg["t_prefill"]
                                 + agg["t_decode"] + agg["t_overhead"])
        / max(agg["windows"], 1),
        "overhead_per_window_s": agg["t_overhead"] / max(agg["windows"], 1),
        "windows_total": agg["windows"],
        "windows_per_s": agg["windows"] / max(wall, 1e-9),
        "wall_s": wall,
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
