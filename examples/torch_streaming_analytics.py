"""End-to-end serving on the PyTorch port: ``examples/streaming_analytics.py``.

    PYTHONPATH=src python examples/torch_streaming_analytics.py [--mode codecflow] \
        [--device cpu]

The paper's deployment scenario: N concurrent CCTV streams served by one
stage pipeline behind a batched scheduler.  Each stream is a
``StreamSession`` (per-stream codec buffer and KV state); the scheduler
pipelines stages across streams (codec window slicing and prune
decisions on host worker threads while the card encodes and prefills
earlier groups) and fuses ready windows of same-phase streams into
single batched ViT-encode / prefill / decode calls.  The driver consumes
typed scheduler events (``StreamAdmitted`` / ``WindowDone`` /
``StreamDone``) as they occur.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import CodecCfg
from repro_torch.data.pipeline import anomaly_dataset
from repro_torch.launch.serve import build_pipeline
from repro_torch.serving import (
    MODES, Scheduler, SchedulerCfg, StreamDone, StreamRequest, WindowDone,
    precision_recall_f1, video_prediction,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="codecflow", choices=MODES)
    ap.add_argument("--arch", default="internvl3-14b-smoke")
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    codec = CodecCfg(gop=4, window_frames=8, stride_frames=4, keep_ratio=0.5)
    pipeline = build_pipeline(args.arch, args.mode, codec, device=args.device)
    streams = anomaly_dataset(args.streams, args.frames, 112, 112, seed=42)

    # session lifecycle: submit (codec ingest) -> consume events
    sched = Scheduler(pipeline, SchedulerCfg(max_concurrent=args.streams))
    t0 = time.time()
    sids = [
        sched.submit(StreamRequest(f"cam-{i}", np.asarray(frames), tag=label))
        for i, (frames, label) in enumerate(streams)
    ]
    total_flops = 0.0
    for ev in sched.events():
        if isinstance(ev, WindowDone):
            s = ev.stats
            total_flops += s.flops_vit + s.flops_prefill + s.flops_decode
        elif isinstance(ev, StreamDone):
            print(f"  {ev.stream_id}: done after {ev.n_windows} windows")
    wall = time.time() - t0

    preds, truths = [], []
    n_windows = 0
    for sid in sids:
        truths.append(sched.session(sid).request.tag)
        results = sched.close(sid)          # releases the session's KV state
        preds.append(video_prediction([r.stats.answer for r in results]))
        n_windows += len(results)
    p, r, f1 = precision_recall_f1(preds, truths)
    print(f"mode={args.mode} arch={args.arch}")
    print(f"streams={len(sids)} windows={n_windows} wall={wall:.1f}s "
          f"({n_windows / max(wall, 1e-9):.2f} windows/s aggregate)")
    lat, ttft = sched.latency_quantiles(), sched.ttft_quantiles()
    print(f"window latency p50={lat.get('p50', 0):.3f}s "
          f"p99={lat.get('p99', 0):.3f}s  ttft p50={ttft.get('p50', 0):.3f}s")
    print(f"decisions={preds} truths={truths}  P={p:.2f} R={r:.2f} F1={f1:.2f}")
    print(f"total GFLOP={total_flops / 1e9:.2f}")


if __name__ == "__main__":
    main()
