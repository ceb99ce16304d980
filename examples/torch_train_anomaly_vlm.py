"""End-to-end training on the PyTorch port: ``examples/train_anomaly_vlm.py``.

    PYTHONPATH=src python examples/torch_train_anomaly_vlm.py --steps 150 [--device cpu]

Trains a tiny VLM on the synthetic anomaly workload
(``training.anomaly_task.train_tiny_vlm``: weights from the port's
initialisers, seeds 0 and 1), then serves held-out streams in
``fullcomp`` and ``codecflow`` with the trained weights and prints each
mode's video-level F1.  The VLM's head dim is 24 (4 heads of 96), which
the card's attention kernels take.
"""
import argparse

import numpy as np

from repro_torch.configs import CodecCfg, ModelCfg, ViTCfg
from repro_torch.data.pipeline import anomaly_dataset
from repro_torch.serving import Engine, EngineCfg, precision_recall_f1, video_prediction
from repro_torch.training.anomaly_task import train_tiny_vlm

LM = ModelCfg(name="ex-vlm", family="vlm", n_layers=4, d_model=96,
              n_heads=4, n_kv=2, d_ff=192, vocab=64, tied_embeddings=True)
VIT = ViTCfg(n_layers=2, d_model=96, n_heads=4, d_ff=192, patch=14,
             image=112, group=2)
CODEC = CodecCfg(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)


def evaluate(lm_params, vit_params, mode: str, videos, device) -> float:
    eng = Engine(LM, VIT, lm_params, vit_params,
                 EngineCfg(mode=mode, codec=CODEC), device=device)
    preds, truths = [], []
    for frames, label in videos:
        res = eng.run_stream(np.asarray(frames))
        preds.append(video_prediction([r.answer for r in res]))
        truths.append(label)
    return precision_recall_f1(preds, truths)[2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--videos", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    print(f"training tiny VLM ({LM.param_count() / 1e6:.1f}M params) "
          f"for {args.steps} steps on synthetic anomaly streams...")
    lm_params, vit_params = train_tiny_vlm(
        LM, VIT, CODEC, n_videos=args.videos, n_frames=28,
        steps=args.steps, verbose=True, device=args.device,
    )
    test = anomaly_dataset(4, 28, VIT.image, VIT.image, seed=777)
    for mode in ["fullcomp", "codecflow"]:
        f1 = evaluate(lm_params, vit_params, mode, test, args.device)
        print(f"eval {mode:10s} F1={f1:.2f}")


if __name__ == "__main__":
    main()
