"""Quickstart on the PyTorch port: ``examples/quickstart.py``'s pipeline.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Generates a synthetic CCTV stream, encodes it with the software codec
(the ``mv_sad`` motion search), derives the motion-guided pruning
decision (paper Eqs. 1-4), and serves every sliding window through a
tiny VLM with selective KVC refresh.  On the card (the default) the
kernels serve it; ``--device cpu`` runs their plain versions.

The tiny VLM is the JAX quickstart's: LM and ViT of 4 heads of 16 (the
LM's over 2 kv heads).  Weights are random, from the port's
initialisers (seeds 0 and 1).
"""
import argparse

import numpy as np
import torch

from repro_torch.codec import encode_stream
from repro_torch.configs import CodecCfg, ModelCfg, ViTCfg
from repro_torch.core import capacity_groups, motion_mask, pruning_stats, select_tokens
from repro_torch.data.video import VideoSpec, generate_video
from repro_torch.models.init import init_lm_params, init_vit_params
from repro_torch.serving import Engine, EngineCfg, resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

# 1. a synthetic surveillance stream with an anomaly event -------------
frames, labels = generate_video(
    VideoSpec(n_frames=16, height=112, width=112, anomaly=True,
              anomaly_start=5, anomaly_len=8, seed=0))
print(f"stream: {frames.shape}, anomaly frames: {labels.sum()}")

# 2. codec: compression is the signal source ---------------------------
codec = CodecCfg(gop=4, window_frames=8, stride_frames=4, keep_ratio=0.4)
bitstream, meta = encode_stream(torch.as_tensor(frames, device=dev), codec)
print(f"motion vectors: {tuple(meta.mv.shape)}, mean |v| on P-frames: "
      f"{float(meta.mv_magnitude[meta.frame_types == 1].mean()):.2f} px")

# 3. Motion Analyzer + Token Pruner (Eqs. 1-4) -------------------------
vit_cfg = ViTCfg(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                 patch=14, image=112, group=2)
dynamic, score = motion_mask(meta, codec, vit_cfg.patches_per_side)
decision = select_tokens(dynamic, score, vit_cfg,
                         capacity_groups(vit_cfg, codec.keep_ratio))
print(f"pruning: {pruning_stats(decision)}")

# 4. serve a stream end-to-end with selective KVC refresh --------------
lm_cfg = ModelCfg(name="demo", family="vlm", n_layers=2, d_model=64,
                  n_heads=4, n_kv=2, d_ff=128, vocab=64,
                  tied_embeddings=True)
lm_params = init_lm_params(lm_cfg, seed=0, device=dev)
vit_params = init_vit_params(vit_cfg, lm_cfg.d_model, seed=1, device=dev)

engine = Engine(lm_cfg, vit_cfg, lm_params, vit_params,
                EngineCfg(mode="codecflow", codec=codec), device=dev)
for r in engine.run_stream(np.asarray(frames)):
    print(f"window: answer={'Yes' if r.answer else 'No'} "
          f"tokens={r.tokens_valid}/{r.tokens_vis} "
          f"refreshed={r.tokens_refreshed} "
          f"GFLOP={(r.flops_vit + r.flops_prefill) / 1e9:.3f}")
