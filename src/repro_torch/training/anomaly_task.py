"""Joint ViT + LM training on the synthetic anomaly-detection workload,
as the JAX package's ``training/anomaly_task.py``: a tiny VLM (the
port's ViT and RoPE LM) trained on the synthetic surveillance streams
through the Full-Comp path (every patch, no reuse), so that the serving
modes can be held to trained weights.  The sampling and augmentation
stream (numpy) is the reference's, call for call.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import CodecCfg, ModelCfg, ViTCfg
from ..data.pipeline import anomaly_dataset
from ..models import transformer as tfm
from ..models import vit as vitm
from ..models.init import detached, init_lm_params, init_vit_params, trainable
from ..serving.api import NO, QUERY_IDS, YES, resolve_device
from . import checkpoint
from .optimizer import OptCfg, apply_updates, init_opt_state
from .train_step import tree_grads


def window_examples(videos: List[Tuple[np.ndarray, int]],
                    codec: CodecCfg) -> Tuple[np.ndarray, np.ndarray]:
    """Slice raw videos into (windows (N, w, H, W), window labels (N,)).

    A window is positive if the anomaly overlaps it: a frame is anomalous
    where the planted object's brightness (250, far above the
    background) shows."""
    wins, labels = [], []
    w, s = codec.window_frames, codec.stride_frames
    for frames, _vid_label in videos:
        per_frame = (frames > 240).reshape(frames.shape[0], -1).any(axis=1)
        for k in range((frames.shape[0] - w) // s + 1):
            lo = k * s
            wins.append(frames[lo:lo + w])
            labels.append(int(per_frame[lo:lo + w].any()))
    return np.stack(wins), np.asarray(labels, np.int32)


def _window_tokens(lm_cfg, vit_cfg, lm_params, vit_params, frames_w):
    """Full-Comp embeds for a batch of windows: (B, T_total, d), the
    windows' visual tokens then the query's embeddings."""
    B, w = frames_w.shape[:2]
    flat = frames_w.reshape(B * w, *frames_w.shape[2:])
    toks = vitm.encode_full(vit_params, vit_cfg, flat)            # (B*w, G, d)
    vis = toks.reshape(B, w * vit_cfg.n_groups, -1)
    ids = torch.tensor(QUERY_IDS, dtype=torch.long, device=frames_w.device)
    q = tfm.embed_tokens(lm_cfg, lm_params, ids[None].expand(B, -1))
    return torch.cat([vis, q], dim=1)


def loss_fn(lm_cfg, vit_cfg, lm_params, vit_params, frames_w, labels):
    """(mean yes/no NLL, accuracy) at the last position."""
    embeds = _window_tokens(lm_cfg, vit_cfg, lm_params, vit_params, frames_w)
    B, T, _ = embeds.shape
    logits, _ = tfm.forward_train(
        lm_cfg, lm_params, torch.zeros((B, T), dtype=torch.long, device=embeds.device),
        inputs_embeds=embeds, remat=False, q_chunk=256,
    )
    final = logits[:, -1]                                         # (B, V)
    pair = torch.stack([final[:, NO], final[:, YES]], dim=-1)
    logp = F.log_softmax(pair, dim=-1)
    lab = labels.long()
    nll = -logp.gather(-1, lab[:, None]).mean()
    acc = (torch.argmax(pair, -1) == lab).float().mean()
    return nll, acc


def train_tiny_vlm(
    lm_cfg: ModelCfg, vit_cfg: ViTCfg, codec: CodecCfg,
    *, n_videos: int = 12, n_frames: int = 24, steps: int = 200,
    batch: int = 8, lr: float = 1e-3, seed: int = 0,
    cache_path: str | None = None, verbose: bool = False, device="cuda",
):
    """Returns (lm_params, vit_params), detached, on ``device``.  Weights
    start from ``init_lm_params(seed)`` / ``init_vit_params(seed + 1)``;
    an existing ``cache_path`` is loaded instead of training, and a
    trained run is saved there."""
    dev = resolve_device(device)
    lm_params = init_lm_params(lm_cfg, seed, dev)
    vit_params = init_vit_params(vit_cfg, lm_cfg.d_model, seed + 1, dev)

    if cache_path and os.path.exists(cache_path):
        both, _ = checkpoint.load(cache_path, {"lm": lm_params, "vit": vit_params})
        return both["lm"], both["vit"]

    hw = vit_cfg.image
    videos = anomaly_dataset(n_videos, n_frames, hw, hw, anomaly_frac=0.6, seed=seed)
    wins_np, labels_np = window_examples(videos, codec)
    labels = torch.from_numpy(labels_np).to(dev)
    n = wins_np.shape[0]

    ocfg = OptCfg(lr=lr, warmup=10, total_steps=steps, weight_decay=0.01)
    both = trainable({"lm": lm_params, "vit": vit_params})
    opt = init_opt_state(both, ocfg)

    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = rng.choice(n, size=min(batch, n), replace=False)
        fw = wins_np[idx]
        # augmentation: global brightness jitter + horizontal flip —
        # forces the model onto the event, not the scene
        fw = fw + rng.uniform(-20, 20, size=(fw.shape[0], 1, 1, 1))
        flip = rng.random(fw.shape[0]) < 0.5
        fw[flip] = fw[flip, :, :, ::-1]
        fw = np.clip(fw, 0, 255).astype(np.float32)
        nll, acc = loss_fn(lm_cfg, vit_cfg, both["lm"], both["vit"],
                           torch.from_numpy(fw).to(dev), labels[torch.from_numpy(idx).to(dev)])
        both, opt, _ = apply_updates(both, tree_grads(nll, both), opt, ocfg)
        if verbose and (i % 20 == 0 or i == steps - 1):
            print(f"  anomaly-train step {i:4d} nll {float(nll):.4f} "
                  f"acc {float(acc):.2f}", flush=True)
    both = detached(both)
    if cache_path:
        checkpoint.save(cache_path, both, opt, steps)
    return both["lm"], both["vit"]
