"""Workload data: labelled synthetic CCTV videos (host numpy) for
serving and the anomaly task, and the synthetic token / multimodal batch
stream of the training launcher."""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..configs.base import ModelCfg
from ..training.train_step import Batch
from .video import generate_video, motion_level_spec


def lm_batches(cfg: ModelCfg, batch: int, seq: int, seed: int = 0, vlm_tokens: int = 0,
               device="cuda") -> Iterator[Batch]:
    """Synthetic next-token LM stream with a planted bigram structure
    (so loss decreases measurably within a few hundred steps): the JAX
    package's ``lm_batches``, the same numpy random stream call for
    call, so both packages yield the same batches from a seed.  Tensors
    land on ``device``; ``vlm_tokens`` adds ``inputs_embeds`` over the
    first positions (``embed_mask``), an encoder-decoder config
    ``enc_feats`` (B, enc_seq, d)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    V = cfg.vocab
    # fixed random successor table: token t is followed by succ[t] 60% of
    # the time; uniform otherwise.
    succ = rng.integers(0, V, size=V)

    def put(a):
        return torch.from_numpy(a).to(dev)

    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=batch)
        for t in range(seq):
            follow = rng.random(batch) < 0.6
            toks[:, t + 1] = np.where(
                follow, succ[toks[:, t]], rng.integers(0, V, size=batch)
            )
        extra = {}
        if vlm_tokens:
            emb = rng.normal(0, 0.5, size=(batch, seq, cfg.d_model)).astype(np.float32)
            mask = np.zeros((batch, seq), bool)
            mask[:, :vlm_tokens] = True
            extra = dict(inputs_embeds=put(emb), embed_mask=put(mask))
        if cfg.enc_dec:
            extra["enc_feats"] = put(
                rng.normal(0, 0.5, size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        yield Batch(
            tokens=put(np.ascontiguousarray(toks[:, :-1])),
            targets=put(np.ascontiguousarray(toks[:, 1:])),
            loss_mask=torch.ones((batch, seq), dtype=torch.float32, device=dev),
            **extra,
        )


def anomaly_dataset(
    n_videos: int, n_frames: int, height: int, width: int,
    anomaly_frac: float = 0.5, seed: int = 0, bg_pool: int = 8,
) -> List[Tuple[np.ndarray, int]]:
    """(frames, video_label) pairs across mixed motion levels.

    Backgrounds come from a shared ``bg_pool`` (fixed-camera deployment:
    the scene set is closed; events vary) so train/eval splits differ in
    dynamics, not scenery.
    """
    rng = np.random.default_rng(seed)
    out = []
    levels = ["low", "medium", "high"]
    for i in range(n_videos):
        anom = rng.random() < anomaly_frac
        spec = motion_level_spec(
            levels[i % 3], seed=seed * 1000 + i,
            n_frames=n_frames, height=height, width=width,
            anomaly=bool(anom),
            anomaly_start=int(rng.integers(n_frames // 4, n_frames // 2)),
            anomaly_len=max(8, n_frames // 4),
            bg_seed=i % bg_pool,
        )
        frames, labels = generate_video(spec)
        out.append((frames, int(labels.any())))
    return out
