"""Serving workload data: labelled synthetic CCTV videos (host numpy)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .video import generate_video, motion_level_spec


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
