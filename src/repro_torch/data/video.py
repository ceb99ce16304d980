"""Synthetic surveillance-like video generator.

Produces luma streams with a static textured background, drifting
objects whose count/speed set the *motion level* (paper Fig. 14), camera
noise, and optional *anomaly events*: a fast, bright intruder object
appearing for a contiguous span — the positive class for the
anomaly-detection workload (paper §2.1, UCF-Crime analogue).

Pure numpy (data pipeline, host-side), deterministic per seed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    n_frames: int = 64
    height: int = 112
    width: int = 112
    n_objects: int = 2
    speed: float = 1.5          # px/frame — motion level knob
    object_size: int = 12
    noise: float = 1.0          # sensor noise sigma (gray levels)
    anomaly: bool = False
    anomaly_start: int = 24
    anomaly_len: int = 16
    anomaly_speed: float = 6.0
    seed: int = 0
    # Fixed-camera deployments see a closed set of scenes: backgrounds
    # are drawn from a shared pool (bg_seed) while object/anomaly
    # dynamics vary per video (seed).  None -> background from ``seed``.
    bg_seed: int | None = None


def _background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Low-frequency textured background in [40, 200]."""
    coarse = rng.uniform(40, 200, size=(h // 8 + 2, w // 8 + 2))
    ups = np.kron(coarse, np.ones((8, 8)))[:h, :w]
    # light smoothing to avoid blocky gradients
    k = np.ones((5, 5)) / 25.0
    pad = np.pad(ups, 2, mode="edge")
    out = np.zeros_like(ups)
    for dy in range(5):
        for dx in range(5):
            out += k[dy, dx] * pad[dy:dy + ups.shape[0], dx:dx + ups.shape[1]]
    return out


def _draw_box(frame: np.ndarray, cy: float, cx: float, size: int, value: float):
    h, w = frame.shape
    y0 = int(np.clip(cy - size // 2, 0, h - size))
    x0 = int(np.clip(cx - size // 2, 0, w - size))
    frame[y0:y0 + size, x0:x0 + size] = value


def generate_video(spec: VideoSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frames (T, H, W) float32 in [0, 255], labels (T,) int32).

    labels[t] == 1 while the anomaly object is on screen.
    """
    rng = np.random.default_rng(spec.seed)
    bg_rng = (np.random.default_rng(spec.bg_seed)
              if spec.bg_seed is not None else rng)
    bg = _background(bg_rng, spec.height, spec.width)

    pos = rng.uniform(
        [spec.object_size, spec.object_size],
        [spec.height - spec.object_size, spec.width - spec.object_size],
        size=(spec.n_objects, 2),
    )
    vel = rng.normal(0, 1, size=(spec.n_objects, 2))
    vel = vel / (np.linalg.norm(vel, axis=1, keepdims=True) + 1e-9) * spec.speed
    values = rng.uniform(0, 60, size=spec.n_objects)  # dark-ish objects

    a_pos = np.array([spec.object_size, spec.object_size], float)
    a_vel = np.array([spec.anomaly_speed, spec.anomaly_speed * 0.7])

    frames = np.zeros((spec.n_frames, spec.height, spec.width), np.float32)
    labels = np.zeros(spec.n_frames, np.int32)
    for t in range(spec.n_frames):
        f = bg.copy()
        for i in range(spec.n_objects):
            pos[i] += vel[i]
            for d in range(2):
                lim = (spec.height, spec.width)[d] - spec.object_size
                if pos[i, d] < spec.object_size or pos[i, d] > lim:
                    vel[i, d] *= -1
                    pos[i, d] = np.clip(pos[i, d], spec.object_size, lim)
            _draw_box(f, pos[i, 0], pos[i, 1], spec.object_size, values[i])
        if spec.anomaly and spec.anomaly_start <= t < spec.anomaly_start + spec.anomaly_len:
            a_pos += a_vel
            a_pos[0] %= spec.height
            a_pos[1] %= spec.width
            _draw_box(f, a_pos[0], a_pos[1], spec.object_size + 4, 250.0)
            labels[t] = 1
        f += rng.normal(0, spec.noise, f.shape)
        frames[t] = np.clip(f, 0, 255)
    return frames, labels


def motion_level_spec(level: str, seed: int = 0, **kw) -> VideoSpec:
    """low / medium / high motion presets (paper Fig. 14 grouping)."""
    presets = {
        "low": dict(n_objects=1, speed=0.4),
        "medium": dict(n_objects=2, speed=1.5),
        "high": dict(n_objects=4, speed=4.0),
    }
    kw.setdefault("bg_seed", seed % 8)
    return VideoSpec(seed=seed, **presets[level], **kw)
