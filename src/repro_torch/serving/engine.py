"""Single-stream serving engine: the batch-1 view of the stage pipeline.

``Engine`` serves every sliding window of one raw luma stream through
``ServingPipeline.serve_batch`` with a batch of one, in window order,
synced after each window.  ``Scheduler`` is the batched multi-stream
path; ``Engine`` keeps the single-stream surface of the JAX package's
``repro.serving.engine``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..codec.metadata import CodecMetadata
from ..configs.base import ModelCfg, ViTCfg
from .api import NO, QUERY_IDS, YES, ServingPipeline, WindowStats
from .config import EngineCfg

__all__ = ["Engine", "EngineCfg", "WindowStats", "QUERY_IDS", "YES", "NO"]


class Engine:
    """Single-stream serving engine over one ``ServingPipeline``."""

    def __init__(self, cfg: ModelCfg, vit_cfg: ViTCfg, params_lm, params_vit,
                 ecfg: EngineCfg, device="cuda"):
        self._bind(ServingPipeline(cfg, vit_cfg, params_lm, params_vit, ecfg,
                                   device=device))

    @classmethod
    def from_pipeline(cls, pipeline: ServingPipeline) -> "Engine":
        eng = cls.__new__(cls)
        eng._bind(pipeline)
        return eng

    def _bind(self, pipeline: ServingPipeline) -> None:
        self.pipeline = pipeline
        self.cfg = pipeline.cfg
        self.v = pipeline.v
        self.params = pipeline.params
        self.vparams = pipeline.vparams
        self.ecfg = pipeline.ecfg
        self.layout = pipeline.layout
        self.prune = pipeline.prune
        self.reuse = pipeline.reuse
        self.is_streaming_family = pipeline.is_streaming_family
        self.cache_slots = pipeline.cache_slots

    def run_stream(self, frames: np.ndarray) -> List[WindowStats]:
        """Encode and serve every sliding window of a raw luma stream."""
        pipe = self.pipeline
        cs = pipe.frontend.open(np.asarray(frames))
        results = []
        state = None
        for k in range(cs.n_windows):
            wframes, wmeta, t_codec = pipe.frontend.window(cs, k)
            stats, state = self.serve_window(k, wframes, wmeta, state)
            stats.t_codec += t_codec
            results.append(stats)
        # paged backends: hand the stream's slab pages back to the pool
        pipe.release_state(state)
        return results

    def serve_window(self, k: int, frames: torch.Tensor, meta: CodecMetadata,
                     state) -> Tuple[WindowStats, dict]:
        """Serve window ``k`` (a batch of one through the stage pipeline);
        returns its stats and the stream state for window k+1."""
        stats, new_state = self.pipeline.serve_batch(frames[None], [meta], state)
        return stats[0], new_state
