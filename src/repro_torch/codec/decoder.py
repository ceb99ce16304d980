"""Decoder + single-pass stream buffer (paper §3.2).

``StreamDecoder`` decodes the bitstream once, buffers the reconstructed
frames on the stream's device and serves every overlapping window from
that buffer (the paper's decode-once design); ``NaiveDecoder`` is the
baseline that re-decodes the covering prefix per window.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configs.base import CodecCfg
from .encoder import motion_compensate
from .metadata import Bitstream, CodecMetadata, I_FRAME


def decode_stream(bitstream: Bitstream, block: int = 16) -> torch.Tensor:
    """Reconstruct all frames (exact inverse of ``encode_stream``)."""
    T, H, W = bitstream.iframe_data.shape
    prev = torch.zeros((H, W), dtype=torch.float32, device=bitstream.iframe_data.device)
    ftypes = bitstream.frame_types.tolist()
    out = []
    for t in range(T):
        if ftypes[t] == I_FRAME:
            recon = bitstream.iframe_data[t]
        else:
            recon = motion_compensate(prev, bitstream.mv[t], block) + bitstream.residual_q[t]
        out.append(recon)
        prev = recon
    return torch.stack(out)


class StreamDecoder:
    """Single-pass decode + shared window buffer.

    ``decode_count`` counts decodes per frame: exactly 1 under any
    window/stride schedule.
    """

    def __init__(self, cfg: CodecCfg):
        self.cfg = cfg
        self._frames: Optional[torch.Tensor] = None
        self._meta: Optional[CodecMetadata] = None
        self.decode_count: Optional[np.ndarray] = None

    def ingest(self, bitstream: Bitstream, meta: CodecMetadata) -> None:
        self._frames = decode_stream(bitstream, self.cfg.block)
        self._meta = meta
        self.decode_count = np.ones(self._frames.shape[0], np.int32)

    def window(self, k: int) -> Tuple[torch.Tensor, CodecMetadata]:
        """k-th sliding window: frames [k*s, k*s + w)."""
        w, s = self.cfg.window_frames, self.cfg.stride_frames
        lo = k * s
        hi = lo + w
        if self._frames is None or hi > self._frames.shape[0]:
            raise IndexError(f"window {k} out of range")
        return self._frames[lo:hi], self._meta.window(lo, w)

    def n_windows(self) -> int:
        if self._frames is None:
            return 0
        w, s = self.cfg.window_frames, self.cfg.stride_frames
        return max(0, (self._frames.shape[0] - w) // s + 1)


class NaiveDecoder:
    """Baseline: re-decodes the covering prefix for every window (the
    redundant design the paper's single-pass front end replaces).
    ``decode_count`` counts decodes per frame."""

    def __init__(self, cfg: CodecCfg):
        self.cfg = cfg
        self._bs: Optional[Bitstream] = None
        self._meta: Optional[CodecMetadata] = None
        self.decode_count: Optional[np.ndarray] = None

    def ingest(self, bitstream: Bitstream, meta: CodecMetadata) -> None:
        self._bs = bitstream
        self._meta = meta
        self.decode_count = np.zeros(bitstream.frame_types.shape[0], np.int32)

    def window(self, k: int) -> Tuple[torch.Tensor, CodecMetadata]:
        w, s = self.cfg.window_frames, self.cfg.stride_frames
        lo, hi = k * s, k * s + w
        # inter frames decode from the stream head: the whole prefix again
        frames = decode_stream(self._bs, self.cfg.block)[:hi]
        self.decode_count[:hi] += 1
        return frames[lo:hi], self._meta.window(lo, w)
