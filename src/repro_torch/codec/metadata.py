"""Compressed-domain metadata structures (paper §2.4.1, §3.2).

``CodecMetadata`` is what the codec hands to the motion analyzer:
per-frame frame types, block motion vectors and residual energies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

I_FRAME = 0
P_FRAME = 1


class CodecMetadata(NamedTuple):
    """Per-stream compressed-domain signals.

    Attributes:
      frame_types: (T,) int32 — I_FRAME or P_FRAME.
      mv: (T, Hb, Wb, 2) int32 — block motion vectors (dy, dx), zero on
        I-frames.
      residual: (T, Hb, Wb) float32 — per-block mean absolute residual
        after motion compensation, zero on I-frames.
    """

    frame_types: torch.Tensor
    mv: torch.Tensor
    residual: torch.Tensor

    @property
    def mv_magnitude(self) -> torch.Tensor:
        """(T, Hb, Wb) float32 — ||v|| per block (paper Eq. 1)."""
        m = self.mv.to(torch.float32)
        return torch.sqrt((m * m).sum(dim=-1))

    def window(self, start: int, length: int) -> "CodecMetadata":
        sl = slice(start, start + length)
        return CodecMetadata(self.frame_types[sl], self.mv[sl], self.residual[sl])


class Bitstream(NamedTuple):
    """A (simulated) encoded stream: everything the decoder needs.

    frame_types (T,) int32; iframe_data (T, H, W) f32 (zero for
    P-frames); mv (T, Hb, Wb, 2) int32; residual_q (T, H, W) f32.
    """

    frame_types: torch.Tensor
    iframe_data: torch.Tensor
    mv: torch.Tensor
    residual_q: torch.Tensor


def gop_frame_types(n_frames: int, gop: int, device=None) -> torch.Tensor:
    """I at every GOP boundary, P elsewhere."""
    t = torch.arange(n_frames, device=device)
    return torch.where(t % gop == 0, I_FRAME, P_FRAME).to(torch.int32)
