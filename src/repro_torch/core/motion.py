"""Motion Analyzer (paper §3.3.1).

Converts compressed-domain block signals into patch-level dynamic masks:

    M_t(i) = V_t(i) + alpha * R_t(i)        (Eq. 3)
    dynamic(i) = M_t(i) >= tau              (Eq. 4)

with GOP accumulation (§3.3.2): a patch marked dynamic stays active until
the next I-frame resets the mask; I-frames are always fully encoded.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..codec.metadata import CodecMetadata, I_FRAME
from ..configs.base import CodecCfg


def block_to_patch(grid: torch.Tensor, patches_per_side: int) -> torch.Tensor:
    """Nearest-neighbour resample of a (..., Hb, Wb) block map onto the
    ViT patch grid."""
    hb, wb = grid.shape[-2:]
    pp = patches_per_side
    ys = (torch.arange(pp, device=grid.device) * hb) // pp
    xs = (torch.arange(pp, device=grid.device) * wb) // pp
    return grid[..., ys[:, None], xs[None, :]]


def motion_mask(meta: CodecMetadata, cfg: CodecCfg, vit_patches: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Patch-level dynamic masks for a window of T frames.

    Returns dynamic (T, pp, pp) bool (GOP-accumulated, all-True on
    I-frames) and score (T, pp, pp) f32 (the raw Eq. 3 motion score).
    """
    m = meta.mv_magnitude + cfg.alpha * meta.residual           # Eq. 3
    m_patch = block_to_patch(m, vit_patches)
    is_i = meta.frame_types == I_FRAME
    own = m_patch >= cfg.mv_threshold                            # Eq. 4
    # GOP accumulation without reading the frame types on the host: a
    # P-frame's mask is the OR of ``own`` since the last I-frame, i.e. a
    # positive count of dynamic P-frames between that I-frame and it
    T = is_i.shape[0]
    hits = torch.cumsum((own & ~is_i[:, None, None]).to(torch.int32), dim=0)
    t = torch.arange(T, device=is_i.device)
    last_i = torch.cummax(torch.where(is_i, t, -1), dim=0).values   # -1: none yet
    before = torch.where((last_i >= 0)[:, None, None],
                         hits[last_i.clamp(min=0)], torch.zeros_like(hits))
    dynamic = torch.where(is_i[:, None, None], True, hits > before)
    return dynamic, m_patch
