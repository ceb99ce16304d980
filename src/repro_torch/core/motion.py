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
    active = torch.zeros_like(own[0])
    acc = []
    for t, i_frame in enumerate(is_i.tolist()):
        active = torch.zeros_like(active) if i_frame else active | own[t]
        acc.append(active)
    dynamic = torch.where(is_i[:, None, None], True, torch.stack(acc))
    return dynamic, m_patch
