"""Token Pruner (paper §3.3.2): capacity-based group selection and the
cross-frame packing plan of the packed ViT encode.

Every P-frame contributes at most ``K_groups = ceil(keep_ratio *
n_groups)`` projector groups, ranked by (dynamic flag, motion score);
a 2x2 patch group is kept iff any of its patches is dynamic, so the
pixel-unshuffle projector layout stays valid.  ``pack_plan`` lays the
kept groups of many frames into shared ``(rows, L_pack)`` buffers on
the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ViTCfg
from ..kernels.flash_packed import PackBlockMap, build_pack_map


class PruneDecision(NamedTuple):
    """Static-shape pruning decision for a stack of T frames.

    group_idx (T, Kg) int64; group_valid (T, Kg) bool; patch_idx
    (T, Kg*g^2) int64 (group-complete, ViT gather order); patch_valid
    (T, Kg*g^2) bool; group_dynamic (T, n_groups) bool.
    """

    group_idx: torch.Tensor
    group_valid: torch.Tensor
    patch_idx: torch.Tensor
    patch_valid: torch.Tensor
    group_dynamic: torch.Tensor


class HostDecision(NamedTuple):
    """The part of a ``PruneDecision`` that ``pack_plan`` reads, on the
    host: group_valid (T, Kg) bool and patch_idx (T, Kg*g^2) int64."""

    group_valid: np.ndarray
    patch_idx: np.ndarray


def to_host(dec: PruneDecision) -> HostDecision:
    """Fetch a decision's two packing fields in one device-to-host copy."""
    both = torch.cat([dec.group_valid.long(), dec.patch_idx.long()], dim=1).cpu().numpy()
    kg = dec.group_valid.shape[1]
    return HostDecision(both[:, :kg].astype(bool), both[:, kg:])


def group_mask(dynamic: torch.Tensor, score: torch.Tensor, v: ViTCfg):
    """Patch-level (T, pp, pp) -> group-level (T, n_groups) mask + score."""
    T = dynamic.shape[0]
    gs, g = v.groups_per_side, v.group
    d = dynamic.reshape(T, gs, g, gs, g)
    s = score.reshape(T, gs, g, gs, g)
    gd = d.any(dim=4).any(dim=2).reshape(T, gs * gs)
    gscore = s.amax(dim=(2, 4)).reshape(T, gs * gs)
    return gd, gscore


def capacity_groups(v: ViTCfg, keep_ratio: float) -> int:
    return max(1, min(v.n_groups, int(-(-keep_ratio * v.n_groups // 1))))


def select_tokens(dynamic: torch.Tensor, score: torch.Tensor, v: ViTCfg,
                  k_groups: int) -> PruneDecision:
    """Rank groups by (dynamic, score) and take a static top-K.

    Ties go to the lower group index, as ``jax.lax.top_k`` breaks them:
    a stable descending sort, not ``torch.topk``.
    """
    gd, gscore = group_mask(dynamic, score, v)
    rank = torch.where(gd, gscore + 1e6, gscore)           # dynamic first
    idx = torch.sort(rank, dim=1, descending=True, stable=True).indices[:, :k_groups]
    valid = torch.gather(gd, 1, idx)                        # only dynamic kept
    gs, g = v.groups_per_side, v.group
    gy, gx = idx // gs, idx % gs
    dy = torch.arange(g, device=idx.device)[:, None]
    dx = torch.arange(g, device=idx.device)[None, :]
    py = gy[..., None, None] * g + dy                       # (T, Kg, g, g)
    px = gx[..., None, None] * g + dx
    patch = (py * v.patches_per_side + px).reshape(idx.shape[0], -1)
    pvalid = valid.repeat_interleave(g * g, dim=1)
    return PruneDecision(idx, valid, patch, pvalid, gd)


def full_decision(v: ViTCfg, t: int, device="cuda") -> PruneDecision:
    """The no-pruning decision (I-frames / Full-Comp baseline) of t
    frames, on ``device``."""
    G, gs, g = v.n_groups, v.groups_per_side, v.group
    idx = torch.arange(G, device=device)[None].expand(t, G)
    gy, gx = idx // gs, idx % gs
    py = gy[..., None, None] * g + torch.arange(g, device=device)[:, None]
    px = gx[..., None, None] * g + torch.arange(g, device=device)[None, :]
    patch = (py * v.patches_per_side + px).reshape(t, -1)
    ones = torch.ones((t, G), dtype=torch.bool, device=device)
    return PruneDecision(idx, ones, patch, torch.ones_like(patch, dtype=torch.bool), ones)


def pruning_stats(dec: PruneDecision) -> dict:
    """Token-reduction accounting (paper Fig. 13/14), from one
    device-to-host copy of the decision's two group fields."""
    gv, gd = dec.group_valid, dec.group_dynamic
    both = torch.cat([gv.reshape(-1), gd.reshape(-1)]).cpu().numpy()
    kept = int(both[:gv.numel()].sum())
    total = gd.shape[0] * gd.shape[1]
    return {
        "kept_tokens": kept,
        "total_tokens": int(total),
        "pruned_frac": float(1.0 - kept / total),
        "dynamic_frac": float(both[gv.numel():].mean()),
    }


# ======================================================================
# Cross-frame patch packing (packed variable-capacity ViT encode)
# ======================================================================
# Row-length buckets of the packed buffer: the smallest bucket that fits
# the largest single frame is chosen (a frame's run never splits rows).
PACK_LEN_BUCKETS: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)

# Rows / kept-group counts are quantized so serving sees a small set of
# packed geometries.
PACK_ROW_QUANTUM = 2
PACK_GROUP_QUANTUM = 32


class PackPlan(NamedTuple):
    """Host-built packing layout for one fused batch of P-frames.

    Attributes:
      l_pack: row length (a ``PACK_LEN_BUCKETS`` entry, tile-aligned).
      patch_src: (n_rows, l_pack) int32 — flat index into the
        ``(n_frames * n_patches)`` patchified batch; 0 for padding.
      seg_id: (n_rows, l_pack) int32 — frame index per slot, -1 padding.
      group_src: (k_pack, g**2) int32 — flat index into the packed buffer
        for each kept group's patches, pixel-unshuffle order.
      group_dst: (k_pack,) int32 — destination slot in the flattened
        ``(n_frames * k_groups)`` token grid; one past the end for padding.
      block_map: per-row kv-tile visit list for ``ops.flash_packed``.
      n_frames, k_groups: decision geometry the plan was built for.
      kept_patches: (n_frames,) int64 — kept patch count per frame.
    """

    l_pack: int
    patch_src: np.ndarray
    seg_id: np.ndarray
    group_src: np.ndarray
    group_dst: np.ndarray
    block_map: PackBlockMap
    n_frames: int
    k_groups: int
    kept_patches: np.ndarray

    @property
    def n_rows(self) -> int:
        return self.patch_src.shape[0]

    @property
    def n_slots(self) -> int:
        """Total packed buffer slots (incl. padding)."""
        return self.patch_src.size

    @property
    def k_pack(self) -> int:
        return self.group_dst.shape[0]

    @property
    def n_kept_groups(self) -> int:
        return int((self.group_dst < self.n_frames * self.k_groups).sum())

    @property
    def fill(self) -> float:
        return float((self.seg_id >= 0).mean())


def _round_up(n: int, q: int) -> int:
    return -(-max(n, 1) // q) * q


def pack_plan(dec, v: ViTCfg, *,
              buckets: Sequence[int] = PACK_LEN_BUCKETS, tile: int = 128,
              row_quantum: int = PACK_ROW_QUANTUM,
              group_quantum: int = PACK_GROUP_QUANTUM) -> PackPlan:
    """Build the cross-frame packing layout from a batched decision (a
    ``PruneDecision``, fetched to the host once, or a ``HostDecision``),
    packing first-fit in frame order, each kept group as a contiguous
    ``g**2``-patch run.
    """
    if not isinstance(dec, HostDecision):
        dec = to_host(dec)
    gv = dec.group_valid.astype(bool)
    pi = dec.patch_idx.astype(np.int64)
    B, Kg = gv.shape
    g2 = v.group ** 2
    P = v.n_patches
    needs = gv.sum(axis=1).astype(np.int64) * g2            # slots per frame

    max_need = int(needs.max(initial=0))
    fit = [b for b in buckets if b >= max(max_need, tile)]
    l_pack = fit[0] if fit else _round_up(max_need, tile)

    fills: list = []                                        # slots used/row
    placement = {}
    for f in range(B):
        need = int(needs[f])
        if need == 0:
            continue
        for r, used in enumerate(fills):
            if used + need <= l_pack:
                placement[f] = (r, used)
                fills[r] += need
                break
        else:
            placement[f] = (len(fills), 0)
            fills.append(need)
    n_rows = _round_up(len(fills), row_quantum) if fills else row_quantum

    patch_src = np.zeros((n_rows, l_pack), np.int32)
    seg_id = np.full((n_rows, l_pack), -1, np.int32)
    dsts, bases = [], []
    for f, (r, off) in placement.items():
        for j in np.nonzero(gv[f])[0]:
            patch_src[r, off: off + g2] = f * P + pi[f, j * g2: (j + 1) * g2]
            seg_id[r, off: off + g2] = f
            dsts.append(f * Kg + int(j))
            bases.append(r * l_pack + off)
            off += g2

    k_pack = _round_up(len(dsts), group_quantum)
    group_dst = np.full((k_pack,), B * Kg, np.int32)        # pad -> dropped
    group_base = np.zeros((k_pack,), np.int32)
    if dsts:
        group_dst[: len(dsts)] = np.asarray(dsts, np.int32)
        group_base[: len(bases)] = np.asarray(bases, np.int32)
    group_src = group_base[:, None] + np.arange(g2, dtype=np.int32)[None]

    tq = tk = min(tile, l_pack)
    block_map = build_pack_map(seg_id, tq=tq, tk=tk)
    return PackPlan(
        l_pack=l_pack, patch_src=patch_src, seg_id=seg_id,
        group_src=group_src, group_dst=group_dst, block_map=block_map,
        n_frames=B, k_groups=Kg, kept_patches=needs,
    )
