"""Window geometry of selective KV-cache reuse + refresh (paper §3.4).

``WindowLayout`` is the static token geometry of a sliding window.
``stride % gop == 0`` makes every window start on an I-frame, so frame
types, token offsets, anchor positions and the shift amount are all
constants of the layout.  The refresh set is the I-frame anchors of the
overlap plus the new-stride and query tokens (§3.4.1).  The reuse of
per-stream caches (Eq. 5) lives here too; its paged twin is in
``kv_pool``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.flash_refresh import RefreshBlockMap, build_block_map


@dataclasses.dataclass(frozen=True)
class WindowLayout:
    """Token order: [frame_0 tokens, ..., frame_{w-1} tokens, query].

    Frame f contributes ``g_tokens`` if it is an I-frame (f % gop == 0)
    else ``k_tokens`` (pruning capacity).
    """

    window: int          # w: frames per window
    stride: int          # s: frames advanced per step
    gop: int
    g_tokens: int        # tokens for a fully-encoded frame (n_groups)
    k_tokens: int        # capacity tokens for a pruned P-frame
    query_len: int

    def __post_init__(self):
        if self.stride % self.gop or self.window % self.gop:
            raise ValueError(
                "window and stride must be GOP multiples so every window "
                f"starts on an I-frame (w={self.window}, s={self.stride}, "
                f"gop={self.gop})")

    def frame_is_i(self, f: int) -> bool:
        return f % self.gop == 0

    @functools.cached_property
    def frame_tokens(self) -> Tuple[int, ...]:
        return tuple(
            self.g_tokens if self.frame_is_i(f) else self.k_tokens
            for f in range(self.window)
        )

    @functools.cached_property
    def frame_offsets(self) -> Tuple[int, ...]:
        off, out = 0, []
        for n in self.frame_tokens:
            out.append(off)
            off += n
        return tuple(out)

    @property
    def vis_len(self) -> int:
        return sum(self.frame_tokens)

    @property
    def total_len(self) -> int:
        return self.vis_len + self.query_len

    @property
    def shift_tokens(self) -> int:
        """Token count of the first ``stride`` frames (= position delta)."""
        return sum(self.frame_tokens[: self.stride])

    @property
    def overlap_tokens(self) -> int:
        return self.vis_len - self.shift_tokens

    @functools.cached_property
    def anchor_token_idx(self) -> np.ndarray:
        """New-window positions of overlap-region I-frame tokens."""
        idx = []
        for f in range(0, self.window - self.stride, self.gop):
            off = self.frame_offsets[f]
            idx.extend(range(off, off + self.g_tokens))
        return np.asarray(idx, np.int32)

    @functools.cached_property
    def refresh_token_idx(self) -> np.ndarray:
        """Refresh set: anchors + new-stride tokens + query tokens."""
        tail = np.arange(self.overlap_tokens, self.total_len, dtype=np.int32)
        return np.concatenate([self.anchor_token_idx, tail])

    @property
    def n_refresh(self) -> int:
        return len(self.refresh_token_idx)

    def frame_token_slice(self, f: int) -> slice:
        return slice(self.frame_offsets[f], self.frame_offsets[f] + self.frame_tokens[f])


@functools.lru_cache(maxsize=None)
def refresh_block_map(layout: WindowLayout, *, tq: int = 128, tk: int = 128,
                      window: Optional[int] = None,
                      kv_len: Optional[int] = None) -> RefreshBlockMap:
    """The (q-tile -> kv-tile) visit list of the selective-refresh pass:
    one per (layout, tiles, sliding window, cache extent), shared by
    every layer of every refresh call.  Slots past ``total_len`` lie
    above every refresh query position, so causality alone keeps their
    tiles out of the list."""
    if kv_len is None:
        kv_len = layout.total_len
    assert kv_len >= layout.total_len, (kv_len, layout.total_len)
    return build_block_map(layout.refresh_token_idx, kv_len, tq=tq, tk=tk,
                           causal=True, window=window)


# ======================================================================
# KVC reuser (position-consistent reuse, Eq. 5) on per-stream caches
# ======================================================================
def shift_cache(cache, layout: WindowLayout, rope_theta: float):
    """Move overlap KV to the new window's coordinates, in place.

    ``cache.k``/``cache.v`` are (..., S, n_kv, d_head).  Old positions
    [shift, vis_len) move to [0, overlap), keys rotated by R(-shift)
    (Eq. 5), values copied.  The two ranges overlap, so both are read
    into copies before either is written.  Slots >= overlap keep stale
    content: the refresh pass overwrites them or the validity mask hides
    them."""
    sh, ov, vl = layout.shift_tokens, layout.overlap_tokens, layout.vis_len
    k_over = cache.k[..., sh:vl, :, :]
    lead = k_over.shape[:-3]
    flat = k_over.reshape((-1,) + k_over.shape[-3:])
    delta = torch.full(flat.shape[:2], -sh, dtype=torch.int32, device=flat.device)
    k_corr = ops.rope_shift(flat, delta, rope_theta).reshape(lead + flat.shape[1:])
    v_over = cache.v[..., sh:vl, :, :].clone()
    cache.k[..., :ov, :, :] = k_corr.to(cache.k.dtype)
    cache.v[..., :ov, :, :] = v_over
    return cache


def reuse_caches(cfg, caches, layout: WindowLayout):
    """``shift_cache`` on every attention position of the stack, in place
    (the (R, B) leading dims are rotated as one batch of R * B rows, the
    operand shape of the JAX package's call)."""
    for blk in caches.blocks:
        shift_cache(blk, layout, cfg.rope_theta)
    return caches


def shift_valid(valid: torch.Tensor, layout: WindowLayout) -> torch.Tensor:
    """The per-token validity mask shifted with the window (a new tensor)."""
    sh, ov = layout.shift_tokens, layout.overlap_tokens
    out = torch.zeros_like(valid)
    out[:, :ov] = valid[:, sh:layout.vis_len]
    return out
