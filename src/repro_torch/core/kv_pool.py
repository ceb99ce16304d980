"""Paged KV pool: one shared slab per layer + per-stream page tables.

All concurrent streams share one pre-allocated bf16 slab per attention
position of the block pattern:

    slab leaf:   (R, n_pages * PAGE, n_kv, d_head)      # batchless
    page table:  (B, pages_per_stream) int32            # per stream

A stream's logical slot ``s`` lives at physical row
``page_table[s // PAGE] * PAGE + s % PAGE``.  Admission pops page ids
off a host-side LIFO free list and eviction pushes them back: KV bytes
are never copied when streams enter or leave.

The slab is updated in place (the JAX package threads it through
donated jitted calls instead).  Recycled pages need no zeroing: every
slot a window attends to is either written this window or masked out by
``kv_valid``, and masked logits contribute exact zeros.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelCfg
from ..kernels import ops
from ..models.layers import KVCache
from ..models.transformer import Caches
from .kvc import WindowLayout

#: Page size in KV slots: the kernels' KV tile, so one visit-list entry
#: is exactly one page.
PAGE_SIZE = 128


class PoolExhausted(RuntimeError):
    """Raised when ``admit`` needs more pages than the free list holds."""


def logical_to_physical(page_table: torch.Tensor, idx: torch.Tensor,
                        page: int = PAGE_SIZE) -> torch.Tensor:
    """Logical slots ``idx`` (T,) through page tables (B, n_pages) ->
    physical slab rows (B, T)."""
    return page_table[:, idx // page] * page + idx % page


class KVPool:
    """Fixed-size paged bf16 KV slab with a LIFO free list.

    Page bookkeeping is host numpy and belongs to the scheduler's thread;
    ``slab`` (a ``Caches`` of batchless ``KVCache`` leaves on the device)
    is written in place by the serving calls.
    """

    def __init__(self, cfg: ModelCfg, n_pages: int, page: int = PAGE_SIZE,
                 dtype=torch.bfloat16, device="cpu") -> None:
        for pos in range(cfg.period):
            mixer, _ = cfg.block_kind(pos)
            if mixer != "attn":
                raise ValueError("KVPool serves pure-attention stacks")
        self.cfg = cfg
        self.page = page
        self.n_pages = n_pages
        shape = (cfg.repeats, n_pages * page, cfg.n_kv, cfg.d_head)
        self.slab = Caches(tuple(
            KVCache(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.period)
        ), None)
        # LIFO: recently evicted pages are re-admitted first
        self._free: list = list(range(n_pages - 1, -1, -1))
        self._in_use: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._in_use)

    def can_admit(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def admit(self, n_pages: int) -> np.ndarray:
        """Pop ``n_pages`` page ids; raises :class:`PoolExhausted` when the
        free list is short."""
        if n_pages > len(self._free):
            raise PoolExhausted(
                f"need {n_pages} pages, {len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n_pages)]
        self._in_use.update(pages)
        return np.asarray(pages, np.int32)

    def admit_streams(self, n_streams: int, pages_per_stream: int) -> np.ndarray:
        """Admit ``n_streams`` streams at once -> (S, pages_per_stream)."""
        return self.admit(n_streams * pages_per_stream).reshape(
            n_streams, pages_per_stream)

    def evict(self, pages) -> None:
        """Return a stream's pages to the free list (no KV copy)."""
        for p in np.asarray(pages, np.int64).ravel().tolist():
            if p not in self._in_use:
                raise ValueError(f"double free of page {p}")
            self._in_use.discard(p)
            self._free.append(p)

    @property
    def slab_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size()
                   for blk in self.slab.blocks for leaf in blk)

    def page_bytes(self) -> int:
        """Bytes one page costs across every layer."""
        return sum((blk.k.numel() + blk.v.numel()) // self.n_pages
                   * blk.k.element_size() for blk in self.slab.blocks)

    def bytes_per_stream(self, hot_pages: int) -> int:
        return hot_pages * self.page_bytes()


def reuse_pool_caches(cfg: ModelCfg, caches: Caches, page_table: torch.Tensor,
                      layout: WindowLayout, page: int = PAGE_SIZE) -> Caches:
    """Position-consistent reuse (Eq. 5) on the paged slab, in place.

    Gathers the overlap KV (logical slots [shift, vis_len)) through the
    page table, rotates the keys by R(-shift) (``rope_shift``) and
    scatters keys and values to logical slots [0, overlap).  Source and
    destination ranges overlap, so the gather completes before the
    scatter: an in-place slice move would overwrite rows it has yet to
    read.
    """
    sh, ov, vl = layout.shift_tokens, layout.overlap_tokens, layout.vis_len
    pt = page_table.long()
    dev = pt.device
    phys_src = logical_to_physical(pt, torch.arange(sh, vl, device=dev), page)
    phys_dst = logical_to_physical(pt, torch.arange(0, ov, device=dev), page)
    B = pt.shape[0]
    for blk in caches.blocks:
        R = blk.k.shape[0]
        k_over = blk.k[:, phys_src]          # (R, B, ov, n_kv, d_head) copy
        v_over = blk.v[:, phys_src]
        flat_k = k_over.reshape((R * B,) + k_over.shape[2:])
        delta = torch.full((R * B, ov), -sh, dtype=torch.int32, device=dev)
        k_corr = ops.rope_shift(flat_k, delta, cfg.rope_theta)
        blk.k[:, phys_dst] = k_corr.reshape(k_over.shape).to(blk.k.dtype)
        blk.v[:, phys_dst] = v_over
    return caches
