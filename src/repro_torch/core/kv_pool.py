"""Paged KV pool: one shared slab per layer + per-stream page tables.

All concurrent streams share one pre-allocated slab per attention
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

With ``cold_pages > 0`` the slab is two-precision (``QuantKVCache``
blocks): hot bf16 pages plus int8 cold pages with per-page-per-head f32
scales, in one page-id space (ids ``>= n_pages`` are cold).  Streams are
admitted all hot with a cold reservation; ``demote`` later moves the
overlap pages a stream has carried for ``demote_after`` windows to the
cold slab (``demote_pool_caches`` moves the content).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelCfg
from ..kernels import ops
from ..kernels.transfer import host_of, nonzero
from ..models.layers import (
    KVCache, QuantKVCache, dequantize_kv, page_quant_scale, quantize_kv,
)
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
    """Fixed-size paged KV slab with LIFO free lists (hot and cold).

    Page bookkeeping is host numpy and belongs to the scheduler's thread;
    ``slab`` (a ``Caches`` of batchless ``KVCache`` or ``QuantKVCache``
    leaves on the device) is written in place by the serving calls.
    Cold capacity is reserved per stream at admission and consumed by
    ``demote``, so an admitted stream can always demote.
    """

    def __init__(self, cfg: ModelCfg, n_pages: int, page: int = PAGE_SIZE,
                 dtype=torch.bfloat16, device="cpu", cold_pages: int = 0) -> None:
        for pos in range(cfg.period):
            mixer, _ = cfg.block_kind(pos)
            if mixer != "attn":
                raise ValueError("KVPool serves pure-attention stacks")
        self.cfg = cfg
        self.page = page
        self.n_pages = n_pages
        self.n_cold = cold_pages
        shape = (cfg.repeats, n_pages * page, cfg.n_kv, cfg.d_head)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=device)

        if cold_pages:
            cold_shape = (cfg.repeats, cold_pages * page, cfg.n_kv, cfg.d_head)
            scale_shape = (cfg.repeats, cold_pages, cfg.n_kv)
            blocks = tuple(
                QuantKVCache(zeros(shape, dtype), zeros(shape, dtype),
                             zeros(cold_shape, torch.int8), zeros(cold_shape, torch.int8),
                             torch.ones(scale_shape, device=device),
                             torch.ones(scale_shape, device=device))
                for _ in range(cfg.period))
        else:
            blocks = tuple(KVCache(zeros(shape, dtype), zeros(shape, dtype))
                           for _ in range(cfg.period))
        self.slab = Caches(blocks, None)
        # LIFO: recently evicted pages are re-admitted first
        self._free: list = list(range(n_pages - 1, -1, -1))
        self._free_cold: list = list(range(n_pages + cold_pages - 1, n_pages - 1, -1))
        self._in_use: set = set()
        self._reserved_cold = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def free_cold_pages(self) -> int:
        return len(self._free_cold)

    @property
    def used_pages(self) -> int:
        return len(self._in_use)

    def can_admit(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def can_admit_streams(self, n_streams: int, pages_per_stream: int,
                          cold_per_stream: int = 0) -> bool:
        """Hot pages now, plus a cold reservation for the demote pass."""
        if n_streams * pages_per_stream > len(self._free):
            return False
        return self._reserved_cold + n_streams * cold_per_stream <= len(self._free_cold)

    def admit(self, n_pages: int) -> np.ndarray:
        """Pop ``n_pages`` page ids; raises :class:`PoolExhausted` when the
        free list is short."""
        if n_pages > len(self._free):
            raise PoolExhausted(
                f"need {n_pages} pages, {len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n_pages)]
        self._in_use.update(pages)
        return np.asarray(pages, np.int32)

    def admit_streams(self, n_streams: int, pages_per_stream: int,
                      cold_per_stream: int = 0) -> np.ndarray:
        """Admit ``n_streams`` streams at once, all hot, reserving
        ``cold_per_stream`` cold pages each -> (S, pages_per_stream)."""
        need_cold = self._reserved_cold + n_streams * cold_per_stream
        if need_cold > len(self._free_cold):
            raise PoolExhausted(
                f"need {need_cold} reserved cold pages, "
                f"{len(self._free_cold)} free of {self.n_cold}")
        pages = self.admit(n_streams * pages_per_stream)
        self._reserved_cold = need_cold
        return pages.reshape(n_streams, pages_per_stream)

    def demote(self, hot_ids) -> np.ndarray:
        """Move pages hot -> cold: frees the hot ids, pops one cold id each
        (consuming the reservation) and returns the unified cold ids
        (``>= n_pages``).  The content move is :func:`demote_pool_caches`."""
        ids = np.asarray(hot_ids, np.int64).ravel().tolist()
        if len(ids) > len(self._free_cold):
            raise PoolExhausted(
                f"need {len(ids)} cold pages, {len(self._free_cold)} free of {self.n_cold}")
        cold = []
        for p in ids:
            if p >= self.n_pages or p not in self._in_use:
                raise ValueError(f"page {p} is not an in-use hot page")
            self._in_use.discard(p)
            self._free.append(p)
            c = self._free_cold.pop()
            self._in_use.add(c)
            cold.append(c)
        self._reserved_cold = max(0, self._reserved_cold - len(ids))
        return np.asarray(cold, np.int32)

    def unreserve_cold(self, n_pages: int) -> None:
        """Release an admission-time cold reservation (a stream evicted
        before it demoted)."""
        self._reserved_cold = max(0, self._reserved_cold - n_pages)

    def evict(self, pages) -> None:
        """Return a stream's pages to their free lists (no KV copy)."""
        for p in np.asarray(pages, np.int64).ravel().tolist():
            if p not in self._in_use:
                raise ValueError(f"double free of page {p}")
            self._in_use.discard(p)
            (self._free_cold if p >= self.n_pages else self._free).append(p)

    @property
    def slab_bytes(self) -> int:
        """Device bytes of the slab (both precisions and the scales)."""
        return sum(leaf.numel() * leaf.element_size()
                   for blk in self.slab.blocks for leaf in blk)

    def page_bytes(self, cold: bool = False) -> int:
        """Bytes one page costs across every layer (scales included)."""
        per = 0
        for blk in self.slab.blocks:
            if cold:
                if not isinstance(blk, QuantKVCache):
                    raise ValueError("pool has no cold slab")
                per += (blk.k8.numel() + blk.v8.numel()) // self.n_cold * blk.k8.element_size()
                per += ((blk.k_scale.numel() + blk.v_scale.numel()) // self.n_cold
                        * blk.k_scale.element_size())
            else:
                per += (blk.k.numel() + blk.v.numel()) // self.n_pages * blk.k.element_size()
        return per

    def bytes_per_stream(self, hot_pages: int, cold_pages: int = 0) -> int:
        """Steady-state slab bytes one stream occupies."""
        per = hot_pages * self.page_bytes()
        if cold_pages:
            per += cold_pages * self.page_bytes(cold=True)
        return per


def demotable_pages(layout: WindowLayout, page: int = PAGE_SIZE) -> np.ndarray:
    """Page indices (within a stream's row) eligible for int8 demotion:
    the pages fully inside the overlap ``[0, overlap_tokens)``.  Every
    reuse window rewrites them from the previous overlap and the refresh
    pass overwrites their anchor slots before any read; the tail stays
    hot."""
    return np.arange(layout.overlap_tokens // page, dtype=np.int64)


def demote_pool_caches(caches: Caches, src_pages: torch.Tensor,
                       dst_pages: torch.Tensor, page: int = PAGE_SIZE) -> Caches:
    """Quantise hot pages into cold slots, in place.

    src_pages (B, n_d) hot page ids; dst_pages (B, n_d) unified cold ids
    (``>= n_hot``) from :meth:`KVPool.demote`.  Each (page, kv head) gets
    a fresh scale from its abs-max, so the content rounds through int8
    once.  The freed hot pages keep their bytes (admission rewrites
    them)."""
    B, n_d = src_pages.shape
    dev = src_pages.device
    off = torch.arange(page, device=dev)
    src_rows = (src_pages.long()[:, :, None] * page + off).reshape(B, n_d * page)
    for blk in caches.blocks:
        if not isinstance(blk, QuantKVCache):
            raise ValueError("demote needs a two-precision slab")
        R, _, n_kv, dh = blk.k.shape
        n_hot = blk.k.shape[1] // page
        cold_pg = dst_pages.long() - n_hot                       # (B, n_d)
        dst_rows = (cold_pg[:, :, None] * page + off).reshape(B, n_d * page)
        for hot, slab8, scales in ((blk.k, blk.k8, blk.k_scale),
                                   (blk.v, blk.v8, blk.v_scale)):
            over = hot[:, src_rows].reshape(R, B, n_d, page, n_kv, dh)
            sc = page_quant_scale(over, (3, 5))                  # (R, B, n_d, n_kv)
            q = quantize_kv(over, sc[:, :, :, None, :])
            slab8[:, dst_rows] = q.reshape(R, B, n_d * page, n_kv, dh)
            scales[:, cold_pg] = sc
    return caches


def reuse_pool_caches(cfg: ModelCfg, caches: Caches, page_table: torch.Tensor,
                      layout: WindowLayout, page: int = PAGE_SIZE) -> Caches:
    """Position-consistent reuse (Eq. 5) on the paged slab, in place.

    Gathers the overlap KV (logical slots [shift, vis_len)) through the
    page table, rotates the keys by R(-shift) (``rope_shift``) and
    scatters keys and values to logical slots [0, overlap).  Source and
    destination ranges overlap, so the gather completes before the
    scatter: an in-place slice move would overwrite rows it has yet to
    read.

    On a two-precision slab the gather is precision-routed (cold rows
    dequantise through the hot dtype) and destination pages fully inside
    the overlap that are cold requantise with fresh scales, so a demoted
    page rounds through int8 once per window.
    """
    sh, ov, vl = layout.shift_tokens, layout.overlap_tokens, layout.vis_len
    pt = page_table.long()
    dev = pt.device
    src = torch.arange(sh, vl, device=dev)
    dst = torch.arange(0, ov, device=dev)
    B = pt.shape[0]
    if not isinstance(caches.blocks[0], QuantKVCache):
        phys_src = logical_to_physical(pt, src, page)
        phys_dst = logical_to_physical(pt, dst, page)
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

    # -- two-precision slab --------------------------------------------
    n_hot = caches.blocks[0].k.shape[1] // page
    n_cold = caches.blocks[0].k8.shape[1] // page
    src_entries = pt[:, src // page]                          # (B, ov)
    src_is_cold = src_entries >= n_hot
    phys_src_hot = src_entries.clamp(max=n_hot - 1) * page + src % page
    src_cold_pg = (src_entries - n_hot).clamp(0, n_cold - 1)
    phys_src_cold = src_cold_pg * page + src % page
    dst_entries = pt[:, dst // page]
    n_full = ov // page
    pt_h = host_of(page_table)
    if pt_h is None:
        hb, ht = torch.nonzero(dst_entries < n_hot, as_tuple=True)
        cb, cj = torch.nonzero(pt[:, :n_full] >= n_hot, as_tuple=True)
    else:        # from the table's host twin: no sync for the counts
        hb, ht = nonzero(pt_h[:, np.arange(ov) // page] < n_hot, dev)
        cb, cj = nonzero(pt_h[:, :n_full] >= n_hot, dev)
    phys_dst_hot = dst_entries[hb, ht] * page + ht % page
    # cold destinations: pages fully inside the overlap (the demotable set)
    cold_pg = pt[cb, cj] - n_hot                              # (N,)
    off = torch.arange(page, device=dev)
    cold_rows = (cold_pg[:, None] * page + off).reshape(-1)

    for blk in caches.blocks:
        R, _, n_kv, dh = blk.k.shape

        def gather(hot, cold8, scales):
            gh = hot[:, phys_src_hot]                         # (R, B, ov, ...)
            deq = dequantize_kv(cold8[:, phys_src_cold], scales[:, src_cold_pg], hot.dtype)
            return torch.where(src_is_cold[None, :, :, None, None], deq, gh)

        k_over = gather(blk.k, blk.k8, blk.k_scale)
        v_over = gather(blk.v, blk.v8, blk.v_scale)
        flat_k = k_over.reshape((R * B,) + k_over.shape[2:])
        delta = torch.full((R * B, ov), -sh, dtype=torch.int32, device=dev)
        k_corr = ops.rope_shift(flat_k, delta, cfg.rope_theta)
        k_corr = k_corr.reshape(k_over.shape).to(blk.k.dtype)
        for vals, hot, slab8, scales in ((k_corr, blk.k, blk.k8, blk.k_scale),
                                         (v_over, blk.v, blk.v8, blk.v_scale)):
            hot[:, phys_dst_hot] = vals[:, hb, ht]
            if cb.numel():
                full = vals[:, :, : n_full * page].reshape(R, B, n_full, page, n_kv, dh)
                full = full[:, cb, cj]                        # (R, N, page, n_kv, dh)
                sc = page_quant_scale(full, (2, 4))           # (R, N, n_kv)
                q = quantize_kv(full, sc[:, :, None, :])
                slab8[:, cold_rows] = q.reshape(R, -1, n_kv, dh)
                scales[:, cold_pg] = sc
    return caches
