"""Block-sparse refresh attention: visit-list maps and the kernels.

Three kernels of ``csrc/attention.cu`` share its refresh body:

  * ``cs_attn_refresh_bf16`` replaces the TPU kernel
    ``repro/kernels/flash_refresh.py:flash_refresh_pallas``: GQA attention
    of gathered query rows over per-stream caches (B, Sk, Hkv, D);
  * ``cs_attn_refresh_paged_bf16`` replaces ``flash_refresh_paged_pallas``
    (its bf16 body ``_refresh_paged_kernel``): the same over one
    batchless KV slab, the stream's page table mapping each logical
    128-slot tile to a physical slab page;
  * ``cs_attn_refresh_paged_int8`` replaces that function's int8 body
    (``_refresh_paged_quant_kernel``): page-table entries ``>= n_hot``
    name int8 cold pages, dequantised ``int8 x scale[page, kv head]`` and
    rounded to bf16 in shared memory, so an all-hot table gives bitwise
    the bf16 kernel's result.

The visit list ``tile_ids[iq, it]`` names the logical tiles a query tile
can reach.  The mask is causal (+ sliding window) on the map's query
positions (-1 = padding) AND the per-stream logical ``kv_valid``; fully
masked rows are exact zeros.  On the card the same kernels also carry
decode and the contiguous fresh prefill, with maps built for those
positions.

Bound on an H100: tensor-core operations (each visited 128x128 tile
pair does 4*128*128*D flops on 64 KB of bf16 K/V at D = 128, 32 KB when
the page is int8); decode reads every visited key for one query row and
is bound by those bytes.  The design: one thread block of eight warps
per (128-row query tile, head, stream) follows the tile's visit list, so
each visited K/V tile is read once per query tile; 16-byte ``cp.async``
copies fill a ring of three 64-key slots ahead of the products (an int8
tile lands in a staging slot and is dequantised into the ring); both
products are ``mma.sync`` m16n8k16 bf16 -> f32 with S, P and O in
registers around an f32 online softmax with the masked multiply.  Query
rows past Sq are neither read nor written, so the query is not padded.

Operands the kernels take (``contracts.FLASH_REFRESH`` and
``FLASH_REFRESH_PAGED``; the wrappers raise on anything else): bf16
q/k/v with head dim 24, 32, 64 or 128; 128-row map tiles and pages; q, k,
v, the int8 slabs and ``kv_valid`` on 16-byte boundaries (``kv_valid``
is copied once where it is not).

``RefreshBlockMap``, ``build_block_map`` and ``dense_block_map`` are
host numpy, equal array for array to the JAX package's.  The plain
PyTorch versions are ``flash_refresh_plain`` (the q-chunked
``ref.flash_refresh_ref``) and ``flash_refresh_paged_plain`` (gather,
through the int8 group where given, then the same).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import contracts, cuda
from .transfer import upload
from .ref import flash_refresh_ref, paged_gather

NAME = "flash_refresh_paged"
NAME_INT8 = "flash_refresh_paged_int8"
NAME_STREAM = "flash_refresh"
TILE = 128


class DeviceBlockMap(NamedTuple):
    """A ``RefreshBlockMap``'s arrays on one device (int32)."""

    q_pos: torch.Tensor
    tile_ids: torch.Tensor
    tile_count: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class RefreshBlockMap:
    """Per-(q-tile, kv-tile) visit list for the refresh kernel.

    Attributes:
      tq, tk: tile sizes the map was built for.
      n_q: unpadded query count (callers slice kernel output to this).
      kv_len: key/value sequence length the map covers.
      q_pos: (n_q_tiles * tq,) int32 query positions, padded with -1.
      tile_ids: (n_q_tiles, t_max) int32 kv tiles to visit per q tile,
        right-padded by repeating the last live id.
      tile_count: (n_q_tiles,) int32 live entries per row.
      causal, window: the positional mask the map was built for.
    """

    tq: int
    tk: int
    n_q: int
    kv_len: int
    q_pos: np.ndarray
    tile_ids: np.ndarray
    tile_count: np.ndarray
    causal: bool = True
    window: int | None = None
    _device: Dict[str, DeviceBlockMap] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_q_tiles(self) -> int:
        return self.tile_ids.shape[0]

    @property
    def t_max(self) -> int:
        return self.tile_ids.shape[1]

    @property
    def n_kv_tiles(self) -> int:
        return -(-self.kv_len // self.tk)

    @property
    def density(self) -> float:
        """Visited fraction of the dense (q-tile, kv-tile) grid."""
        total = self.n_q_tiles * self.n_kv_tiles
        return float(self.tile_count.sum()) / max(total, 1)

    @property
    def visited(self) -> int:
        return int(self.tile_count.sum())

    def on(self, device: torch.device) -> DeviceBlockMap:
        """The map's arrays on ``device``, copied once per device."""
        key = str(device)
        hit = self._device.get(key)
        if hit is None:
            hit = DeviceBlockMap(*(
                upload(a, device, torch.int32)
                for a in (self.q_pos, self.tile_ids, self.tile_count)
            ))
            self._device[key] = hit
        return hit


def build_block_map(q_pos, kv_len: int, *, tq: int = 128, tk: int = 128,
                    causal: bool = True, window: int | None = None
                    ) -> RefreshBlockMap:
    """Static (q-tile -> kv-tile) visit list.

    A kv tile is visited iff some (q, k) pair in the tile pair can pass
    the positional mask (conservative per-tile bounds); ``kv_valid`` is
    applied per element inside the kernel.
    """
    q_pos = np.asarray(q_pos, np.int32).reshape(-1)
    n_q = q_pos.shape[0]
    assert n_q > 0 and kv_len > 0, (n_q, kv_len)
    pad = (-n_q) % tq
    qp = np.concatenate([q_pos, np.full((pad,), -1, np.int32)])
    n_q_tiles = qp.shape[0] // tq
    n_kv_tiles = -(-kv_len // tk)
    k_lo = np.arange(n_kv_tiles, dtype=np.int64) * tk
    k_hi = np.minimum(k_lo + tk, kv_len) - 1

    active = np.zeros((n_q_tiles, n_kv_tiles), bool)
    qt = qp.reshape(n_q_tiles, tq)
    for i in range(n_q_tiles):
        live = qt[i][qt[i] >= 0]
        if live.size == 0:
            continue
        row = k_lo < kv_len
        if causal:
            row &= k_lo <= int(live.max())
        if window is not None:
            row &= k_hi > int(live.min()) - window
        active[i] = row

    t_max = max(1, int(active.sum(axis=1).max(initial=0)))
    tile_ids = np.zeros((n_q_tiles, t_max), np.int32)
    tile_count = active.sum(axis=1).astype(np.int32)
    for i in range(n_q_tiles):
        ids = np.nonzero(active[i])[0].astype(np.int32)
        if ids.size:
            tile_ids[i, : ids.size] = ids
            tile_ids[i, ids.size:] = ids[-1]
    return RefreshBlockMap(
        tq=tq, tk=tk, n_q=n_q, kv_len=kv_len,
        q_pos=qp, tile_ids=tile_ids, tile_count=tile_count,
        causal=causal, window=window,
    )


def dense_block_map(q_pos, kv_len: int, *, tq: int = 128, tk: int = 128,
                    causal: bool = True, window: int | None = None
                    ) -> RefreshBlockMap:
    """Every kv tile visited for every q tile (the unskipped twin)."""
    q_pos = np.asarray(q_pos, np.int32).reshape(-1)
    pad = (-q_pos.shape[0]) % tq
    qp = np.concatenate([q_pos, np.full((pad,), -1, np.int32)])
    n_q_tiles = qp.shape[0] // tq
    n_kv_tiles = -(-kv_len // tk)
    ids = np.broadcast_to(
        np.arange(n_kv_tiles, dtype=np.int32), (n_q_tiles, n_kv_tiles)
    ).copy()
    return RefreshBlockMap(
        tq=tq, tk=tk, n_q=q_pos.shape[0], kv_len=kv_len, q_pos=qp,
        tile_ids=ids,
        tile_count=np.full((n_q_tiles,), n_kv_tiles, np.int32),
        causal=causal, window=window,
    )


# ======================================================================
# plain versions and kernels
# ======================================================================
def flash_refresh_plain(q, k, v, q_pos, kv_valid=None, *, causal: bool = True,
                        window: int | None = None, q_chunk: int = 1024):
    """q-chunked oracle over per-stream caches k, v (B, Sk, Hkv, D) (peak
    activation ~ q_chunk x Sk instead of Sq x Sk; rows are independent)."""
    Sq = q.shape[1]
    outs = [
        flash_refresh_ref(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                          kv_valid, causal=causal, window=window)
        for i in range(0, Sq, q_chunk)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def flash_refresh_paged_plain(q, k, v, q_pos, kv_valid, page_table, *,
                              page: int = 128, causal: bool = True,
                              window: int | None = None, q_chunk: int = 1024,
                              cold=None):
    """Gather the logical K/V view once (through the int8 ``cold`` group
    where given), then the q-chunked oracle."""
    kg, vg = paged_gather(k, v, page_table, page, cold)
    return flash_refresh_plain(q, kg, vg, q_pos, kv_valid, causal=causal,
                               window=window, q_chunk=q_chunk)


def _valid_bytes(kv_valid: torch.Tensor) -> torch.Tensor:
    """kv_valid as the kernels read it: contiguous, 16-byte aligned."""
    kvv = kv_valid.contiguous()
    return kvv if kvv.data_ptr() % 16 == 0 else kvv.clone()


def flash_refresh_cuda(q, k, v, kv_valid, block_map: RefreshBlockMap, *,
                       causal: bool = True, window: int | None = None):
    """Launch the per-stream kernel: q (B, Sq, H, D) bf16; k, v (B, Sk,
    Hkv, D) bf16 caches, Sk a multiple of 128; kv_valid (B, Sk) bool.
    The query rows are masked by the MAP's positions (``ops.flash_refresh``
    checks that they equal the caller's).  Operands the kernel does not
    take raise."""
    contracts.require(contracts.flash_refresh_verdict(
        q, k, v, None, kv_valid, causal=causal, window=window, block_map=block_map),
        NAME_STREAM)
    return flash_refresh_launch(q, k, v, kv_valid, block_map, causal=causal, window=window)


def flash_refresh_launch(q, k, v, kv_valid, block_map: RefreshBlockMap, *,
                         causal: bool, window: int | None):
    """The launch alone, for operands the registry took (``ops``)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bm = block_map
    dm = bm.on(q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda.require_aligned(NAME_STREAM, q, k, v)
    kvv = _valid_bytes(kv_valid)
    out = torch.empty_like(q)
    rc = cuda.library().cs_attn_refresh_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dm.q_pos.data_ptr(), kvv.data_ptr(), dm.tile_ids.data_ptr(),
        dm.tile_count.data_ptr(), B, Sq, H, Hkv, D, Sk // TILE,
        bm.t_max, int(causal), -1 if window is None else int(window),
        float(D ** -0.5), cuda.stream_handle(q),
    )
    cuda.check(rc, NAME_STREAM)
    cuda.record_launch(NAME_STREAM)
    return out


def flash_refresh_paged_cuda(q, k, v, kv_valid, page_table,
                             block_map: RefreshBlockMap, *, page: int = 128,
                             causal: bool = True, window: int | None = None,
                             cold=None):
    """Launch the paged kernel, the int8 one when ``cold = (k8, v8,
    k_scale, v_scale)`` is given.  The query rows are masked by the MAP's
    positions (``ops.flash_refresh_paged`` checks that they equal the
    caller's, and that the page ids lie in the slabs).

    q (B, Sq, H, D) bf16; k, v (P_phys, Hkv, D) bf16 (hot) slab; kv_valid
    (B, n_pages * page) bool; page_table (B, n_pages) int; k8, v8
    (n_cold * page, Hkv, D) int8; k_scale, v_scale (n_cold, Hkv) f32.
    Operands the kernel does not take raise.
    """
    contracts.require(contracts.flash_refresh_paged_verdict(
        q, k, v, None, kv_valid, page_table, page=page, causal=causal, window=window,
        block_map=block_map, cold=cold), NAME if cold is None else NAME_INT8)
    return flash_refresh_paged_launch(q, k, v, kv_valid, page_table, block_map, page=page,
                                      causal=causal, window=window, cold=cold)


def flash_refresh_paged_launch(q, k, v, kv_valid, page_table, block_map: RefreshBlockMap,
                               *, page: int, causal: bool, window: int | None, cold):
    """The launch alone, for operands the registry took (``ops``)."""
    name = NAME if cold is None else NAME_INT8
    B, Sq, H, D = q.shape
    P_phys, Hkv = k.shape[0], k.shape[1]
    n_pages = page_table.shape[1]
    bm = block_map
    dm = bm.on(q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda.require_aligned(name, q, k, v)
    kvv = _valid_bytes(kv_valid)
    pt = page_table.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              dm.q_pos.data_ptr(), kvv.data_ptr(), pt.data_ptr(),
              dm.tile_ids.data_ptr(), dm.tile_count.data_ptr())
    shape = (B, Sq, H, Hkv, D, n_pages, bm.t_max, int(causal),
             -1 if window is None else int(window), float(D ** -0.5),
             cuda.stream_handle(q))
    if cold is None:
        rc = cuda.library().cs_attn_refresh_paged_bf16(*common, *shape)
    else:
        k8, v8, k_scale, v_scale = (t.contiguous() for t in cold)
        cuda.require_aligned(name, k8, v8)
        rc = cuda.library().cs_attn_refresh_paged_int8(
            *common, k8.data_ptr(), v8.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), P_phys // page, *shape)
    cuda.check(rc, name)
    cuda.record_launch(name)
    return out


def flash_refresh_work(q, k, q_pos=None, kv_valid=None, *, causal: bool = True,
                       window: int | None = None):
    """(flops, bytes) the refresh attention needs over per-stream caches:
    4 D H flops per live (query, key) pair; q, the output and the K/V
    rows some query sees read or written once, kv_valid once.  Live pairs
    come from ``q_pos`` and ``kv_valid`` where they hold data; on the
    meta device (the dry run) the queries are taken as the last Sq
    positions of the Sk keys and every key as valid, which is what a
    fresh prefill and a decode step at the end of the caches see."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.device.type == "meta" or q_pos is None:
        p = np.arange(Sk - Sq, Sk, dtype=np.int64)
        hi = p if causal else np.full_like(p, Sk - 1)
        lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros_like(p)
        live = float(B * np.clip(hi - lo + 1, 0, None).sum())
        rows = float(B * (hi.max() - lo.min() + 1))
    else:
        qp = q_pos.long()
        kpos = torch.arange(Sk, device=qp.device)
        mask = (kv_valid[:, None, :] if kv_valid is not None
                else torch.ones((B, 1, Sk), dtype=torch.bool, device=qp.device))
        if causal:
            mask = mask & (kpos[None, None, :] <= qp[:, :, None])
        if window is not None:
            mask = mask & (kpos[None, None, :] > qp[:, :, None] - window)
        mask = mask.expand(B, Sq, Sk)
        live = float(mask.sum())
        rows = float(mask.any(1).sum())
    n_bytes = (2 * q.numel() * q.element_size() + 2 * rows * Hkv * D * k.element_size()
               + B * Sk)
    return 4.0 * D * H * live, float(n_bytes)
