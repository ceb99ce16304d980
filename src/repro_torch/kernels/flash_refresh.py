"""Paged block-sparse refresh attention: visit-list maps and the kernel.

Replaces the TPU kernel ``repro/kernels/flash_refresh.py:
flash_refresh_paged_pallas`` (its bf16 body ``_refresh_paged_kernel``);
the CUDA source is ``csrc/attention.cu`` (``cs_attn_refresh_paged_bf16``).
GQA attention of gathered query rows over one batchless KV slab: the
visit list ``tile_ids[iq, it]`` names a logical 128-slot tile, the
stream's page table maps it to a physical slab page.  The mask is
causal (+ sliding window) on the map's query positions (-1 = padding)
AND the per-stream logical ``kv_valid``; fully masked rows are exact
zeros.  On the card the same kernel also carries decode, with a map
built for the one decode position.

Bound on an H100: tensor-core operations (each visited 128x128 tile
pair does 4*128*128*D flops on 64 KB of K/V at D = 128).  The design:
thread blocks over (q tile half, head, stream) follow their tile's
visit list, stream K/V pages through shared memory, and run both
products on the tensor cores (WMMA bf16 -> f32) around an f32 online
softmax with the masked multiply.

``RefreshBlockMap``, ``build_block_map`` and ``dense_block_map`` are
host numpy, equal array for array to the JAX package's.  The plain
PyTorch version is ``flash_refresh_paged_plain`` (gather + the q-chunked
``ref.flash_refresh_ref``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda
from .ref import flash_refresh_ref, paged_gather_ref

NAME = "flash_refresh_paged"
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
                torch.as_tensor(a, dtype=torch.int32).to(device)
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
# plain version and kernel
# ======================================================================
def flash_refresh_paged_plain(q, k, v, q_pos, kv_valid, page_table, *,
                              page: int = 128, causal: bool = True,
                              window: int | None = None, q_chunk: int = 1024):
    """Gather the logical K/V view once, then the q-chunked oracle (peak
    activation ~ q_chunk x S instead of Sq x S; rows are independent)."""
    kg = paged_gather_ref(k, page_table, page)
    vg = paged_gather_ref(v, page_table, page)
    Sq = q.shape[1]
    outs = [
        flash_refresh_ref(q[:, i:i + q_chunk], kg, vg, q_pos[:, i:i + q_chunk],
                          kv_valid, causal=causal, window=window)
        for i in range(0, Sq, q_chunk)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def flash_refresh_paged_cuda(q, k, v, kv_valid, page_table,
                             block_map: RefreshBlockMap, *, page: int = 128,
                             causal: bool = True, window: int | None = None):
    """Launch the kernel.  The query rows are masked by the MAP's
    positions (``ops.flash_refresh_paged`` checks that they equal the
    caller's).

    q (B, Sq, H, D) bf16; k, v (P_phys, Hkv, D) bf16 slab; kv_valid
    (B, n_pages * page) bool; page_table (B, n_pages) int.
    """
    B, Sq, H, D = q.shape
    P_phys, Hkv, Dk = k.shape
    bm = block_map
    cuda.require(q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
                 and v.dtype == torch.bfloat16, NAME, "q/k/v must be bf16")
    cuda.require(D == Dk and D in (32, 64, 128), NAME, f"head dim {D}")
    cuda.require(page == TILE and bm.tq == TILE and bm.tk == TILE, NAME,
                 "page and map tiles must be 128")
    cuda.require(bm.n_q == Sq, NAME, f"map built for {bm.n_q} queries, got {Sq}")
    cuda.require(bm.causal == causal and bm.window == window, NAME,
                 "map built for another mask")
    n_pages = page_table.shape[1]
    cuda.require(bm.kv_len == n_pages * page, NAME, "map built for another length")
    cuda.require(tuple(kv_valid.shape) == (B, n_pages * page)
                 and kv_valid.dtype == torch.bool, NAME, "kv_valid shape/dtype")
    dm = bm.on(q.device)
    pad = dm.q_pos.shape[0] - Sq
    qq = F.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q.contiguous()
    k, v = k.contiguous(), v.contiguous()
    cuda.require_aligned(NAME, qq, k, v)
    kvv = kv_valid.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    out = torch.empty_like(qq)
    rc = cuda.library().cs_attn_refresh_paged_bf16(
        qq.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dm.q_pos.data_ptr(), kvv.data_ptr(), pt.data_ptr(),
        dm.tile_ids.data_ptr(), dm.tile_count.data_ptr(),
        B, qq.shape[1], H, Hkv, D, n_pages, bm.t_max, int(causal),
        -1 if window is None else int(window), float(D ** -0.5),
        cuda.stream_handle(q),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return out[:, :Sq]
