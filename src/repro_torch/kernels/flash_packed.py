"""Block-diagonal attention over packed ViT rows: visit lists and kernel.

Replaces the TPU kernel ``repro/kernels/flash_packed.py:
flash_packed_pallas``; the CUDA source is ``csrc/attention.cu``
(``cs_attn_packed_bf16``: the register body of the refresh and prefill
kernels with the ``Packed`` problem struct).  Slots attend iff they
carry the same non-negative segment id (one frame's kept patches);
padding slots (-1) are exact zeros.  Visit lists are per packed row and
change with every packing, so they are device inputs, not compile-time
constants.

The kernel's mask is a key range per query slot, not a comparison of
segment ids per (query, key) pair (a per-element test costs the softmax
a dozen instructions a score).  That is exact when every segment is one
contiguous run of its row, which ``core.pruning.pack_plan`` guarantees
(a frame's kept patches never split); ``build_pack_map`` records each
slot's run and whether the layout has that property, and
``flash_packed_cuda`` refuses a layout that does not (eligibility rule
``single-run`` of ``contracts.FLASH_PACKED``).  The plain version takes
any layout.

Bound on an H100: tensor-core operations on the visited block-diagonal
tiles (at D = 64 each tile pair does 4*128*128*64 flops on 32 KB of
K/V).  The design visits only tiles that share a live segment and runs
both products on the tensor cores around an f32 online softmax, with S,
P and O in registers.

``PackBlockMap``'s ``tile_ids`` / ``tile_count`` from ``build_pack_map``
and ``dense_pack_map`` are host numpy, equal array for array to the JAX
package's.  The plain PyTorch version is ``flash_packed_plain`` (the
q-chunked ``ref.flash_packed_ref``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import contracts, cuda
from .transfer import upload
from .ref import flash_packed_ref

NAME = "flash_packed"


class DevicePackMap(NamedTuple):
    seg_id: torch.Tensor
    span: torch.Tensor
    tile_ids: torch.Tensor
    tile_count: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class PackBlockMap:
    """Per-(row, q-tile) kv-tile visit list for the packed kernel.

    Attributes:
      tq, tk: tile sizes the map was built for.
      tile_ids: (rows, n_q_tiles, t_max) int32 kv-tile ids per (row, q
        tile), right-padded by repeating the last live id (id 0 when a
        row is empty).
      tile_count: (rows, n_q_tiles) int32 live entries per visit list.
      seg_id: (rows, L) int32, the layout the map was built from.
      span: (rows, L) int32, per slot the first and last slot of its run
        of equal segment ids, as ``first | last << 16``; -1 for padding.
      single_run: every segment id is one run in each row it occupies,
        so a slot's run is its whole segment (the kernel's precondition).
    """

    tq: int
    tk: int
    tile_ids: np.ndarray
    tile_count: np.ndarray
    seg_id: np.ndarray
    span: np.ndarray
    single_run: bool
    _device: Dict[str, DevicePackMap] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_rows(self) -> int:
        return self.tile_ids.shape[0]

    @property
    def n_q_tiles(self) -> int:
        return self.tile_ids.shape[1]

    @property
    def t_max(self) -> int:
        return self.tile_ids.shape[2]

    @property
    def visited(self) -> int:
        return int(self.tile_count.sum())

    @property
    def density(self) -> float:
        """Visited fraction of the dense (row, q-tile, kv-tile) grid."""
        total = self.tile_count.size * max(
            1, -(-self.tile_ids.shape[1] * self.tq // self.tk)
        )
        return self.visited / max(total, 1)

    def on(self, device: torch.device) -> DevicePackMap:
        key = str(device)
        hit = self._device.get(key)
        if hit is None:
            hit = DevicePackMap(*(
                upload(a, device, torch.int32)
                for a in (self.seg_id, self.span, self.tile_ids, self.tile_count)
            ))
            self._device[key] = hit
        return hit


def _segment_spans(seg: np.ndarray):
    """Per slot of ``seg`` (rows, L), the first and last slot of its run
    of equal ids as ``first | last << 16`` (-1 for padding), and whether
    each row holds every segment id as a single run."""
    rows, L = seg.shape
    if L > 1 << 15:
        raise ValueError(f"packed rows of {L} slots: a span holds 15-bit slot indices")
    span = np.full((rows, L), -1, np.int32)
    single_run = True
    for r in range(rows):
        starts = np.flatnonzero(np.diff(seg[r], prepend=seg[r, 0] - 1))
        ends = np.append(starts[1:], L) - 1
        ids = seg[r, starts]
        span[r] = np.repeat(np.where(ids >= 0, starts | ends << 16, -1), ends + 1 - starts)
        live = ids[ids >= 0]
        single_run &= np.unique(live).size == live.size
    return span, bool(single_run)


def build_pack_map(seg_id, *, tq: int = 128, tk: int = 128,
                   t_max: int | None = None) -> PackBlockMap:
    """Visit list from a packed segment-id layout (rows, L_pack), -1 =
    padding: a kv tile is visited iff it shares a live segment id with
    the q tile.  ``t_max`` defaults to the next power of two above the
    max live count, clamped to the kv tile count."""
    seg = np.array(seg_id, np.int32)          # the map keeps its own layout
    rows, L = seg.shape
    assert L % tq == 0 and L % tk == 0, (L, tq, tk)
    nq, nk = L // tq, L // tk
    active = np.zeros((rows, nq, nk), bool)
    qt = seg.reshape(rows, nq, tq)
    kt = seg.reshape(rows, nk, tk)
    for r in range(rows):
        ksets = [set(kt[r, j][kt[r, j] >= 0].tolist()) for j in range(nk)]
        for i in range(nq):
            live = set(qt[r, i][qt[r, i] >= 0].tolist())
            if not live:
                continue
            for j in range(nk):
                if live & ksets[j]:
                    active[r, i, j] = True

    counts = active.sum(axis=2).astype(np.int32)
    need = max(1, int(counts.max(initial=0)))
    if t_max is None:
        t_max = 1 << (need - 1).bit_length()
    t_max = min(max(t_max, need), nk) if nk else 1
    tile_ids = np.zeros((rows, nq, t_max), np.int32)
    for r in range(rows):
        for i in range(nq):
            ids = np.nonzero(active[r, i])[0].astype(np.int32)
            if ids.size:
                tile_ids[r, i, : ids.size] = ids[:t_max]
                tile_ids[r, i, ids.size:] = ids[-1]
    return PackBlockMap(tq, tk, tile_ids, counts, seg, *_segment_spans(seg))


def dense_pack_map(seg_id, *, tq: int = 128, tk: int = 128) -> PackBlockMap:
    """Every kv tile visited for every (row, q tile)."""
    seg = np.array(seg_id, np.int32)          # the map keeps its own layout
    rows, L = seg.shape
    nq, nk = L // tq, L // tk
    ids = np.broadcast_to(
        np.arange(nk, dtype=np.int32), (rows, nq, nk)
    ).copy()
    return PackBlockMap(tq, tk, ids, np.full((rows, nq), nk, np.int32), seg,
                        *_segment_spans(seg))


# ======================================================================
# plain version and kernel
# ======================================================================
def flash_packed_plain(q, k, v, seg_id, *, q_chunk: int = 1024):
    """q-chunked ``ref.flash_packed_ref`` (rows are independent)."""
    L = q.shape[1]
    outs = [
        flash_packed_ref(q[:, i:i + q_chunk], k, v, seg_id,
                         q_seg=seg_id[:, i:i + q_chunk])
        for i in range(0, L, q_chunk)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def flash_packed_cuda(q, k, v, block_map: PackBlockMap):
    """Launch the kernel: q (R, L, H, D), k, v (R, L, Hkv, D) bf16 over
    the layout ``block_map`` was built from (the kernel masks by its
    runs).  Operands the kernel does not take raise, a layout whose
    segments are not single runs as eligibility ``single-run``."""
    seg = block_map.on(q.device).seg_id      # the map's own layout stands in for seg_id
    contracts.require(contracts.flash_packed_verdict(q, k, v, seg, block_map), NAME)
    return flash_packed_launch(q, k, v, block_map)


def flash_packed_launch(q, k, v, block_map: PackBlockMap):
    """The launch alone, for operands the registry took (``ops``)."""
    R, L, H, D = q.shape
    Hkv = k.shape[2]
    bm = block_map
    dm = bm.on(q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda.require_aligned(NAME, q, k, v)
    out = torch.empty_like(q)
    rc = cuda.library().cs_attn_packed_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dm.span.data_ptr(), dm.tile_ids.data_ptr(), dm.tile_count.data_ptr(),
        R, L, H, Hkv, D, bm.t_max, float(D ** -0.5), cuda.stream_handle(q),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return out
