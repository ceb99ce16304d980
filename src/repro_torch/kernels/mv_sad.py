"""Motion search kernel: full-search block matching (codec ingest).

Replaces the TPU kernel ``repro/kernels/mv_sad.py:mv_sad_pallas``; the
CUDA source is ``csrc/mv_sad.cu``.  One thread block per macroblock
stages the macroblock and its reference band in shared memory with
clamped indices (no padded copy of the frame; a band past 48 KB opts in
to dynamic shared memory, up to the card's 227 KB); each thread walks
the candidates tid, tid + threads, ... and keeps its first minimum, and
a warp reduction on (SAD, index) pairs, the smaller index winning a
tie, keeps the first minimum in dy-major order as the plain version's
strict '<' does.  Any block edge (float4 rows where it is a multiple of
4) and any radius: where the macroblock and its band pass 227 KB the
tiled kernel walks the candidates in tiles of dy x dx ranges and the
macroblock in row strips, one tile's band slice staged at a time, each
thread's candidate sums kept in registers across the strips
(``launch_geometry``'s ``tile``).

Bound on an H100: bytes at radius 4 (two f32 frames read once; about 30
flops per byte), the f32 CUDA cores from radius 16 on (about 400; at
radius 128, 66,049 candidates, about 25,000).  At
448x448 a launch moves 1.6 MB, so launch latency is the practical floor
at radius 4; the design makes one pass over device memory, keeps every
reread in shared memory (the band's rows padded so that neighbouring
candidates hit distinct banks) and leaves no serial tail.

``mv_sad_plain`` is the plain PyTorch version (``ref.mv_sad_ref``); the
CPU path and the card-side comparison use it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import contracts, cuda
from .ref import mv_sad_ref as mv_sad_plain

NAME = "mv_sad"

__all__ = ["NAME", "launch_geometry", "mv_sad_cuda", "mv_sad_launch", "mv_sad_plain"]

SMEM_LIMIT = 232448      # shared bytes an H100 block can have (227 KB), opted in
MAX_THREADS = 1024
TILE_PER = 4             # candidates a thread of the tiled kernel holds per tile


class Geometry(NamedTuple):
    """One macroblock's launch: threads, the band's (or band slice's) row
    stride, shared bytes, and ``tile`` = (ty, tx, rs) for the tiled
    kernel (tiles of ty dy rows by tx dx columns of candidates, row
    strips of rs rows of the macroblock), None for the one-band kernel."""
    threads: int
    ldr: int
    smem: int
    tile: Optional[Tuple[int, int, int]]


def launch_geometry(block: int, radius: int) -> Geometry:
    """The launch ``cs_mv_sad_f32`` makes.  Where the macroblock, its band
    and one (SAD, index) pair per warp fit ``SMEM_LIMIT``: the fewest
    candidates a thread (at most 1024 threads) and as few whole warps as
    share them evenly, the band's row stride padded to n_cand (mod 32).
    Else the tiled kernel (1024 threads, ``TILE_PER`` candidates a thread
    a tile): tx the widest dx range up to 4096 candidates whose one-row
    strip and slice fit, ty as many dy rows as a tile holds, cut to fit
    beside the whole macroblock, else row strips of rs rows beside ty rows
    (ty 1 if none fit); the slice's rows padded to tx (mod 32)."""
    n_cand, band = 2 * radius + 1, block + 2 * radius
    n2 = n_cand * n_cand
    ldr = band + (n_cand - band) % 32
    per = -(-n2 // MAX_THREADS)
    threads = -(-(-(-n2 // per)) // 32) * 32
    smem = 4 * (block * block + band * ldr + 2 * (threads // 32))
    if smem <= SMEM_LIMIT:
        return Geometry(threads, ldr, smem, None)
    cap = MAX_THREADS * TILE_PER
    avail = SMEM_LIMIT // 4 - 2 * (MAX_THREADS // 32)
    pad = (1 - block) % 32
    x_fit = avail - 2 * block - pad + 1
    if x_fit < 1:
        raise ValueError(f"mv_sad: a macroblock edge of {block} leaves no tile in shared memory")
    tx = min(n_cand, cap, x_fit)
    ldr = tx - 1 + block + pad
    ty, rs = min(cap // tx, n_cand), block
    y_fit = (avail - block * block) // ldr + 1 - block
    if y_fit >= 1:
        ty = min(ty, y_fit)
    else:
        rs = (avail - (ty - 1) * ldr) // (block + ldr)
        if rs < 1:
            ty, rs = 1, avail // (block + ldr)
    smem = 4 * (rs * block + (ty - 1 + rs) * ldr + 2 * (MAX_THREADS // 32))
    return Geometry(MAX_THREADS, ldr, smem, (ty, tx, rs))


def mv_sad_cuda(cur: torch.Tensor, prev: torch.Tensor, block: int = 16,
                radius: int = 4):
    """Launch the kernel: cur, prev (H, W) on the card -> (mv, sad).
    Operands the kernel does not take (``contracts.MV_SAD``) raise."""
    contracts.require(contracts.mv_sad_verdict(cur, prev, block, radius), NAME)
    return mv_sad_launch(cur, prev, block, radius)


def mv_sad_launch(cur: torch.Tensor, prev: torch.Tensor, block: int, radius: int):
    """The launch alone, for operands the registry took (``ops``)."""
    H, W = cur.shape
    cur = cur.to(torch.float32).contiguous()
    prev = prev.to(torch.float32).contiguous()
    mv = torch.empty((H // block, W // block, 2), dtype=torch.int32, device=cur.device)
    sad = torch.empty((H // block, W // block), dtype=torch.float32, device=cur.device)
    rc = cuda.library().cs_mv_sad_f32(
        cur.data_ptr(), prev.data_ptr(), H, W, block, radius,
        mv.data_ptr(), sad.data_ptr(), cuda.stream_handle(cur),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return mv, sad
