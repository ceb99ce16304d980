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
4) and any radius.

Bound on an H100: bytes at radius 4 (two f32 frames read once; about 30
flops per byte), the f32 CUDA cores from radius 16 on (about 400).  At
448x448 a launch moves 1.6 MB, so launch latency is the practical floor
at radius 4; the design makes one pass over device memory, keeps every
reread in shared memory (the band's rows padded so that neighbouring
candidates hit distinct banks) and leaves no serial tail.

``mv_sad_plain`` is the plain PyTorch version (``ref.mv_sad_ref``); the
CPU path and the card-side comparison use it.
"""
from __future__ import annotations

import torch

from . import contracts, cuda
from .ref import mv_sad_ref as mv_sad_plain

NAME = "mv_sad"

__all__ = ["NAME", "launch_geometry", "mv_sad_cuda", "mv_sad_launch", "mv_sad_plain"]

SMEM_LIMIT = 232448      # shared bytes an H100 block can have (227 KB), opted in
MAX_THREADS = 1024


def launch_geometry(block: int, radius: int):
    """(threads, band row stride, shared bytes) of one macroblock's block,
    as ``cs_mv_sad_f32`` computes them: the fewest candidates a thread
    (at most 1024 threads) and as few whole warps as share them evenly;
    the band's row stride padded to n_cand (mod 32); the macroblock, the
    band and one (SAD, index) pair per warp."""
    n_cand, band = 2 * radius + 1, block + 2 * radius
    n2 = n_cand * n_cand
    ldr = band + (n_cand - band) % 32
    per = -(-n2 // MAX_THREADS)
    threads = -(-(-(-n2 // per)) // 32) * 32
    return threads, ldr, 4 * (block * block + band * ldr + 2 * (threads // 32))


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
