"""Motion search kernel: full-search block matching (codec ingest).

Replaces the TPU kernel ``repro/kernels/mv_sad.py:mv_sad_pallas``; the
CUDA source is ``csrc/mv_sad.cu``.  One thread block per 16x16
macroblock stages its reference band in shared memory with clamped
indices (no padded copy of the frame) and walks the 81 candidates in
dy-major order, keeping the first minimum under a strict '<'.

Bound on an H100: bytes (two f32 frames read once; about 30 flops per
byte).  At 448x448 a launch moves 1.6 MB, so launch latency is the
practical floor; the design makes one pass over device memory and
keeps every reread in shared memory.

``mv_sad_plain`` is the plain PyTorch version (``ref.mv_sad_ref``); the
CPU path and the card-side comparison use it.
"""
from __future__ import annotations

import torch

from . import cuda
from .ref import mv_sad_ref as mv_sad_plain

NAME = "mv_sad"

__all__ = ["NAME", "mv_sad_cuda", "mv_sad_plain"]


def mv_sad_cuda(cur: torch.Tensor, prev: torch.Tensor, block: int = 16,
                radius: int = 4):
    """Launch the kernel: cur, prev (H, W) on the card -> (mv, sad)."""
    H, W = cur.shape
    threads = block * block
    cuda.require(threads % 32 == 0 and threads <= 1024, NAME,
                 f"block {block}: block*block must be a multiple of 32, <= 1024")
    band, n_cand = block + 2 * radius, 2 * radius + 1
    smem = 4 * (band * band + n_cand * n_cand * (threads // 32))
    cuda.require(smem <= 48 * 1024, NAME, f"radius {radius} needs {smem} B of shared memory")
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
