"""Mamba-2 SSD chunked scan: the plain version and the kernel.

``cs_ssd_scan`` (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan_pallas`` (``_ssd_kernel``).  The
Pallas grid walks the chunk axis in order and carries the (P, N) state
in VMEM; on the card a thread block loops over the chunks itself and
owns ``SLICE`` rows p of one (batch row, head)'s state, which stays on
chip throughout (grid: P slices x heads x batch rows).

Both take the time axis in chunks of ``q = min(chunk, L)`` when L is not
a multiple of ``chunk`` (else ``chunk``).  The plain version pads L to a
multiple of q with identity steps (log_a = 0 keeps the state, x = b = 0
adds nothing), as the JAX package's ``ops.ssd_scan`` does; the kernel
masks the ragged last chunk instead, which is the same arithmetic.

Bound on an H100: bytes.  The kernel runs every product on the tensor
cores (``mma.sync`` bf16 -> f32; the f32 operands M = (C B^T) o decay,
the state and w o B enter as bf16 hi + lo, about 16 bits), so the f32
state's read and write and the x/b/c/y rows take longer than the
function's flops at 989 TFLOP/s; ``ssd_scan_work`` counts both.
"""
from __future__ import annotations

import torch

from . import contracts, cuda
from .ref import ssd_chunked_scan_grouped_ref

NAME = "ssd_scan"
Q_MAX = 256           # the kernel's largest chunk (one scan step per thread)
SLICE = 32            # state rows p per thread block
THREADS = 256
STATE_WIDTHS = (16, 64, 128)   # the N the kernel is built for (jamba, mamba2)
SMEM_LIMIT = 232_448  # shared bytes one block may use on an H100 (227 KB)


def scan_chunk(L: int, chunk: int) -> int:
    """The chunk the scan runs with: ``chunk``, or ``min(chunk, L)``
    when L is not a multiple of it."""
    return min(chunk, L) if L % chunk else chunk


def launch_geometry(B: int, H: int, P: int, N: int, q: int):
    """(grid, threads, shared bytes) of the kernel for chunk q, as
    ``csrc/ssd_scan.cu`` lays them out (``SsdSmem``): rows = q rounded up
    to 16; B rows (rows x N bf16, sharing their bytes with the f32 state
    slice), the x slice (rows x SLICE bf16), the state's bf16 hi and lo
    halves, cum and the scan partials; row strides padded by 16 bytes."""
    rows = -(-q // 16) * 16
    ld = N + 8
    smem = (max(2 * rows * ld, 4 * SLICE * ld) + 2 * rows * (SLICE + 8)
            + 2 * 2 * SLICE * ld + 4 * rows + 4 * (THREADS // 32))
    return (-(-P // SLICE), H, B), THREADS, smem


def ssd_scan_plain(x, log_a, b, c, init_state=None, chunk: int = 128):
    """x (B, L, H, P); log_a (B, L, H); b, c (B, L, G, N) per group;
    init_state (B, H, P, N) or None.  Returns y (B, L, H, P) in x's
    dtype and the final state (B, H, P, N) f32."""
    L = x.shape[1]
    q = scan_chunk(L, chunk)
    pad = (-L) % q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    y, st = ssd_chunked_scan_grouped_ref(x, log_a, b, c, q, init_state)
    return y[:, :L], st


def ssd_scan_cuda(x, log_a, b, c, init_state=None, chunk: int = 128):
    """Launch the kernel.  x (B, L, H, P) bf16 and b, c (B, L, G, N) bf16
    are read through their batch and time strides (heads, groups and
    features must be packed, rows on 16-byte boundaries: no copy is
    made); P a multiple of 8, N one of ``STATE_WIDTHS``; log_a (B, L, H)
    f32 with packed heads; init_state (B, H, P, N) f32 must be contiguous
    (a view such as one layer of stacked caches is, and is read in
    place).  Operands the kernel does not take (``contracts.SSD_SCAN``)
    raise ``KernelIneligibleError``, a ``cuda.KernelError``."""
    contracts.require(contracts.ssd_scan_verdict(x, log_a, b, c, init_state, chunk), NAME)
    return ssd_scan_launch(x, log_a, b, c, init_state, chunk)


def ssd_scan_launch(x, log_a, b, c, init, chunk: int):
    """The launch alone, for operands the registry took (``ops``)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    q = scan_chunk(L, chunk)
    xs, bs, las = x.stride(), b.stride(), log_a.stride()
    y = torch.empty((B, L, H, P), dtype=torch.bfloat16, device=x.device)
    st = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    rc = cuda.library().cs_ssd_scan(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        0 if init is None else init.data_ptr(), y.data_ptr(), st.data_ptr(),
        B, L, H, P, G, N, q, xs[0], xs[1], las[0], las[1], bs[0], bs[1],
        cuda.stream_handle(x),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return y, st


def ssd_scan_work(L: int, H: int, P: int, G: int, N: int, chunk: int, B: int = 1):
    """(flops, bytes) the scan needs: for each (b, h) and chunk of q
    steps, 2 flops per (t, s <= t) pair and feature of c.b and of the
    decayed mix of x, and 4qPN for the state's read-out and update;
    x, log_a, b, c and init read once, y and the state written once."""
    q = scan_chunk(L, chunk)
    flops = 0.0
    for t0 in range(0, L, q):
        n = min(q, L - t0)
        flops += n * (n + 1) * (N + P) + 4.0 * n * P * N
    flops *= B * H
    n_bytes = B * L * (H * P * 2 * 2 + H * 4 + 2 * G * N * 2) + 2 * B * H * P * N * 4
    return flops, n_bytes
