"""Mamba-2 SSD chunked scan: the plain version and the kernel.

``cs_ssd_scan`` (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan_pallas`` (``_ssd_kernel``).  The
Pallas grid walks the chunk axis in order and carries the (P, N) state
in VMEM; on the card one thread block per (batch row, head) loops over
the chunks itself and keeps the state in shared memory.

Both take the time axis in chunks of ``q = min(chunk, L)`` when L is not
a multiple of ``chunk`` (else ``chunk``).  The plain version pads L to a
multiple of q with identity steps (log_a = 0 keeps the state, x = b = 0
adds nothing), as the JAX package's ``ops.ssd_scan`` does; the kernel
masks the ragged last chunk instead, which is the same arithmetic.

Bound on an H100: f32 operations on the CUDA cores (the Pallas body's
math is f32); each (b, h) and chunk of q steps does about
q(q+1)(N + P) + 4qPN flops on q(P + 2N) * 2 + 4q bytes.
"""
from __future__ import annotations

import torch

from . import cuda
from .ref import ssd_chunked_scan_grouped_ref

NAME = "ssd_scan"
Q_MAX = 256           # the kernel's largest chunk (shared-memory budget)


def scan_chunk(L: int, chunk: int) -> int:
    """The chunk the scan runs with: ``chunk``, or ``min(chunk, L)``
    when L is not a multiple of it."""
    return min(chunk, L) if L % chunk else chunk


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
    features must be packed: no copy is made); log_a (B, L, H) f32 with
    packed heads; init_state (B, H, P, N) f32 must be contiguous (a view
    such as one layer of stacked caches is, and is read in place).
    Operands the kernel does not take raise ``cuda.KernelError``."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    q = scan_chunk(L, chunk)
    cuda.require(x.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
                 and c.dtype == torch.bfloat16, NAME, "x, b and c must be bf16")
    cuda.require(log_a.dtype == torch.float32, NAME, "log_a must be f32")
    cuda.require(q <= Q_MAX, NAME, f"chunk {q} > {Q_MAX}")
    cuda.require(x.stride(3) == 1 and x.stride(2) == P, NAME,
                 "x must have packed (H, P) per step")
    for t, name in ((b, "b"), (c, "c")):
        cuda.require(t.stride(3) == 1 and t.stride(2) == N, NAME,
                     f"{name} must have packed (G, N) per step")
    cuda.require(b.stride() == c.stride(), NAME, "b and c must share strides")
    cuda.require(log_a.stride(2) == 1, NAME, "log_a must have packed heads per step")
    init = init_state
    if init is not None:
        cuda.require(init.dtype == torch.float32 and tuple(init.shape) == (B, H, P, N),
                     NAME, "init_state must be f32 (B, H, P, N)")
        cuda.require(init.is_contiguous(), NAME, "init_state must be contiguous")
    y = torch.empty((B, L, H, P), dtype=torch.bfloat16, device=x.device)
    st = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    rc = cuda.library().cs_ssd_scan(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        0 if init is None else init.data_ptr(), y.data_ptr(), st.data_ptr(),
        B, L, H, P, G, N, q,
        x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1),
        b.stride(0), b.stride(1), cuda.stream_handle(x),
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
