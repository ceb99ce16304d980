"""RoPE shift kernel: Eq. 5 position correction of reused keys.

Replaces the TPU kernel ``repro/kernels/rope_shift.py:rope_shift_pallas``;
the CUDA source is ``csrc/rope_shift.cu``.  One thread per (token, chunk
of rotation pairs: 16 bytes of each half, 8 pairs in bf16 or f16 and 4 in
f32, where half the head dim holds a whole number of them; else 8, 4 or,
in bf16 and f16, 2 bytes, down to one pair at an odd half, as at D 90): it builds
the chunk's angles ``delta * theta^(-i/half)`` once in f32, from the
plain version's own inverse frequencies (``ref.rope_freqs``, made once
per head dim, theta and card), with the accurate ``sincosf``
(``|delta * freq|`` reaches hundreds of radians on the serving path,
where fast intrinsics are useless) and
applies them to every kv head of the token with one load and one store
per half, rounding to the key dtype.  It takes f32, bf16 or f16 keys of
any even head dim (the reference's ``even-head``) on a 16-byte boundary
(``contracts.ROPE_SHIFT``), and raises otherwise.  Unlike the TPU kernel
there is no sequence-tile eligibility rule: any ``S`` runs.

Bound on an H100: bytes (one read and one write of the key block).

``rope_shift_plain`` is the plain PyTorch version (``ref.rope_shift_ref``).
"""
from __future__ import annotations

import torch

from . import contracts, cuda
from .ref import rope_freqs
from .ref import rope_shift_ref as rope_shift_plain

NAME = "rope_shift"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the plain version's inverse frequencies per (half, theta, card)
_FREQS: dict = {}

__all__ = ["NAME", "rope_shift_cuda", "rope_shift_launch", "rope_shift_plain"]


def rope_shift_cuda(k: torch.Tensor, delta: torch.Tensor,
                    theta: float = 10_000.0) -> torch.Tensor:
    """Launch the kernel: k (B, S, n_kv, d_h) f32/bf16/f16, delta (B, S) int.
    Operands the kernel does not take raise."""
    contracts.require(contracts.rope_shift_verdict(k, delta), NAME)
    return rope_shift_launch(k, delta, theta)


def rope_shift_launch(k: torch.Tensor, delta: torch.Tensor, theta: float) -> torch.Tensor:
    """The launch alone, for operands the registry took (``ops``)."""
    B, S, n_kv, d_h = k.shape
    k = k.contiguous()
    cuda.require_aligned(NAME, k)
    delta = delta.to(torch.int32).contiguous()
    out = torch.empty_like(k)
    key = (d_h // 2, float(theta), k.device)
    if key not in _FREQS:
        _FREQS[key] = rope_freqs(d_h // 2, float(theta), k.device)
    rc = cuda.library().cs_rope_shift(
        k.data_ptr(), delta.data_ptr(), out.data_ptr(), B * S, n_kv, d_h,
        _FREQS[key].data_ptr(), _DTYPES[k.dtype], cuda.stream_handle(k),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return out
