"""RoPE shift kernel: Eq. 5 position correction of reused keys.

Replaces the TPU kernel ``repro/kernels/rope_shift.py:rope_shift_pallas``;
the CUDA source is ``csrc/rope_shift.cu``.  One thread per (token, chunk
of 16 bytes of rotation pairs: 8 in bf16, 4 in f32): it builds the
chunk's angles ``delta * theta^(-i/half)`` once in f32 with the accurate
``powf``/``sincosf`` (``|delta * freq|`` reaches hundreds of radians on
the serving path, where fast intrinsics are useless) and applies them to
every kv head of the token with 16-byte loads and stores, rounding to the
key dtype.  It takes f32 or bf16 keys whose head dim is a multiple of 16
bytes' worth of pairs (``d_h % 16 == 0`` in bf16, ``% 8`` in f32) on a
16-byte boundary, and raises otherwise; every config's ``d_head`` is 64
or 128.  Unlike the TPU kernel there is no sequence-tile eligibility
rule: any ``S`` runs.

Bound on an H100: bytes (one read and one write of the key block).

``rope_shift_plain`` is the plain PyTorch version (``ref.rope_shift_ref``).
"""
from __future__ import annotations

import torch

from . import cuda
from .ref import rope_shift_ref as rope_shift_plain

NAME = "rope_shift"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["NAME", "rope_shift_cuda", "rope_shift_plain"]


def rope_shift_cuda(k: torch.Tensor, delta: torch.Tensor,
                    theta: float = 10_000.0) -> torch.Tensor:
    """Launch the kernel: k (B, S, n_kv, d_h) f32/bf16, delta (B, S) int."""
    cuda.require(k.dtype in _DTYPES, NAME, f"dtype {k.dtype} not supported")
    B, S, n_kv, d_h = k.shape
    step = 32 // k.element_size()          # 16 bytes of each half per chunk
    cuda.require(d_h % step == 0, NAME, f"head dim {d_h} not a multiple of {step}")
    k = k.contiguous()
    cuda.require_aligned(NAME, k)
    delta = delta.to(torch.int32).contiguous()
    out = torch.empty_like(k)
    rc = cuda.library().cs_rope_shift(
        k.data_ptr(), delta.data_ptr(), out.data_ptr(), B * S, n_kv, d_h,
        float(theta), _DTYPES[k.dtype], cuda.stream_handle(k),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return out
