"""Dense causal / sliding-window prefill attention: plain versions and
the kernels.

Three kernels of ``csrc/attention.cu`` (problem structs ``Prefill``,
``PrefillPaged``, ``PrefillPagedQuant`` on the register body
``mma_kernel`` that the refresh kernels use):

  * ``cs_attn_prefill_bf16`` replaces the TPU kernel
    ``repro/kernels/flash_prefill.py:flash_prefill_pallas``
    (``_flash_kernel``): q (B, Sq, H, D) against k, v (B, Sk, Hkv, D);
  * ``cs_attn_prefill_paged_bf16`` replaces ``flash_prefill_paged_pallas``
    (its bf16 body ``_flash_paged_kernel``): the same against the
    batchless slab (P_phys, Hkv, D) through a page table, causal;
  * ``cs_attn_prefill_paged_int8`` replaces that function's int8 body
    (``_flash_paged_quant_kernel``): page-table entries ``>= n_hot`` name
    int8 cold pages, dequantised as ``refresh``'s int8 kernel does.

The mask is positional: query row i sits at ``i + q_offset``, key j at
``j``; causal keeps keys ``<=`` the query's position, ``window`` keys
``>`` position - window.  Each thread block derives the key tiles its
query tile can reach from that band (no host visit list), and any Sq or
Sk is taken: the ragged edges are masked in the kernel.  A row with no
visible key returns the mean of V over all keys, as the oracle's finite
-1e30 mask and softmax give it.

Bound on an H100: tensor-core operations at long prefills (4 D H flops
per live (query, key) pair), bytes at short ones.

The plain versions (``ref.flash_prefill_ref`` chunked over queries,
after ``ref.paged_gather`` where the KV is paged) keep f32 throughout, as
the Pallas body does, and so do the kernels: the scale multiplies the
f32 scores, and P V is accumulated from P split into two bf16 halves
(about 16 bits of P).  Only the output's rounding to bf16 differs: one
bf16 step of the row's largest value.  Operands: bf16 or f16 K/V under a
query of any float type (read in its own type; the output is in it): q in
K's type as is, an f32 or f16 q over bf16 K/V as two bf16 halves (the
``_q32`` builds), a bf16 or f32 q over f16 K/V as two f16 halves of each
row scaled by a power of two (the ``_q16`` builds); f16 K/V take P as two
f16 halves; and, for the dense kernel, f32 K/V under any q
(``cs_attn_prefill_f32``: K and V split into bf16 halves in a scratch
buffer the wrapper allocates), at any head dim
(past 256 on the D-512 build: a 256-column slab of V and O a block; past
512 on the DEEP build: 128-column slabs, Q K^T summed over depth chunks
of 256).
"""
from __future__ import annotations

import torch

from . import contracts, cuda
from .ref import flash_prefill_ref, paged_gather

NAME = "flash_prefill"
NAME_PAGED = "flash_prefill_paged"
NAME_INT8 = "flash_prefill_paged_int8"


def flash_prefill_plain(q, k, v, *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0, q_chunk: int = 1024):
    """q-chunked ``ref.flash_prefill_ref`` (rows are independent)."""
    Sq = q.shape[1]
    outs = [
        flash_prefill_ref(q[:, i:i + q_chunk], k, v, causal=causal, window=window,
                          q_offset=q_offset + i)
        for i in range(0, Sq, q_chunk)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def flash_prefill_paged_plain(q, k, v, page_table, *, page: int = 128,
                              causal: bool = True, window: int | None = None,
                              q_offset: int = 0, cold=None, q_chunk: int = 1024):
    """Gather the logical K/V view once (through the int8 ``cold`` group
    where given), then ``flash_prefill_plain``."""
    kg, vg = paged_gather(k, v, page_table, page, cold)
    return flash_prefill_plain(q, kg, vg, causal=causal, window=window,
                               q_offset=q_offset, q_chunk=q_chunk)


def flash_prefill_cuda(q, k, v, *, causal: bool = True, window: int | None = None,
                       q_offset: int = 0):
    """Launch the dense kernel: q (B, Sq, H, D) of any float type; k, v
    (B, Sk, Hkv, D) bf16, f16 or f32, contiguous; any Sq and Sk; the
    output in q's type.  Operands the kernel does not take
    (``contracts.FLASH_PREFILL``) raise."""
    contracts.require(contracts.flash_prefill_verdict(
        q, k, v, causal=causal, window=window, q_offset=q_offset), NAME)
    return flash_prefill_launch(q, k, v, causal=causal, window=window, q_offset=q_offset)


def flash_prefill_launch(q, k, v, *, causal: bool, window: int | None, q_offset: int):
    """The launch alone, for operands the registry took (``ops``)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, Hkv, D,
            int(q_offset), int(causal), -1 if window is None else int(window),
            float(D ** -0.5))
    if k.dtype == torch.float32:     # K's and V's bf16 halves, written by the kernel
        rc = cuda.f32_kv_launch(cuda.library().cs_attn_prefill_f32, q, k, *args)
    else:
        rc = cuda.attention_entry("cs_attn_prefill_bf16", q, k, D)(*args, cuda.stream_handle(q))
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return out


def flash_prefill_paged_cuda(q, k, v, page_table, *, page: int = 128,
                             window: int | None = None, q_offset: int = 0, cold=None):
    """Launch the paged kernel (causal), the int8 one when ``cold = (k8,
    v8, k_scale, v_scale)`` is given.  q (B, Sq, H, D) of any float type,
    any Sq; k, v (P_phys, Hkv, D) bf16 or f16 (hot) slab; page_table (B, n_pages) int; k8, v8
    (n_cold * page, Hkv, D) int8; k_scale, v_scale (n_cold, Hkv) f32; all
    contiguous.  Operands the kernel does not take raise."""
    contracts.require(contracts.flash_prefill_paged_verdict(
        q, k, v, page_table, page=page, causal=True, window=window, q_offset=q_offset,
        cold=cold), NAME_PAGED, NAME_PAGED if cold is None else NAME_INT8)
    return flash_prefill_paged_launch(q, k, v, page_table, page=page, window=window,
                                      q_offset=q_offset, cold=cold)


def flash_prefill_paged_launch(q, k, v, page_table, *, page: int, window: int | None,
                               q_offset: int, cold):
    """The launch alone, for operands the registry took (``ops``)."""
    name = NAME_PAGED if cold is None else NAME_INT8
    B, Sq, H, D = q.shape
    P_phys, Hkv, _ = k.shape
    n_pages = page_table.shape[1]
    pt = page_table.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), pt.data_ptr())
    shape = (B, Sq, H, Hkv, D, n_pages, int(q_offset),
             -1 if window is None else int(window), float(D ** -0.5),
             cuda.stream_handle(q))
    if cold is None:
        rc = cuda.attention_entry("cs_attn_prefill_paged_bf16", q, k, D)(*common, *shape)
    else:
        k8, v8, k_scale, v_scale = cold
        rc = cuda.attention_entry("cs_attn_prefill_paged_int8", q, k, D)(
            *common, k8.data_ptr(), v8.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), P_phys // page, *shape)
    cuda.check(rc, name)
    cuda.record_launch(name)
    return out
