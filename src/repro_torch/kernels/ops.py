"""Dispatch for the kernels of the serving path.

Every op checks its preconditions (a violation raises
:class:`KernelContractError`: neither path could give a meaningful
answer), then routes by where its operands live:

  * a CPU tensor runs the plain PyTorch version;
  * a CUDA tensor launches the hand-written kernel, or raises when the
    kernel does not take the operands (``KernelContractError`` for a
    precondition of the kernel alone: ``flash_packed``'s single runs).
    There is no silent fallback.  No kernel has a backward, so under
    grad mode a CUDA operand that requires grad raises
    ``KernelContractError`` rather than being detached (the plain
    versions, on the CPU or under ``kernel_mode("plain")``, differentiate).

  * a meta tensor (the dry run) gives outputs of the right shapes and
    dtypes and computes nothing.

``kernel_mode("plain")`` forces the plain version on the card too; only
tests and ``chip_smoke.py`` use it, to hold the kernels against it.

``count_work(counter)`` reports each call of ``flash_refresh`` and
``ssd_scan`` to ``counter.kernel(op, formula)`` (``formula()`` gives the
op's (flops, bytes)), and runs the call inside the context manager that
returns, so that a counter of aten ops (``analysis.roofline.count_step``)
does not also count the plain version's step-by-step arithmetic.

``dispatch_counts()`` records where each call went, per kernel name:
``kernel``, ``backend:ok`` (CPU tensor, plain version), ``mode:plain``
(plain version forced on the card) or ``meta`` (shapes only).  ``launch_counts()`` counts the
kernel launches themselves.  ``flash_refresh_paged`` and
``flash_prefill_paged`` with an int8 ``cold`` group are counted as
``flash_refresh_paged_int8`` and ``flash_prefill_paged_int8``.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from . import cuda
from .cuda import KernelContractError
from .flash_packed import PackBlockMap, flash_packed_cuda, flash_packed_plain
from .flash_prefill import (
    flash_prefill_cuda, flash_prefill_paged_cuda, flash_prefill_paged_plain,
    flash_prefill_plain,
)
from .flash_refresh import (
    RefreshBlockMap, flash_refresh_cuda, flash_refresh_paged_cuda,
    flash_refresh_paged_plain, flash_refresh_plain, flash_refresh_work,
)
from .mv_sad import mv_sad_cuda, mv_sad_plain
from .rope_shift import rope_shift_cuda, rope_shift_plain
from .ssd_scan import ssd_scan_cuda, ssd_scan_plain, ssd_scan_work
from .transfer import host_of

KERNELS = ("mv_sad", "rope_shift", "flash_refresh_paged", "flash_packed",
           "flash_refresh", "flash_refresh_paged_int8", "ssd_scan",
           "flash_prefill", "flash_prefill_paged", "flash_prefill_paged_int8")
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

_MODE = "auto"   # auto | plain
_COUNTS: "defaultdict[str, Counter]" = defaultdict(Counter)
_WORK: list = []   # active work counters, innermost last

launch_counts = cuda.launch_counts
reset_launch_counts = cuda.reset_launch_counts


def set_kernel_mode(mode: str) -> None:
    global _MODE
    if mode not in ("auto", "plain"):
        raise ValueError(f"kernel mode {mode!r}")
    _MODE = mode


@contextmanager
def kernel_mode(mode: str):
    prev = _MODE
    set_kernel_mode(mode)
    try:
        yield
    finally:
        set_kernel_mode(prev)


def dispatch_counts() -> Dict[str, Dict[str, int]]:
    """Snapshot of per-op dispatch decisions."""
    return {op: dict(c) for op, c in _COUNTS.items()}


def reset_dispatch_counts() -> None:
    _COUNTS.clear()


def plain_calls_on_cuda() -> Dict[str, int]:
    """Plain-version calls on CUDA tensors per op (``kernel_mode("plain")``)."""
    return {op: c.get("mode:plain", 0) for op, c in _COUNTS.items()}


@contextmanager
def count_work(counter):
    """While active, kernel ops report their work to ``counter``."""
    _WORK.append(counter)
    try:
        yield counter
    finally:
        _WORK.remove(counter)


def _work(op: str, formula):
    """The call's work (``formula`` -> (flops, bytes)) reported to the
    innermost counter; the call runs inside the context manager returned
    (nothing to do without a counter)."""
    return _WORK[-1].kernel(op, formula) if _WORK else nullcontext()


def _on_meta(op: str, t: torch.Tensor) -> bool:
    """Whether ``t`` is a meta tensor (shapes only: no kernel, no plain
    version)."""
    if t.device.type != "meta":
        return False
    _COUNTS[op]["meta"] += 1
    return True


def _use_kernel(op: str, t: torch.Tensor, *operands) -> bool:
    """Whether ``op`` launches its kernel: ``t`` decides the device; the
    kernel path raises when grad mode is on and ``t`` or any tensor of
    ``operands`` requires grad (the kernel's output would carry no
    gradient)."""
    if t.device.type == "cpu":
        _COUNTS[op]["backend:ok"] += 1
        return False
    if t.device.type != "cuda":
        raise KernelContractError(f"{op}: no kernel for device {t.device}")
    if _MODE == "plain":
        _COUNTS[op]["mode:plain"] += 1
        return False
    if torch.is_grad_enabled() and any(
            torch.is_tensor(o) and o.requires_grad for o in (t,) + operands):
        raise KernelContractError(
            f"{op}: an operand requires grad and the op has no backward kernel; "
            f"call it under torch.no_grad() or on detached tensors")
    _COUNTS[op]["kernel"] += 1
    return True


def _require(cond: bool, op: str, code: str, what: str) -> None:
    if not cond:
        raise KernelContractError(f"{op}: precondition '{code}' violated ({what})")


def _attn_dtypes(op: str, q, k, v) -> None:
    _require(q.dtype in _FLOATS and k.dtype in _FLOATS and k.dtype == v.dtype,
             op, "dtype", "q/k/v are f32/bf16/f16 with k == v")


# the last (q_pos tensor, its version, map) found equal; holding the
# tensor keeps its storage from being reused by another
_MATCHED: list = [None]


def _positions_match_map(op: str, q_pos: torch.Tensor, bm: RefreshBlockMap) -> None:
    """The kernel masks by the map's query positions, the plain version
    by ``q_pos``: they must be equal on every device.  The comparison
    runs on ``q_pos``'s host twin where it has one; on the card a device
    comparison syncs, so it runs once per positions tensor and map (the
    layers of one pass share both)."""
    hit = _MATCHED[0]
    if hit is not None and hit[0] is q_pos and hit[1] == q_pos._version and hit[2] is bm:
        return
    host = host_of(q_pos)
    same = q_pos.shape[1] == bm.n_q and (
        bool((host == bm.q_pos[: bm.n_q]).all()) if host is not None
        else bool((q_pos == bm.on(q_pos.device).q_pos[: bm.n_q]).all()))
    _require(same, op, "positions-match", "q_pos equals the block map's query positions")
    _MATCHED[0] = (q_pos, q_pos._version, bm)


# the last (seg_id tensor, its version, map) found equal
_SEG_MATCHED: list = [None]


def _segments_match_map(op: str, seg_id: torch.Tensor, bm: PackBlockMap) -> None:
    """The kernel masks by the map's layout, the plain version by
    ``seg_id``: they must be equal on every device.  The comparison runs
    on ``seg_id``'s host twin where it has one; on the card a device
    comparison syncs, so it runs once per layout tensor and map (the ViT
    layers of one packing share both)."""
    hit = _SEG_MATCHED[0]
    if hit is not None and hit[0] is seg_id and hit[1] == seg_id._version and hit[2] is bm:
        return
    host = host_of(seg_id)
    same = tuple(seg_id.shape) == bm.seg_id.shape and (
        np.array_equal(host, bm.seg_id) if host is not None
        else bool((seg_id == bm.on(seg_id.device).seg_id).all()))
    _require(same, op, "segments-match", "seg_id equals the block map's layout")
    _SEG_MATCHED[0] = (seg_id, seg_id._version, bm)


# the last (page table, its version, page count) found in range
_IN_RANGE: list = [None]


def _page_ids_in_range(op: str, page_table: torch.Tensor, n_pages: int) -> None:
    """Every entry addresses a hot or a cold page: the plain gather would
    clamp or fail, the kernel read past the slab.  The check runs on the
    table's host twin where it has one; on the card a device check syncs,
    so it runs once per table (the layers of one pass share it)."""
    hit = _IN_RANGE[0]
    if (hit is not None and hit[0] is page_table and hit[1] == page_table._version
            and hit[2] == n_pages):
        return
    host = host_of(page_table)
    table = page_table if host is None else host
    _require(bool(((table >= 0) & (table < n_pages)).all()), op, "page-range",
             f"page ids lie in [0, {n_pages}): hot pages, then cold ones")
    _IN_RANGE[0] = (page_table, page_table._version, n_pages)


def _cold_group(op: str, k, page: int, cold) -> None:
    """An int8 cold group ``(k8, v8, k_scale, v_scale)`` beside the slab k."""
    if cold is None:
        return
    k8, v8, k_scale, v_scale = cold
    _require(k8.shape == v8.shape and k8.dim() == 3
             and tuple(k8.shape[1:]) == tuple(k.shape[1:])
             and k8.shape[0] % page == 0, op, "cold-shape",
             "cold slabs are (n_cold * page, Hkv, D) like the hot slab")
    _require(k8.dtype == torch.int8 and v8.dtype == torch.int8, op,
             "cold-dtype", "cold slabs are int8")
    _require(tuple(k_scale.shape) == (k8.shape[0] // page, k.shape[1])
             and k_scale.shape == v_scale.shape, op, "cold-scale",
             "scales are (n_cold, Hkv)")


# ----------------------------------------------------------------------
def mv_sad(cur, prev, block: int = 16, radius: int = 4):
    """Block-matching motion search (see ``ref.mv_sad_ref``)."""
    op = "mv_sad"
    _require(cur.dim() == 2 and prev.dim() == 2, op, "rank",
             "cur and prev are 2-D (H, W) luma planes")
    _require(cur.shape == prev.shape, op, "shape-match",
             "cur and prev have identical shapes")
    _require(cur.shape[0] % block == 0 and cur.shape[1] % block == 0, op,
             "block-divisibility", "H and W are multiples of the block edge")
    _require(not cur.is_complex() and not prev.is_complex()
             and cur.dtype != torch.bool, op, "dtype", "frames are real numeric")
    _require(radius >= 1, op, "radius", "search radius >= 1")
    if _use_kernel(op, cur, prev):
        return mv_sad_cuda(cur, prev, block, radius)
    return mv_sad_plain(cur, prev, block, radius)


def rope_shift(k, delta, theta: float = 10_000.0):
    """Rotate cached keys by per-token position deltas (Eq. 5)."""
    op = "rope_shift"
    _require(k.dim() == 4 and delta.dim() == 2, op, "rank",
             "k is (B, S, n_kv, d_h) and delta is (B, S)")
    _require(tuple(delta.shape) == tuple(k.shape[:2]), op, "delta-shape",
             "delta matches k's (B, S) prefix")
    _require(not delta.is_floating_point() and delta.dtype != torch.bool, op,
             "delta-dtype", "delta is an integer position shift")
    _require(k.dtype in _FLOATS, op, "k-dtype", "k is f32/bf16/f16")
    _require(k.shape[3] % 2 == 0, op, "even-head", "head dim is even")
    if _use_kernel(op, k):
        return rope_shift_cuda(k, delta, theta)
    return rope_shift_plain(k, delta, theta)


def flash_refresh(q, k, v, q_pos, kv_valid=None, *, causal: bool = True,
                  window: Optional[int] = None,
                  block_map: Optional[RefreshBlockMap] = None,
                  q_chunk: int = 1024):
    """Refresh attention over per-stream caches: q (B, Sq, H, D) against
    k, v (B, Sk, Hkv, D) whose key positions are ``arange(Sk)``; q_pos
    (B, Sq) positions; kv_valid (B, Sk) bool or None (all valid).  On the
    card the kernel needs the ``block_map``; a map given on any device
    must be built for exactly these query positions."""
    op = "flash_refresh"
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4 and q_pos.dim() == 2,
             op, "rank", "q/k/v rank-4, q_pos rank-2")
    _require(k.shape == v.shape, op, "kv-shape", "k and v caches match")
    _require(tuple(q_pos.shape) == tuple(q.shape[:2]), op, "q-pos-shape",
             "q_pos is (B, Sq)")
    _require(k.shape[0] == q.shape[0], op, "batch", "caches lead with q's batch dim")
    _require(q.shape[3] == k.shape[3], op, "head-dim", "q and caches share d_head")
    _require(q.shape[2] % k.shape[2] == 0, op, "gqa",
             "query heads divide evenly over kv heads")
    _attn_dtypes(op, q, k, v)
    _require(not q_pos.is_floating_point(), op, "q-pos-dtype", "integer positions")
    _require(kv_valid is None or (tuple(kv_valid.shape) == tuple(k.shape[:2])
                                  and kv_valid.dtype == torch.bool),
             op, "kv-valid", "kv_valid is a (B, Sk) bool mask")
    if q.device.type != "meta" and block_map is not None:
        _positions_match_map(op, q_pos, block_map)
    with _work(op, lambda: flash_refresh_work(q, k, q_pos, kv_valid, causal=causal,
                                              window=window)):
        if _on_meta(op, q):
            return torch.empty_like(q)
        if _use_kernel(op, q, k, v):
            if block_map is None:
                raise KernelContractError(f"{op}: the kernel needs a RefreshBlockMap")
            if kv_valid is None:
                kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
            return flash_refresh_cuda(q, k, v, kv_valid, block_map, causal=causal,
                                      window=window)
        return flash_refresh_plain(q, k, v, q_pos, kv_valid, causal=causal,
                                   window=window, q_chunk=q_chunk)


def flash_refresh_paged(q, k, v, q_pos, kv_valid, page_table, *,
                        page: int = 128, causal: bool = True,
                        window: Optional[int] = None,
                        block_map: Optional[RefreshBlockMap] = None,
                        q_chunk: int = 1024, cold=None):
    """Paged refresh attention: q (B, Sq, H, D) against the shared slab
    k, v (P_phys, Hkv, D) through page_table (B, n_pages); q_pos (B, Sq)
    logical positions; kv_valid (B, n_pages * page) bool (mandatory:
    recycled pages hold stale KV).  ``cold = (k8, v8, k_scale, v_scale)``
    is the int8 cold slab: entries ``>= P_phys // page`` address its
    pages.  On the card the kernel needs the ``block_map``; a map given
    on any device must be built for exactly these query positions."""
    op = "flash_refresh_paged" if cold is None else "flash_refresh_paged_int8"
    _require(q.dim() == 4 and k.dim() == 3 and v.dim() == 3
             and q_pos.dim() == 2 and page_table.dim() == 2, op, "rank",
             "q rank-4, slab k/v rank-3, q_pos rank-2, page_table rank-2")
    _require(k.shape == v.shape, op, "kv-shape", "k and v slabs match")
    _require(tuple(q_pos.shape) == tuple(q.shape[:2]), op, "q-pos-shape",
             "q_pos is (B, Sq)")
    _require(page_table.shape[0] == q.shape[0], op, "pt-batch",
             "page_table leads with q's batch dim")
    _require(q.shape[3] == k.shape[2], op, "head-dim", "q and slab share d_head")
    _require(q.shape[2] % k.shape[1] == 0, op, "gqa",
             "query heads divide evenly over kv heads")
    _attn_dtypes(op, q, k, v)
    _require(not q_pos.is_floating_point(), op, "q-pos-dtype", "integer positions")
    _require(not page_table.is_floating_point(), op, "pt-dtype", "integer page ids")
    _require(page >= 1 and k.shape[0] % page == 0, op, "slab-align",
             "slab rows divide by the page size")
    _require(tuple(kv_valid.shape) == (q.shape[0], page_table.shape[1] * page)
             and kv_valid.dtype == torch.bool, op, "kv-valid",
             "kv_valid is a (B, n_pages * page) bool mask")
    _cold_group(op, k, page, cold)
    n_cold = 0 if cold is None else cold[0].shape[0] // page
    _page_ids_in_range(op, page_table, k.shape[0] // page + n_cold)
    if block_map is not None:
        _positions_match_map(op, q_pos, block_map)
    if _use_kernel(op, q, k, v, *(cold or ())):
        if block_map is None:
            raise KernelContractError(f"{op}: the kernel needs a RefreshBlockMap")
        return flash_refresh_paged_cuda(
            q, k, v, kv_valid, page_table, block_map, page=page,
            causal=causal, window=window, cold=cold)
    return flash_refresh_paged_plain(
        q, k, v, q_pos, kv_valid, page_table, page=page, causal=causal,
        window=window, q_chunk=q_chunk, cold=cold)


def flash_packed(q, k, v, seg_id, block_map: Optional[PackBlockMap] = None,
                 *, q_chunk: int = 1024):
    """Block-diagonal attention over packed ViT rows: q (R, L, H, D);
    k, v (R, L, Hkv, D); seg_id (R, L) int with -1 padding.  On the card
    the kernel needs the packing's ``block_map``, whose segments must be
    single runs; a map given on any device must be built from exactly
    this layout."""
    op = "flash_packed"
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4
             and seg_id.dim() == 2, op, "rank", "q/k/v rank-4, seg_id rank-2")
    _require(k.shape == v.shape, op, "kv-shape", "k and v match")
    _require(tuple(seg_id.shape) == tuple(q.shape[:2]), op, "seg-shape",
             "seg_id is (R, L)")
    _require(q.shape[0] == k.shape[0], op, "rows", "q and k share rows")
    _require(q.shape[2] % k.shape[2] == 0, op, "gqa",
             "query heads divide evenly over kv heads")
    _attn_dtypes(op, q, k, v)
    _require(not seg_id.is_floating_point(), op, "seg-dtype", "integer segments")
    if block_map is not None:
        _segments_match_map(op, seg_id, block_map)
    if _use_kernel(op, q, k, v):
        if block_map is None:
            raise KernelContractError(f"{op}: the kernel needs a PackBlockMap")
        return flash_packed_cuda(q, k, v, block_map)
    return flash_packed_plain(q, k, v, seg_id, q_chunk=q_chunk)


def flash_prefill(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, q_chunk: int = 1024):
    """Dense GQA attention: q (B, Sq, H, D) at positions ``q_offset +
    arange(Sq)`` against k, v (B, Sk, Hkv, D) at ``arange(Sk)``, causal
    and/or a sliding window.  Any Sq and Sk: the kernel masks the ragged
    edges (the JAX package sends such geometries to its oracle)."""
    op = "flash_prefill"
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, op, "rank",
             "q/k/v are rank-4 (B, S, H, D)")
    _require(k.shape == v.shape, op, "kv-shape", "k and v have identical shapes")
    _require(q.shape[0] == k.shape[0], op, "batch", "q and k share the batch dim")
    _require(q.shape[3] == k.shape[3], op, "head-dim", "q and k share the head dim")
    _require(q.shape[2] % k.shape[2] == 0, op, "gqa",
             "query heads divide evenly over kv heads")
    _attn_dtypes(op, q, k, v)
    _require(window is None or window >= 1, op, "window",
             "sliding window is None or >= 1")
    if _use_kernel(op, q, k, v):
        return flash_prefill_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_prefill_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, q_chunk=q_chunk)


def flash_prefill_paged(q, k, v, page_table, *, page: int = 128, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0, cold=None,
                        q_chunk: int = 1024):
    """Paged ``flash_prefill``: q (B, Sq, H, D) against the shared slab
    k, v (P_phys, Hkv, D) through page_table (B, n_pages); the logical
    keys are ``arange(n_pages * page)``.  Causal only: the mask is what
    hides stale rows of recycled pages.  ``cold = (k8, v8, k_scale,
    v_scale)`` is the int8 cold group (entries ``>= P_phys // page``)."""
    op = "flash_prefill_paged" if cold is None else "flash_prefill_paged_int8"
    _require(q.dim() == 4 and k.dim() == 3 and v.dim() == 3 and page_table.dim() == 2,
             op, "rank", "q rank-4, slab k/v rank-3, page_table rank-2")
    _require(k.shape == v.shape, op, "kv-shape", "k and v slabs match")
    _require(page_table.shape[0] == q.shape[0], op, "pt-batch",
             "page_table leads with q's batch dim")
    _require(q.shape[3] == k.shape[2], op, "head-dim", "q and the slab share d_head")
    _require(q.shape[2] % k.shape[1] == 0, op, "gqa",
             "query heads divide evenly over kv heads")
    _attn_dtypes(op, q, k, v)
    _require(not page_table.is_floating_point() and page_table.dtype != torch.bool,
             op, "pt-dtype", "integer page ids")
    _require(page >= 1 and k.shape[0] % page == 0, op, "slab-align",
             "slab rows divide by the page size")
    _require(causal, op, "causal", "causal masking is mandatory: it hides stale "
             "rows of recycled pages")
    _require(window is None or window >= 1, op, "window",
             "sliding window is None or >= 1")
    _cold_group(op, k, page, cold)
    n_cold = 0 if cold is None else cold[0].shape[0] // page
    _page_ids_in_range(op, page_table, k.shape[0] // page + n_cold)
    if _use_kernel(op, q, k, v, *(cold or ())):
        return flash_prefill_paged_cuda(q, k, v, page_table, page=page, window=window,
                                        q_offset=q_offset, cold=cold)
    return flash_prefill_paged_plain(q, k, v, page_table, page=page, causal=causal,
                                     window=window, q_offset=q_offset, cold=cold,
                                     q_chunk=q_chunk)


def ssd_scan(x, log_a, b, c, init_state=None, chunk: int = 128):
    """Mamba-2 chunked SSD: x (B, L, H, P); log_a (B, L, H); b, c (B, L,
    G, N) per group; init_state (B, H, P, N) or None.  Any L: the time
    axis runs in chunks of ``min(chunk, L)`` when L is not a multiple of
    ``chunk``, the last one ragged (identity steps in the plain
    version).  Returns y (B, L, H, P) and the final state (B, H, P, N)
    f32."""
    op = "ssd_scan"
    _require(x.dim() == 4 and log_a.dim() == 3 and b.dim() == 4 and c.dim() == 4,
             op, "rank", "x rank-4, log_a rank-3, b/c rank-4")
    _require(b.shape == c.shape, op, "bc-shape", "b and c have identical shapes")
    _require(tuple(log_a.shape) == tuple(x.shape[:3]), op, "log-a-shape",
             "log_a matches x's (B, L, H) prefix")
    _require(tuple(b.shape[:2]) == tuple(x.shape[:2]), op, "batch-len",
             "b shares x's (B, L) prefix")
    _require(x.shape[2] % b.shape[2] == 0, op, "gqa",
             "state heads divide evenly over B/C groups")
    _require(x.dtype in _FLOATS and log_a.dtype in _FLOATS and b.dtype in _FLOATS
             and b.dtype == c.dtype, op, "dtype",
             "x/log_a/b/c are f32/bf16/f16 with b == c")
    _require(chunk >= 1, op, "chunk", "chunk size >= 1")
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    with _work(op, lambda: ssd_scan_work(L, H, P, G, N, chunk, B)):
        if _on_meta(op, x):
            return (torch.empty_like(x),
                    torch.empty((B, H, P, N), dtype=torch.float32, device=x.device))
        if _use_kernel(op, x, log_a, b, c, init_state):
            return ssd_scan_cuda(x, log_a, b, c, init_state, chunk)
        return ssd_scan_plain(x, log_a, b, c, init_state, chunk)
