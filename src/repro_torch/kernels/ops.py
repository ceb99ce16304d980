"""Dispatch for the kernels of the serving path.

Every op goes through its contract in ``contracts`` (``CONTRACTS[op]``):
it builds the call's facts, ``contracts.verdict`` checks the
preconditions (a violation raises :class:`KernelContractError` on every
device: neither path could give a meaningful answer) and decides whether
the kernel takes the call (``ok``, or the code of the first eligibility
rule that fails), then the call is routed by where its operands live:

  * a CPU tensor runs the plain PyTorch version, whatever the verdict;
  * a CUDA tensor launches the hand-written kernel, or raises
    :class:`KernelIneligibleError` (a ``KernelContractError`` and a
    ``cuda.KernelError``) naming the rule when the verdict is not ``ok``.
    There is no silent fallback.  No kernel has a backward, so under
    grad mode a CUDA operand that requires grad raises
    ``KernelContractError`` rather than being detached (the plain
    versions, on the CPU or under ``kernel_mode("plain")``, differentiate);
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
(plain version forced on the card) or ``meta`` (shapes only).
``card_verdicts()`` records, per kernel name and on every device, the
registry's verdict: ``ok`` or the code of the rule the card refuses the
call by (the JAX package's ``backend:<rule>``).  ``launch_counts()``
counts the kernel launches themselves.  ``flash_refresh_paged`` and
``flash_prefill_paged`` with an int8 ``cold`` group are counted as
``flash_refresh_paged_int8`` and ``flash_prefill_paged_int8``.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from . import contracts, cuda
from .contracts import KernelContractError, KernelIneligibleError
from .flash_packed import PackBlockMap, flash_packed_launch, flash_packed_plain
from .flash_prefill import (
    flash_prefill_launch, flash_prefill_paged_launch, flash_prefill_paged_plain,
    flash_prefill_plain,
)
from .flash_refresh import (
    RefreshBlockMap, flash_refresh_launch, flash_refresh_paged_launch,
    flash_refresh_paged_plain, flash_refresh_plain, flash_refresh_work,
)
from .mv_sad import mv_sad_launch, mv_sad_plain
from .rope_shift import rope_shift_launch, rope_shift_plain
from .ssd_scan import ssd_scan_launch, ssd_scan_plain, ssd_scan_work
from .transfer import host_of

__all__ = [
    "KERNELS", "KernelContractError", "KernelIneligibleError", "card_verdicts",
    "count_work", "dispatch_counts", "flash_packed", "flash_prefill", "flash_prefill_paged",
    "flash_refresh", "flash_refresh_paged", "kernel_mode", "launch_counts", "mv_sad",
    "plain_calls_on_cuda", "reset_card_verdicts", "reset_dispatch_counts",
    "reset_launch_counts", "rope_shift", "set_kernel_mode", "ssd_scan",
]

KERNELS = ("mv_sad", "rope_shift", "flash_refresh_paged", "flash_packed",
           "flash_refresh", "flash_refresh_paged_int8", "ssd_scan",
           "flash_prefill", "flash_prefill_paged", "flash_prefill_paged_int8")

_MODE = "auto"   # auto | plain
_COUNTS: "defaultdict[str, Counter]" = defaultdict(Counter)
_VERDICTS: "defaultdict[str, Counter]" = defaultdict(Counter)
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


def card_verdicts() -> Dict[str, Dict[str, int]]:
    """Snapshot of per-op verdicts on every device: ``ok`` or the code of
    the first eligibility rule the call fails (the card would refuse it)."""
    return {op: dict(c) for op, c in _VERDICTS.items()}


def reset_card_verdicts() -> None:
    _VERDICTS.clear()


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


def _on_meta(op: str, dec, t: torch.Tensor) -> bool:
    """Record the call's verdict; whether ``t`` is a meta tensor (shapes
    only: no kernel, no plain version)."""
    _VERDICTS[op][dec.reason] += 1
    if t.device.type != "meta":
        return False
    _COUNTS[op]["meta"] += 1
    return True


def _use_kernel(op: str, name: str, dec, t: torch.Tensor, *operands) -> bool:
    """Whether ``op`` launches its kernel: ``t`` decides the device.  On
    the card a call the contract ``name`` refuses raises, and so does one
    under grad mode where ``t`` or any tensor of ``operands`` requires
    grad (the kernel's output would carry no gradient)."""
    if t.device.type == "cpu":
        _COUNTS[op]["backend:ok"] += 1
        return False
    if t.device.type != "cuda":
        raise KernelContractError(f"{op}: no kernel for device {t.device}")
    if _MODE == "plain":
        _COUNTS[op]["mode:plain"] += 1
        return False
    contracts.require(dec, name, op)
    if torch.is_grad_enabled() and any(
            torch.is_tensor(o) and o.requires_grad for o in (t,) + operands):
        raise KernelContractError(
            f"{op}: an operand requires grad and the op has no backward kernel; "
            f"call it under torch.no_grad() or on detached tensors")
    _COUNTS[op]["kernel"] += 1
    return True


# ----------------------------------------------------------------------
# deferred preconditions: each may sync on the card, so each runs on a
# host twin where there is one, and once per operand tensor and map
# (the layers of one pass share both)
# ----------------------------------------------------------------------
# the last (q_pos tensor, its version, map) found equal; holding the
# tensor keeps its storage from being reused by another
_MATCHED: list = [None]


def _positions_match(q_pos: torch.Tensor, bm: RefreshBlockMap) -> bool:
    """The kernel masks by the map's query positions, the plain version
    by ``q_pos``: they must be equal on every device."""
    hit = _MATCHED[0]
    if hit is not None and hit[0] is q_pos and hit[1] == q_pos._version and hit[2] is bm:
        return True
    host = host_of(q_pos)
    same = q_pos.shape[1] == bm.n_q and (
        bool((host == bm.q_pos[: bm.n_q]).all()) if host is not None
        else bool((q_pos == bm.on(q_pos.device).q_pos[: bm.n_q]).all()))
    if same:
        _MATCHED[0] = (q_pos, q_pos._version, bm)
    return same


# the last (seg_id tensor, its version, map) found equal
_SEG_MATCHED: list = [None]


def _segments_match(seg_id: torch.Tensor, bm: PackBlockMap) -> bool:
    """The kernel masks by the map's layout, the plain version by
    ``seg_id``: they must be equal on every device."""
    hit = _SEG_MATCHED[0]
    if hit is not None and hit[0] is seg_id and hit[1] == seg_id._version and hit[2] is bm:
        return True
    host = host_of(seg_id)
    same = tuple(seg_id.shape) == bm.seg_id.shape and (
        np.array_equal(host, bm.seg_id) if host is not None
        else bool((seg_id == bm.on(seg_id.device).seg_id).all()))
    if same:
        _SEG_MATCHED[0] = (seg_id, seg_id._version, bm)
    return same


# the last (page table, its version, page count) found in range
_IN_RANGE: list = [None]


def _pages_in_range(page_table: torch.Tensor, n_pages: int) -> bool:
    """Every entry addresses a hot or a cold page: the plain gather would
    clamp or fail, the kernel read past the slab."""
    hit = _IN_RANGE[0]
    if (hit is not None and hit[0] is page_table and hit[1] == page_table._version
            and hit[2] == n_pages):
        return True
    host = host_of(page_table)
    table = page_table if host is None else host
    ok = bool(((table >= 0) & (table < n_pages)).all())
    if ok:
        _IN_RANGE[0] = (page_table, page_table._version, n_pages)
    return ok


def _true() -> bool:
    return True


def _page_check(q, k, page_table, page: int, cold):
    """The deferred 'page-range' check of a paged call (none on meta)."""
    if q.device.type == "meta":
        return _true
    n_cold = 0 if cold is None else cold[0].shape[0] // page
    return lambda: _pages_in_range(page_table, k.shape[0] // page + n_cold)


# ----------------------------------------------------------------------
def mv_sad(cur, prev, block: int = 16, radius: int = 4):
    """Block-matching motion search (see ``ref.mv_sad_ref``)."""
    op = "mv_sad"
    dec = contracts.mv_sad_verdict(cur, prev, block, radius)
    if _on_meta(op, dec, cur):
        H, W = cur.shape
        return (torch.empty((H // block, W // block, 2), dtype=torch.int32, device="meta"),
                torch.empty((H // block, W // block), dtype=torch.float32, device="meta"))
    if _use_kernel(op, op, dec, cur, prev):
        return mv_sad_launch(cur, prev, block, radius)
    return mv_sad_plain(cur, prev, block, radius)


def rope_shift(k, delta, theta: float = 10_000.0):
    """Rotate cached keys by per-token position deltas (Eq. 5)."""
    op = "rope_shift"
    dec = contracts.rope_shift_verdict(k, delta)
    if _on_meta(op, dec, k):
        return torch.empty_like(k)
    if _use_kernel(op, op, dec, k):
        return rope_shift_launch(k, delta, theta)
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
    match = (_true if block_map is None or q.device.type == "meta"
             else lambda: _positions_match(q_pos, block_map))
    dec = contracts.flash_refresh_verdict(q, k, v, q_pos, kv_valid, causal=causal,
                                          window=window, block_map=block_map,
                                          positions_match=match)
    with _work(op, lambda: flash_refresh_work(q, k, q_pos, kv_valid, causal=causal,
                                              window=window)):
        if _on_meta(op, dec, q):
            return torch.empty_like(q)
        if _use_kernel(op, op, dec, q, k, v):
            if kv_valid is None:
                kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
            return flash_refresh_launch(q, k, v, kv_valid, block_map, causal=causal,
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
    match = (_true if block_map is None or q.device.type == "meta"
             else lambda: _positions_match(q_pos, block_map))
    dec = contracts.flash_refresh_paged_verdict(
        q, k, v, q_pos, kv_valid, page_table, page=page, causal=causal, window=window,
        block_map=block_map, cold=cold, positions_match=match,
        pages_in_range=_page_check(q, k, page_table, page, cold))
    if _on_meta(op, dec, q):
        return torch.empty_like(q)
    if _use_kernel(op, "flash_refresh_paged", dec, q, k, v, *(cold or ())):
        return flash_refresh_paged_launch(
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
    match = (_true if block_map is None or q.device.type == "meta"
             else lambda: _segments_match(seg_id, block_map))
    dec = contracts.flash_packed_verdict(q, k, v, seg_id, block_map, match)
    if _on_meta(op, dec, q):
        return torch.empty_like(q)
    if _use_kernel(op, op, dec, q, k, v):
        return flash_packed_launch(q, k, v, block_map)
    return flash_packed_plain(q, k, v, seg_id, q_chunk=q_chunk)


def flash_prefill(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, q_chunk: int = 1024):
    """Dense GQA attention: q (B, Sq, H, D) at positions ``q_offset +
    arange(Sq)`` against k, v (B, Sk, Hkv, D) at ``arange(Sk)``, causal
    and/or a sliding window.  Any Sq and Sk: the kernel masks the ragged
    edges (the JAX package sends such geometries to its oracle)."""
    op = "flash_prefill"
    dec = contracts.flash_prefill_verdict(q, k, v, causal=causal, window=window,
                                          q_offset=q_offset)
    if _on_meta(op, dec, q):
        return torch.empty_like(q)
    if _use_kernel(op, op, dec, q, k, v):
        return flash_prefill_launch(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
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
    dec = contracts.flash_prefill_paged_verdict(
        q, k, v, page_table, page=page, causal=causal, window=window, q_offset=q_offset,
        cold=cold, pages_in_range=_page_check(q, k, page_table, page, cold))
    if _on_meta(op, dec, q):
        return torch.empty_like(q)
    if _use_kernel(op, "flash_prefill_paged", dec, q, k, v, *(cold or ())):
        return flash_prefill_paged_launch(q, k, v, page_table, page=page, window=window,
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
    dec = contracts.ssd_scan_verdict(x, log_a, b, c, init_state, chunk)
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    with _work(op, lambda: ssd_scan_work(L, H, P, G, N, chunk, B)):
        if _on_meta(op, dec, x):
            return (torch.empty_like(x),
                    torch.empty((B, H, P, N), dtype=torch.float32, device=x.device))
        if _use_kernel(op, op, dec, x, log_a, b, c, init_state):
            return ssd_scan_launch(x, log_a, b, c, init_state, chunk)
        return ssd_scan_plain(x, log_a, b, c, init_state, chunk)
