"""Declarative kernel contracts: the one source of truth for dispatch.

The port's counterpart of ``repro/kernels/contracts.py``.  Every public
op of ``ops`` is described by one :class:`KernelContract`: the CUDA
wrapper it launches, the plain PyTorch version it must match, and two
tiers of rules over a flat "facts" dict.

  * **Preconditions** hold for both paths (ranks, shapes, GQA, dtype
    admissibility, and three checks of the caller's operands against
    the host maps and the slab: ``positions-match``, ``segments-match``,
    ``page-range``).  A violation raises :class:`KernelContractError`
    on every device.
  * **Eligibility rules** are the kernels' own limits (bf16 operands,
    head dims, map tiles, state widths, strides, alignment).  The first
    rule that fails names the call's verdict.  Where the JAX package
    falls back to its oracle, the port does not: on a CUDA tensor a
    refused call raises :class:`KernelIneligibleError` (a
    ``KernelContractError`` and a ``cuda.KernelError``), on a CPU tensor
    the plain version runs and ``ops.card_verdicts()`` counts the code
    the card would have refused it with.

Facts are built from tensors on any device, the meta device included,
with numpy's dtype names (``"bfloat16"``, ``"float32"``, ``"int8"``), so
they compare key for key with the reference's; the port's facts add what
its kernels read (strides, alignment, launch geometry).  Facts that may
sync (the three comparisons against host maps and the slab) are deferred
callables, evaluated after every structural rule.

The JAX package evaluates its registry once per trace; here every eager
call reaches it, so :func:`verdict` memoizes the structural verdict per
(op, geometry key): a steady-state call builds its key and looks it up.

``DIFFERENCES`` lists every eligibility rule the port adds to or drops
from the reference's, with the reason.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import cuda
from . import mv_sad as _mv_sad
from . import ssd_scan as _ssd_scan
from .cuda import KernelContractError, KernelError

__all__ = [
    "ADMISSIBLE_FLOAT", "CONTRACTS", "DIFFERENCES", "DispatchDecision", "KernelContract",
    "KernelContractError", "KernelIneligibleError", "OK", "Rule", "contract", "decide",
    "validate", "verdict",
]

# Dtypes the kernels' plain versions accept for float operands.
ADMISSIBLE_FLOAT = frozenset({"float32", "bfloat16", "float16"})

OK = "ok"
TILE = 128            # the attention kernels' query and key tile, and the page size


class KernelIneligibleError(KernelContractError, KernelError):
    """The kernel does not take these operands (an eligibility rule
    failed) and the call was on the card, where there is no fallback."""


@dataclasses.dataclass(frozen=True)
class Rule:
    """One machine-checkable clause of a contract.  A ``deferred`` rule
    reads a callable fact that may sync; it runs after every structural
    rule and is never memoized."""

    code: str
    description: str
    predicate: Callable[[Mapping[str, Any]], bool]
    deferred: bool = False

    def holds(self, facts: Mapping[str, Any]) -> bool:
        return bool(self.predicate(facts))


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """Outcome of the eligibility check for one call geometry."""

    use_kernel: bool
    reason: str  # ``OK`` or the code of the first failed rule

    def __bool__(self) -> bool:
        return self.use_kernel


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declarative record for one public kernel op."""

    name: str
    kernel: str  # dotted symbol of the CUDA wrapper
    oracle: str  # dotted symbol of the plain PyTorch version it must match
    description: str
    preconditions: Tuple[Rule, ...]
    eligibility: Tuple[Rule, ...]
    tile: Optional[Tuple[int, int]] = None  # (tq, tk) of the kernel
    visit_list: Optional[str] = None  # device operands that steer the kernel
    # prose: what one host build of a map (plus its upload) is keyed on;
    # the port's counterpart of an XLA compile
    compile_key: str = ""
    # most distinct map keys this op may produce over the audit's
    # scenario suite (``kernels/audit.py``); None: not budgeted
    recompile_budget: Optional[int] = None

    def violation(self, rule: Rule, facts: Mapping[str, Any]) -> KernelContractError:
        shown = _public_facts(facts)
        return KernelContractError(
            f"{self.name}: precondition '{rule.code}' violated ({rule.description})"
            + (f"; facts={shown}" if shown else ""))

    def refusal(self, reason: str, op: Optional[str] = None) -> KernelIneligibleError:
        rule = next(r for r in self.eligibility if r.code == reason)
        return KernelIneligibleError(
            f"{op or self.name}: eligibility '{rule.code}' failed ({rule.description})")

    def validate(self, facts: Mapping[str, Any], *, deferred: bool = True) -> None:
        """Raise on the first violated precondition (the deferred ones
        too unless ``deferred=False``)."""
        for rule in self.preconditions:
            if (deferred or not rule.deferred) and not rule.holds(facts):
                raise self.violation(rule, facts)

    def decide(self, facts: Mapping[str, Any]) -> DispatchDecision:
        """First failed eligibility rule wins; rules may therefore assume
        every earlier rule held."""
        for rule in self.eligibility:
            if not rule.holds(facts):
                return DispatchDecision(False, rule.code)
        return DispatchDecision(True, OK)


def _public_facts(facts: Mapping[str, Any]) -> dict:
    return {k: v for k, v in facts.items() if not callable(v)}


# ----------------------------------------------------------------------
# facts builders (shapes, dtypes, strides and pointers only: no sync)
# ----------------------------------------------------------------------
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.float64: "float64", torch.int8: "int8", torch.uint8: "uint8",
          torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
          torch.bool: "bool", torch.complex64: "complex64", torch.complex128: "complex128"}


def _dt(t) -> str:
    return _NAMES.get(t.dtype) or str(t.dtype).replace("torch.", "")


def _kind(name: str) -> str:
    """numpy's kind letter of a dtype name; bf16 is a float ('f': numpy
    has no bf16, the JAX package's ml_dtypes calls it 'V')."""
    return "f" if name == "bfloat16" else np.dtype(name).kind


def _shape(t) -> Optional[tuple]:
    return None if t is None else tuple(t.shape)


def read_in_place(*ts) -> bool:
    """Every operand a wrapper reads without copying starts on a 16-byte
    boundary (the kernels' 16-byte loads)."""
    return all(t.data_ptr() % 16 == 0 for t in ts if t is not None)


def read_or_copied(*ts) -> bool:
    """Every operand a wrapper makes contiguous (a copy is aligned, a
    contiguous operand is read in place) starts on a 16-byte boundary."""
    return all(not t.is_contiguous() or t.data_ptr() % 16 == 0 for t in ts if t is not None)


def _map_facts(block_map) -> dict:
    if block_map is None:
        return {}
    return dict(map_n_q=block_map.n_q, map_kv_len=block_map.kv_len, map_tq=block_map.tq,
                map_tk=block_map.tk, map_causal=block_map.causal,
                map_window=block_map.window)


def mv_sad_facts(cur, prev, *, block: int, radius: int) -> dict:
    threads, _, smem = _mv_sad.launch_geometry(int(block), int(radius))
    return {
        "cur_shape": tuple(cur.shape),
        "prev_shape": tuple(prev.shape),
        "cur_dtype": _dt(cur),
        "prev_dtype": _dt(prev),
        "block": int(block),
        "radius": int(radius),
        "threads": threads,
        "shared_bytes": smem,
    }


def rope_shift_facts(k, delta) -> dict:
    return {
        "k_shape": tuple(k.shape),
        "delta_shape": tuple(delta.shape),
        "k_dtype": _dt(k),
        "delta_dtype": _dt(delta),
        "aligned": read_or_copied(k),
    }


def flash_prefill_facts(q, k, v, *, causal: bool, window, q_offset: int) -> dict:
    return {
        "q_shape": tuple(q.shape),
        "k_shape": tuple(k.shape),
        "v_shape": tuple(v.shape),
        "q_dtype": _dt(q),
        "k_dtype": _dt(k),
        "v_dtype": _dt(v),
        "causal": bool(causal),
        "window": window,
        "q_offset": int(q_offset),
        "contiguous": all(t.is_contiguous() for t in (q, k, v)),
        "aligned": read_in_place(q, k, v),
    }


def _q_pos_facts(q, q_pos) -> dict:
    """``q_pos`` None: the map's own positions (the CUDA wrappers mask by
    them and take no positions of the caller)."""
    if q_pos is None:
        return {"q_pos_shape": tuple(q.shape[:2]), "q_pos_dtype": "int32"}
    return {"q_pos_shape": tuple(q_pos.shape), "q_pos_dtype": _dt(q_pos)}


def _true() -> bool:
    return True


def flash_refresh_facts(q, k, v, q_pos, kv_valid, *, causal: bool, window, block_map,
                        positions_match: Callable[[], bool] = _true) -> dict:
    """``positions_match`` is deferred: comparing the caller's positions
    with the map's may sync, so it runs after every structural rule."""
    facts = {
        "q_shape": tuple(q.shape),
        "k_shape": tuple(k.shape),
        "v_shape": tuple(v.shape),
        **_q_pos_facts(q, q_pos),
        "q_dtype": _dt(q),
        "k_dtype": _dt(k),
        "v_dtype": _dt(v),
        "kv_valid_shape": _shape(kv_valid),
        "kv_valid_dtype": None if kv_valid is None else _dt(kv_valid),
        "causal": bool(causal),
        "window": window,
        "has_map": block_map is not None,
        "positions_match": positions_match,
        "aligned": read_or_copied(q, k, v),
    }
    facts.update(_map_facts(block_map))
    return facts


def _cold_facts(cold, *, page: int) -> dict:
    """Facts of the optional int8 cold-page group ``(k8, v8, k_scale,
    v_scale)``: (n_cold * page, Hkv, D) slabs and (n_cold, Hkv) scales."""
    if cold is None:
        return {"has_cold": False}
    k8, v8, k_scale, v_scale = cold
    return {
        "has_cold": True,
        "cold_k_shape": tuple(k8.shape),
        "cold_v_shape": tuple(v8.shape),
        "cold_k_dtype": _dt(k8),
        "cold_v_dtype": _dt(v8),
        "k_scale_shape": tuple(k_scale.shape),
        "v_scale_shape": tuple(v_scale.shape),
        "k_scale_dtype": _dt(k_scale),
        "v_scale_dtype": _dt(v_scale),
    }


def _logical_len(pt_shape: tuple, page: int) -> int:
    return pt_shape[1] * int(page) if len(pt_shape) == 2 else -1


def flash_refresh_paged_facts(q, k, v, q_pos, kv_valid, page_table, *, page: int,
                              causal: bool, window, block_map,
                              positions_match: Callable[[], bool] = _true, cold=None,
                              pages_in_range: Callable[[], bool] = _true) -> dict:
    """``k``/``v`` are the batchless (P_phys, Hkv, D) slab; the logical
    length is the page table's (n_pages * page).  ``pages_in_range`` and
    ``positions_match`` are deferred."""
    pt_shape = tuple(page_table.shape)
    facts = {
        "q_shape": tuple(q.shape),
        "k_shape": tuple(k.shape),
        "v_shape": tuple(v.shape),
        **_q_pos_facts(q, q_pos),
        "pt_shape": pt_shape,
        "q_dtype": _dt(q),
        "k_dtype": _dt(k),
        "v_dtype": _dt(v),
        "pt_dtype": _dt(page_table),
        "kv_valid_shape": _shape(kv_valid),
        "kv_valid_dtype": None if kv_valid is None else _dt(kv_valid),
        "page": int(page),
        "logical_len": _logical_len(pt_shape, page),
        "causal": bool(causal),
        "window": window,
        "has_map": block_map is not None,
        "positions_match": positions_match,
        "pages_in_range": pages_in_range,
        "aligned": read_or_copied(q, k, v, *(cold or ())[:2]),
    }
    facts.update(_cold_facts(cold, page=page))
    facts.update(_map_facts(block_map))
    return facts


def flash_prefill_paged_facts(q, k, v, page_table, *, page: int, causal: bool, window,
                              q_offset: int, cold=None,
                              pages_in_range: Callable[[], bool] = _true) -> dict:
    pt_shape = tuple(page_table.shape)
    facts = {
        "q_shape": tuple(q.shape),
        "k_shape": tuple(k.shape),
        "v_shape": tuple(v.shape),
        "pt_shape": pt_shape,
        "q_dtype": _dt(q),
        "k_dtype": _dt(k),
        "v_dtype": _dt(v),
        "pt_dtype": _dt(page_table),
        "page": int(page),
        "logical_len": _logical_len(pt_shape, page),
        "causal": bool(causal),
        "window": window,
        "q_offset": int(q_offset),
        "pages_in_range": pages_in_range,
        "contiguous": all(t.is_contiguous() for t in (q, k, v, *(cold or ()))),
        "aligned": read_in_place(q, k, v, *(cold or ())[:2]),
    }
    facts.update(_cold_facts(cold, page=page))
    return facts


def flash_packed_facts(q, k, v, seg_id, block_map, *,
                       segments_match: Callable[[], bool] = _true) -> dict:
    """The reference's ``tile_ids``/``tile_count``/``tq``/``tk`` come
    from the ``PackBlockMap`` (tiles of 128 without one)."""
    bm = block_map
    return {
        "q_shape": tuple(q.shape),
        "k_shape": tuple(k.shape),
        "v_shape": tuple(v.shape),
        "seg_shape": tuple(seg_id.shape),
        "q_dtype": _dt(q),
        "k_dtype": _dt(k),
        "v_dtype": _dt(v),
        "seg_dtype": _dt(seg_id),
        "has_map": bm is not None,
        "tile_ids_shape": None if bm is None else tuple(bm.tile_ids.shape),
        "tile_count_shape": None if bm is None else tuple(bm.tile_count.shape),
        "tq": TILE if bm is None else int(bm.tq),
        "tk": TILE if bm is None else int(bm.tk),
        "map_single_run": bm is not None and bool(bm.single_run),
        "segments_match": segments_match,
        "aligned": read_or_copied(q, k, v),
    }


def ssd_scan_facts(x, log_a, b, c, *, chunk: int, init_state=None) -> dict:
    L = x.shape[1] if x.dim() > 1 else 0
    return {
        "x_shape": tuple(x.shape),
        "log_a_shape": tuple(log_a.shape),
        "b_shape": tuple(b.shape),
        "c_shape": tuple(c.shape),
        "x_dtype": _dt(x),
        "log_a_dtype": _dt(log_a),
        "b_dtype": _dt(b),
        "c_dtype": _dt(c),
        "chunk": int(chunk),
        "scan_chunk": _ssd_scan.scan_chunk(L, chunk) if L and chunk >= 1 else int(chunk),
        "x_stride": tuple(x.stride()),
        "log_a_stride": tuple(log_a.stride()),
        "b_stride": tuple(b.stride()),
        "c_stride": tuple(c.stride()),
        "init_shape": _shape(init_state),
        "init_dtype": None if init_state is None else _dt(init_state),
        "init_contiguous": init_state is None or init_state.is_contiguous(),
        "aligned": read_in_place(x, b, c, init_state),
    }


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
def _attn_dtype_ok(f: Mapping[str, Any]) -> bool:
    return (
        f["q_dtype"] in ADMISSIBLE_FLOAT
        and f["k_dtype"] in ADMISSIBLE_FLOAT
        and f["k_dtype"] == f["v_dtype"]
    )


def _window_ok(f: Mapping[str, Any]) -> bool:
    return f["window"] is None or f["window"] >= 1


# the int8 cold-page group of the paged ops; vacuous without one
_COLD_PRECONDITIONS = (
    Rule("cold-kv-shape", "cold k8 and v8 are rank-3 slabs with identical shapes",
         lambda f: not f["has_cold"]
         or (len(f["cold_k_shape"]) == 3 and f["cold_k_shape"] == f["cold_v_shape"])),
    Rule("cold-align", "cold slab row count divides by the page size",
         lambda f: not f["has_cold"] or f["cold_k_shape"][0] % f["page"] == 0),
    Rule("cold-head", "cold slab matches the hot slab's (Hkv, D) trailing dims",
         lambda f: not f["has_cold"] or f["cold_k_shape"][1:] == f["k_shape"][1:]),
    Rule("scale-shape", "k/v scales are (n_cold, Hkv) per-page-per-head",
         lambda f: not f["has_cold"]
         or (f["k_scale_shape"] == (f["cold_k_shape"][0] // f["page"], f["cold_k_shape"][1])
             and f["k_scale_shape"] == f["v_scale_shape"])),
)

_COLD_ELIGIBILITY = (
    Rule("cold-dtype", "fused dequant kernel requires int8 cold pages",
         lambda f: not f["has_cold"]
         or (f["cold_k_dtype"] == "int8" and f["cold_v_dtype"] == "int8")),
    Rule("scale-f32", "fused dequant kernel requires f32 scales (the plain version casts)",
         lambda f: not f["has_cold"]
         or (f["k_scale_dtype"] == "float32" and f["v_scale_dtype"] == "float32")),
)

_PAGE_RANGE = Rule("page-range", "page ids lie in [0, n_hot + n_cold): hot pages, then cold ones",
                   lambda f: f["pages_in_range"](), deferred=True)
_POSITIONS = Rule("positions-match", "q_pos equals the block map's query positions",
                  lambda f: f["positions_match"](), deferred=True)
_MAP_PRESENT = Rule("map-present", "a RefreshBlockMap was supplied",
                    lambda f: f["has_map"])
# the port's kernels' own rules, shared by the attention ops
_BF16 = Rule("bf16", "q/k/v must be bf16",
             lambda f: f["q_dtype"] == f["k_dtype"] == f["v_dtype"] == "bfloat16")
_HEAD_DIM = Rule("kernel-head-dim", "head dim must be 24, 32, 64 or 128 (the kernels' builds)",
                 lambda f: f["q_shape"][3] in cuda.HEAD_DIMS)
_MAP_TILE = Rule("map-tile", "the map's tiles must be 128 x 128",
                 lambda f: f["map_tq"] == TILE and f["map_tk"] == TILE)
_ALIGNED = Rule("aligned", "operands read in place must be 16-byte aligned",
                lambda f: f["aligned"])
_CONTIGUOUS = Rule("contiguous", "q/k/v (and the cold group) must be contiguous",
                   lambda f: f["contiguous"])


MV_SAD = KernelContract(
    name="mv_sad",
    kernel="repro_torch.kernels.mv_sad.mv_sad_cuda",
    oracle="repro_torch.kernels.mv_sad.mv_sad_plain",
    description="Full-search block-matching motion estimation over luma.",
    preconditions=(
        Rule("rank", "cur and prev are 2-D (H, W) luma planes",
             lambda f: len(f["cur_shape"]) == 2 and len(f["prev_shape"]) == 2),
        Rule("shape-match", "cur and prev have identical shapes",
             lambda f: f["cur_shape"] == f["prev_shape"]),
        Rule("block-divisibility", "H and W are multiples of the macroblock edge",
             lambda f: f["cur_shape"][0] % f["block"] == 0
             and f["cur_shape"][1] % f["block"] == 0),
        Rule("dtype", "frames are real numeric (float or integer)",
             lambda f: _kind(f["cur_dtype"]) in "fiu" and _kind(f["prev_dtype"]) in "fiu"),
        Rule("radius", "search radius >= 1", lambda f: f["radius"] >= 1),
    ),
    eligibility=(
        Rule("block-4", "the block edge must be a multiple of 4 (float4 rows)",
             lambda f: f["block"] % 4 == 0),
        Rule("candidates", "at most 1024 candidates: one thread per motion vector",
             lambda f: f["threads"] <= 1024),
        Rule("shared-memory", "the macroblock and its search band must fit 48 KB of "
             "shared memory", lambda f: f["shared_bytes"] <= _mv_sad.SMEM_LIMIT),
    ),
    compile_key="none: one build of every kernel; (H, W, block, radius) are launch arguments",
)

ROPE_SHIFT = KernelContract(
    name="rope_shift",
    kernel="repro_torch.kernels.rope_shift.rope_shift_cuda",
    oracle="repro_torch.kernels.rope_shift.rope_shift_plain",
    description="RoPE position correction of cached keys (paper Eq. 5).",
    preconditions=(
        Rule("rank", "k is (B, S, n_kv, d_h) and delta is (B, S)",
             lambda f: len(f["k_shape"]) == 4 and len(f["delta_shape"]) == 2),
        Rule("delta-shape", "delta matches k's (B, S) prefix",
             lambda f: f["delta_shape"] == f["k_shape"][:2]),
        Rule("delta-dtype", "delta is an integer position shift",
             lambda f: _kind(f["delta_dtype"]) in "iu"),
        Rule("k-dtype", "k is f32/bf16/f16", lambda f: f["k_dtype"] in ADMISSIBLE_FLOAT),
        Rule("even-head", "head dim is even (rotate-half RoPE)",
             lambda f: f["k_shape"][3] % 2 == 0),
    ),
    eligibility=(
        Rule("kernel-dtype", "k must be f32 or bf16 (no f16 build)",
             lambda f: f["k_dtype"] in ("float32", "bfloat16")),
        Rule("head-dim-8", "head dim must be a multiple of 8 (four rotation pairs a half)",
             lambda f: f["k_shape"][3] % 8 == 0),
        _ALIGNED,
    ),
    tile=None,
    compile_key="none: (B * S, n_kv, d_h, dtype) are launch arguments",
)

FLASH_PREFILL = KernelContract(
    name="flash_prefill",
    kernel="repro_torch.kernels.flash_prefill.flash_prefill_cuda",
    oracle="repro_torch.kernels.flash_prefill.flash_prefill_plain",
    description="Blockwise causal GQA attention over a contiguous window.",
    preconditions=(
        Rule("rank", "q/k/v are rank-4 (B, S, H, D)",
             lambda f: len(f["q_shape"]) == 4 and len(f["k_shape"]) == 4
             and len(f["v_shape"]) == 4),
        Rule("kv-shape", "k and v have identical shapes",
             lambda f: f["k_shape"] == f["v_shape"]),
        Rule("batch", "q and k share the batch dim",
             lambda f: f["q_shape"][0] == f["k_shape"][0]),
        Rule("head-dim", "q and k share the head dim",
             lambda f: f["q_shape"][3] == f["k_shape"][3]),
        Rule("gqa", "query heads divide evenly over kv heads",
             lambda f: f["q_shape"][2] % f["k_shape"][2] == 0),
        Rule("dtype", "q/k/v are f32/bf16/f16 with k == v", _attn_dtype_ok),
        Rule("window", "sliding window is None or >= 1", _window_ok),
    ),
    eligibility=(_BF16, _HEAD_DIM, _CONTIGUOUS, _ALIGNED),
    tile=(TILE, TILE),
    compile_key="none: each block derives its key tiles from the causal/window band",
)

FLASH_REFRESH = KernelContract(
    name="flash_refresh",
    kernel="repro_torch.kernels.flash_refresh.flash_refresh_cuda",
    oracle="repro_torch.kernels.flash_refresh.flash_refresh_plain",
    description=("Block-sparse masked attention over gathered query positions "
                 "(selective KVC refresh, fresh prefill and decode)."),
    preconditions=(
        Rule("rank", "q/k/v rank-4, q_pos rank-2",
             lambda f: len(f["q_shape"]) == 4 and len(f["k_shape"]) == 4
             and len(f["v_shape"]) == 4 and len(f["q_pos_shape"]) == 2),
        Rule("kv-shape", "k and v have identical shapes",
             lambda f: f["k_shape"] == f["v_shape"]),
        Rule("q-pos-shape", "q_pos is (B, Sq)",
             lambda f: f["q_pos_shape"] == (f["q_shape"][0], f["q_shape"][1])),
        Rule("batch", "q and k share the batch dim",
             lambda f: f["q_shape"][0] == f["k_shape"][0]),
        Rule("head-dim", "q and k share the head dim",
             lambda f: f["q_shape"][3] == f["k_shape"][3]),
        Rule("gqa", "query heads divide evenly over kv heads",
             lambda f: f["q_shape"][2] % f["k_shape"][2] == 0),
        Rule("dtype", "q/k/v are f32/bf16/f16 with k == v", _attn_dtype_ok),
        Rule("q-pos-dtype", "q_pos is integer token positions",
             lambda f: _kind(f["q_pos_dtype"]) in "iu"),
        Rule("kv-valid", "kv_valid is None or a (B, Sk) bool mask",
             lambda f: f["kv_valid_shape"] is None
             or (f["kv_valid_shape"] == (f["k_shape"][0], f["k_shape"][1])
                 and f["kv_valid_dtype"] == "bool")),
        _POSITIONS,
    ),
    eligibility=(
        _MAP_PRESENT,
        Rule("map-n-q", "map was built for this query count",
             lambda f: f["map_n_q"] == f["q_shape"][1]),
        Rule("map-kv-len", "map was built for this cache length",
             lambda f: f["map_kv_len"] == f["k_shape"][1]),
        Rule("k-tile", "cache length divides by the map's key tile",
             lambda f: f["k_shape"][1] % f["map_tk"] == 0),
        Rule("map-causal", "map and call agree on causal masking",
             lambda f: f["map_causal"] == f["causal"]),
        Rule("map-window", "map and call agree on the sliding window",
             lambda f: f["map_window"] == f["window"]),
        _MAP_TILE, _BF16, _HEAD_DIM, _ALIGNED,
    ),
    tile=(TILE, TILE),
    visit_list=("the map's q_pos (n_q_tiles * tq,), tile_ids (n_q_tiles, t_max) and "
                "tile_count (n_q_tiles,) int32, uploaded once per device "
                "(RefreshBlockMap.on); t_max <= ceil(kv_len / tk)"),
    compile_key=("one host build + upload per (WindowLayout, tiles, window, cache slots): "
                 "core.kvc.refresh_block_map's map, cached per layout, so steady-state "
                 "windows and fleet sizes add none"),
    # one key per (layout, fleet size) pair of the audit's suite at most:
    # 5 layouts x 4 fleet sizes; steady-state windows must add zero
    recompile_budget=20,
)

FLASH_REFRESH_PAGED = KernelContract(
    name="flash_refresh_paged",
    kernel="repro_torch.kernels.flash_refresh.flash_refresh_paged_cuda",
    oracle="repro_torch.kernels.flash_refresh.flash_refresh_paged_plain",
    description=("Paged block-sparse refresh attention: visit list -> page table "
                 "-> physical page of the shared slab (core/kv_pool.py)."),
    preconditions=(
        Rule("rank", "q rank-4, slab k/v rank-3, q_pos rank-2, page_table rank-2",
             lambda f: len(f["q_shape"]) == 4 and len(f["k_shape"]) == 3
             and len(f["v_shape"]) == 3 and len(f["q_pos_shape"]) == 2
             and len(f["pt_shape"]) == 2),
        Rule("kv-shape", "k and v slabs have identical shapes",
             lambda f: f["k_shape"] == f["v_shape"]),
        Rule("q-pos-shape", "q_pos is (B, Sq)",
             lambda f: f["q_pos_shape"] == (f["q_shape"][0], f["q_shape"][1])),
        Rule("pt-batch", "page_table leads with q's batch dim",
             lambda f: f["pt_shape"][0] == f["q_shape"][0]),
        Rule("head-dim", "q and the slab share the head dim",
             lambda f: f["q_shape"][3] == f["k_shape"][2]),
        Rule("gqa", "query heads divide evenly over kv heads",
             lambda f: f["q_shape"][2] % f["k_shape"][1] == 0),
        Rule("dtype", "q/k/v are f32/bf16/f16 with k == v", _attn_dtype_ok),
        Rule("q-pos-dtype", "q_pos is integer token positions",
             lambda f: _kind(f["q_pos_dtype"]) in "iu"),
        Rule("pt-dtype", "page_table is integer page ids",
             lambda f: _kind(f["pt_dtype"]) in "iu"),
        Rule("slab-align", "slab row count divides by the page size",
             lambda f: f["page"] >= 1 and f["k_shape"][0] % f["page"] == 0),
        Rule("kv-valid", "kv_valid is a (B, n_pages * page) bool mask over logical "
             "slots (mandatory: recycled pages hold stale KV)",
             lambda f: f["kv_valid_shape"] == (f["q_shape"][0], f["logical_len"])
             and f["kv_valid_dtype"] == "bool"),
    ) + _COLD_PRECONDITIONS + (_PAGE_RANGE, _POSITIONS),
    eligibility=(
        _MAP_PRESENT,
        Rule("map-n-q", "map was built for this query count",
             lambda f: f["map_n_q"] == f["q_shape"][1]),
        Rule("map-kv-len", "map was built for the logical stream length",
             lambda f: f["map_kv_len"] == f["logical_len"]),
        Rule("page-tile", "the map's key tile equals the page size (one visit-list "
             "entry == one slab page)", lambda f: f["map_tk"] == f["page"]),
        Rule("map-causal", "map and call agree on causal masking",
             lambda f: f["map_causal"] == f["causal"]),
        Rule("map-window", "map and call agree on the sliding window",
             lambda f: f["map_window"] == f["window"]),
    ) + _COLD_ELIGIBILITY + (_MAP_TILE, _BF16, _HEAD_DIM, _ALIGNED),
    tile=(TILE, TILE),
    visit_list=("the map's q_pos, tile_ids and tile_count (logical tiles) as for "
                "flash_refresh, plus page_table (B, n_pages) int32 per call (and the "
                "(n_cold, Hkv) f32 scales with a cold group): kv page = pt[b, tile]"),
    compile_key=("one host build + upload per (WindowLayout, tiles, window, cache slots), "
                 "as flash_refresh: page tables are per-call device values, so paging and "
                 "stream churn add none"),
    recompile_budget=20,
)

FLASH_PREFILL_PAGED = KernelContract(
    name="flash_prefill_paged",
    kernel="repro_torch.kernels.flash_prefill.flash_prefill_paged_cuda",
    oracle="repro_torch.kernels.flash_prefill.flash_prefill_paged_plain",
    description=("Paged causal GQA attention: contiguous logical window, key tiles "
                 "read from the shared slab through the page table."),
    preconditions=(
        Rule("rank", "q rank-4, slab k/v rank-3, page_table rank-2",
             lambda f: len(f["q_shape"]) == 4 and len(f["k_shape"]) == 3
             and len(f["v_shape"]) == 3 and len(f["pt_shape"]) == 2),
        Rule("kv-shape", "k and v slabs have identical shapes",
             lambda f: f["k_shape"] == f["v_shape"]),
        Rule("pt-batch", "page_table leads with q's batch dim",
             lambda f: f["pt_shape"][0] == f["q_shape"][0]),
        Rule("head-dim", "q and the slab share the head dim",
             lambda f: f["q_shape"][3] == f["k_shape"][2]),
        Rule("gqa", "query heads divide evenly over kv heads",
             lambda f: f["q_shape"][2] % f["k_shape"][1] == 0),
        Rule("dtype", "q/k/v are f32/bf16/f16 with k == v", _attn_dtype_ok),
        Rule("pt-dtype", "page_table is integer page ids",
             lambda f: _kind(f["pt_dtype"]) in "iu"),
        Rule("slab-align", "slab row count divides by the page size",
             lambda f: f["page"] >= 1 and f["k_shape"][0] % f["page"] == 0),
        Rule("causal", "causal masking is mandatory: it is what hides stale "
             "previous-tenant rows in recycled pages", lambda f: f["causal"]),
        Rule("window", "sliding window is None or >= 1", _window_ok),
    ) + _COLD_PRECONDITIONS + (_PAGE_RANGE,),
    eligibility=(
        Rule("page-tile", "page size equals the key tile Tk=128",
             lambda f: f["page"] == TILE),
    ) + _COLD_ELIGIBILITY + (_BF16, _HEAD_DIM, _CONTIGUOUS, _ALIGNED),
    tile=(TILE, TILE),
    visit_list="page_table (B, n_pages) int32 per call; each block walks its band of pages",
    compile_key="none: no host map; (B, Sq, n_pages, window, q_offset) are launch arguments",
)

FLASH_PACKED = KernelContract(
    name="flash_packed",
    kernel="repro_torch.kernels.flash_packed.flash_packed_cuda",
    oracle="repro_torch.kernels.flash_packed.flash_packed_plain",
    description="Block-diagonal attention over packed ViT rows (segment mask).",
    preconditions=(
        Rule("rank", "q/k/v rank-4, seg_id rank-2",
             lambda f: len(f["q_shape"]) == 4 and len(f["k_shape"]) == 4
             and len(f["v_shape"]) == 4 and len(f["seg_shape"]) == 2),
        Rule("kv-shape", "k and v have identical shapes",
             lambda f: f["k_shape"] == f["v_shape"]),
        Rule("seg-shape", "seg_id is (R, L)",
             lambda f: f["seg_shape"] == (f["q_shape"][0], f["q_shape"][1])),
        Rule("rows", "q and k share the packed-row dim",
             lambda f: f["q_shape"][0] == f["k_shape"][0]),
        Rule("gqa", "query heads divide evenly over kv heads",
             lambda f: f["q_shape"][2] % f["k_shape"][2] == 0),
        Rule("dtype", "q/k/v are f32/bf16/f16 with k == v", _attn_dtype_ok),
        Rule("seg-dtype", "seg_id is integer (-1 marks padding)",
             lambda f: _kind(f["seg_dtype"]) in "iu"),
        Rule("tiles-positive", "tq and tk are >= 1", lambda f: f["tq"] >= 1 and f["tk"] >= 1),
        Rule("segments-match", "seg_id equals the block map's layout",
             lambda f: f["segments_match"](), deferred=True),
    ),
    eligibility=(
        Rule("map-present", "a PackBlockMap was supplied (per-row visit lists)",
             lambda f: f["has_map"]),
        Rule("q-tile", "L divides by tq", lambda f: f["q_shape"][1] % f["tq"] == 0),
        Rule("k-tile", "L divides by tk", lambda f: f["q_shape"][1] % f["tk"] == 0),
        Rule("tile-ids-shape", "tile_ids leads with (R, L/tq)",
             lambda f: f["tile_ids_shape"][:2] == (f["q_shape"][0], f["q_shape"][1] // f["tq"])),
        Rule("tile-count-shape", "tile_count is exactly (R, L/tq)",
             lambda f: f["tile_count_shape"] == (f["q_shape"][0], f["q_shape"][1] // f["tq"])),
        Rule("map-tile", "the map's tiles must be 128 x 128",
             lambda f: f["tq"] == TILE and f["tk"] == TILE),
        Rule("single-run", "the kernel masks by key range: every segment must be one "
             "contiguous run of its row", lambda f: f["map_single_run"]),
        _BF16, _HEAD_DIM, _ALIGNED,
    ),
    tile=(TILE, TILE),
    visit_list=("the map's span (R, L), tile_ids (R, L/tq, t_max) and tile_count "
                "(R, L/tq) int32, uploaded once per packing (PackBlockMap.on); t_max <= L/tk"),
    compile_key=("one host build + upload per packing: (R, L, t_max, tq, tk); R is "
                 "quantized by PACK_ROW_QUANTUM, L by PACK_LEN_BUCKETS, t_max by "
                 "power-of-two rounding in build_pack_map"),
    # rows-quantum x len-bucket x t_max combinations the audit's scenario
    # suite may produce (core/pruning.py's bucket constants)
    recompile_budget=24,
)

_SSD_PACKED = ("x must have packed (H, P) per step, b and c packed (G, N) with shared "
               "strides, log_a packed heads")

SSD_SCAN = KernelContract(
    name="ssd_scan",
    kernel="repro_torch.kernels.ssd_scan.ssd_scan_cuda",
    oracle="repro_torch.kernels.ssd_scan.ssd_scan_plain",
    description="Chunked state-space-duality scan (recurrent families).",
    preconditions=(
        Rule("rank", "x rank-4, log_a rank-3, b/c rank-4",
             lambda f: len(f["x_shape"]) == 4 and len(f["log_a_shape"]) == 3
             and len(f["b_shape"]) == 4 and len(f["c_shape"]) == 4),
        Rule("bc-shape", "b and c have identical shapes",
             lambda f: f["b_shape"] == f["c_shape"]),
        Rule("log-a-shape", "log_a matches x's (B, L, H) prefix",
             lambda f: f["log_a_shape"] == f["x_shape"][:3]),
        Rule("batch-len", "b shares x's (B, L) prefix",
             lambda f: f["b_shape"][:2] == f["x_shape"][:2]),
        Rule("gqa", "state heads divide evenly over B/C groups",
             lambda f: f["x_shape"][2] % f["b_shape"][2] == 0),
        Rule("dtype", "x/log_a/b/c are f32/bf16/f16 with b == c",
             lambda f: f["x_dtype"] in ADMISSIBLE_FLOAT and f["log_a_dtype"] in ADMISSIBLE_FLOAT
             and f["b_dtype"] in ADMISSIBLE_FLOAT and f["b_dtype"] == f["c_dtype"]),
        Rule("chunk", "chunk size >= 1", lambda f: f["chunk"] >= 1),
    ),
    eligibility=(
        Rule("bf16", "x, b and c must be bf16",
             lambda f: f["x_dtype"] == f["b_dtype"] == f["c_dtype"] == "bfloat16"),
        Rule("log-a-f32", "log_a must be f32", lambda f: f["log_a_dtype"] == "float32"),
        Rule("chunk-256", "the scan's chunk min(chunk, L) must be at most 256 (one step "
             "per thread)", lambda f: f["scan_chunk"] <= _ssd_scan.Q_MAX),
        Rule("state-width", "state width N must be 16, 64 or 128 (the kernel's builds)",
             lambda f: f["b_shape"][3] in _ssd_scan.STATE_WIDTHS),
        Rule("head-width-8", "head width P must be a multiple of 8",
             lambda f: f["x_shape"][3] % 8 == 0),
        Rule("aligned", "x, b, c and init_state must be 16-byte aligned (read in place)",
             lambda f: f["aligned"]),
        Rule("row-strides", "x, b and c batch and time strides must be multiples of 8 "
             "(16-byte aligned rows)",
             lambda f: all(s[0] % 8 == 0 and s[1] % 8 == 0
                           for s in (f["x_stride"], f["b_stride"]))),
        Rule("packed", _SSD_PACKED,
             lambda f: f["x_stride"][3] == 1 and f["x_stride"][2] == f["x_shape"][3]
             and f["b_stride"][3] == 1 and f["b_stride"][2] == f["b_shape"][3]
             and f["c_stride"] == f["b_stride"] and f["log_a_stride"][2] == 1),
        Rule("init-state", "init_state must be f32 (B, H, P, N) and contiguous",
             lambda f: f["init_shape"] is None
             or (f["init_dtype"] == "float32" and f["init_contiguous"]
                 and f["init_shape"] == f["x_shape"][:1] + (f["x_shape"][2], f["x_shape"][3],
                                                            f["b_shape"][3]))),
    ),
    tile=None,
    compile_key="none: one build per state width N; (B, L, H, P, G, chunk) are launch arguments",
)

CONTRACTS: Dict[str, KernelContract] = {
    c.name: c
    for c in (MV_SAD, ROPE_SHIFT, FLASH_PREFILL, FLASH_PREFILL_PAGED, FLASH_REFRESH,
              FLASH_REFRESH_PAGED, FLASH_PACKED, SSD_SCAN)
}

# How the port's eligibility rules differ from the reference's:
# (op, code, "+" added by the port | "-" the reference's, dropped, why).
DIFFERENCES: Tuple[Tuple[str, str, str, str], ...] = (
    ("mv_sad", "block-4", "+", "the kernel loads macroblock rows as float4"),
    ("mv_sad", "candidates", "+", "one thread per candidate, at most 1024 a block"),
    ("mv_sad", "shared-memory", "+", "macroblock and band are staged in 48 KB of shared memory"),
    ("rope_shift", "seq-tile", "-", "one thread per token: any S runs, no sequence tile"),
    ("rope_shift", "kernel-dtype", "+", "built for f32 and bf16 keys, not f16"),
    ("rope_shift", "head-dim-8", "+", "16-byte (8-byte at D 24) chunks of four rotation pairs"),
    ("rope_shift", "aligned", "+", "16-byte loads of k, read in place when contiguous"),
    ("flash_prefill", "q-tile", "-", "the kernel masks ragged query tiles"),
    ("flash_prefill", "k-tile", "-", "the kernel masks ragged key tiles"),
    ("flash_prefill", "bf16", "+", "bf16 tensor-core products only"),
    ("flash_prefill", "kernel-head-dim", "+", "built for head dims 24, 32, 64 and 128"),
    ("flash_prefill", "contiguous", "+", "q/k/v are read in place with packed rows"),
    ("flash_prefill", "aligned", "+", "16-byte cp.async copies of q/k/v"),
    ("flash_prefill_paged", "q-tile", "-", "the kernel masks ragged query tiles"),
    ("flash_prefill_paged", "bf16", "+", "bf16 tensor-core products only (the cold group int8)"),
    ("flash_prefill_paged", "kernel-head-dim", "+", "built for head dims 24, 32, 64 and 128"),
    ("flash_prefill_paged", "contiguous", "+", "q/k/v and the cold group are read in place"),
    ("flash_prefill_paged", "aligned", "+", "16-byte cp.async copies of q/k/v and the int8 slabs"),
    ("flash_refresh", "positions", "-", "a precondition here ('positions-match'): the kernel "
     "masks by the map's positions, and a card refusal is no fallback"),
    ("flash_refresh", "map-tile", "+", "the kernel's tiles are 128 x 128"),
    ("flash_refresh", "bf16", "+", "bf16 tensor-core products only"),
    ("flash_refresh", "kernel-head-dim", "+", "built for head dims 24, 32, 64 and 128"),
    ("flash_refresh", "aligned", "+", "16-byte cp.async copies, contiguous operands in place"),
    ("flash_refresh_paged", "positions", "-", "a precondition here ('positions-match')"),
    ("flash_refresh_paged", "map-tile", "+", "the kernel's tiles and pages are 128"),
    ("flash_refresh_paged", "bf16", "+", "bf16 tensor-core products only (the cold group int8)"),
    ("flash_refresh_paged", "kernel-head-dim", "+", "built for head dims 24, 32, 64 and 128"),
    ("flash_refresh_paged", "aligned", "+", "16-byte cp.async copies of q/k/v and the int8 slabs"),
    ("flash_packed", "map-tile", "+", "the kernel's tiles are 128 x 128"),
    ("flash_packed", "single-run", "+", "the mask is one key range per slot, exact only "
     "when every segment is one run of its row (pack_plan's layouts)"),
    ("flash_packed", "bf16", "+", "bf16 tensor-core products only"),
    ("flash_packed", "kernel-head-dim", "+", "built for head dims 24, 32, 64 and 128"),
    ("flash_packed", "aligned", "+", "16-byte cp.async copies, contiguous operands in place"),
    ("ssd_scan", "bf16", "+", "x, b, c enter the tensor-core products as bf16"),
    ("ssd_scan", "log-a-f32", "+", "the decays are summed in f32 from an f32 log_a"),
    ("ssd_scan", "chunk-256", "+", "one scan step per thread of a 256-thread block"),
    ("ssd_scan", "state-width", "+", "built for N 16, 64 and 128 (jamba, mamba2)"),
    ("ssd_scan", "head-width-8", "+", "P is split into 8-column tensor-core tiles"),
    ("ssd_scan", "aligned", "+", "16-byte loads of x, b, c and the state, read in place"),
    ("ssd_scan", "row-strides", "+", "rows are read through batch and time strides"),
    ("ssd_scan", "packed", "+", "heads, groups and features packed within a step"),
    ("ssd_scan", "init-state", "+", "the f32 state is read and written whole, in place"),
)


def contract(name: str) -> KernelContract:
    return CONTRACTS[name]


def validate(name: str, facts: Mapping[str, Any]) -> None:
    CONTRACTS[name].validate(facts)


def decide(name: str, facts: Mapping[str, Any]) -> DispatchDecision:
    return CONTRACTS[name].decide(facts)


# ----------------------------------------------------------------------
# memoized verdicts
# ----------------------------------------------------------------------
_VERDICTS: Dict[tuple, DispatchDecision] = {}
_MEMO_MAX = 4096


def verdict(name: str, key: tuple, make_facts: Callable[[], dict],
            deferred: Optional[Mapping[str, Callable[[], bool]]] = None) -> DispatchDecision:
    """The call's dispatch decision.  The structural preconditions and the
    eligibility rules run once per (``name``, ``key``): ``key`` must
    determine every fact they read, and ``make_facts`` is called only on
    a miss.  Then the deferred preconditions run against ``deferred``
    (their callables), on every call.  A violated precondition raises."""
    c = CONTRACTS[name]
    dec = _VERDICTS.get((name, key))
    if dec is None:
        facts = make_facts()
        c.validate(facts, deferred=False)
        dec = c.decide(facts)
        if len(_VERDICTS) >= _MEMO_MAX:
            _VERDICTS.clear()
        _VERDICTS[(name, key)] = dec
    if deferred:
        for rule in c.preconditions:
            if rule.deferred and not rule.holds(deferred):
                raise c.violation(rule, {})
    return dec


def clear_verdicts() -> None:
    """Forget the memoized verdicts (tests; a change of ``cuda.HEAD_DIMS``)."""
    _VERDICTS.clear()


def require(dec: DispatchDecision, name: str, op: Optional[str] = None) -> None:
    """Raise the refusal of a call the kernel does not take."""
    if not dec.use_kernel:
        raise CONTRACTS[name].refusal(dec.reason, op)


# ----------------------------------------------------------------------
# memo keys: every fact a structural rule reads, cheaply
# ----------------------------------------------------------------------
def _map_key(bm) -> Optional[tuple]:
    return None if bm is None else (bm.n_q, bm.kv_len, bm.tq, bm.tk, bm.causal, bm.window)


def mv_sad_verdict(cur, prev, block: int, radius: int) -> DispatchDecision:
    return verdict("mv_sad", (cur.shape, prev.shape, cur.dtype, prev.dtype, block, radius),
                   lambda: mv_sad_facts(cur, prev, block=block, radius=radius))


def rope_shift_verdict(k, delta) -> DispatchDecision:
    return verdict("rope_shift", (k.shape, k.dtype, delta.shape, delta.dtype,
                                  read_or_copied(k)),
                   lambda: rope_shift_facts(k, delta))


def flash_prefill_verdict(q, k, v, *, causal: bool, window, q_offset: int) -> DispatchDecision:
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, bool(causal), window,
           q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
           read_in_place(q, k, v))
    return verdict("flash_prefill", key, lambda: flash_prefill_facts(
        q, k, v, causal=causal, window=window, q_offset=q_offset))


def flash_refresh_verdict(q, k, v, q_pos, kv_valid, *, causal: bool, window, block_map,
                          positions_match: Callable[[], bool] = _true) -> DispatchDecision:
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype,
           None if q_pos is None else (q_pos.shape, q_pos.dtype),
           None if kv_valid is None else (kv_valid.shape, kv_valid.dtype),
           bool(causal), window, _map_key(block_map), read_or_copied(q, k, v))
    return verdict("flash_refresh", key, lambda: flash_refresh_facts(
        q, k, v, q_pos, kv_valid, causal=causal, window=window, block_map=block_map,
        positions_match=positions_match), {"positions_match": positions_match})


def _cold_key(cold) -> Optional[tuple]:
    return None if cold is None else tuple((t.shape, t.dtype) for t in cold)


def flash_refresh_paged_verdict(q, k, v, q_pos, kv_valid, page_table, *, page: int,
                                causal: bool, window, block_map, cold=None,
                                positions_match: Callable[[], bool] = _true,
                                pages_in_range: Callable[[], bool] = _true
                                ) -> DispatchDecision:
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype,
           None if q_pos is None else (q_pos.shape, q_pos.dtype),
           None if kv_valid is None else (kv_valid.shape, kv_valid.dtype),
           page_table.shape, page_table.dtype, page, bool(causal), window,
           _map_key(block_map), _cold_key(cold), read_or_copied(q, k, v, *(cold or ())[:2]))
    return verdict("flash_refresh_paged", key, lambda: flash_refresh_paged_facts(
        q, k, v, q_pos, kv_valid, page_table, page=page, causal=causal, window=window,
        block_map=block_map, positions_match=positions_match, cold=cold,
        pages_in_range=pages_in_range),
        {"positions_match": positions_match, "pages_in_range": pages_in_range})


def flash_prefill_paged_verdict(q, k, v, page_table, *, page: int, causal: bool, window,
                                q_offset: int, cold=None,
                                pages_in_range: Callable[[], bool] = _true
                                ) -> DispatchDecision:
    ops_ = (q, k, v, *(cold or ()))
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, page_table.shape,
           page_table.dtype, page, bool(causal), window, _cold_key(cold),
           all(t.is_contiguous() for t in ops_), read_in_place(q, k, v, *(cold or ())[:2]))
    return verdict("flash_prefill_paged", key, lambda: flash_prefill_paged_facts(
        q, k, v, page_table, page=page, causal=causal, window=window, q_offset=q_offset,
        cold=cold, pages_in_range=pages_in_range), {"pages_in_range": pages_in_range})


def flash_packed_verdict(q, k, v, seg_id, block_map,
                         segments_match: Callable[[], bool] = _true) -> DispatchDecision:
    bm = block_map
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, seg_id.shape, seg_id.dtype,
           None if bm is None else (bm.tq, bm.tk, bm.tile_ids.shape, bm.tile_count.shape,
                                    bm.single_run),
           read_or_copied(q, k, v))
    return verdict("flash_packed", key, lambda: flash_packed_facts(
        q, k, v, seg_id, bm, segments_match=segments_match),
        {"segments_match": segments_match})


def ssd_scan_verdict(x, log_a, b, c, init_state, chunk: int) -> DispatchDecision:
    key = (x.shape, x.dtype, x.stride(), log_a.shape, log_a.dtype, log_a.stride(),
           b.shape, b.dtype, b.stride(), c.shape, c.dtype, c.stride(), chunk,
           None if init_state is None else (init_state.shape, init_state.dtype,
                                            init_state.is_contiguous()),
           read_in_place(x, b, c, init_state))
    return verdict("ssd_scan", key, lambda: ssd_scan_facts(
        x, log_a, b, c, chunk=chunk, init_state=init_state))
