"""Grouped serving configuration (the JAX package's ``serving/config.py``).

``EngineCfg`` used to be a flat bag of nine flags; it is now four
orthogonal groups matching the stage that consumes them:

  * top-level   — ``mode`` / ``codec`` / ``max_new_tokens`` / ``q_chunk``
                  (consumed by every stage).
  * ``prune``   — ViT-side token pruning knobs (``PruneCfg``).
  * ``refresh`` — KVC refresh-policy budgets for the dynamic baselines
                  (``RefreshCfg``).
  * ``kv``      — KV storage strategy: paged slab vs per-stream concat
                  (``KVCfg``).

``SchedulerCfg`` configures the multi-stream scheduler (admission,
batching, and the stage-pipelined async engine) and is passed to
``Scheduler`` directly — it is deliberately NOT part of ``EngineCfg``:
one pipeline can be driven by schedulers with different concurrency.

Legacy flat kwargs (``EngineCfg(paged_kv=False)`` etc.) are still
accepted with a ``DeprecationWarning`` and mapped onto the groups, and
the old attribute reads (``ecfg.paged_kv``) resolve through deprecated
properties — see the migration note in ``docs/serving_api.md``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from ..configs.base import CodecCfg


@dataclasses.dataclass(frozen=True)
class PruneCfg:
    """ViT-side codec-guided token pruning (stage 2)."""

    # pruned P-frames: pack kept patch groups across frames/streams into
    # variable-capacity buffers (docs/vit_packing.md) instead of padding
    # every frame to the static K_sel capacity
    packed_vit: bool = True


@dataclasses.dataclass(frozen=True)
class RefreshCfg:
    """Refresh budgets of the dynamic-selection baselines (stage 3)."""

    cacheblend_ratio: float = 0.15   # refresh budget for the baseline
    vlcache_ratio: float = 0.15


@dataclasses.dataclass(frozen=True)
class KVCfg:
    """Per-stream KV storage strategy (stage 3, attention families)."""

    # reuse modes on attention families: per-stream KV lives in a shared
    # paged slab (core/kv_pool.py, docs/paged_kv.md) — fused windows
    # stage page tables instead of concatenating caches, stream churn
    # never copies KV.  ``pool_streams`` pins the pool capacity (in
    # streams); None sizes it from the scheduler's max_concurrent.
    paged_kv: bool = True
    pool_streams: Optional[int] = None
    # storage dtype for stale (overlap-carried, non-refreshed) pages:
    # "bf16" keeps the single-precision slab (the bitwise PR 7 control);
    # "int8" demotes pages the refresh selector has not rewritten for
    # ``demote_after`` windows into an int8 cold slab with per-page-
    # per-head scales (docs/paged_kv.md §Quantized cold pages), roughly
    # doubling pages-per-byte at fixed slab bytes.
    stale_page_dtype: str = "bf16"
    # windows a page must survive untouched before demotion (>= 1)
    demote_after: int = 1


@dataclasses.dataclass(frozen=True)
class SchedulerCfg:
    """Multi-stream scheduler: admission, batching, stage pipelining.

    ``pipelined=True`` (default, as in the JAX package) runs the
    stage-pipelined engine: codec windows sliced and their prune
    decisions made on ``ingest_workers`` host threads, per-stage groups
    formed from whatever is ready, every device stage dispatched on one
    CUDA stream and each group synced one tick after its dispatch.
    ``pipelined=False`` runs the lockstep engine: one fused group per
    step through ``serve_batch``, synced before the next.  Both give the
    same answers for the same groups.
    """

    max_concurrent: int = 8          # admitted sessions holding KV state
    max_batch: Optional[int] = None  # fused-group cap (None = max_concurrent)
    pipelined: bool = True
    # host threads slicing codec windows while the accelerator runs
    # earlier groups' encode/prefill (0 = slice inline on the main thread)
    ingest_workers: int = 2
    # windows a stream may run ahead through ingest+encode while its
    # previous window is still in prefill/decode (per-stream stage
    # queue depth; 0 disables lookahead)
    lookahead: int = 1


# ----------------------------------------------------------------------
# EngineCfg: grouped, with legacy flat-kwarg acceptance
# ----------------------------------------------------------------------
#: legacy flat kwarg/attribute -> (group field, field inside the group)
_LEGACY_FIELDS = {
    "packed_vit": ("prune", "packed_vit"),
    "cacheblend_ratio": ("refresh", "cacheblend_ratio"),
    "vlcache_ratio": ("refresh", "vlcache_ratio"),
    "paged_kv": ("kv", "paged_kv"),
    "pool_streams": ("kv", "pool_streams"),
}

_warned_attrs: set = set()


def _warn_legacy(name: str, group: str, kind: str) -> None:
    key = (name, kind)
    if key in _warned_attrs:
        return
    _warned_attrs.add(key)
    cls = {"prune": "PruneCfg", "refresh": "RefreshCfg", "kv": "KVCfg"}[group]
    warnings.warn(
        f"EngineCfg.{name} is deprecated; use the grouped field "
        f"EngineCfg.{group}.{name} (construct with "
        f"EngineCfg({group}={cls}({name}=...)))",
        DeprecationWarning,
        stacklevel=3,
    )


@dataclasses.dataclass(frozen=True, init=False)
class EngineCfg:
    mode: str = "codecflow"
    codec: CodecCfg = CodecCfg()
    max_new_tokens: int = 1
    q_chunk: int = 1024
    prune: PruneCfg = PruneCfg()
    refresh: RefreshCfg = RefreshCfg()
    kv: KVCfg = KVCfg()

    def __init__(
        self,
        mode: str = "codecflow",
        codec: CodecCfg = CodecCfg(),
        max_new_tokens: int = 1,
        q_chunk: int = 1024,
        prune: Optional[PruneCfg] = None,
        refresh: Optional[RefreshCfg] = None,
        kv: Optional[KVCfg] = None,
        **legacy,
    ):
        groups = {
            "prune": prune or PruneCfg(),
            "refresh": refresh or RefreshCfg(),
            "kv": kv or KVCfg(),
        }
        for name, val in legacy.items():
            if name not in _LEGACY_FIELDS:
                raise TypeError(
                    f"EngineCfg() got an unexpected keyword argument "
                    f"{name!r}"
                )
            group, field = _LEGACY_FIELDS[name]
            _warn_legacy(name, group, "kwarg")
            groups[group] = dataclasses.replace(groups[group], **{field: val})
        object.__setattr__(self, "mode", mode)
        object.__setattr__(self, "codec", codec)
        object.__setattr__(self, "max_new_tokens", max_new_tokens)
        object.__setattr__(self, "q_chunk", q_chunk)
        for name, val in groups.items():
            object.__setattr__(self, name, val)

    # -- deprecated flat attribute reads -------------------------------
    def __getattr__(self, name: str):
        # only reached for attributes NOT found normally (i.e. the
        # legacy flat names); keeps old call sites working with a
        # one-time DeprecationWarning per attribute.
        if name in _LEGACY_FIELDS:
            group, field = _LEGACY_FIELDS[name]
            _warn_legacy(name, group, "attr")
            return getattr(getattr(self, group), field)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )
