"""Codec-guided core: motion analyzer -> token pruner -> KV reuse and
refresh geometry -> paged KV pool."""
from .motion import motion_mask, block_to_patch
from .pruning import (
    PACK_LEN_BUCKETS, PackPlan, PruneDecision, select_tokens,
    capacity_groups, pack_plan, group_mask,
)
from .kvc import (
    WindowLayout, refresh_block_map, reuse_caches, shift_cache, shift_valid,
)
from .kv_pool import (
    PAGE_SIZE, KVPool, PoolExhausted, demotable_pages, demote_pool_caches,
    logical_to_physical, reuse_pool_caches,
)

__all__ = [
    "motion_mask", "block_to_patch",
    "PACK_LEN_BUCKETS", "PackPlan", "PruneDecision", "select_tokens",
    "capacity_groups", "pack_plan", "group_mask",
    "WindowLayout", "refresh_block_map", "reuse_caches", "shift_cache",
    "shift_valid",
    "PAGE_SIZE", "KVPool", "PoolExhausted", "demotable_pages",
    "demote_pool_caches", "logical_to_physical", "reuse_pool_caches",
]
