"""Decoder-only transformer of the serving path (attention + dense FFN).

Parameters are the JAX package's tree with each pattern position's
layers stacked on a leading ``repeats`` axis; ``run_stack`` walks the
layers in a Python loop where the JAX package used ``lax.scan``, and
attention reads and writes the shared paged KV slab in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelCfg
from . import layers
from .layers import KVCache

F32 = torch.float32


class Caches(NamedTuple):
    """Per-pattern-position stacked caches (leading dim = repeats)."""

    blocks: Tuple[Any, ...]
    cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(cfg: ModelCfg, pos: int, p, h, positions, valid, cache,
                 cache_offset, cache_len, *, q_chunk, scatter_idx, kv_valid,
                 block_map, page_table, page_size):
    mixer, ffn = cfg.block_kind(pos)
    if mixer != "attn" or ffn != "dense" or cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: only attention + dense FFN stacks are ported")
    hn = layers.rmsnorm(p["ln1"], h, cfg.norm_eps)
    out, cache = layers.attention_block(
        p["mixer"], cfg, hn, positions, valid, cache=cache,
        cache_offset=cache_offset, cache_len=cache_len,
        scatter_idx=scatter_idx, kv_valid=kv_valid, q_chunk=q_chunk,
        block_map=block_map, page_table=page_table, page_size=page_size,
    )
    h = h + out
    hn = layers.rmsnorm(p["ln2"], h, cfg.norm_eps)
    return h + layers.mlp_block(p["ffn"], hn)


def run_stack(cfg: ModelCfg, params, h: torch.Tensor, positions: torch.Tensor,
              valid=None, caches: Optional[Caches] = None, cache_offset=None,
              cache_len: Optional[int] = None, *, q_chunk: int = 1024,
              scatter_idx=None, kv_valid=None, block_map=None,
              page_table=None, page_size: int = 128):
    """Run every layer over ``h``; the paged slab in ``caches`` is written
    in place.  Returns (h, caches)."""
    for i in range(cfg.repeats):
        for pos in range(cfg.period):
            blk = caches.blocks[pos]
            h = _apply_block(
                cfg, pos, layer_params(params["blocks"][pos], i), h, positions,
                valid, KVCache(blk.k[i], blk.v[i]), cache_offset, cache_len,
                q_chunk=q_chunk, scatter_idx=scatter_idx, kv_valid=kv_valid,
                block_map=block_map, page_table=page_table, page_size=page_size,
            )
    return h, caches


def embed_tokens(cfg: ModelCfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def lm_logits(cfg: ModelCfg, params, h: torch.Tensor) -> torch.Tensor:
    """f32 logits; tied to the embedding for ``tied_embeddings`` configs
    (the ``-smoke`` variants), ``lm_head`` otherwise."""
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return (h @ head).to(F32)


def decode_step(cfg: ModelCfg, params, token: torch.Tensor, caches: Caches,
                cur_len: int, page_table: torch.Tensor, cache_len: int,
                page_size: int = 128, block_map=None):
    """One paged decode step.  token (B, 1); ``cur_len`` is the new
    token's position and write slot.  ``block_map`` is the visit list of
    that one position (the kernel needs it on the card).  Returns
    (logits (B, V), caches)."""
    h = embed_tokens(cfg, params, token)
    B = h.shape[0]
    positions = torch.full((B, 1), cur_len, dtype=torch.int32, device=h.device)
    h, caches = run_stack(
        cfg, params, h, positions, None, caches, cache_offset=cur_len,
        cache_len=cache_len, page_table=page_table, page_size=page_size,
        block_map=block_map,
    )
    hn = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(cfg, params, hn[:, -1]), caches
