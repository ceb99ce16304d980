"""Decoder-only stacks of the serving path: an attention or Mamba-2
mixer per block, then a dense SwiGLU, a token-choice MoE or no FFN
(dense and MoE transformers, the SSM family's mixer-only blocks, and
the hybrid family's interleave of both mixers).

Parameters are the JAX package's tree with each pattern position's
layers stacked on a leading ``repeats`` axis; ``run_stack`` walks the
layers in a Python loop where the JAX package used ``lax.scan``.  Caches
are written in place: attention its KV (the shared paged slab, bf16 or
two-precision, or per-stream caches), mamba its conv tail and SSD state.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelCfg
from ..kernels.transfer import with_host
from . import layers
from .layers import KVCache, SSMCache

F32 = torch.float32


class Caches(NamedTuple):
    """Per-pattern-position stacked caches (leading dim = repeats)."""

    blocks: Tuple[Any, ...]
    cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def init_caches(cfg: ModelCfg, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cpu") -> Caches:
    """Zeroed caches for every pattern position: attention KV (R, batch,
    max_len, n_kv, d_head); mamba conv tails (R, batch, d_conv - 1,
    conv_dim) in ``dtype`` and SSD states (R, batch, H, P, N) f32."""
    R = cfg.repeats
    blocks = []
    for pos in range(cfg.period):
        if cfg.block_kind(pos)[0] == "attn":
            shape = (R, batch, max_len, cfg.n_kv, cfg.d_head)
            blocks.append(KVCache(torch.zeros(shape, dtype=dtype, device=device),
                                  torch.zeros(shape, dtype=dtype, device=device)))
        else:
            s = cfg.ssm
            conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
            blocks.append(SSMCache(
                torch.zeros((R, batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
                torch.zeros((R, batch, s.n_heads(cfg.d_model), s.head_dim, s.d_state),
                            dtype=F32, device=device)))
    return Caches(tuple(blocks), None)


def has_attention(cfg: ModelCfg) -> bool:
    return any(cfg.block_kind(pos)[0] == "attn" for pos in range(cfg.period))


def caches_max_len(cfg: ModelCfg, caches: Caches) -> Optional[int]:
    """Slots of the per-stream attention caches; None for a stack
    without attention."""
    for pos in range(cfg.period):
        if cfg.block_kind(pos)[0] == "attn":
            return caches.blocks[pos].k.shape[2]
    return None


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(cfg: ModelCfg, pos: int, p, h, positions, valid, cache,
                 cache_offset, cache_len, *, decode, q_chunk, scatter_idx, kv_valid,
                 block_map, page_table, page_size):
    mixer, ffn = cfg.block_kind(pos)
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder stack is not ported")
    hn = layers.rmsnorm(p["ln1"], h, cfg.norm_eps)
    if mixer == "attn":
        out, cache = layers.attention_block(
            p["mixer"], cfg, hn, positions, valid, cache=cache,
            cache_offset=cache_offset, cache_len=cache_len,
            scatter_idx=scatter_idx, kv_valid=kv_valid, q_chunk=q_chunk,
            block_map=block_map, page_table=page_table, page_size=page_size,
        )
    elif decode:
        out, cache = layers.mamba_decode(p["mixer"], cfg, hn, cache)
    else:
        out, cache = layers.mamba_block(p["mixer"], cfg, hn, cache)
    h = h + out
    if ffn == "none":
        return h
    hn = layers.rmsnorm(p["ln2"], h, cfg.norm_eps)
    if ffn == "moe":
        out, _ = layers.moe_block(p["ffn"], cfg.moe, hn)   # serving drops aux
        return h + out
    return h + layers.mlp_block(p["ffn"], hn)


def run_stack(cfg: ModelCfg, params, h: torch.Tensor, positions: torch.Tensor,
              valid=None, caches: Optional[Caches] = None, cache_offset=None,
              cache_len: Optional[int] = None, *, decode: bool = False,
              q_chunk: int = 1024, scatter_idx=None, kv_valid=None, block_map=None,
              page_table=None, page_size: int = 128):
    """Run every layer over ``h``; the caches (paged slab, per-stream KV,
    or mamba state) are written in place.  ``decode`` runs the mamba
    positions' one-token step.  Returns (h, caches): the MoE layers'
    Switch aux loss, which the JAX package sums as a third output, is
    dropped, since serving never reads it (training, which would, is not
    ported)."""
    for i in range(cfg.repeats):
        for pos in range(cfg.period):
            blk = caches.blocks[pos]
            h = _apply_block(
                cfg, pos, layer_params(params["blocks"][pos], i), h, positions,
                valid, type(blk)(*(leaf[i] for leaf in blk)), cache_offset, cache_len,
                decode=decode, q_chunk=q_chunk, scatter_idx=scatter_idx,
                kv_valid=kv_valid, block_map=block_map, page_table=page_table,
                page_size=page_size,
            )
    return h, caches


def embed_tokens(cfg: ModelCfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


HEAD_CHUNK = 16384   # vocab columns per f32 product on the CPU


def lm_logits(cfg: ModelCfg, params, h: torch.Tensor) -> torch.Tensor:
    """f32 logits; tied to the embedding for ``tied_embeddings`` configs
    (the ``-smoke`` variants), ``lm_head`` otherwise.  The head product
    keeps its f32 result (``layers.f32_matmul``), widened on the CPU a
    chunk of vocab columns at a time, never whole."""
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return layers.f32_matmul(h, head, HEAD_CHUNK)


def prefill(cfg: ModelCfg, params, tokens: torch.Tensor, caches: Caches,
            positions=None, valid=None, inputs_embeds=None, cache_offset: int = 0,
            *, q_chunk: int = 1024, block_map=None):
    """Contiguous prefill of ``tokens`` (or ``inputs_embeds``) into the
    per-stream caches at ``cache_offset`` (mamba positions continue from
    their state).  ``block_map`` is the visit list of positions
    ``cache_offset + arange(S)`` (the attention kernel needs it on the
    card).  Returns (last-position logits (B, V), caches, h)."""
    h = embed_tokens(cfg, params, tokens)
    if inputs_embeds is not None:
        h = inputs_embeds.to(h.dtype)
    B, S, _ = h.shape
    if positions is None:
        positions = with_host(
            (torch.arange(S, dtype=torch.int32, device=h.device) + cache_offset)[None]
            .expand(B, S),
            np.broadcast_to(np.arange(S, dtype=np.int32) + cache_offset, (B, S)))
    h, caches = run_stack(
        cfg, params, h, positions, valid, caches, cache_offset=cache_offset,
        cache_len=caches_max_len(cfg, caches), q_chunk=q_chunk, block_map=block_map,
    )
    hn = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(cfg, params, hn[:, -1]), caches, h


def decode_step(cfg: ModelCfg, params, token: torch.Tensor, caches: Caches,
                cur_len: int, page_table: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None, page_size: int = 128,
                block_map=None):
    """One decode step.  token (B, 1); ``cur_len`` is the new token's
    position and write slot.  With ``page_table``, ``caches`` is the
    shared slab and ``cache_len`` is mandatory; otherwise they are
    per-stream caches of ``caches_max_len`` slots.  ``block_map`` is the
    visit list of that one position (the kernel needs it on the card);
    a stack without attention needs neither.  Returns (logits (B, V),
    caches)."""
    h = embed_tokens(cfg, params, token)
    B = h.shape[0]
    positions = with_host(torch.full((B, 1), cur_len, dtype=torch.int32, device=h.device),
                          np.full((B, 1), cur_len, np.int32))
    if cache_len is None:
        if page_table is not None:
            raise ValueError("paged decode needs an explicit cache_len")
        cache_len = caches_max_len(cfg, caches)
    h, caches = run_stack(
        cfg, params, h, positions, None, caches, cache_offset=cur_len,
        cache_len=cache_len, decode=True, page_table=page_table,
        page_size=page_size, block_map=block_map,
    )
    hn = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(cfg, params, hn[:, -1]), caches
