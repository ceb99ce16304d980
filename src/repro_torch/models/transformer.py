"""Decoder-only and encoder-decoder stacks: an attention or Mamba-2
mixer per block, then a dense SwiGLU, a token-choice MoE or no FFN
(dense and MoE transformers, the SSM family's mixer-only blocks, the
hybrid family's interleave of both mixers), and whisper's encoder and
cross-attending decoder.

Parameters are the JAX package's tree with each pattern position's
layers stacked on a leading ``repeats`` axis; ``run_stack`` walks the
layers in a Python loop where the JAX package used ``lax.scan``, each
layer a view of the stacked leaves (``unstack``: under autograd their
gradients meet in the stacked leaf's one gradient, as the scan's do).
Three paths share the block code, as in the JAX package:

  * ``forward_hidden`` / ``forward_train``: full-sequence attention, no
    cache (training; ``remat`` recomputes each layer in the backward);
  * ``prefill``: writes the caches; ``decode_step``: one token against
    them.  Caches are written in place: attention its KV (the shared
    paged slab, bf16 or two-precision, or per-stream caches), mamba its
    conv tail and SSD state; whisper's cross K/V ride in ``Caches.cross``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelCfg
from ..kernels.transfer import with_host
from ..sharding import ctx as shctx
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


def unstack(tree) -> list:
    """The layers of a stacked parameter tree as a list of trees of
    views, one ``unbind`` per leaf: under autograd the layers' gradients
    meet in one stack (indexing each layer apart would add a zero-filled
    copy of the whole leaf per layer)."""
    if isinstance(tree, dict):
        per = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _apply_block(cfg: ModelCfg, pos: int, p, h, positions, valid, cache,
                 cache_offset, cache_len, cross_kv, *, decode, q_chunk, scatter_idx,
                 kv_valid, block_map, page_table, page_size):
    """One block; returns (h, the MoE aux loss or None)."""
    mixer, ffn = cfg.block_kind(pos)
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
    if cfg.enc_dec and cross_kv is not None:
        hx = layers.rmsnorm(p["lnx"], h, cfg.norm_eps)
        h = h + layers.cross_attention_block(p["xattn"], cfg, hx, cross_kv)
    if ffn == "none":
        return h, None
    hn = layers.rmsnorm(p["ln2"], h, cfg.norm_eps)
    if ffn == "moe":
        out, aux = layers.moe_block(p["ffn"], cfg.moe, hn)
        return h + out, aux
    return h + layers.mlp_block(p["ffn"], hn), None


def run_stack(cfg: ModelCfg, params, h: torch.Tensor, positions: torch.Tensor,
              valid=None, caches: Optional[Caches] = None, cache_offset=None,
              cache_len: Optional[int] = None, *, decode: bool = False,
              q_chunk: int = 1024, remat: bool = False, scatter_idx=None,
              kv_valid=None, block_map=None, page_table=None, page_size: int = 128):
    """Run every layer over ``h``.  Returns (h, caches, aux): the caches
    (paged slab, per-stream KV, mamba state; a position whose cache is
    None, or ``caches`` None, runs uncached) are written in place, and
    ``aux`` is the MoE layers' Switch aux loss summed in layer order (f32,
    0 without MoE).  ``caches.cross`` (R, B, S_enc, K, dh) K and V feed
    whisper's cross-attention, layer by layer.  ``remat`` (under grad)
    recomputes each repeat of the pattern in the backward
    (``torch.utils.checkpoint``), as the JAX package's
    ``jax.checkpoint(..., nothing_saveable)`` of its scan body does;
    ``decode`` runs the mamba positions' one-token step."""
    R = cfg.repeats
    per_pos = [unstack(params["blocks"][pos]) for pos in range(cfg.period)]
    cross = caches.cross if caches is not None else None
    aux = torch.zeros((), dtype=F32, device=h.device)

    def body(i, h):
        if shctx.seq_sharding() and h.shape[1] > 1:
            # sequence-parallel layer boundary: the residual stream split
            # over (batch, seq), cutting what remat saves by the TP degree
            h = shctx.constrain(h, "batch", "model", None)
        auxes = []
        for pos in range(cfg.period):
            blk = caches.blocks[pos] if caches is not None else None
            lc = type(blk)(*(leaf[i] for leaf in blk)) if blk is not None else None
            h, a = _apply_block(
                cfg, pos, per_pos[pos][i], h, positions, valid, lc, cache_offset,
                cache_len, (cross[0][i], cross[1][i]) if cross is not None else None,
                decode=decode, q_chunk=q_chunk, scatter_idx=scatter_idx,
                kv_valid=kv_valid, block_map=block_map, page_table=page_table,
                page_size=page_size,
            )
            if a is not None:
                auxes.append(a)
        return h, tuple(auxes)

    for i in range(R):
        if remat and torch.is_grad_enabled():
            h, auxes = checkpoint(body, i, h, use_reentrant=False, preserve_rng_state=False)
        else:
            h, auxes = body(i, h)
        for a in auxes:                 # block by block, as the reference's scan adds
            aux = aux + a
    return h, caches, aux


def embed_tokens(cfg: ModelCfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embed_lookup(params["embed"], tokens)


def embed_inputs(cfg: ModelCfg, params, tokens: torch.Tensor, inputs_embeds=None,
                 embed_mask=None) -> torch.Tensor:
    """Token embeddings, replaced by ``inputs_embeds`` where ``embed_mask``
    (B, S) is true (everywhere without a mask)."""
    h = embed_tokens(cfg, params, tokens)
    if inputs_embeds is None:
        return h
    if embed_mask is None:
        return inputs_embeds.to(h.dtype)
    return torch.where(embed_mask[..., None], inputs_embeds.to(h.dtype), h)


HEAD_CHUNK = 16384   # vocab columns per f32 product on the CPU


def head_of(cfg: ModelCfg, params) -> torch.Tensor:
    """The (d, V) head: the embedding's transpose for ``tied_embeddings``
    configs (the ``-smoke`` variants), ``lm_head`` otherwise."""
    return params["embed"].T if cfg.tied_embeddings else params["lm_head"]


def lm_logits(cfg: ModelCfg, params, h: torch.Tensor) -> torch.Tensor:
    """f32 logits of ``h`` (B, d).  The head product keeps its f32 result
    (``layers.f32_matmul``), widened on the CPU a chunk of vocab columns
    at a time, never whole."""
    return layers.f32_matmul(h, head_of(cfg, params), HEAD_CHUNK)


def prefill(cfg: ModelCfg, params, tokens: torch.Tensor, caches: Caches,
            positions=None, valid=None, inputs_embeds=None, cache_offset: int = 0,
            *, embed_mask=None, q_chunk: int = 1024, block_map=None):
    """Contiguous prefill of ``tokens`` (or ``inputs_embeds`` where
    ``embed_mask``, everywhere without one) into the per-stream caches at
    ``cache_offset`` (mamba positions continue from their state; whisper
    attends ``caches.cross``).  ``block_map`` is the visit list of
    positions ``cache_offset + arange(S)`` (the attention kernel needs it
    on the card).  Returns (last-position logits (B, V), caches, h)."""
    h = embed_inputs(cfg, params, tokens, inputs_embeds, embed_mask)
    B, S, _ = h.shape
    if positions is None:
        positions = with_host(
            (torch.arange(S, dtype=torch.int32, device=h.device) + cache_offset)[None]
            .expand(B, S),
            np.broadcast_to(np.arange(S, dtype=np.int32) + cache_offset, (B, S)))
    h, caches, _ = run_stack(
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
    h, caches, _ = run_stack(
        cfg, params, h, positions, None, caches, cache_offset=cur_len,
        cache_len=cache_len, decode=True, page_table=page_table,
        page_size=page_size, block_map=block_map,
    )
    hn = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(cfg, params, hn[:, -1]), caches


# ======================================================================
# whisper's encoder, and the full-sequence (training) paths
# ======================================================================
def run_encoder(cfg: ModelCfg, params, feats: torch.Tensor, q_chunk: int = 1024,
                remat: bool = False) -> torch.Tensor:
    """feats (B, S_enc, d) stub frontend embeddings -> the encoder output:
    ``enc_embed``, then ``enc_layers`` bidirectional blocks (RoPE
    attention over every position, dense FFN), then ``enc_norm``."""
    h = feats.to(params["enc_embed"].dtype) @ params["enc_embed"]
    B, S, _ = h.shape
    pos = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)

    def body(lp, h):
        hn = layers.rmsnorm(lp["ln1"], h, cfg.norm_eps)
        out, _ = layers.attention_block(lp["mixer"], cfg, hn, pos, causal=False,
                                        q_chunk=q_chunk)
        h = h + out
        hn = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
        return h + layers.mlp_block(lp["ffn"], hn)

    for lp in unstack(params["encoder"]):
        if remat and torch.is_grad_enabled():
            h = checkpoint(body, lp, h, use_reentrant=False, preserve_rng_state=False)
        else:
            h = body(lp, h)
    return layers.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def build_cross_kv(cfg: ModelCfg, params, enc_out: torch.Tensor):
    """Every decoder layer's cross K/V of ``enc_out``, stacked:
    ((R, B, S_enc, K, dh), (R, B, S_enc, K, dh))."""
    kv = [layers.cross_attention_kv(lp, cfg, enc_out)
          for lp in unstack(params["blocks"][0]["xattn"])]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def _cross_only_caches(cfg: ModelCfg, cross) -> Caches:
    """No self-attention caches (the train path attends uncached), only
    the cross K/V."""
    return Caches(tuple(None for _ in range(cfg.period)), cross)


def forward_hidden(cfg: ModelCfg, params, tokens: torch.Tensor, inputs_embeds=None,
                   embed_mask=None, valid=None, enc_feats=None, *, q_chunk: int = 1024,
                   remat: bool = True):
    """Full-sequence forward up to the final norm (the head is left to
    the loss's chunked cross-entropy).  Returns (h (B, S, d), aux)."""
    h = embed_inputs(cfg, params, tokens, inputs_embeds, embed_mask)
    B, S, _ = h.shape
    pos = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
    caches = None
    if cfg.enc_dec:
        enc_out = run_encoder(cfg, params, enc_feats, q_chunk, remat=remat)
        caches = _cross_only_caches(cfg, build_cross_kv(cfg, params, enc_out))
    h, _, aux = run_stack(cfg, params, h, pos, valid, caches, q_chunk=q_chunk, remat=remat)
    return layers.rmsnorm(params["final_norm"], h, cfg.norm_eps), aux


def forward_train(cfg: ModelCfg, params, tokens: torch.Tensor, inputs_embeds=None,
                  embed_mask=None, valid=None, enc_feats=None, *, q_chunk: int = 1024,
                  remat: bool = True):
    """Full-sequence forward: (logits (B, S, V) f32, aux).  The logits
    exist whole: small models only (the train step goes through
    ``forward_hidden`` and the chunked cross-entropy).  The head product
    is rounded to the weights' dtype and then widened: the jitted JAX
    package rounds this (B, S, d) @ (d, V) product (its ``forward_train``
    logits are all bf16 values on the CPU), unlike the (B, d) one of
    ``lm_logits``."""
    h, aux = forward_hidden(cfg, params, tokens, inputs_embeds, embed_mask, valid,
                            enc_feats, q_chunk=q_chunk, remat=remat)
    return (h @ head_of(cfg, params)).to(F32), aux
