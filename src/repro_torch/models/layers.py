"""Layers of the serving path: RMSNorm, RoPE, GQA attention over the
paged KV slab, dense attention (ViT I-frames), SwiGLU MLP.

Functions take parameter dicts of tensors in the JAX package's layout:
weights are (in, out) and applied as ``x @ w``; attention tensors are
(B, S, H, D).  Attention reads go through ``kernels/ops.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelCfg
from ..kernels import ops
from ..kernels.ref import apply_rope_ref

NEG_INF = -1e30
F32 = torch.float32


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 math with an f32 scale, result in x's dtype."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].to(F32)).to(x.dtype)


class KVCache(NamedTuple):
    """KV storage of one attention position: a batchless paged slab
    (R, P_phys, n_kv, d_head), or one layer's (P_phys, n_kv, d_head)."""

    k: torch.Tensor
    v: torch.Tensor


def _qkv(p, cfg: ModelCfg, x: torch.Tensor, positions: torch.Tensor):
    """x (B, T, d) -> q (B, T, H, dh), k/v (B, T, K, dh), RoPE applied."""
    B, T, _ = x.shape
    dh = cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, T, cfg.n_heads, dh)
    k = k.reshape(B, T, cfg.n_kv, dh)
    v = v.reshape(B, T, cfg.n_kv, dh)
    q = apply_rope_ref(q, positions, cfg.rope_theta)
    k = apply_rope_ref(k, positions, cfg.rope_theta)
    return q, k, v


def mha(q, k, v, qpos, kpos, kvalid=None, *, causal: bool = True,
        window: Optional[int] = None, q_chunk: int = 1024) -> torch.Tensor:
    """Dense masked GQA attention, chunked over queries (plain PyTorch;
    the JAX package runs it outside Pallas too).

    q (B, Sq, H, dh); k, v (B, Sk, K, dh); qpos (B, Sq); kpos (B, Sk);
    kvalid (B, Sk) bool or None.
    """
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    scale = dh ** -0.5
    kf, vf = k.to(F32), v.to(F32)

    def block(qc, qpc):
        Tq = qc.shape[1]
        qq = (qc.to(F32) * scale).to(k.dtype).reshape(B, Tq, K, g, dh)
        logits = torch.einsum("btkgd,bskd->bkgts", qq.to(F32), kf)
        m = torch.ones((B, Tq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos[:, None, :] <= qpc[:, :, None]
        if window is not None:
            m &= kpos[:, None, :] > qpc[:, :, None] - window
        if kvalid is not None:
            m &= kvalid[:, None, :]
        logits = logits.masked_fill(~m[:, None, None], NEG_INF)
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bkgts,bskd->btkgd", p.to(F32), vf)
        return out.reshape(B, Tq, H, dh).to(q.dtype)

    outs = [block(q[:, i:i + q_chunk], qpos[:, i:i + q_chunk])
            for i in range(0, Sq, q_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attention_block(
    p,
    cfg: ModelCfg,
    x: torch.Tensor,
    positions: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    cache_offset: Optional[int] = None,
    cache_len: Optional[int] = None,
    scatter_idx: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    q_chunk: int = 1024,
    block_map=None,
    page_table: Optional[torch.Tensor] = None,
    page_size: int = 128,
) -> Tuple[torch.Tensor, KVCache]:
    """Attention over the paged KV slab (the JAX package's paged branch).

    ``cache`` is one layer's batchless slab (P_phys, n_kv, dh); this
    chunk's K/V are written in place at logical slots mapped through
    ``page_table`` (B, n_pages), then the chunk attends the stream's
    logical view of ``cache_len == n_pages * page_size`` slots through
    ``ops.flash_refresh_paged``.  Two write modes:

      * scatter (``scatter_idx`` (T,) positions): fresh prefill and
        selective refresh; ``kv_valid`` (B, S) is the full validity;
      * contiguous (``cache_offset``): decode; keys ``<= cache_offset +
        T - 1`` are visible (causal only, as in the JAX package).

    ``block_map`` is the visit list for the query positions; on the card
    the kernel needs it in both modes (decode passes a map built for its
    position).
    """
    if cache is None or page_table is None:
        raise NotImplementedError("only the paged attention path is ported")
    B, T, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    window = cfg.sliding_window
    S = cache_len
    if S is None or S != page_table.shape[1] * page_size:
        raise ValueError(f"cache_len {S} != n_pages * page ({page_table.shape}, {page_size})")
    dev = x.device
    if scatter_idx is not None:
        idx = scatter_idx.long()
    else:
        idx = cache_offset + torch.arange(T, device=dev)
    entries = page_table.long()[:, idx // page_size]            # (B, T)
    phys = entries * page_size + idx % page_size
    cache.k[phys] = k.to(cache.k.dtype)
    cache.v[phys] = v.to(cache.v.dtype)
    if scatter_idx is not None:
        kval = (kv_valid[:, :S] if kv_valid is not None
                else torch.ones((B, S), dtype=torch.bool, device=dev))
    else:
        kval = (torch.arange(S, device=dev) <= cache_offset + T - 1).expand(B, S)
        if kv_valid is not None:
            kval = kval & kv_valid[:, :S]
        if valid is not None:
            ones = torch.ones((B, S), dtype=torch.bool, device=dev)
            ones[:, cache_offset:cache_offset + T] = valid
            kval = kval & ones
        kval = kval.contiguous()
    out = ops.flash_refresh_paged(
        q, cache.k, cache.v, positions, kval, page_table, page=page_size,
        causal=causal, window=window, block_map=block_map, q_chunk=q_chunk,
    )
    out = out.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"]
    return out, cache


def mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x Wg) * x Wu) Wd."""
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
