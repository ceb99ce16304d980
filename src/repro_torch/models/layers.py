"""Layers of the serving and training paths: RMSNorm, RoPE, GQA
attention over the paged KV slab (bf16, or two-precision with int8 cold
pages), over per-stream caches or uncached (training, the whisper
encoder, ViT I-frames), whisper's cross-attention, SwiGLU MLP, the
token-choice MoE, and the Mamba-2 (SSD) mixer with its one-token decode
step.

Functions take parameter dicts of tensors in the JAX package's layout:
weights are (in, out) and applied as ``x @ w``; attention tensors are
(B, S, H, D).  Attention reads and the SSD scan go through
``kernels/ops.py``.

Under a mesh (``sharding.ctx``), parameters and activations are
DTensors: ``shctx.constrain`` marks the JAX package's tensor-parallel
cut points, and the ops DTensor has no strategy for (the MoE routing,
dispatch and combine, the f32-output products) or that cannot see a
DTensor (the kernel ops) run on local shards through ``shctx.local``.
Without a mesh both are no-ops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelCfg
from ..kernels import ops
from ..kernels.ref import apply_rope_ref, ssd_decode_ref
from ..kernels.transfer import host_of, nonzero, with_host
from ..sharding import ctx as shctx

NEG_INF = -1e30
F32 = torch.float32


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """emb (V, d) rows at ``tokens``.  Under a mesh, on local shards: each
    rank reads the tokens inside its slice of V (where 'vocab' splits it)
    and zero elsewhere, a partial sum with one non-zero term per token;
    the rows whole along d; tokens split as they are over the batch."""
    mesh = shctx.mesh_of(emb)
    if mesh is None:
        return emb[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    pe, pt, po, vocab = [], [], [], []
    for ax, pw, ptok in zip(mesh.mesh_dim_names, emb.placements,
                            shctx.replicated(tokens, mesh).placements):
        if pw == Shard(0):
            vocab.append(ax)
            pe.append(Shard(0)); pt.append(Replicate()); po.append(Partial())
        elif ptok == Shard(0):
            pe.append(Replicate()); pt.append(Shard(0)); po.append(Shard(0))
        else:
            pe.append(Replicate()); pt.append(Replicate()); po.append(Replicate())

    def local(e, t):
        i, n = shctx.coordinate(mesh, tuple(vocab))
        if n == 1:
            return e[t]
        V_l = e.shape[0]
        t = t - i * V_l
        inside = (t >= 0) & (t < V_l)
        return torch.where(inside[..., None], e[t.clamp(0, V_l - 1)],
                           torch.zeros((), dtype=e.dtype, device=e.device))

    return shctx.local(local, (tuple(po),), (tuple(pe), tuple(pt)), mesh)(emb, tokens)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 math with an f32 scale, result in x's dtype."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].to(F32)).to(x.dtype)


class KVCache(NamedTuple):
    """KV storage of one attention position: a batchless paged slab
    (R, P_phys, n_kv, d_head), per-stream caches (R, B, S, n_kv, d_head),
    or one layer of either."""

    k: torch.Tensor
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """Two-precision paged slab of one attention position (or one layer).

    Hot pages stay in the float dtype; cold (demoted) pages hold int8
    with one f32 scale per (page, kv head), ``value = int8 * scale``.
    Page ids share one space: an entry ``< n_hot`` rows into ``k``/``v``,
    an entry ``>= n_hot`` into ``k8``/``v8`` at ``entry - n_hot``.

      k, v:             ([R,] n_hot * page, n_kv, d_head) float
      k8, v8:           ([R,] n_cold * page, n_kv, d_head) int8
      k_scale, v_scale: ([R,] n_cold, n_kv) f32
    """

    k: torch.Tensor
    v: torch.Tensor
    k8: torch.Tensor
    v8: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


INT8_QMAX = 127.0


def page_quant_scale(vals: torch.Tensor, dims) -> torch.Tensor:
    """Symmetric int8 scale from the abs-max over ``dims``; all-zero
    pages get scale 1.0, so they round-trip to exact zeros."""
    amax = torch.amax(vals.to(F32).abs(), dim=dims)
    return torch.where(amax > 0, amax / INT8_QMAX, torch.ones_like(amax))


def quantize_kv(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """vals (..., n_kv, d_head) float; scale (..., n_kv) f32 -> int8,
    round half to even, saturating at +-127."""
    q = torch.round(vals.to(F32) / scale[..., None])
    return q.clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)


def dequantize_kv(vals: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 (..., n_kv, d_head) * f32 scale (..., n_kv), rounded through
    the hot dtype (the value the kernel's tile load produces)."""
    return (vals.to(F32) * scale[..., None]).to(dtype)


def _qkv(p, cfg: ModelCfg, x: torch.Tensor, positions: torch.Tensor):
    """x (B, T, d) -> q (B, T, H, dh), k/v (B, T, K, dh), RoPE applied."""
    B, T, _ = x.shape
    dh = cfg.d_head
    q = shctx.constrain(shctx.split_last(x @ p["wq"], cfg.n_heads, dh), "batch", None, "model",
                        None)
    k = shctx.constrain(shctx.split_last(x @ p["wk"], cfg.n_kv, dh), "batch", None, "model", None)
    v = shctx.constrain(shctx.split_last(x @ p["wv"], cfg.n_kv, dh), "batch", None, "model", None)
    if cfg.qkv_bias:
        # added after the constraint: under a mesh a product can leave
        # partial sums, and adding a split bias to them would ask DTensor
        # to make the bias partial, which it cannot
        q = q + shctx.split_last(p["bq"].to(q.dtype), cfg.n_heads, dh)
        k = k + shctx.split_last(p["bk"].to(k.dtype), cfg.n_kv, dh)
        v = v + shctx.split_last(p["bv"].to(v.dtype), cfg.n_kv, dh)
    q = apply_rope_ref(q, positions, cfg.rope_theta)
    k = apply_rope_ref(k, positions, cfg.rope_theta)
    return q, k, v


class _F32BatchProduct(torch.autograd.Function):
    """a @ b over a batch of bf16 matrices with the f32 result of one
    tensor-core GEMM (``bmm`` with ``out_dtype``), the dense ``mha``'s
    products on the card.  The backward's two products are such GEMMs
    too, on the incoming gradient rounded to the operands' dtype (exact
    for P V, whose output is rounded to bf16 after the product; the
    scores' gradient loses bits below bf16's), so neither direction
    makes an f32 copy of an operand."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = _bmm_f32(g, b.transpose(1, 2)).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = _bmm_f32(a.transpose(1, 2), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if shctx.is_dtensor(a):
        return _local_product(_bmm_f32, a, b, batched=True)
    return torch.bmm(a, b) if a.dtype == F32 else torch.bmm(a, b, out_dtype=F32)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if shctx.is_dtensor(x):
        return _local_product(_mm_f32, x, w, batched=False)
    return torch.mm(x, w, out_dtype=F32)


def _local_product(fn, a, b, *, batched: bool):
    """``fn(a, b)`` on local shards (DTensor has no strategy for a
    product with an f32 output): per mesh dim, a batched product keeps a
    shard of the batch dim on both operands and the output; a 2-D one
    keeps a's row shard, else b's column shard; every other dim whole."""
    from torch.distributed.tensor import Replicate, Shard
    pa, pb, po = [], [], []
    for da, db in zip(a.placements, b.placements):
        if batched and (da == Shard(0) or db == Shard(0)):
            pa.append(Shard(0)); pb.append(Shard(0)); po.append(Shard(0))
        elif not batched and da == Shard(0):
            pa.append(Shard(0)); pb.append(Replicate()); po.append(Shard(0))
        elif not batched and db == Shard(1):
            pa.append(Replicate()); pb.append(Shard(1)); po.append(Shard(1))
        else:
            pa.append(Replicate()); pb.append(Replicate()); po.append(Replicate())
    return shctx.local(fn, (tuple(po),), (tuple(pa), tuple(pb)), a.device_mesh)(a, b)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's path: a CUDA tensor, or a meta one
    (the dry run describes the card's program)."""
    return t.device.type in ("cuda", "meta")


def heads_local(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` for attention q (B, Sq, H, D) over k, v (B,
    Sk, K, D) and per-row tensors ``rows`` ((B, ...) or None).  Under a
    mesh it runs on local shards: split over batch where q's batch is,
    over heads where q's heads are (k and v by their own heads where K
    divides that axis, else whole, each rank then taking the kv heads its
    query heads read); the output is laid out as q.  Attention is
    independent per (row, head), so no collective runs inside.  ``fn``
    may flatten (H, D) into one dim: the output keeps q's split dims.
    Without a mesh, ``fn`` itself."""
    mesh = shctx.mesh_of(q, k, v)
    if mesh is None:
        return fn(q, k, v, *rows)
    from torch.distributed.tensor import Replicate, Shard
    H, K = q.shape[2], k.shape[2]
    pq, pk, pr, head_axis = [], [], [], None
    for ax, pl in zip(mesh.mesh_dim_names, q.placements):
        n = mesh.size(mesh.mesh_dim_names.index(ax))
        if pl == Shard(0):
            pq.append(Shard(0)); pk.append(Shard(0)); pr.append(Shard(0))
        elif pl == Shard(2) and head_axis is None:
            head_axis = ax
            pq.append(Shard(2)); pr.append(Replicate())
            pk.append(Shard(2) if K % n == 0 else Replicate())
        else:
            pq.append(Replicate()); pk.append(Replicate()); pr.append(Replicate())
    kv_whole = head_axis is not None and pk[mesh.mesh_dim_names.index(head_axis)] == Replicate()

    def local(q, k, v, *rows):
        if kv_whole:
            j, _ = shctx.coordinate(mesh, head_axis)
            g, H_l = H // K, q.shape[2]
            kv0, kv1 = j * H_l // g, (j * H_l + H_l - 1) // g + 1
            if H_l % (kv1 - kv0) or (j * H_l) % min(g, H_l):
                raise ValueError(f"{H_l} query heads per rank do not cover whole kv "
                                 f"groups of {g} (H {H}, K {K})")
            k, v = k[:, :, kv0:kv1], v[:, :, kv0:kv1]
        return fn(q, k, v, *rows)

    row_pl = tuple(None if r is None else tuple(pr) for r in rows)
    return shctx.local(local, (tuple(pq),), (tuple(pq), tuple(pk), tuple(pk)) + row_pl,
                       mesh)(q, k, v, *rows)


def mha(q, k, v, qpos, kpos, kvalid=None, *, causal: bool = True,
        window: Optional[int] = None, q_chunk: int = 1024) -> torch.Tensor:
    """Dense masked GQA attention, chunked over queries (plain PyTorch;
    the JAX package runs it outside Pallas too).

    q (B, Sq, H, dh); k, v (B, Sk, K, dh); qpos (B, Sq); kpos (B, Sk);
    kvalid (B, Sk) bool or None.

    Both products keep bf16 operands and an f32 result, as the reference
    does: on the card as batched tensor-core GEMMs (``_F32BatchProduct``)
    over one bf16 copy of K and V in (B * K, Sk, dh) order; on the CPU,
    which has no such GEMM, as f32 einsums of the widened operands (bf16
    products are exact in f32, so both give the same value).  On the meta
    device (the dry run) as on the card.
    """
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    scale = dh ** -0.5
    gemm = on_card(q)
    if gemm:
        kt = k.transpose(1, 2).reshape(B * K, Sk, dh).transpose(1, 2)
        vt = v.transpose(1, 2).reshape(B * K, Sk, dh)
    else:
        kf, vf = k.to(F32), v.to(F32)

    def block(qc, qpc):
        Tq = qc.shape[1]
        qq = (qc.to(F32) * scale).to(k.dtype).reshape(B, Tq, K, g, dh)
        if gemm:
            a = qq.permute(0, 2, 3, 1, 4).reshape(B * K, g * Tq, dh)
            logits = _F32BatchProduct.apply(a, kt).view(B, K, g, Tq, Sk)
        else:
            logits = torch.einsum("btkgd,bskd->bkgts", qq.to(F32), kf)
        m = torch.ones((B, Tq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos[:, None, :] <= qpc[:, :, None]
        if window is not None:
            m &= kpos[:, None, :] > qpc[:, :, None] - window
        if kvalid is not None:
            m &= kvalid[:, None, :]
        logits = logits.masked_fill(~m[:, None, None], NEG_INF)
        p = torch.softmax(logits, dim=-1)
        del logits
        p = p.to(v.dtype)
        if gemm:
            out = _F32BatchProduct.apply(p.view(B * K, g * Tq, Sk), vt)
            out = out.view(B, K, g, Tq, dh).permute(0, 3, 1, 2, 4).to(q.dtype)
            return out.reshape(B, Tq, H, dh)
        out = torch.einsum("bkgts,bskd->btkgd", p.to(F32), vf)
        return out.reshape(B, Tq, H, dh).to(q.dtype)

    outs = [block(q[:, i:i + q_chunk], qpos[:, i:i + q_chunk])
            for i in range(0, Sq, q_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _precision_split(page_table, idx, entries, n_hot: int, page_size: int):
    """(stream, token) indices of a two-precision write's hot and of its
    cold rows.  Found on the host twins of the page table and ``idx``
    where both have one, once per table and index list (the layers of one
    pass share them); else by ``torch.nonzero``, which syncs."""
    pt_h, idx_h = host_of(page_table), host_of(idx)
    if pt_h is None or idx_h is None:
        is_cold = entries >= n_hot
        return torch.nonzero(~is_cold, as_tuple=True), torch.nonzero(is_cold, as_tuple=True)
    memo = page_table.__dict__.setdefault("_cs_split", {})
    key = (idx_h.tobytes(), n_hot)
    if key not in memo:
        cold = pt_h[:, idx_h // page_size] >= n_hot
        memo[key] = (nonzero(~cold, idx.device), nonzero(cold, idx.device))
    return memo[key]


def _paged_write(cache, k, v, page_table, idx, page_size: int):
    """Write this chunk's K/V at logical slots ``idx`` (T,) of every
    stream, in place, through the page tables.  On a two-precision slab
    each token goes to its page's precision: hot rows as they are, cold
    rows quantised with the page's current scale (no row outside either
    slab is touched)."""
    entries = page_table.long()[:, idx // page_size]            # (B, T)
    slot = idx % page_size
    if not isinstance(cache, QuantKVCache):
        phys = entries * page_size + slot
        cache.k[phys] = k.to(cache.k.dtype)
        cache.v[phys] = v.to(cache.v.dtype)
        return
    n_hot = cache.k.shape[0] // page_size
    (hb, ht), (cb, ct) = _precision_split(page_table, idx, entries, n_hot, page_size)
    phys = entries[hb, ht] * page_size + slot[ht]
    cache.k[phys] = k[hb, ht].to(cache.k.dtype)
    cache.v[phys] = v[hb, ht].to(cache.v.dtype)
    cold_pg = entries[cb, ct] - n_hot
    rows = cold_pg * page_size + slot[ct]
    cache.k8[rows] = quantize_kv(k[cb, ct], cache.k_scale[cold_pg])
    cache.v8[rows] = quantize_kv(v[cb, ct], cache.v_scale[cold_pg])


def attention_block(
    p,
    cfg: ModelCfg,
    x: torch.Tensor,
    positions: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    cache=None,
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
) -> Tuple[torch.Tensor, object]:
    """The JAX package's ``attention_block``.

    Without a cache: self-attention over ``x`` by the dense ``mha``
    (training, the whisper encoder with ``causal=False``), masked by
    ``causal``, the config's sliding window and ``valid`` (B, T); returns
    (out, None).  With a cache this chunk's K/V are written in place,
    then the chunk attends the cache.  Two write modes:

      * scatter (``scatter_idx`` (T,) positions): fresh prefill and
        selective refresh; ``kv_valid`` (B, S) is the full validity;
      * contiguous (``cache_offset``): decode and the per-stream fresh
        prefill; keys ``<= cache_offset + T - 1`` are visible, and
        ``valid`` (B, T) masks this chunk's own slots.

    Paged (``page_table`` (B, n_pages)): ``cache`` is one layer's
    batchless slab, a ``KVCache`` or a two-precision ``QuantKVCache``
    whose cold group rides to ``ops.flash_refresh_paged``;
    ``cache_len`` must equal ``n_pages * page_size``.  Per-stream
    (no page table): ``cache`` holds (B, S_max, n_kv, dh) caches and the
    chunk attends their first ``cache_len`` slots (all by default)
    through ``ops.flash_refresh``.

    ``block_map`` is the visit list for the query positions; on the card
    the kernels need it in every mode (decode and the contiguous fresh
    prefill pass maps built for their positions).
    """
    B, T, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    window = cfg.sliding_window
    if cache is None:
        out = heads_local(lambda q, k, v, pos, val: mha(
            q, k, v, pos, pos, val, causal=causal, window=window, q_chunk=q_chunk).flatten(2),
            q, k, v, positions, valid)
        return out @ p["wo"], None
    if shctx.mesh_of(cache.k) is not None:
        return _attend_sharded_cache(p, cfg, q, k, v, positions, valid, cache,
                                     cache_offset, cache_len, page_table, scatter_idx,
                                     kv_valid, causal=causal, q_chunk=q_chunk)
    dev = x.device
    if page_table is not None:
        S = cache_len
        if S is None or S != page_table.shape[1] * page_size:
            raise ValueError(
                f"cache_len {S} != n_pages * page ({page_table.shape}, {page_size})")
    else:
        S = cache_len if cache_len is not None else cache.k.shape[1]
    if scatter_idx is not None:
        idx = scatter_idx.long()
    else:
        idx = with_host(cache_offset + torch.arange(T, device=dev),
                        cache_offset + np.arange(T))
    if page_table is not None:
        _paged_write(cache, k, v, page_table, idx, page_size)
    elif scatter_idx is not None:
        cache.k[:, idx] = k.to(cache.k.dtype)
        cache.v[:, idx] = v.to(cache.v.dtype)
    else:
        cache.k[:, cache_offset:cache_offset + T] = k.to(cache.k.dtype)
        cache.v[:, cache_offset:cache_offset + T] = v.to(cache.v.dtype)
    if scatter_idx is not None:
        if kv_valid is not None:
            kval = kv_valid[:, :S]
        elif page_table is not None:
            kval = torch.ones((B, S), dtype=torch.bool, device=dev)
        else:
            kval = None
    else:
        kval = (torch.arange(S, device=dev) <= cache_offset + T - 1).expand(B, S)
        if kv_valid is not None:
            kval = kval & kv_valid[:, :S]
        if valid is not None:
            ones = torch.ones((B, S), dtype=torch.bool, device=dev)
            ones[:, cache_offset:cache_offset + T] = valid
            kval = kval & ones
        kval = kval.contiguous()
    if page_table is not None:
        cold = (cache.k8, cache.v8, cache.k_scale, cache.v_scale) \
            if isinstance(cache, QuantKVCache) else None
        out = ops.flash_refresh_paged(
            q, cache.k, cache.v, positions, kval, page_table, page=page_size,
            causal=causal, window=window, block_map=block_map, q_chunk=q_chunk,
            cold=cold,
        )
    else:
        out = ops.flash_refresh(
            q, cache.k[:, :S], cache.v[:, :S], positions, kval, causal=causal,
            window=window, block_map=block_map, q_chunk=q_chunk,
        )
    out = out.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"]
    return out, cache


def _write_local(dst, src, offset: int) -> None:
    """dst[:, offset:offset + T] = src for DTensors dst (B, S, ...) and src
    (B, T, ...), written into dst's local shard: src is laid out as dst
    (whole along the sequence), and where dst's sequence is split each
    rank writes the part that falls in its range."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in dst.placements]
    part = src.redistribute(mesh, pl).to_local()
    lo, S_l = 0, dst.shape[1]
    for ax, p in zip(mesh.mesh_dim_names, dst.placements):
        if p == Shard(1):
            i, n = shctx.coordinate(mesh, ax)
            S_l = dst.shape[1] // n
            lo = i * S_l
    a, b = max(offset, lo), min(offset + part.shape[1], lo + S_l)
    if a < b:
        dst.to_local()[:, a - lo:b - lo] = part[:, a - offset:b - offset].to(dst.dtype)


def _attend_sharded_cache(p, cfg, q, k, v, positions, valid, cache, cache_offset,
                          cache_len, page_table, scatter_idx, kv_valid, *, causal, q_chunk):
    """The cached attention on a mesh (the dry run's prefill and decode):
    this chunk's K/V written contiguously at ``cache_offset`` into each
    rank's shard of the per-stream caches, then ``ops.flash_refresh`` on
    local shards (``heads_local``), the caches gathered whole along what
    the query heads need."""
    if page_table is not None or scatter_idx is not None:
        raise ValueError("on a mesh the caches are per-stream and written contiguously "
                         "(prefill, decode)")
    B, T = q.shape[:2]
    S = cache_len if cache_len is not None else cache.k.shape[1]
    _write_local(cache.k, k, cache_offset)
    _write_local(cache.v, v, cache_offset)
    kval = (torch.arange(S, device=q.device) <= cache_offset + T - 1).expand(B, S)
    if kv_valid is not None:
        kval = kval & kv_valid[:, :S]
    if valid is not None:
        ones = torch.ones((B, S), dtype=torch.bool, device=q.device)
        ones[:, cache_offset:cache_offset + T] = valid
        kval = kval & ones
    out = heads_local(lambda q, k, v, pos, kv: ops.flash_refresh(
        q, k, v, pos, kv, causal=causal, window=cfg.sliding_window,
        q_chunk=q_chunk).flatten(2),
        q, cache.k[:, :S], cache.v[:, :S], positions, kval.contiguous())
    return out @ p["wo"], cache


def cross_attention_block(p, cfg: ModelCfg, x: torch.Tensor, enc_kv) -> torch.Tensor:
    """Whisper's decoder cross-attention: x (B, T, d) against the
    precomputed encoder (k, v) (B, S_enc, K, dh); no RoPE, no mask."""
    B, T, _ = x.shape
    dh = cfg.d_head
    q = shctx.split_last(x @ p["wq"], cfg.n_heads, dh)
    k, v = enc_kv
    qpos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=x.device)
    out = heads_local(lambda q, k, v, qp, kp: mha(q, k, v, qp, kp, causal=False).flatten(2),
                      q, k, v, qpos, kpos)
    return out @ p["wo"]


def cross_attention_kv(p, cfg: ModelCfg, enc_out: torch.Tensor):
    """The encoder output's cross K/V of one decoder layer: (B, S, K, dh) each."""
    B, S, _ = enc_out.shape
    k = shctx.split_last(enc_out @ p["wk"], cfg.n_kv, cfg.d_head)
    v = shctx.split_last(enc_out @ p["wv"], cfg.n_kv, cfg.d_head)
    return k, v


def mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x Wg) * x Wu) Wd."""
    hidden = F.silu(x @ p["wg"]) * (x @ p["wu"])
    hidden = shctx.constrain(hidden, *(("batch",) + (None,) * (hidden.ndim - 2) + ("model",)))
    return hidden @ p["wd"]


# ======================================================================
# Mixture of Experts (token-choice top-k, static capacity)
# ======================================================================
class _F32Product(torch.autograd.Function):
    """x @ w (2-D) with the f32 result of one GEMM on the card; the
    backward's two products take the f32 gradient against the other
    operand widened to f32, as the CPU path's autograd does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g @ w.to(F32).T).to(x.dtype) if ctx.needs_input_grad[0] else None
        gw = (x.to(F32).T @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def f32_matmul(x: torch.Tensor, w: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """x (..., d) @ w (d, n) keeping the f32 result of the bf16 product,
    as the jitted JAX package does (XLA does not round ``(x @ w).astype(F32)``
    to bf16).  On the card one GEMM with an f32 output (``_F32Product``,
    differentiable).  On the CPU, which has no such GEMM, bf16 products
    are exact in f32, so the f32 product of the bf16 operands is the same
    value; ``chunk`` columns of w are widened at a time where w is large."""
    if on_card(x):
        lead = x.shape[:-1]
        return _F32Product.apply(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[1])
    xf, n = x.to(F32), w.shape[1]
    step = chunk or n
    return torch.cat([xf @ w[:, i:i + step].to(F32) for i in range(0, n, step)], dim=-1)


def top_k_lower_first(gates: torch.Tensor, k: int):
    """(values, indices) of each row's k largest gates, a tie going to the
    lower expert id as in ``jax.lax.top_k`` (a stable descending sort)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class MoERoute(NamedTuple):
    """Routing of n rows over E experts (assignments in sorted order)."""

    gates: torch.Tensor    # (n, E) f32 router softmax
    topw: torch.Tensor     # (n, k) f32 renormalised gate of each choice
    tope: torch.Tensor     # (n, k) expert ids, highest gate first
    order: torch.Tensor    # (n * k,) flat (token * k + j) ids sorted by expert, stable
    slot: torch.Tensor     # (n * k,) buffer row of each sorted assignment
    keep: torch.Tensor     # (n * k,) bool: within its expert's capacity
    cap: int
    aux: torch.Tensor      # () f32 Switch load-balance loss


def moe_route(p, cfg, x2: torch.Tensor) -> MoERoute:
    """The JAX package's ``moe_block`` routing over x2 (n, d): softmax of
    the router product's f32 result (a rounded product would move the
    choices), top-k renormalised with a 1e-9 floor, the Switch aux loss, and
    static capacity ``cap = int(capacity_factor * n * k / E) + 1`` taken
    in token order (a stable sort on the expert id).  Under a mesh the
    gates are gathered and every rank routes all n rows (the sort is
    global); the route's tensors are replicated."""
    n = x2.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    gates = torch.softmax(f32_matmul(x2, p["router"]), dim=-1)
    cap = int(cfg.capacity_factor * n * k / E) + 1
    mesh = shctx.mesh_of(gates)
    rep = shctx.whole(mesh)
    route = shctx.local(lambda g: _route(cfg, cap, g), (rep,) * 6, (rep,), mesh)(gates)
    return MoERoute(gates, *route[:5], cap, route[5])


def _route(cfg, cap: int, gates: torch.Tensor):
    """(topw, tope, order, slot, keep, aux) of the gates (n, E)."""
    n = gates.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    dev = gates.device
    topw, tope = top_k_lower_first(gates, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = tope.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    aux = E * torch.sum(counts.to(F32) / (n * k) * gates.mean(0))
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = torch.arange(n * k, device=dev) - (torch.cumsum(counts, 0) - counts)[se]
    keep = pos < cap
    slot = se * cap + torch.where(keep, pos, cap - 1)
    return topw, tope, order, slot, keep, aux


def _sorted_rows(order: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """(n, k): the sorted-order row of each token's k assignments,
    ascending (the order the reference's scatter-add meets them)."""
    where_sorted = torch.empty_like(order)
    where_sorted[order] = torch.arange(n * k, device=order.device)
    return torch.sort(where_sorted.view(n, k), dim=1).values


def _sum_choices(ys: torch.Tensor) -> torch.Tensor:
    """(n, k, d) -> (n, d): from zero, in ascending k, in ys' dtype."""
    out = torch.zeros((ys.shape[0], ys.shape[2]), dtype=ys.dtype, device=ys.device)
    for j in range(ys.shape[1]):
        out = out + ys[:, j]
    return out


def combine_sorted(y: torch.Tensor, order: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Each token's sum of its k rows of y (n * k, d), given in sorted
    assignment order (``order[i]`` is the flat token * k + j id of row i):
    in y's dtype, from zero, in ascending row order, which is the order in
    which the reference's scatter-add ``zeros.at[token].add(y)`` meets
    them.  A fixed order of plain adds: the same result on every run."""
    return _sum_choices(y[_sorted_rows(order, n, k)])


class _Block(NamedTuple):
    """A rank's share of the MoE on a mesh: token rows [t0, t0 + n_l) of
    n and experts [e0, e0 + E_l) of E."""

    t0: int
    n_l: int
    n: int
    e0: int
    E_l: int
    E: int


def _dispatch(cap: int, k: int, blk: _Block, x2, order, slot, keep):
    """The (E_l, cap, d) buffer of this rank's experts holding its own
    token rows x2 (n_l, d) at their slots (zeros elsewhere); dropped
    assignments, and others' rows, go to a scratch row."""
    d = x2.shape[1]
    st = torch.div(order, k, rounding_mode="floor")             # token of each
    se = torch.div(slot, cap, rounding_mode="floor")
    mine = (keep & (st >= blk.t0) & (st < blk.t0 + blk.n_l)
            & (se >= blk.e0) & (se < blk.e0 + blk.E_l))
    st = (st - blk.t0).clamp(0, blk.n_l - 1)
    rows = blk.E_l * cap
    buf = torch.zeros((rows + 1, d), dtype=x2.dtype, device=x2.device)
    buf[torch.where(mine, slot - blk.e0 * cap, rows)] = x2[st]
    return buf[:rows].view(blk.E_l, cap, d)


def _combine(cap: int, k: int, blk: _Block, out_e, topw, order, slot, keep):
    """This rank's tokens' sums (n_l, d) of their k expert outputs that
    come from its experts, in ``combine_sorted``'s order; ``out_e``
    (E_l, cap, d) holds every slot of those experts."""
    d = out_e.shape[2]
    sw = topw.reshape(-1).to(out_e.dtype)[order]
    se = torch.div(slot, cap, rounding_mode="floor")
    ours = (se >= blk.e0) & (se < blk.e0 + blk.E_l)
    slot = torch.where(ours, slot - blk.e0 * cap, 0)
    w = torch.where(keep & ours, sw, 0)
    rows = _sorted_rows(order, blk.n, k)[blk.t0:blk.t0 + blk.n_l]   # (n_l, k)
    ys = out_e.reshape(blk.E_l * cap, d)[slot[rows]] * w[rows][..., None]
    return _sum_choices(ys)


def moe_block(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with static capacity, the JAX package's
    ``moe_block``: x (B, T, d) -> (out (B, T, d), Switch aux loss f32).

    Every one of the n = B * T rows is routed (``moe_route``), padded
    rows included; assignments past an expert's capacity are dropped and
    add zero.  A token's k expert outputs are summed in bf16 in ascending
    expert order, the order of the reference's scatter-add over the
    sorted assignments, so the sum is the same on every run (no
    atomics).  No host sync: drops are written to a scratch row of the
    dispatch buffer.  The expert products are plain batched GEMMs, as
    the reference's einsums are.  A DTensor ``x`` takes
    ``_moe_block_on_mesh``.
    """
    if shctx.is_dtensor(x):
        return _moe_block_on_mesh(p, cfg, x)
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = B * T
    x2 = x.reshape(n, d)
    r = moe_route(p, cfg, x2)
    cap = r.cap
    st = torch.div(r.order, k, rounding_mode="floor")             # token of each
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(r.keep, r.slot, E * cap)] = x2[st]
    buf = buf[:E * cap].view(E, cap, d)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    out_e = torch.bmm(h, p["wd"]).view(E * cap, d)
    sw = r.topw.reshape(-1).to(x.dtype)[r.order]
    y = out_e[r.slot] * torch.where(r.keep, sw, 0)[:, None]       # sorted order
    out = combine_sorted(y, r.order, n, k)
    if "residual" in p:
        out = out + mlp_block(p["residual"], x2)
    return out.reshape(B, T, d), r.aux


def _moe_block_on_mesh(p, cfg, x):
    """``moe_block`` expert-parallel, at the reference's cut points: each
    rank routes every row, writes its own token rows into the buffer of
    its experts (a partial sum over the batch axes: the constraint to
    (experts on 'model', slots on the batch axes) reduce-scatters it),
    the experts run on that layout, and each rank sums its tokens'
    outputs from its experts (a partial sum over 'model', reduced by the
    last constraint).  The same values as ``moe_block``'s on a 1x1 mesh."""
    B, T, d = x.shape
    n = B * T
    x2 = shctx.constrain(x.reshape(n, d), "batch", None)
    r = moe_route(p, cfg, x2)
    share = _MoEShare(shctx.mesh_of(x2), n, cfg.n_experts)
    buf = shctx.constrain(share.dispatch(r.cap, cfg.top_k, x2, r), "model", "batch", None)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    h = shctx.constrain(h, "model", "batch", None)
    out = share.combine(r.cap, cfg.top_k, torch.bmm(h, p["wd"]), r)
    out = shctx.constrain(out, "batch", None)
    if "residual" in p:
        out = out + mlp_block(p["residual"], x2)
    return out.reshape(B, T, d), r.aux


class _MoEShare:
    """The MoE's layout on a mesh: token rows split over the batch axes
    (where they divide), experts over 'model' (where they divide)."""

    def __init__(self, mesh, n: int, E: int):
        from torch.distributed.tensor import Partial, Replicate, Shard
        self.mesh, self.n, self.E = mesh, n, E
        self.rows = shctx.resolve((n,), ("batch",), mesh)[0]
        self.experts = shctx.resolve((E,), ("model",), mesh)[0]
        row_axes = shctx.axes_of(self.rows)
        rows, self.buf, self.exp, self.out = [], [], [], []
        for ax in mesh.mesh_dim_names:
            by_rows, by_exp = ax in row_axes, ax == self.experts
            rows.append(Shard(0) if by_rows else Replicate())
            # the buffer: each rank's rows summed over the batch axes
            self.buf.append(Partial() if by_rows else Shard(0) if by_exp else Replicate())
            self.exp.append(Shard(0) if by_exp else Replicate())
            # the combine: each rank's experts' share summed over 'model'
            self.out.append(Shard(0) if by_rows else Partial() if by_exp else Replicate())
        self.x = tuple(rows)
        self.rep = shctx.whole(mesh)

    def block(self) -> _Block:
        ti, tn = shctx.coordinate(self.mesh, self.rows)
        ei, en = shctx.coordinate(self.mesh, self.experts)
        n_l, E_l = self.n // tn, self.E // en
        return _Block(ti * n_l, n_l, self.n, ei * E_l, E_l, self.E)

    def dispatch(self, cap: int, k: int, x2, r: MoERoute):
        """``_dispatch`` of each rank's own rows into its experts' block."""
        fn = lambda xl, order, slot, keep: _dispatch(cap, k, self.block(), xl, order, slot, keep)
        return shctx.local(fn, (tuple(self.buf),), (self.x, self.rep, self.rep, self.rep),
                           self.mesh)(x2, r.order, r.slot, r.keep)

    def combine(self, cap: int, k: int, out_e, r: MoERoute):
        """``_combine`` of each rank's rows from its experts' outputs,
        gathered whole over the batch axes."""
        fn = lambda oe, topw, order, slot, keep: _combine(cap, k, self.block(), oe, topw,
                                                          order, slot, keep)
        return shctx.local(fn, (tuple(self.out),),
                           (tuple(self.exp), self.rep, self.rep, self.rep, self.rep),
                           self.mesh)(out_e, r.topw, r.order, r.slot, r.keep)


# ======================================================================
# Mamba-2 (SSD) mixer
# ======================================================================
class SSMCache(NamedTuple):
    """Recurrent state of one mamba position (or one layer of it): the
    causal conv's last d_conv - 1 inputs and the SSD state."""

    conv: torch.Tensor   # ([R,] B, d_conv - 1, conv_dim), storage dtype
    ssm: torch.Tensor    # ([R,] B, H, P, N) f32


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor]):
    """Depthwise causal conv by shifted adds in f32, SiLU, cast to x's
    dtype.  x (B, T, C); w (K, C); tail (B, K - 1, C) or None (zeros).
    Returns (out, the new tail)."""
    K = w.shape[0]
    if tail is None:
        # K - 1 zero steps in x's own layout, by cat: under a mesh x is a
        # DTensor, and DTensor 2.11 fails to place F.pad's output on the
        # (16, 16) mesh (the training dry run of the hybrid family)
        tail = torch.zeros_like(x[:, :1])
        xp = torch.cat([tail] * (K - 1) + [x], dim=1)
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    T = x.shape[1]
    acc = torch.zeros(x.shape, dtype=F32, device=x.device) + b.to(F32)
    for i in range(K):
        acc = acc + xp[:, i:i + T].to(F32) * w[i].to(F32)
    new_tail = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(acc).to(x.dtype), new_tail


def _gated_norm(p, cfg: ModelCfg, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm in f32: y * silu(z), normalised, times p["norm"]."""
    y = y * F.silu(z.to(F32))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + cfg.norm_eps) * p["norm"].to(F32)


def scan_local(fn, x, log_a, b, c, init=None):
    """``fn(x, log_a, b, c, init)`` -> (y, state) for the SSD scan: x (B,
    L, H, P), log_a (B, L, H), b/c (B, L, G, N), init (B, H, P, N) or
    None.  Under a mesh it runs on local shards: batch over the batch
    axes where x's is split, heads over 'model' where they divide it
    (b/c by groups where G divides too, else whole, each rank taking
    its heads' groups); y and the state come out laid out the same way.
    Without a mesh, ``fn`` itself."""
    mesh = shctx.mesh_of(x, log_a, b, c, init)
    if mesh is None:
        return fn(x, log_a, b, c, init)
    from torch.distributed.tensor import Replicate, Shard
    H, G = x.shape[2], b.shape[2]
    batch = shctx.axes_of(shctx.resolve(x.shape, ("batch",), mesh)[0])
    heads = shctx.resolve((H,), ("model",), mesh)[0]
    px, pa, pb, ps = [], [], [], []
    for ax in mesh.mesh_dim_names:
        n = mesh.size(mesh.mesh_dim_names.index(ax))
        if ax in batch:
            px.append(Shard(0)); pa.append(Shard(0)); pb.append(Shard(0)); ps.append(Shard(0))
        elif ax == heads:
            px.append(Shard(2)); pa.append(Shard(2)); ps.append(Shard(1))
            pb.append(Shard(2) if G % n == 0 else Replicate())
        else:
            for lst in (px, pa, pb, ps):
                lst.append(Replicate())
    groups_whole = heads is not None and G % mesh.size(mesh.mesh_dim_names.index(heads))

    def local(x, log_a, b, c, init):
        if groups_whole:
            j, _ = shctx.coordinate(mesh, heads)
            H_l, per = x.shape[2], H // G
            g0, g1 = j * H_l // per, (j * H_l + H_l - 1) // per + 1
            b, c = b[:, :, g0:g1], c[:, :, g0:g1]
        return fn(x, log_a, b, c, init)

    px, pa, pb, ps = tuple(px), tuple(pa), tuple(pb), tuple(ps)
    return shctx.local(local, (px, ps), (px, pa, pb, pb, None if init is None else ps),
                       mesh)(x, log_a, b, c, init)


def mamba_block(p, cfg: ModelCfg, x: torch.Tensor,
                cache: Optional[SSMCache] = None) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Mamba-2 mixer over a chunk.  x (B, T, d).  With ``cache`` (one
    layer's conv tail and state) the chunk continues from it and the
    cache is updated in place; returns (out (B, T, d), cache)."""
    s = cfg.ssm
    B, T, d = x.shape
    di, nh, P = s.d_inner(d), s.n_heads(d), s.head_dim
    gn = s.n_groups * s.d_state

    zxbcdt = shctx.constrain(x @ p["in_proj"], "batch", None, "model")
    z, xin, bc, dt = torch.split(zxbcdt, [di, di, 2 * gn, nh], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, new_tail = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      cache.conv if cache is not None else None)
    xin, b, c = torch.split(conv_out, [di, gn, gn], dim=-1)

    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))                # (B, T, nh)
    A = -torch.exp(p["A_log"].to(F32))
    log_a = dt * A[None, None, :]
    xh = shctx.split_last(xin.to(F32) * dt.repeat_interleave(P, dim=-1), nh, P)
    bg = shctx.split_last(b, s.n_groups, s.d_state)
    cg = shctx.split_last(c, s.n_groups, s.d_state)

    y, final_state = scan_local(
        lambda *a: ops.ssd_scan(*a, chunk=s.chunk),
        xh.to(x.dtype), log_a, bg.to(x.dtype), cg.to(x.dtype),
        cache.ssm if cache is not None else None)
    y = (y.reshape(B, T, di).to(F32)
         + xin.to(F32) * p["D"].to(F32).repeat_interleave(P)[None, None, :])
    out = _gated_norm(p, cfg, y, z).to(x.dtype) @ p["out_proj"]
    if cache is not None:
        cache.conv.copy_(new_tail)
        cache.ssm.copy_(final_state)
    return out, cache


def mamba_decode(p, cfg: ModelCfg, x: torch.Tensor,
                 cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token recurrent step (plain PyTorch, as in the JAX package).
    x (B, 1, d); the cache is updated in place.  The conv output and the
    SSD operands round through the storage dtype exactly as
    ``mamba_block`` rounds them, so decode follows the prefill's
    numerics."""
    s = cfg.ssm
    B, _, d = x.shape
    di, nh, P = s.d_inner(d), s.n_heads(d), s.head_dim
    gn = s.n_groups * s.d_state

    zxbcdt = x[:, 0] @ p["in_proj"]
    z, xin, bc, dt = torch.split(zxbcdt, [di, di, 2 * gn, nh], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)[:, None]                   # (B, 1, C)
    window = torch.cat([cache.conv.to(conv_in.dtype), conv_in], dim=1)  # (B, K, C)
    acc = p["conv_b"].to(F32) + torch.einsum("bkc,kc->bc", window.to(F32),
                                             p["conv_w"].to(F32))
    conv_out = F.silu(acc).to(x.dtype).to(F32)
    xin, b, c = torch.split(conv_out, [di, gn, gn], dim=-1)

    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))                # (B, nh)
    A = -torch.exp(p["A_log"].to(F32))
    log_a = dt * A[None, :]
    xh = (xin * dt.repeat_interleave(P, dim=-1)).reshape(B, nh, P).to(x.dtype)
    bg = b.reshape(B, s.n_groups, s.d_state).to(x.dtype)
    cg = c.reshape(B, s.n_groups, s.d_state).to(x.dtype)

    def step(x1, la1, b1, c1, state):
        """The step on one token in the scan's layout (under a mesh on
        local shards, as the scan runs: the state's batch and head splits
        stay put)."""
        rep = x1.shape[2] // b1.shape[2]
        y1, new = ssd_decode_ref(state, x1[:, 0], la1[:, 0],
                                 b1[:, 0].repeat_interleave(rep, dim=1),
                                 c1[:, 0].repeat_interleave(rep, dim=1))
        return y1[:, None], new
    y, new_state = scan_local(step, xh[:, None], log_a[:, None], bg[:, None], cg[:, None],
                              cache.ssm)
    y = y[:, 0].to(F32).reshape(B, di) + xin * p["D"].to(F32).repeat_interleave(P)[None]
    out = (_gated_norm(p, cfg, y, z).to(x.dtype) @ p["out_proj"])[:, None]
    cache.conv.copy_(window[:, 1:])
    cache.ssm.copy_(new_state)
    return out, cache
