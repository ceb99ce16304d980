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

NEG_INF = -1e30
F32 = torch.float32


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
    return torch.bmm(a, b) if a.dtype == F32 else torch.bmm(a, b, out_dtype=F32)


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
    products are exact in f32, so both give the same value).
    """
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    scale = dh ** -0.5
    gemm = q.device.type == "cuda"
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
        out = mha(q, k, v, positions, positions, valid, causal=causal, window=window,
                  q_chunk=q_chunk)
        return out.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"], None
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


def cross_attention_block(p, cfg: ModelCfg, x: torch.Tensor, enc_kv) -> torch.Tensor:
    """Whisper's decoder cross-attention: x (B, T, d) against the
    precomputed encoder (k, v) (B, S_enc, K, dh); no RoPE, no mask."""
    B, T, _ = x.shape
    dh = cfg.d_head
    q = (x @ p["wq"]).reshape(B, T, cfg.n_heads, dh)
    k, v = enc_kv
    qpos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=x.device)
    out = mha(q, k, v, qpos, kpos, causal=False)
    return out.reshape(B, T, cfg.n_heads * dh) @ p["wo"]


def cross_attention_kv(p, cfg: ModelCfg, enc_out: torch.Tensor):
    """The encoder output's cross K/V of one decoder layer: (B, S, K, dh) each."""
    B, S, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, S, cfg.n_kv, cfg.d_head)
    v = (enc_out @ p["wv"]).reshape(B, S, cfg.n_kv, cfg.d_head)
    return k, v


def mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x Wg) * x Wu) Wd."""
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


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
        return torch.mm(x, w, out_dtype=F32)

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
    if x.device.type == "cuda":
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
    in token order (a stable sort on the expert id)."""
    n = x2.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    dev = x2.device
    gates = torch.softmax(f32_matmul(x2, p["router"]), dim=-1)
    topw, tope = top_k_lower_first(gates, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = tope.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    aux = E * torch.sum(counts.to(F32) / (n * k) * gates.mean(0))
    cap = int(cfg.capacity_factor * n * k / E) + 1
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = torch.arange(n * k, device=dev) - (torch.cumsum(counts, 0) - counts)[se]
    keep = pos < cap
    slot = se * cap + torch.where(keep, pos, cap - 1)
    return MoERoute(gates, topw, tope, order, slot, keep, cap, aux)


def combine_sorted(y: torch.Tensor, order: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Each token's sum of its k rows of y (n * k, d), given in sorted
    assignment order (``order[i]`` is the flat token * k + j id of row i):
    in y's dtype, from zero, in ascending row order, which is the order in
    which the reference's scatter-add ``zeros.at[token].add(y)`` meets
    them.  A fixed order of plain adds: the same result on every run."""
    where_sorted = torch.empty_like(order)
    where_sorted[order] = torch.arange(n * k, device=y.device)
    ys = y[torch.sort(where_sorted.view(n, k), dim=1).values]      # (n, k, d)
    out = torch.zeros((n, y.shape[1]), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + ys[:, j]
    return out


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
    the reference's einsums are.
    """
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = B * T
    dev = x.device
    x2 = x.reshape(n, d)
    r = moe_route(p, cfg, x2)
    cap = r.cap
    st = torch.div(r.order, k, rounding_mode="floor")             # token of each
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=dev)
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
        xp = F.pad(x, (0, 0, K - 1, 0))
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


def mamba_block(p, cfg: ModelCfg, x: torch.Tensor,
                cache: Optional[SSMCache] = None) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Mamba-2 mixer over a chunk.  x (B, T, d).  With ``cache`` (one
    layer's conv tail and state) the chunk continues from it and the
    cache is updated in place; returns (out (B, T, d), cache)."""
    s = cfg.ssm
    B, T, d = x.shape
    di, nh, P = s.d_inner(d), s.n_heads(d), s.head_dim
    gn = s.n_groups * s.d_state

    zxbcdt = x @ p["in_proj"]
    z, xin, bc, dt = torch.split(zxbcdt, [di, di, 2 * gn, nh], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, new_tail = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      cache.conv if cache is not None else None)
    xin, b, c = torch.split(conv_out, [di, gn, gn], dim=-1)

    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))                # (B, T, nh)
    A = -torch.exp(p["A_log"].to(F32))
    log_a = dt * A[None, None, :]
    xh = (xin.to(F32) * dt.repeat_interleave(P, dim=-1)).reshape(B, T, nh, P)
    bg = b.reshape(B, T, s.n_groups, s.d_state)
    cg = c.reshape(B, T, s.n_groups, s.d_state)

    y, final_state = ops.ssd_scan(
        xh.to(x.dtype), log_a, bg.to(x.dtype), cg.to(x.dtype),
        cache.ssm if cache is not None else None, chunk=s.chunk)
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
    rep = nh // s.n_groups
    bg = b.reshape(B, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    cg = c.reshape(B, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    y, new_state = ssd_decode_ref(cache.ssm, xh, log_a, bg.to(x.dtype), cg.to(x.dtype))
    y = y.to(F32).reshape(B, di) + xin * p["D"].to(F32).repeat_interleave(P)[None]
    out = (_gated_norm(p, cfg, y, z).to(x.dtype) @ p["out_proj"])[:, None]
    cache.conv.copy_(window[:, 1:])
    cache.ssm.copy_(new_state)
    return out, cache
