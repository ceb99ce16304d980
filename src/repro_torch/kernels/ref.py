"""Plain PyTorch versions of the kernels on the serving path.

Each function computes exactly what its CUDA kernel computes and what
the JAX package's oracle of the same name computes, with the same
numerics: attention rounds the scaled query to the K/V storage dtype
and the probabilities to the V dtype, accumulates in f32, and returns
exact zeros for fully masked query rows.  They run for CPU tensors,
and on the card only where a caller asks for them (tests,
``chip_smoke.py``, ``ops.kernel_mode("plain")``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30


# ----------------------------------------------------------------------
# mv_sad: block-matching motion estimation
# ----------------------------------------------------------------------
def mv_sad_ref(cur: torch.Tensor, prev: torch.Tensor, block: int, radius: int):
    """Full-search block matching.

    cur, prev: (H, W) f32 luma.  Returns mv (H//block, W//block, 2)
    int32 (dy, dx) and sad (H//block, W//block) f32.  The first minimum
    in candidate order (dy-major) wins.
    """
    H, W = cur.shape
    hb, wb = H // block, W // block
    cur = cur.to(F32)
    pad = F.pad(prev.to(F32)[None, None], (radius,) * 4, mode="replicate")[0, 0]
    n_cand = 2 * radius + 1
    sads = torch.stack([
        (cur - pad[dy:dy + H, dx:dx + W]).abs()
        .reshape(hb, block, wb, block).sum(dim=(1, 3))
        for dy in range(n_cand) for dx in range(n_cand)
    ])                                                   # (C, hb, wb)
    best = torch.argmin(sads, dim=0)                     # first minimum
    sad = torch.gather(sads, 0, best[None])[0]
    mv = torch.stack([best // n_cand - radius, best % n_cand - radius], dim=-1)
    return mv.to(torch.int32), sad


# ----------------------------------------------------------------------
# rope_shift: RoPE position correction of cached keys (paper Eq. 5)
# ----------------------------------------------------------------------
def rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(half, dtype=F32, device=device) / half))


def rope_shift_ref(k: torch.Tensor, delta: torch.Tensor, theta: float = 10_000.0):
    """K' = R(delta) K (rotate-half RoPE); k (B, S, n_kv, d_h), delta
    (B, S) int.  Angles in f32; the result is cast back to k's dtype."""
    half = k.shape[-1] // 2
    ang = delta.to(F32)[..., None] * rope_freqs(half, theta, k.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    kf = k.to(F32)
    k1, k2 = kf[..., :half], kf[..., half:]
    out = torch.cat([k1 * cos - k2 * sin, k2 * cos + k1 * sin], dim=-1)
    return out.to(k.dtype)


def apply_rope_ref(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """Standard RoPE. x: (B, S, H, D), positions: (B, S)."""
    return rope_shift_ref(x, positions, theta)


# ----------------------------------------------------------------------
# masked attention (shared body of the refresh and packed oracles)
# ----------------------------------------------------------------------
def _masked_attention(q, k, v, mask, scale):
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D); mask (B, Sq, Sk) bool."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    if scale is None:
        scale = D ** -0.5
    qq = (q.to(F32) * scale).to(k.dtype).reshape(B, Sq, Hkv, g, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qq.to(F32), k.to(F32))
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(F32), v.to(F32))
    out = out.reshape(B, Sq, H, D)
    alive = mask.any(dim=-1)
    return torch.where(alive[..., None, None], out, 0.0).to(q.dtype)


# ----------------------------------------------------------------------
# flash_refresh: masked attention over gathered query positions
# ----------------------------------------------------------------------
def flash_refresh_ref(q, k, v, q_pos, kv_valid=None, *, causal: bool = True,
                      window: int | None = None, scale: float | None = None):
    """Key positions are ``arange(Sk)``; query positions ``q_pos`` (B, Sq)
    are explicit and may be non-contiguous; kv_valid (B, Sk) bool."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= kpos[None, None, :] > q_pos[:, :, None] - window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    return _masked_attention(q, k, v, mask, scale)


def paged_gather_ref(slab: torch.Tensor, page_table: torch.Tensor, page: int):
    """(P_phys, Hkv, D) slab -> (B, n_pages * page, Hkv, D) logical view:
    slot ``s`` of stream ``b`` is row ``pt[b, s // page] * page + s % page``."""
    B, n_pages = page_table.shape
    off = torch.arange(page, device=page_table.device)
    rows = page_table.long()[:, :, None] * page + off[None, None, :]
    return slab[rows.reshape(B, n_pages * page)]


def paged_gather_quant_ref(hot: torch.Tensor, cold: torch.Tensor,
                           scale: torch.Tensor, page_table: torch.Tensor,
                           page: int):
    """Logical view of a two-precision slab: hot (n_hot * page, Hkv, D)
    float rows, cold (n_cold * page, Hkv, D) int8 rows, scale (n_cold,
    Hkv) f32.  Entries ``< n_hot`` index the hot slab, entries ``>=
    n_hot`` cold page ``entry - n_hot``, dequantised as ``int8 * scale``
    in f32 and rounded to the hot dtype (the kernel's tile values)."""
    B, n_pages = page_table.shape
    n_hot = hot.shape[0] // page
    n_cold = cold.shape[0] // page
    entries = page_table.long()
    is_cold = entries >= n_hot
    hot_pg = entries.clamp(max=n_hot - 1)
    cold_pg = (entries - n_hot).clamp(0, max(n_cold - 1, 0))
    off = torch.arange(page, device=page_table.device)
    hot_rows = (hot_pg[:, :, None] * page + off).reshape(B, n_pages * page)
    cold_rows = (cold_pg[:, :, None] * page + off).reshape(B, n_pages * page)
    sc = scale.to(F32)[cold_pg].repeat_interleave(page, dim=1)   # (B, S, Hkv)
    deq = (cold[cold_rows].to(F32) * sc[..., None]).to(hot.dtype)
    mask = is_cold.repeat_interleave(page, dim=1)
    return torch.where(mask[:, :, None, None], deq, hot[hot_rows])


def paged_gather(k, v, page_table, page: int, cold=None):
    """Logical K/V of a plain slab, or of a two-precision one when
    ``cold = (k8, v8, k_scale, v_scale)``."""
    if cold is None:
        return paged_gather_ref(k, page_table, page), paged_gather_ref(v, page_table, page)
    k8, v8, k_scale, v_scale = cold
    return (paged_gather_quant_ref(k, k8, k_scale, page_table, page),
            paged_gather_quant_ref(v, v8, v_scale, page_table, page))


def flash_refresh_paged_ref(q, k, v, q_pos, kv_valid, page_table, *,
                            page: int = 128, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None, cold=None):
    """Paged refresh oracle: gather the logical view (through the int8
    ``cold`` group where given), then ``flash_refresh_ref``."""
    kg, vg = paged_gather(k, v, page_table, page, cold)
    return flash_refresh_ref(q, kg, vg, q_pos, kv_valid, causal=causal,
                             window=window, scale=scale)


# ----------------------------------------------------------------------
# flash_packed: block-diagonal (segment-masked) attention for packed ViT
# ----------------------------------------------------------------------
def flash_packed_ref(q, k, v, seg_id, *, scale: float | None = None,
                     q_seg=None):
    """Slots attend iff they carry the same non-negative segment id.

    q (R, Lq, H, D); k, v (R, L, Hkv, D); seg_id (R, L) int, -1 for
    padding.  ``q_seg`` (R, Lq) gives the query rows' segments when the
    queries are a chunk of the keys (defaults to ``seg_id``)."""
    if q_seg is None:
        q_seg = seg_id
    mask = (q_seg[:, :, None] == seg_id[:, None, :]) & (q_seg[:, :, None] >= 0)
    return _masked_attention(q, k, v, mask, scale)
