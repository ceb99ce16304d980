"""Plain PyTorch versions of the kernels.

Each function computes exactly what its CUDA kernel computes and what
the JAX package's oracle of the same name computes, with the same
numerics: refresh and packed attention round the scaled query to the
K/V storage dtype and the probabilities to the V dtype, accumulate in
f32, and return exact zeros for fully masked query rows; prefill
attention keeps f32 throughout and, like its oracle, gives a row with
no visible key the mean of V; the SSD scans run in f32.  They run for
CPU tensors, and on the card only where a caller asks for them (tests,
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
    # one row of candidates at a time: pad[dy + h, dx + w] for every dx
    # is a view (H, n_cand, W) of the padded rows
    sads = torch.cat([
        (cur[:, None, :] - pad[dy:dy + H].unfold(1, W, 1)).abs()
        .reshape(hb, block, n_cand, wb, block).sum(dim=(1, 4)).transpose(0, 1)
        for dy in range(n_cand)
    ])                                                   # (C, hb, wb), dy-major
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


# ----------------------------------------------------------------------
# flash_prefill: causal (optionally windowed) GQA attention
# ----------------------------------------------------------------------
def flash_prefill_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                      q_offset: int = 0, scale: float | None = None):
    """Multi-head attention with GQA broadcast, f32 throughout.

    q (B, Sq, H, D); k, v (B, Sk, Hkv, D).  Query i sits at position
    ``i + q_offset`` and key j at ``j``: causal keeps keys ``<=`` the
    query's position, ``window`` keys ``>`` position - window.  Masked
    logits are the finite -1e30, so a row with no visible key softmaxes
    uniformly: it returns the mean of V over all Sk keys.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = (q.to(F32) * scale).reshape(B, Sq, Hkv, g, D).permute(0, 2, 3, 1, 4)
    kf = k.to(F32).transpose(1, 2)                       # (B, Hkv, Sk, D)
    vf = v.to(F32).transpose(1, 2)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


# ----------------------------------------------------------------------
# ssd_scan: Mamba-2 state-space duality
# ----------------------------------------------------------------------
def ssd_scan_ref(x, log_a, b, c, init_state=None):
    """Exact sequential SSD recurrence (the oracle of the chunked scans).

    h_t = exp(log_a_t) h_{t-1} + x_t b_t^T,  y_t = h_t c_t.

    x (B, L, H, P); log_a (B, L, H); b, c (B, L, H, N) per head;
    init_state (B, H, P, N) or None.  Returns y (B, L, H, P) in x's
    dtype and the final state (B, H, P, N) f32.
    """
    B, L, H, P = x.shape
    N = b.shape[-1]
    xf, af, bf, cf = (t.to(F32) for t in (x, log_a, b, c))
    h = (torch.zeros((B, H, P, N), dtype=F32, device=x.device) if init_state is None
         else init_state.to(F32))
    ys = []
    for t in range(L):
        h = torch.exp(af[:, t])[:, :, None, None] * h + xf[:, t, :, :, None] * bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_scan_ref(x, log_a, b, c, chunk: int, init_state=None):
    """Chunked SSD with the state carried chunk to chunk, per-head B/C.

    x (B, L, H, P); log_a (B, L, H); b, c (B, L, H, N); L a multiple of
    ``chunk``.  Within a chunk: y_t = sum_{s<=t} exp(cum_t - cum_s)
    (c_t . b_s) x_s + exp(cum_t) c_t . S_prev; then S = exp(cum_end)
    S_prev + sum_s exp(cum_end - cum_s) x_s b_s^T.
    """
    B, L, H, P = x.shape
    N = b.shape[-1]
    assert L % chunk == 0, (L, chunk)
    nc, Q = L // chunk, chunk
    xf = x.to(F32).reshape(B, nc, Q, H, P)
    af = log_a.to(F32).reshape(B, nc, Q, H)
    bf = b.to(F32).reshape(B, nc, Q, H, N)
    cf = c.to(F32).reshape(B, nc, Q, H, N)
    state = (torch.zeros((B, H, P, N), dtype=F32, device=x.device) if init_state is None
             else init_state.to(F32))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for i in range(nc):
        xc, ac, bc, cc = xf[:, i], af[:, i], bf[:, i], cf[:, i]
        cum = torch.cumsum(ac, dim=1)                                  # (B, Q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]                  # (B, t, s, H)
        decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("bthn,bshn->btsh", cc, bc)
        y = torch.einsum("btsh,btsh,bshp->bthp", cb, decay, xc)
        y = y + torch.einsum("bth,bthn,bhpn->bthp", torch.exp(cum), cc, state)
        decay_end = torch.exp(cum[:, -1:, :] - cum)
        upd = torch.einsum("bsh,bshn,bshp->bhpn", decay_end, bc, xc)
        state = torch.exp(cum[:, -1, :])[:, :, None, None] * state + upd
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, L, H, P).to(x.dtype)
    return y, state


def ssd_chunked_scan_grouped_ref(x, log_a, b, c, chunk: int, init_state=None,
                                 states: bool = False):
    """``ssd_chunked_scan_ref`` with B/C kept per group: b, c (B, L, G,
    N), G | H, head h reading group h // (H / G); no H/G-fold copy.
    With ``states`` it also returns the state entering each chunk,
    (B, H, nc, P, N) f32."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Hg = H // G
    assert L % chunk == 0, (L, chunk)
    nc, Q = L // chunk, chunk
    xf = x.to(F32).reshape(B, nc, Q, G, Hg, P)
    af = log_a.to(F32).reshape(B, nc, Q, G, Hg)
    bf = b.to(F32).reshape(B, nc, Q, G, N)
    cf = c.to(F32).reshape(B, nc, Q, G, N)
    state = (torch.zeros((B, H, P, N), dtype=F32, device=x.device) if init_state is None
             else init_state.to(F32)).reshape(B, G, Hg, P, N)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys, entering = [], []
    for i in range(nc):
        entering.append(state)
        xc, ac, bc, cc = xf[:, i], af[:, i], bf[:, i], cf[:, i]
        cum = torch.cumsum(ac, dim=1)                                  # (B, Q, G, Hg)
        seg = cum[:, :, None] - cum[:, None]                           # (B, t, s, G, Hg)
        decay = torch.where(tri[None, :, :, None, None], torch.exp(seg), 0.0)
        cb = torch.einsum("btgn,bsgn->btsg", cc, bc)
        y = torch.einsum("btsg,btsgh,bsghp->btghp", cb, decay, xc)
        y = y + torch.einsum("btgh,btgn,bghpn->btghp", torch.exp(cum), cc, state)
        decay_end = torch.exp(cum[:, -1:] - cum)
        upd = torch.einsum("bsgh,bsgn,bsghp->bghpn", decay_end, bc, xc)
        state = torch.exp(cum[:, -1])[..., None, None] * state + upd
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, L, H, P).to(x.dtype)
    if states:
        return y, state.reshape(B, H, P, N), torch.stack(entering, 3).reshape(B, H, nc, P, N)
    return y, state.reshape(B, H, P, N)


def ssd_decode_ref(state, x, log_a, b, c):
    """One SSD step: state (B, H, P, N); x (B, H, P); log_a (B, H);
    b, c (B, H, N).  Returns y (B, H, P) in x's dtype and the new f32
    state."""
    new = (torch.exp(log_a.to(F32))[:, :, None, None] * state.to(F32)
           + x.to(F32)[..., None] * b.to(F32)[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new, c.to(F32))
    return y.to(x.dtype), new
