"""Analytic FLOP accounting for the serving pipeline (paper Fig. 13b).

Counts matmul FLOPs (2*m*n*k) for the ViT encode, LLM prefill and
decode paths as a function of the *actual token counts processed*, so
pruning / selective-refresh savings are measured exactly and
hardware-independently.
"""
from __future__ import annotations

from ..configs.base import ModelCfg, ViTCfg


def vit_flops(v: ViTCfg, n_patches: int) -> float:
    """Encode ``n_patches`` patches (+ projector on their groups)."""
    per_tok_proj = 2 * (4 * v.d_model * v.d_model)           # qkvo
    per_tok_ffn = 2 * (3 * v.d_model * v.d_ff)               # swiglu-ish 2-mat
    attn = 2 * 2 * n_patches * n_patches * v.d_model         # logits + pv
    per_layer = n_patches * (per_tok_proj + per_tok_ffn) + attn
    proj = (n_patches // (v.group ** 2)) * 2 * (v.group ** 2 * v.d_model) * v.d_model
    embed = n_patches * 2 * (v.patch ** 2) * v.d_model
    return float(v.n_layers * per_layer + proj + embed)


def vit_padded_flops(v: ViTCfg, n_frames: int, k_sel: int) -> float:
    """Exact cost of the padded pruned path (``encode_pruned_tokens``):
    full-grid patch embedding, ``k_sel`` masked attention lanes per
    frame, full-grid ``n_groups`` projection — what the hardware pays
    regardless of how many of the ``k_sel`` lanes are valid."""
    d = v.d_model
    embed = n_frames * v.n_patches * 2 * (v.patch ** 2) * d
    per_tok = 2 * 4 * d * d + 2 * 3 * d * v.d_ff
    attn = 4 * k_sel * k_sel * d
    enc = v.n_layers * n_frames * (k_sel * per_tok + attn)
    proj = n_frames * v.n_groups * 2 * (v.group ** 2 * d) * d
    return float(embed + enc + proj)


def vit_packed_flops(
    v: ViTCfg, n_slots: int, visited_tiles: int, tq: int, tk: int,
    k_pack: int,
) -> float:
    """Exact cost of the packed path (``encode_packed_tokens``):
    gathered embedding + per-token work over the packed buffer slots,
    attention only on the block map's visited (q, kv) tiles, projection
    of the ``k_pack`` kept group rows."""
    d = v.d_model
    embed = n_slots * 2 * (v.patch ** 2) * d
    per_tok = 2 * 4 * d * d + 2 * 3 * d * v.d_ff
    attn = visited_tiles * 4 * tq * tk * d
    enc = v.n_layers * (n_slots * per_tok + attn)
    proj = k_pack * 2 * (v.group ** 2 * d) * d
    return float(embed + enc + proj)


def _layer_flops_per_token(cfg: ModelCfg, pos: int) -> float:
    d, dh = cfg.d_model, cfg.d_head
    mixer, ffn = cfg.block_kind(pos)
    f = 0.0
    if mixer == "attn":
        f += 2 * d * (cfg.n_heads + 2 * cfg.n_kv) * dh        # qkv
        f += 2 * cfg.n_heads * dh * d                         # out
    else:
        s = cfg.ssm
        di = s.d_inner(d)
        proj_in = 2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d)
        f += 2 * d * proj_in + 2 * di * d
        f += 2 * di * s.d_state * 2                           # ssd state in/out
    if ffn == "moe":
        m = cfg.moe
        f += 2 * 3 * d * m.d_ff_expert * m.top_k + 2 * d * m.n_experts
        if m.dense_residual:
            f += 2 * 3 * d * cfg.d_ff
    elif ffn != "none":
        f += 2 * 3 * d * cfg.d_ff
    return f


def _attn_flops(cfg: ModelCfg, n_q: int, n_kv: int) -> float:
    """Score+value matmul FLOPs for one attention layer."""
    return 4.0 * n_q * n_kv * cfg.n_heads * cfg.d_head


def prefill_flops(cfg: ModelCfg, n_q: int, n_kv: int, causal: bool = True) -> float:
    """LLM forward over n_q query tokens attending to n_kv cache slots.

    For full self-attention prefill pass n_kv == n_q (causal halves it).
    """
    f = 0.0
    for pos in range(cfg.period):
        per_tok = _layer_flops_per_token(cfg, pos)
        f += cfg.repeats * n_q * per_tok
        if cfg.block_kind(pos)[0] == "attn":
            a = _attn_flops(cfg, n_q, n_kv)
            if causal and n_q == n_kv:
                a *= 0.5
            f += cfg.repeats * a
    f += n_q * 2 * cfg.d_model * cfg.vocab                    # lm head
    return f


def decode_flops(cfg: ModelCfg, n_kv: int) -> float:
    return prefill_flops(cfg, 1, n_kv, causal=False)
