"""ViT encoder + pixel-unshuffle projector: full (I-frame), padded
pruned and packed pruned (P-frame) paths.

``encode_full`` runs every patch through dense attention (plain
PyTorch, as the JAX package runs it outside Pallas).
``encode_pruned_tokens`` (the padded A/B baseline of the packed path)
encodes each frame's static-capacity selection, padding lanes masked
out of the keys, through the same dense attention.
``encode_packed_tokens`` runs only the kept patch groups of many frames,
laid out by ``core.pruning.pack_plan`` in shared ``(rows, L_pack)``
buffers, with block-diagonal attention per frame (``ops.flash_packed``),
and projects only the kept groups.
"""
from __future__ import annotations

import torch

from ..configs.base import ViTCfg
from ..kernels import ops
from ..kernels.flash_packed import PackBlockMap
from . import layers
from .transformer import unstack


def patchify(frames: torch.Tensor, v: ViTCfg) -> torch.Tensor:
    """frames (B, H, W) luma [0, 255] -> (B, P, patch*patch) in [-1, 1]."""
    B = frames.shape[0]
    pp = v.patches_per_side
    x = frames.to(torch.float32).reshape(B, pp, v.patch, pp, v.patch).permute(0, 1, 3, 2, 4)
    return (x.reshape(B, pp * pp, v.patch * v.patch) / 127.5) - 1.0


def _vit_block(lp, v: ViTCfg, h: torch.Tensor, eps: float, attend) -> torch.Tensor:
    B, T, _ = h.shape
    dh = v.d_model // v.n_heads
    hn = layers.rmsnorm(lp["ln1"], h, eps)
    q = (hn @ lp["wq"]).reshape(B, T, v.n_heads, dh)
    k = (hn @ lp["wk"]).reshape(B, T, v.n_heads, dh)
    vv = (hn @ lp["wv"]).reshape(B, T, v.n_heads, dh)
    h = h + attend(q, k, vv).reshape(B, T, v.d_model) @ lp["wo"]
    hn = layers.rmsnorm(lp["ln2"], h, eps)
    return h + layers.mlp_block(lp["ffn"], hn)


def _encoder(params, v: ViTCfg, h: torch.Tensor, valid, eps: float) -> torch.Tensor:
    """Dense bidirectional encoder over (B, T, d) (no RoPE in the ViT);
    ``valid`` (B, T) bool or None masks padding lanes out of the keys."""
    B, T, _ = h.shape
    pos = torch.zeros((B, T), dtype=torch.int32, device=h.device)

    def attend(q, k, vv):
        return layers.mha(q, k, vv, pos, pos, valid, causal=False)

    for lp in unstack(params["blocks"]):
        h = _vit_block(lp, v, h, eps, attend)
    return layers.rmsnorm(params["final_norm"], h, eps)


def project(params, v: ViTCfg, patch_feats: torch.Tensor) -> torch.Tensor:
    """2x2 pixel-unshuffle + projection: (B, n_patches, d_vit) in
    row-major patch order -> (B, n_groups, d_lm)."""
    B = patch_feats.shape[0]
    g, gs = v.group, v.groups_per_side
    x = patch_feats.reshape(B, gs, g, gs, g, v.d_model)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, gs * gs, g * g * v.d_model)
    return x @ params["projector"]


def encode_full(params, v: ViTCfg, frames: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Unpruned path: (B, H, W) -> (B, n_groups, d_lm) visual tokens."""
    x = patchify(frames, v).to(params["patch_embed"].dtype)
    h = x @ params["patch_embed"] + params["pos_embed"][None]
    h = _encoder(params, v, h, None, eps)
    return project(params, v, h)


def encode_pruned(params, v: ViTCfg, frames: torch.Tensor, sel_idx: torch.Tensor,
                  sel_valid: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pruned path at static capacity (paper §3.3.2): frames (B, H, W),
    sel_idx (B, K_sel) patch indices (group-complete; padding lanes repeat
    index 0), sel_valid (B, K_sel) bool -> (B, n_patches, d_vit) encoded
    patches on the full grid, zeros at pruned positions."""
    B = frames.shape[0]
    x = patchify(frames, v).to(params["patch_embed"].dtype)
    emb = x @ params["patch_embed"] + params["pos_embed"][None]     # (B, P, d)
    idx = sel_idx.long()[..., None].expand(-1, -1, emb.shape[-1])
    h = _encoder(params, v, torch.gather(emb, 1, idx), sel_valid, eps)
    h = torch.where(sel_valid[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
    full = torch.zeros((B, v.n_patches, v.d_model), dtype=h.dtype, device=h.device)
    # padding lanes all land on index 0 and add zero
    return full.scatter_add(1, idx, h)


def encode_pruned_tokens(params, v: ViTCfg, frames: torch.Tensor, sel_idx: torch.Tensor,
                         sel_valid: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pruned ViT -> projected visual tokens (B, n_groups, d_lm)."""
    return project(params, v, encode_pruned(params, v, frames, sel_idx, sel_valid, eps))


def _encoder_packed(params, v: ViTCfg, h: torch.Tensor, seg_id: torch.Tensor,
                    block_map: PackBlockMap, eps: float) -> torch.Tensor:
    """ViT blocks over packed rows; attention is block-diagonal per
    segment (frame) through ``ops.flash_packed``."""
    def attend(q, k, vv):
        return ops.flash_packed(q, k, vv, seg_id, block_map)

    for lp in unstack(params["blocks"]):
        h = _vit_block(lp, v, h, eps, attend)
    return layers.rmsnorm(params["final_norm"], h, eps)


def encode_packed_tokens(params, v: ViTCfg, frames: torch.Tensor,
                         patch_src: torch.Tensor, seg_id: torch.Tensor,
                         group_src: torch.Tensor, group_dst: torch.Tensor,
                         block_map: PackBlockMap, n_out: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """Packed pruned ViT -> projected visual tokens, flat (n_out, d_lm).

    Index arrays come from a ``core.pruning.PackPlan``: the patch
    embedding, the encoder and the projector all run on kept content
    only.  Slots of dropped groups are zeros.
    """
    x = patchify(frames, v).to(params["patch_embed"].dtype)
    flat = x.reshape(-1, x.shape[-1])                      # (B*P, patch^2)
    src = patch_src.long()
    h = flat[src] @ params["patch_embed"] + params["pos_embed"][src % v.n_patches]
    h = _encoder_packed(params, v, h, seg_id, block_map, eps)
    R, Lp, d = h.shape
    g2 = v.group ** 2
    grp = h.reshape(R * Lp, d)[group_src.long().reshape(-1)].reshape(-1, g2 * d)
    tok = grp @ params["projector"]                        # (Kp, d_lm)
    out = torch.zeros((n_out + 1, tok.shape[-1]), dtype=tok.dtype, device=tok.device)
    out[group_dst.long()] = tok                            # pad row -> n_out
    return out[:n_out]
