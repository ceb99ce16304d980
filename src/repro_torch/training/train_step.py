"""Loss and train step of the JAX package's ``training/train_step.py``,
shared by the launcher and the anomaly task.

Gradients come from ``torch.autograd`` over a tree made by
``models.init.trainable``; the step updates that tree in place.  The
chunked cross-entropy puts each chunk of the head product in a
checkpointed segment (``torch.utils.checkpoint``), so the (B, S, V)
logits never exist: a chunk's (B, chunk, V) f32 logits are recomputed in
the backward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelCfg
from ..models import layers
from ..models import transformer as tfm
from ..models.init import map_tree, tree_leaves
from ..sharding import ctx as shctx
from ..sharding.ctx import is_dtensor
from .optimizer import OptCfg, OptState, apply_updates

F32 = torch.float32


class Batch(NamedTuple):
    """One training batch.  Optional fields are family-dependent.

    tokens: (B, S) int inputs; targets: (B, S) int (next-token, already
    shifted by the pipeline); loss_mask: (B, S) f32;
    inputs_embeds/embed_mask: multimodal injection (vlm);
    enc_feats: (B, S_enc, d) stub frontend output (audio).
    """

    tokens: torch.Tensor
    targets: torch.Tensor
    loss_mask: torch.Tensor
    inputs_embeds: Optional[torch.Tensor] = None
    embed_mask: Optional[torch.Tensor] = None
    enc_feats: Optional[torch.Tensor] = None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor):
    """Mean masked token CE + z-loss regularizer (stability)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    ce = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    zloss = 1e-4 * torch.sum((logz * mask) ** 2) / denom
    return ce.sum() / denom + zloss


def gold_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (..., V) at ``targets`` (...).  A DTensor split over V (the
    head's 'vocab' axis) is read on local shards: each rank takes the
    targets inside its slice of V and zero elsewhere, a partial sum over
    that axis that holds one non-zero term per row (the vocab-parallel
    cross-entropy; DTensor's own gather on a split dim masks only 2-D
    results)."""
    if not shctx.is_dtensor(logits):
        return logits.gather(-1, targets.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = logits.device_mesh, logits.dim() - 1
    pl, pt, po, vocab = [], [], [], []
    for ax, p in zip(mesh.mesh_dim_names, logits.placements):
        if p == Shard(last) or p == Shard(-1):
            vocab.append(ax)
            pl.append(Shard(last)); pt.append(Replicate()); po.append(Partial())
        elif isinstance(p, Shard) and p.dim < last:
            pl.append(p); pt.append(p); po.append(p)
        else:
            pl.append(Replicate()); pt.append(Replicate()); po.append(Replicate())

    def local(lg, t):
        i, n = shctx.coordinate(mesh, tuple(vocab))
        V_l = lg.shape[-1]
        t = t.long() - i * V_l
        inside = (t >= 0) & (t < V_l)
        g = lg.gather(-1, t.clamp(0, V_l - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))

    return shctx.local(local, (tuple(po),), (tuple(pl), tuple(pt)), mesh)(logits, targets)


def _ce_chunk(hc, head, tc, mc):
    """(CE sum, z sum) of one chunk: its f32 logits (B, c, V) live only here."""
    logits = layers.f32_matmul(hc, head, tfm.HEAD_CHUNK)
    logz = torch.logsumexp(logits, dim=-1)
    gold = gold_logits(logits, tc)
    return torch.sum((logz - gold) * mc), torch.sum((logz * mc) ** 2)


def chunked_cross_entropy(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor, chunk: int = 512):
    """``cross_entropy`` of ``h @ head`` over sequence chunks; under grad
    each chunk is a checkpointed segment (logits recomputed in the
    backward), so peak activation is (B, chunk, V) instead of (B, S, V).
    The head product keeps its f32 result (``layers.f32_matmul``), as
    the jitted reference's ``(hc @ head).astype(f32)`` does."""
    B, S, _ = h.shape
    c = min(chunk, S)
    if S % c:
        c = S  # fallback: no chunking for odd lengths
    ce_sum = torch.zeros((), dtype=F32, device=h.device)
    z_sum = torch.zeros((), dtype=F32, device=h.device)
    for i in range(0, S, c):
        args = (h[:, i:i + c], head, targets[:, i:i + c], mask[:, i:i + c])
        if torch.is_grad_enabled():
            a, z = checkpoint(_ce_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            a, z = _ce_chunk(*args)
        ce_sum, z_sum = ce_sum + a, z_sum + z
    denom = torch.clamp(mask.sum(), min=1.0)
    return ce_sum / denom + 1e-4 * z_sum / denom


def loss_fn(cfg: ModelCfg, params, batch: Batch, *, q_chunk: int = 1024,
            remat: bool = True, ce_chunk: int = 512):
    """(CE + router_aux_weight x MoE aux, (CE, aux))."""
    h, aux = tfm.forward_hidden(
        cfg, params, batch.tokens,
        inputs_embeds=batch.inputs_embeds, embed_mask=batch.embed_mask,
        enc_feats=batch.enc_feats, q_chunk=q_chunk, remat=remat,
    )
    ce = chunked_cross_entropy(h, tfm.head_of(cfg, params), batch.targets, batch.loss_mask,
                               ce_chunk)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    return ce + aux_w * aux, (ce, aux)


def tree_grads(loss: torch.Tensor, params):
    """d loss / d every floating leaf of ``params`` (a ``trainable``
    tree), as a tree of the same structure; an unused leaf's gradient is
    zeros."""
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    if not all(t.requires_grad for t in leaves):
        raise ValueError("params must be a trainable tree (models.init.trainable)")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): (g if g is not None else torch.zeros_like(t))
             for t, g in zip(leaves, grads)}
    return map_tree(lambda t: by_id.get(id(t)), params)


def make_train_step(cfg: ModelCfg, opt_cfg: OptCfg, *, q_chunk: int = 1024,
                    remat: bool = True, microbatch: int = 1, acc_dtype=F32):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), ``params`` a ``trainable`` tree updated in place.

    ``microbatch > 1`` accumulates gradients (in ``acc_dtype``) over that
    many sequential micro-steps, each taking consecutive rows of the
    batch (a DTensor batch, split over the mesh's batch axes: every
    microbatch-th row, so each micro-step stays split; the means are the
    same sums in another order); loss, CE and aux are their means."""

    def grad_of(params, batch):
        loss, (ce, aux) = loss_fn(cfg, params, batch, q_chunk=q_chunk, remat=remat)
        return loss.detach(), ce.detach(), aux.detach(), tree_grads(loss, params)

    def train_step(params, opt_state: OptState, batch: Batch):
        if microbatch == 1:
            loss, ce, aux, grads = grad_of(params, batch)
        else:
            def part(x, j):
                if x is None:
                    return None
                n = x.shape[0] // microbatch
                if is_dtensor(x):
                    # every microbatch-th row: the rows stay split over the
                    # batch axes (a slice of the split dim would gather it)
                    return x.reshape((n, microbatch) + tuple(x.shape[1:]))[:, j]
                return x[j * n:(j + 1) * n]

            grads = map_tree(lambda p: torch.zeros_like(
                p, dtype=acc_dtype, memory_format=torch.contiguous_format), params)
            loss = ce = aux = torch.zeros((), dtype=F32, device=batch.tokens.device)
            for j in range(microbatch):
                mb = Batch(*(part(f, j) for f in batch))
                l, c, a, g = grad_of(params, mb)
                for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gg.to(acc.dtype))
                loss, ce, aux = loss + l, ce + c, aux + a
            grads = map_tree(lambda g: g / microbatch, grads)
            loss, ce, aux = loss / microbatch, ce / microbatch, aux / microbatch
        params, opt_state, om = apply_updates(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, "ce": ce, "moe_aux": aux, **om}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelCfg, *, q_chunk: int = 1024):
    @torch.no_grad()
    def eval_step(params, batch: Batch):
        loss, (ce, aux) = loss_fn(cfg, params, batch, q_chunk=q_chunk, remat=False)
        return {"loss": loss, "ce": ce}
    return eval_step
