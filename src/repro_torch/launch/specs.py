"""Dry-run program construction, the JAX package's ``launch/specs.py``:
step function + meta arguments + shardings for every (architecture x
input shape x mesh) combination, plus the per-layer parts the roofline
assembly multiplies (``analysis.roofline``).

Arguments are meta tensors (shapes and dtypes, no storage); ``place``
turns them into DTensors on the mesh by their shardings, and the dry
run runs the program eagerly on them (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelCfg, ShapeCfg
from ..configs.registry import LONG_CONTEXT_WINDOW
from ..models import layers
from ..models import transformer as tfm
from ..models.init import logical_specs, map_tree, meta_lm_params
from ..sharding import rules as shr
from ..training.optimizer import OptCfg, OptState, apply_updates
from ..training.train_step import Batch, chunked_cross_entropy, make_train_step

F32 = torch.float32
BF16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def shape_adapted_cfg(cfg: ModelCfg, shape: ShapeCfg) -> ModelCfg:
    """long_500k on attention archs runs the sliding-window variant."""
    if (
        shape.name == "long_500k"
        and cfg.sliding_window is None
        and "attn" in cfg.block_pattern
        and cfg.family in ("dense", "moe", "vlm")
    ):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def opt_cfg_for(cfg: ModelCfg) -> OptCfg:
    """bf16 optimizer moments for the >=100B-class models (HBM budget)."""
    big = cfg.param_count() >= 60e9
    return OptCfg(state_dtype="bfloat16" if big else "float32")


def abstract_state(cfg: ModelCfg):
    """(meta params, logical specs, meta opt state, opt cfg).  The
    state's step is a host scalar: the update reads it on the host."""
    params = meta_lm_params(cfg)
    ocfg = opt_cfg_for(cfg)
    dt = BF16 if ocfg.state_dtype == "bfloat16" else F32
    moment = map_tree(lambda p: _meta(p.shape, dt), params)
    opt = OptState(torch.zeros((), dtype=torch.int32), moment,
                   map_tree(lambda p: _meta(p.shape, dt), params))
    return params, logical_specs(cfg), opt, ocfg


def abstract_caches(cfg: ModelCfg, batch: int, max_len: int) -> tfm.Caches:
    return tfm.init_caches(cfg, batch, max_len, device="meta")


def cache_shardings(cfg: ModelCfg, caches, mesh, batch: int, *, seq_shard: bool):
    kv = shr.kv_cache_spec(mesh, batch, seq_shard=seq_shard,
                           n_kv=cfg.n_kv, d_head=cfg.d_head)
    if cfg.ssm is not None:
        di = cfg.ssm.d_inner(cfg.d_model)
        conv, ssm = shr.ssm_cache_specs(
            mesh, batch, n_heads=cfg.ssm.n_heads(cfg.d_model),
            conv_dim=di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state,
        )
    else:
        conv, ssm = shr.ssm_cache_specs(mesh, batch)
    named = lambda spec: shr.NamedSharding(mesh, spec)

    def per_block(blk):
        if isinstance(blk, layers.KVCache):
            return layers.KVCache(named(kv), named(kv))
        return layers.SSMCache(named(conv), named(ssm))

    cross = None
    if caches.cross is not None:
        cs = named(shr.kv_cache_spec(mesh, batch, seq_shard=False, n_kv=cfg.n_kv,
                                     d_head=cfg.d_head))
        cross = (cs, cs)
    return tfm.Caches(tuple(per_block(b) for b in caches.blocks), cross)


def place(tree, shardings):
    """Each meta leaf of ``tree`` as a DTensor on its sharding's mesh
    (``rules.NamedSharding``); None stays None, other leaves (the host
    step) stay as they are."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(v, s) for v, s in zip(tree, shardings)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    if tree is None or shardings is None or not torch.is_tensor(tree):
        return tree
    return distribute_tensor(tree, shardings.mesh, shardings.placements, src_data_rank=None)


# ======================================================================
# Step-function + spec construction per shape kind
# ======================================================================
@dataclasses.dataclass
class DryRunProgram:
    name: str
    fn: Callable
    args: tuple                 # meta arguments
    in_shardings: Any
    parts: list                 # [(name, multiplier, fn, args, shardings)]
    model_flops: float
    grad: bool = False          # run under autograd (train)


def _train_batch_specs(cfg: ModelCfg, shape: ShapeCfg, mesh):
    B, S = shape.global_batch, shape.seq_len
    dp = shr.NamedSharding(mesh, shr.data_spec(mesh, B, 2))
    dp3 = shr.NamedSharding(mesh, shr.data_spec(mesh, B, 3))
    tok = _meta((B, S), torch.int32)
    batch = dict(tokens=tok, targets=tok, loss_mask=_meta((B, S), F32))
    shard = dict(tokens=dp, targets=dp, loss_mask=dp)
    if cfg.family == "vlm":
        batch["inputs_embeds"] = _meta((B, S, cfg.d_model), BF16)
        batch["embed_mask"] = _meta((B, S), torch.bool)
        shard["inputs_embeds"] = dp3
        shard["embed_mask"] = dp
    if cfg.enc_dec:
        batch["enc_feats"] = _meta((B, cfg.enc_seq, cfg.d_model), BF16)
        shard["enc_feats"] = dp3
    b = Batch(**batch)
    s = Batch(**{**{k: None for k in Batch._fields}, **shard})
    return b, s


def _model_flops(cfg: ModelCfg, shape: ShapeCfg) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token


def _layer_slice(tree, specs):
    """One layer of a stacked position: leaves without their leading
    layer axis, specs without its None."""
    if isinstance(tree, dict):
        return ({k: _layer_slice(v, specs[k])[0] for k, v in tree.items()},
                {k: _layer_slice(v, specs[k])[1] for k, v in tree.items()})
    return _meta(tree.shape[1:], tree.dtype), specs[1:]


def _grads(f, *xs):
    """d f(*xs) / d each floating leaf of xs (meta trees made leaves that
    require grad)."""
    from ..models.init import tree_leaves, trainable
    xs = tuple(trainable(x) for x in xs)
    out = f(*xs)
    leaves = [t for t in tree_leaves(xs) if t.is_floating_point()]
    return torch.autograd.grad(out, leaves, allow_unused=True)


def microbatch_count(want: int, batch: int, data_shards: int) -> int:
    """The reference's microbatch count (the least of at least ``want``
    that divides ``batch``), kept at most ``batch / data_shards`` where
    the shards divide the batch: each microbatch then still holds whole
    rows on every data shard.  DTensor splits a dim only evenly, so a
    microbatch of fewer rows than data shards (32 of 8 rows over 16 at
    qwen1.5-110b's train_4k) cannot be cut from the sharded batch, where
    the reference's GSPMD pads; either way a device holds at least one
    row's remat saves."""
    cap = batch // data_shards if batch % data_shards == 0 else batch
    micro = min(want, cap)
    while cap % micro:
        micro += 1
    return micro


def build_program(cfg: ModelCfg, shape: ShapeCfg, mesh, *, q_chunk: int = 512,
                  overrides: dict | None = None) -> DryRunProgram:
    """``overrides`` — the JAX package's hillclimb knobs:
      no_fsdp: bool   — TP-only params (replicate over data).
      seq_shard_acts: bool — TP-SP residual boundaries (``launch.dryrun``
                        sets it in ``sharding.ctx``).
      micro_budget: float — remat-save byte budget for microbatching.
      q_chunk: int    — attention query chunk.
      moe_cf: float   — MoE capacity factor.
      ssd_chunk: int  — SSD scan chunk.
      chunk_parts: bool — attention parts at one query chunk x (S / q_chunk).
      acc_bf16: bool  — bf16 gradient accumulation over microbatches.
    """
    ov = overrides or {}
    q_chunk = int(ov.get("q_chunk", q_chunk))
    cfg = shape_adapted_cfg(cfg, shape)
    if ov.get("moe_cf") and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(ov["moe_cf"])))
    if ov.get("ssd_chunk") and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=int(ov["ssd_chunk"])))
    params, specs, opt, ocfg = abstract_state(cfg)
    rules = shr.default_rules(mesh)
    if ov.get("no_fsdp"):
        rules = dict(rules, embed=None)
    pshard = shr.param_shardings(specs, mesh, rules=rules, params_tree=params)
    B, S = shape.global_batch, shape.seq_len
    named = lambda spec: shr.NamedSharding(mesh, spec)

    def layer_params_at(pos):
        lp, specs1 = _layer_slice(params["blocks"][pos], specs["blocks"][pos])
        return lp, shr.param_shardings(specs1, mesh, rules=rules, params_tree=lp)

    dp3 = named(shr.data_spec(mesh, B, 3))
    dp2 = named(shr.data_spec(mesh, B, 2))

    def part_len(pos):
        """Mamba positions at one SSD chunk, multiplied; with
        ``chunk_parts`` attention positions at one query chunk against
        the whole sequence, multiplied (the per-chunk KV re-read)."""
        if cfg.block_pattern[pos] == "mamba" and S > cfg.ssm.chunk:
            lp_len = cfg.ssm.chunk
            return lp_len, cfg.repeats * (S // lp_len)
        if ov.get("chunk_parts") and S > q_chunk and S % q_chunk == 0:
            return q_chunk, cfg.repeats * (S // q_chunk)
        return S, cfg.repeats

    # a tied head is the embedding's transpose, laid out as such
    tied = cfg.tied_embeddings
    head_w = _meta((cfg.d_model, cfg.vocab), params["embed"].dtype) if tied \
        else params["lm_head"]
    head_sh = named(pshard["embed"].spec[::-1]) if tied else pshard["lm_head"]
    parts = []
    grad = False
    if shape.kind == "train":
        grad = True
        opt_shard = OptState(None, pshard, pshard)
        batch, bshard = _train_batch_specs(cfg, shape, mesh)
        # Microbatch so the rematerialization boundary saves
        # (n_layers x micro_tokens x d_model x 2B / data_shards) stay
        # within a ~5 GiB budget per device.
        sizes = shr.axis_sizes(mesh)
        dshard = 1
        for a in ("pod", "data"):
            dshard *= sizes.get(a, 1)
        tok_budget = float(ov.get("micro_budget", 5e9)) * dshard / (
            cfg.n_layers * cfg.d_model * 2)
        micro = max(1, int(-(-B * S // max(tok_budget, 1))))
        micro = microbatch_count(micro, B, dshard)
        acc_dtype = BF16 if ov.get("acc_bf16") else F32
        step = make_train_step(cfg, ocfg, q_chunk=q_chunk, remat=True,
                               microbatch=micro, acc_dtype=acc_dtype)

        def fn(p, o, b):
            from ..models.init import trainable
            return step(trainable(p), o, b)

        args = (params, opt, batch)
        in_sh = (pshard, opt_shard, bshard)

        def embed_head(pe, pn, ph, tokens, targets, mask):
            def f(pe, pn, ph):
                h = layers.embed_lookup(pe, tokens)
                hn = layers.rmsnorm(pn, h, cfg.norm_eps)
                # chunk = S: one segment, as the reference's scan-free part
                return chunked_cross_entropy(hn, ph, targets, mask, chunk=S)
            return _grads(f, pe, pn, ph)

        parts.append((
            "embed_head", 1, embed_head,
            (params["embed"], params["final_norm"], head_w,
             batch.tokens, batch.targets, batch.loss_mask),
            (pshard["embed"], pshard["final_norm"], head_sh,
             bshard.tokens, bshard.targets, bshard.loss_mask),
        ))
        for pos in range(cfg.period):
            lp, lsh = layer_params_at(pos)
            Lp, mult = part_len(pos)

            def layer_fb(lp, h, _pos=pos, _L=Lp):
                def block(lp, h):
                    pos_ids = torch.arange(_L, dtype=torch.int32, device="meta")[None] \
                        .expand(B, _L)
                    return tfm._apply_block(
                        cfg, _pos, lp, h, pos_ids, None, None, None, None, None,
                        decode=False, q_chunk=_L, scatter_idx=None, kv_valid=None,
                        block_map=None, page_table=None, page_size=128)

                def f(lp, h):
                    # recomputed in the backward, as the step's layers are
                    out, aux = checkpoint(block, lp, h, use_reentrant=False,
                                          preserve_rng_state=False)
                    total = torch.sum(out.to(F32))
                    return total + aux if aux is not None else total
                return _grads(f, lp, h)

            parts.append((f"layer{pos}", mult, layer_fb,
                          (lp, _meta((B, Lp, cfg.d_model), BF16)), (lsh, dp3)))

        def opt_only(p, o):
            g = map_tree(torch.zeros_like, p)
            return apply_updates(p, g, o, ocfg)[0]

        parts.append(("optimizer", 1, opt_only, (params, opt), (pshard, opt_shard)))

    elif shape.kind == "prefill":
        caches = abstract_caches(cfg, B, S)
        if cfg.enc_dec:
            kv = (cfg.repeats, B, cfg.enc_seq, cfg.n_kv, cfg.d_head)
            caches = tfm.Caches(caches.blocks, (_meta(kv, BF16), _meta(kv, BF16)))
        csh = cache_shardings(cfg, caches, mesh, B, seq_shard=False)

        if cfg.family == "vlm":
            def fn(p, embeds, caches):
                toks = torch.zeros((B, S), dtype=torch.int32, device="meta")
                return tfm.prefill(cfg, p, toks, caches, inputs_embeds=embeds,
                                   q_chunk=q_chunk)[:2]
            args = (params, _meta((B, S, cfg.d_model), BF16), caches)
            in_sh = (pshard, dp3, csh)
        elif cfg.enc_dec:
            def fn(p, tokens, enc_feats, caches):
                enc = tfm.run_encoder(cfg, p, enc_feats, q_chunk)
                cross = tfm.build_cross_kv(cfg, p, enc)
                caches2 = tfm.Caches(caches.blocks, cross)
                return tfm.prefill(cfg, p, tokens, caches2, q_chunk=q_chunk)[:2]
            args = (params, _meta((B, S), torch.int32),
                    _meta((B, cfg.enc_seq, cfg.d_model), BF16),
                    tfm.Caches(caches.blocks, None))
            in_sh = (pshard, dp2, dp3, tfm.Caches(csh.blocks, None))
        else:
            def fn(p, tokens, caches):
                return tfm.prefill(cfg, p, tokens, caches, q_chunk=q_chunk)[:2]
            args = (params, _meta((B, S), torch.int32), caches)
            in_sh = (pshard, dp2, csh)

        parts.append(("embed", 1, layers.embed_lookup,
                      (params["embed"], _meta((B, S), torch.int32)), (pshard["embed"], dp2)))
        for pos in range(cfg.period):
            lp, lsh = layer_params_at(pos)
            Lp, mult = part_len(pos)
            blk1 = type(caches.blocks[pos])(
                *(_meta(x.shape[1:], x.dtype) for x in caches.blocks[pos]))
            bsh1 = type(csh.blocks[pos])(
                *(named(s.spec[1:]) for s in csh.blocks[pos]))

            def layer_pf(lp, h, c, _pos=pos, _L=Lp):
                pos_ids = torch.arange(_L, dtype=torch.int32, device="meta")[None] \
                    .expand(B, _L)
                out, _ = tfm._apply_block(
                    cfg, _pos, lp, h, pos_ids, None, c, 0, None, None, decode=False, q_chunk=_L, scatter_idx=None, kv_valid=None,
                    block_map=None, page_table=None, page_size=128)
                return out, c

            parts.append((f"layer{pos}", mult, layer_pf,
                          (lp, _meta((B, Lp, cfg.d_model), BF16), blk1), (lsh, dp3, bsh1)))
        parts.append(("head", 1, lambda ph, h: layers.f32_matmul(h[:, -1], ph),
                      (head_w, _meta((B, S, cfg.d_model), BF16)), (head_sh, dp3)))

    else:  # decode
        seq_shard = B == 1
        caches = abstract_caches(cfg, B, S)
        if cfg.enc_dec:
            kv = (cfg.repeats, B, cfg.enc_seq, cfg.n_kv, cfg.d_head)
            caches = tfm.Caches(caches.blocks, (_meta(kv, BF16), _meta(kv, BF16)))
        csh = cache_shardings(cfg, caches, mesh, B, seq_shard=seq_shard)

        def fn(p, tok, caches):
            return tfm.decode_step(cfg, p, tok, caches, S - 1)

        args = (params, _meta((B, 1), torch.int32), caches)
        in_sh = (pshard, dp2, csh)

        parts.append(("embed", 1, layers.embed_lookup,
                      (params["embed"], _meta((B, 1), torch.int32)), (pshard["embed"], dp2)))
        for pos in range(cfg.period):
            lp, lsh = layer_params_at(pos)
            blk1 = type(caches.blocks[pos])(
                *(_meta(x.shape[1:], x.dtype) for x in caches.blocks[pos]))
            bsh1 = type(csh.blocks[pos])(*(named(s.spec[1:]) for s in csh.blocks[pos]))

            def layer_dc(lp, h, c, _pos=pos):
                pos_ids = torch.full((B, 1), S - 1, dtype=torch.int32, device="meta")
                out, _ = tfm._apply_block(
                    cfg, _pos, lp, h, pos_ids, None, c, S - 1, S, None,
                    decode=True, q_chunk=q_chunk, scatter_idx=None, kv_valid=None,
                    block_map=None, page_table=None, page_size=128)
                return out, c

            parts.append((f"layer{pos}", cfg.repeats, layer_dc,
                          (lp, _meta((B, 1, cfg.d_model), BF16), blk1), (lsh, dp3, bsh1)))
        parts.append(("head", 1, lambda ph, h: layers.f32_matmul(h[:, -1], ph),
                      (head_w, _meta((B, 1, cfg.d_model), BF16)), (head_sh, dp3)))

    return DryRunProgram(
        name=f"{cfg.name}:{shape.name}", fn=fn, args=args, in_shardings=in_sh,
        parts=parts, model_flops=_model_flops(cfg, shape), grad=grad,
    )
