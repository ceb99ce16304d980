"""Parameter initialisation and the weight bridge from the JAX package.

The parameter trees keep the JAX package's structure and layouts:
nested dicts of tensors, weights (in, out), each pattern position's
layers stacked on a leading axis, RMSNorm scales and mamba's ``A_log``,
``D``, ``dt_bias`` and gated-norm ``norm`` f32, every other leaf in the
config's dtype.

* ``init_lm_params`` / ``init_vit_params`` draw random weights on the
  target device tensor by tensor (one layer slice at a time) from an
  explicit ``torch.Generator``: truncated-normal fan-in, like the JAX
  package's ``ParamBuilder.dense``.  No f32 copy of the model is ever
  built.  The numbers differ from JAX's (different generators).
* ``from_numpy_tree`` takes the JAX package's trees as numpy arrays
  (parameters, and an optimizer state ``(step, mu, nu)``).
* ``load_npz_params`` reads the ``training/checkpoint.py`` npz layout
  (flat ``params/...`` keys, bf16 saved as f32 and cast back
  losslessly; the f32 leaves stay f32).
* ``trainable`` makes a tree's floating leaves leaf tensors that require
  grad; ``detached`` gives the same values with no autograd history
  (what serving takes).
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelCfg, ViTCfg

F32 = torch.float32
# checkpoint leaves kept in f32 whatever the config's dtype
F32_LEAVES = ("['scale']", "['A_log']", "['D']", "['dt_bias']", "['norm']")


def param_dtype(cfg: ModelCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else F32


class _Init:
    """Fills parameter tensors on one device from one generator.  Every
    leaf is made with its logical axes (one per dim of the unstacked
    leaf, the JAX package's ``ParamBuilder`` annotations), which this
    builder ignores; ``_Specs`` and ``_Meta`` build the same tree from
    them."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _fill(self, out: torch.Tensor, scale: float) -> None:
        tmp = torch.empty(out.shape, dtype=F32, device=self.device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        out.copy_(tmp.mul_(scale))

    def dense(self, shape, logical, scale: float | None = None, layers: int = 0) -> torch.Tensor:
        """Truncated-normal fan-in init; ``layers > 0`` stacks that many
        independent draws on a leading axis, filled one layer at a time."""
        shape = tuple(shape)
        if scale is None:
            scale = (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5
        if not layers:
            out = torch.empty(shape, dtype=self.dtype, device=self.device)
            self._fill(out, scale)
            return out
        out = torch.empty((layers,) + shape, dtype=self.dtype, device=self.device)
        for i in range(layers):
            self._fill(out[i], scale)
        return out

    def ones(self, shape, logical, layers: int = 0) -> torch.Tensor:
        lead = (layers,) if layers else ()
        return torch.ones(lead + tuple(shape), dtype=F32, device=self.device)

    def zeros(self, shape, logical, layers: int = 0) -> torch.Tensor:
        lead = (layers,) if layers else ()
        return torch.zeros(lead + tuple(shape), dtype=self.dtype, device=self.device)

    def f32_rows(self, row: torch.Tensor, logical, layers: int = 0) -> torch.Tensor:
        """An f32 vector on the device, repeated per layer."""
        t = row.to(dtype=F32, device=self.device)
        return t.expand((layers,) + t.shape).clone() if layers else t


class _Specs:
    """Builds the logical-axes tree: each leaf its axes, a stacked leaf
    led by None (the layer axis)."""

    @staticmethod
    def _axes(logical, layers: int):
        return ((None,) if layers else ()) + tuple(logical)

    def dense(self, shape, logical, scale=None, layers: int = 0):
        return self._axes(logical, layers)

    def ones(self, shape, logical, layers: int = 0):
        return self._axes(logical, layers)

    zeros = ones

    def f32_rows(self, row, logical, layers: int = 0):
        return self._axes(logical, layers)


class _Meta:
    """Builds the tree of meta tensors (shapes and dtypes, no storage):
    the dry run's parameters."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def _empty(self, shape, layers: int, dtype):
        lead = (layers,) if layers else ()
        return torch.empty(lead + tuple(shape), dtype=dtype, device="meta")

    def dense(self, shape, logical, scale=None, layers: int = 0):
        return self._empty(shape, layers, self.dtype)

    def ones(self, shape, logical, layers: int = 0):
        return self._empty(shape, layers, F32)

    def zeros(self, shape, logical, layers: int = 0):
        return self._empty(shape, layers, self.dtype)

    def f32_rows(self, row, logical, layers: int = 0):
        return self._empty(row.shape, layers, F32)


def _mamba_params(ini: _Init, cfg: ModelCfg, R: int) -> Dict[str, Any]:
    """One mamba position, made like the JAX package's ``init_mamba``:
    A = -[1 .. 16], dt_bias the inverse softplus of [1e-3 .. 1e-1]."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    a = torch.linspace(1.0, 16.0, nh, dtype=F32)
    dt = torch.linspace(1e-3, 1e-1, nh, dtype=F32)
    return {
        "in_proj": ini.dense((d, 2 * di + 2 * gn + nh), ("embed", "ssm_inner"), layers=R),
        "conv_w": ini.dense((s.d_conv, di + 2 * gn), (None, "ssm_inner"), scale=0.5,
                           layers=R),
        "conv_b": ini.zeros((di + 2 * gn,), ("ssm_inner",), layers=R),
        "A_log": ini.f32_rows(torch.log(a), (None,), layers=R),
        "D": ini.ones((nh,), (None,), layers=R),
        "dt_bias": ini.f32_rows(torch.log(torch.expm1(dt)), (None,), layers=R),
        "norm": ini.ones((di,), (None,), layers=R),
        "out_proj": ini.dense((di, d), ("ssm_inner", "embed"), layers=R),
    }


def _attention_params(ini: _Init, cfg: ModelCfg, R: int) -> Dict[str, Any]:
    d, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": ini.dense((d, cfg.n_heads * dh), ("embed", "heads"), layers=R),
        "wk": ini.dense((d, cfg.n_kv * dh), ("embed", "kv"), layers=R),
        "wv": ini.dense((d, cfg.n_kv * dh), ("embed", "kv"), layers=R),
        "wo": ini.dense((cfg.n_heads * dh, d), ("heads", "embed"), layers=R),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((cfg.n_heads * dh,), ("heads",), layers=R)
        p["bk"] = ini.zeros((cfg.n_kv * dh,), ("kv",), layers=R)
        p["bv"] = ini.zeros((cfg.n_kv * dh,), ("kv",), layers=R)
    return p


def _mlp_params(ini: _Init, d: int, d_ff: int, R: int) -> Dict[str, Any]:
    return {
        "wg": ini.dense((d, d_ff), ("embed", "ffn"), layers=R),
        "wu": ini.dense((d, d_ff), ("embed", "ffn"), layers=R),
        "wd": ini.dense((d_ff, d), ("ffn", "embed"), layers=R),
    }


def _moe_params(ini: _Init, cfg: ModelCfg, R: int) -> Dict[str, Any]:
    """One MoE position, made like the JAX package's ``init_moe``: the
    router (d, E) at scale 0.02, experts (E, d, f) / (E, f, d) at fan-in
    scale, and arctic's dense residual MLP."""
    m, d = cfg.moe, cfg.d_model
    p = {
        "router": ini.dense((d, m.n_experts), ("embed", None), scale=0.02, layers=R),
        "wg": ini.dense((m.n_experts, d, m.d_ff_expert), ("experts", "embed", None), layers=R),
        "wu": ini.dense((m.n_experts, d, m.d_ff_expert), ("experts", "embed", None), layers=R),
        "wd": ini.dense((m.n_experts, m.d_ff_expert, d), ("experts", None, "embed"), layers=R),
    }
    if m.dense_residual:
        p["residual"] = _mlp_params(ini, d, cfg.d_ff, R)
    return p


def _cross_attention_params(ini: _Init, cfg: ModelCfg, R: int) -> Dict[str, Any]:
    d, dh = cfg.d_model, cfg.d_head
    return {
        "wq": ini.dense((d, cfg.n_heads * dh), ("embed", "heads"), layers=R),
        "wk": ini.dense((d, cfg.n_kv * dh), ("embed", "kv"), layers=R),
        "wv": ini.dense((d, cfg.n_kv * dh), ("embed", "kv"), layers=R),
        "wo": ini.dense((cfg.n_heads * dh, d), ("heads", "embed"), layers=R),
    }


def init_lm_params(cfg: ModelCfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random LM parameters for every block kind of the configs: an
    attention or mamba mixer, then a dense, MoE or no FFN.  Keys follow
    the JAX package's ``_init_block``: ``ln2`` unless the FFN is
    ``"none"``; an encoder-decoder config (whisper) adds each block's
    ``lnx`` and ``xattn`` (cross-attention), and ``encoder`` (its
    ``enc_layers`` stacked: ln1, attention mixer, ln2, dense FFN),
    ``enc_norm`` and ``enc_embed`` (d, d), as ``init_params`` does."""
    return _lm_tree(_Init(seed, device, param_dtype(cfg)), cfg)


def logical_specs(cfg: ModelCfg) -> Dict[str, Any]:
    """The logical axes of every leaf of ``init_lm_params``' tree (same
    keys and leaf paths): ``"embed"``, ``"heads"``, ``"kv"``, ``"ffn"``,
    ``"vocab"``, ``"experts"``, ``"ssm_inner"`` or None per dim, a
    stacked leaf led by None; the JAX package's ``init_params`` specs.
    ``sharding.rules.param_shardings`` maps them onto a mesh."""
    return _lm_tree(_Specs(), cfg)


def meta_lm_params(cfg: ModelCfg) -> Dict[str, Any]:
    """``init_lm_params``' tree as meta tensors (shapes and dtypes only):
    the dry run describes a 480 B-parameter model without allocating it."""
    return _lm_tree(_Meta(param_dtype(cfg)), cfg)


def _lm_tree(ini, cfg: ModelCfg) -> Dict[str, Any]:
    d, R = cfg.d_model, cfg.repeats
    tree: Dict[str, Any] = {
        "embed": ini.dense((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "final_norm": {"scale": ini.ones((d,), (None,))},
    }
    if not cfg.tied_embeddings:
        tree["lm_head"] = ini.dense((d, cfg.vocab), ("embed", "vocab"))
    blocks = []
    for pos in range(cfg.period):
        mixer, ffn = cfg.block_kind(pos)
        blk: Dict[str, Any] = {"ln1": {"scale": ini.ones((d,), (None,), layers=R)}}
        blk["mixer"] = (_attention_params(ini, cfg, R) if mixer == "attn"
                        else _mamba_params(ini, cfg, R))
        if ffn != "none":
            blk["ln2"] = {"scale": ini.ones((d,), (None,), layers=R)}
            blk["ffn"] = (_moe_params(ini, cfg, R) if ffn == "moe"
                          else _mlp_params(ini, d, cfg.d_ff, R))
        if cfg.enc_dec:
            blk["lnx"] = {"scale": ini.ones((d,), (None,), layers=R)}
            blk["xattn"] = _cross_attention_params(ini, cfg, R)
        blocks.append(blk)
    tree["blocks"] = tuple(blocks)
    if cfg.enc_dec:
        L = cfg.enc_layers
        tree["encoder"] = {
            "ln1": {"scale": ini.ones((d,), (None,), layers=L)},
            "mixer": _attention_params(ini, cfg, L),
            "ln2": {"scale": ini.ones((d,), (None,), layers=L)},
            "ffn": _mlp_params(ini, d, cfg.d_ff, L),
        }
        tree["enc_norm"] = {"scale": ini.ones((d,), (None,))}
        tree["enc_embed"] = ini.dense((d, d), (None, "embed"))
    return tree


def init_vit_params(v: ViTCfg, d_lm: int, seed: int = 1, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random ViT + projector parameters."""
    ini = _Init(seed, device, dtype)
    d, L = v.d_model, v.n_layers
    return {
        "patch_embed": ini.dense((v.patch * v.patch, d), (None, "embed")),
        "pos_embed": ini.dense((v.n_patches, d), (None, "embed"), scale=0.02),
        "blocks": {
            "ln1": {"scale": ini.ones((d,), (None,), layers=L)},
            "wq": ini.dense((d, d), ("embed", "heads"), layers=L),
            "wk": ini.dense((d, d), ("embed", "heads"), layers=L),
            "wv": ini.dense((d, d), ("embed", "heads"), layers=L),
            "wo": ini.dense((d, d), ("heads", "embed"), layers=L),
            "ln2": {"scale": ini.ones((d,), (None,), layers=L)},
            "ffn": {
                "wg": ini.dense((d, v.d_ff), ("embed", "ffn"), layers=L),
                "wu": ini.dense((d, v.d_ff), ("embed", "ffn"), layers=L),
                "wd": ini.dense((v.d_ff, d), ("ffn", "embed"), layers=L),
            },
        },
        "final_norm": {"scale": ini.ones((d,), (None,))},
        "projector": ini.dense((v.group * v.group * d, d_lm), (None, "embed")),
    }


# ======================================================================
# weight bridge
# ======================================================================
def to_tensor(arr, device="cpu") -> torch.Tensor:
    """numpy array (ml_dtypes bf16 included) -> tensor of the same dtype.

    ``torch.from_numpy`` rejects ml_dtypes bf16, so it goes through f32,
    which holds every bf16 value exactly.
    """
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)     # a writable copy


def from_numpy_tree(tree, device="cpu"):
    """The JAX package's parameter tree (``tfm.init_params`` LM tree or
    ``vitm.init_vit`` ViT tree, leaves as numpy arrays) -> the port's.
    A named tuple with the fields ``(step, mu, nu)`` (the JAX package's
    ``OptState``) becomes the port's ``training.optimizer.OptState``."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == ("step", "mu", "nu"):
        from ..training.optimizer import OptState
        return OptState(*(from_numpy_tree(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(from_numpy_tree(v, device) for v in tree)
    return to_tensor(tree, device)


def map_tree(fn, tree):
    """``fn`` over every tensor leaf of nested dicts, tuples and lists
    (named tuples keep their type)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def map_paths(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` over every leaf in the JAX package's flattening
    order (dict keys sorted, sequence items and named-tuple fields in
    order); returns the tree of results.  A leaf's key is its path as
    ``jax.tree_util.tree_flatten_with_path`` prints it, after ``prefix``:
    ``['key']`` per dict level, ``[i]`` per sequence index, ``.field``
    per named-tuple field, joined by ``/``
    (``['blocks']/[0]/['mixer']/['wq']``, ``.mu/['embed']``).  The
    checkpoint layout's keys; ``load_npz_params`` parses them back."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(t[k], path + [f"['{k}']"]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, path + [f".{n}"]) for n, v in zip(t._fields, t)))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, path + [f"[{i}]"]) for i, v in enumerate(t))
        return fn(prefix + "/".join(path), t)
    return walk(tree, [])


def leaf_paths(tree, prefix: str = "") -> list:
    """(key, leaf) pairs of ``map_paths``, in its order."""
    out = []
    map_paths(lambda k, t: out.append((k, t)), tree, prefix)
    return out


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's flattening order."""
    return [t for _, t in leaf_paths(tree)]


def trainable(tree):
    """The same values as leaf tensors, the floating ones requiring grad
    (they share storage with ``tree``'s)."""
    return map_tree(lambda t: t.detach().requires_grad_(t.is_floating_point()), tree)


def detached(tree):
    """The same values with no autograd history and no ``requires_grad``."""
    return map_tree(lambda t: t.detach() if torch.is_tensor(t) else t, tree)


# one segment of a ``map_paths`` key below a dict or a sequence
_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _insert(tree: Dict[str, Any], path: str, value) -> None:
    parts = []
    for seg in path.split("/"):
        m = _KEY.fullmatch(seg)
        if m is None:
            raise ValueError(f"unexpected checkpoint key segment {seg!r}")
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
    node = tree
    for here, nxt in zip(parts, parts[1:] + [None]):
        fresh = value if nxt is None else ([] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            node.extend([None] * (here + 1 - len(node)))
            if node[here] is None:
                node[here] = fresh
            node = node[here]
        else:
            node = node.setdefault(here, fresh)


def _freeze(tree):
    if isinstance(tree, dict):
        return {k: _freeze(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return tuple(_freeze(v) for v in tree)
    return tree


def load_npz_params(path: str, cfg: ModelCfg, device="cpu") -> Dict[str, Any]:
    """LM parameters from a ``training/checkpoint.py`` npz: keys like
    ``params/['blocks']/[0]/['mixer']/['wq']``; norm scales and mamba's
    ``A_log``, ``D``, ``dt_bias`` and ``norm`` (``F32_LEAVES``) stay f32,
    every other leaf is cast back to the config's dtype."""
    dtype = param_dtype(cfg)
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if not key.startswith("params/"):
                continue
            rel = key[len("params/"):]
            t = torch.from_numpy(data[key]).to(device)
            leaf_dtype = F32 if rel.endswith(F32_LEAVES) else dtype
            _insert(tree, rel, t.to(leaf_dtype))
    return _freeze(tree)
