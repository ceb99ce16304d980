"""Logical-axis -> mesh-axis sharding rules, the JAX package's
``sharding/rules.py``.

Tensor parallelism lives on the ``model`` axis (heads / kv / ffn /
experts / vocab / ssm_inner); parameters are additionally FSDP-sharded
along their ``embed`` dimension over ``data`` (and ``pod`` when
present).  Activations shard batch over (pod, data); long-context
decode (batch=1) shards the KV-cache sequence dimension over ``data``
instead.

A spec is a tuple with one entry per tensor dim: ``None``, a mesh-axis
name, or a tuple of names (the JAX package's ``PartitionSpec`` entries,
so the two packages' specs compare directly).  ``to_placements`` turns
one into DTensor placements, one per mesh dim.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or a
``MeshShape`` (names and sizes only, like JAX's ``AbstractMesh``): the
rules read nothing else.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

Logical = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]


class MeshShape(NamedTuple):
    """Mesh-axis sizes and names without devices."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def spec(*entries) -> Spec:
    """A spec from per-dim entries, normalised as ``PartitionSpec``
    normalises them: a one-axis tuple becomes the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def map_specs(fn, tree):
    """``fn`` over every logical-spec leaf of nested dicts and tuples."""
    if _is_logical(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return tuple(map_specs(fn, v) for v in tree)


def default_rules(mesh) -> Dict[Optional[str], Any]:
    names = axis_names(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    fsdp = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    return {
        "embed": fsdp,          # FSDP over data(+pod)
        "heads": "model",
        "kv": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "ssm_inner": "model",
        None: None,
    }


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


def logical_to_pspec(logical: Logical, rules: Dict, shape: Optional[Tuple[int, ...]] = None,
                     mesh=None) -> Spec:
    """Resolve logical axes; drop mesh axes that do not divide the dim
    (e.g. the 50280 vocab of mamba2 is not divisible by the 16-way model
    axis)."""
    entries = []
    for i, ax in enumerate(logical):
        e = rules.get(ax, None)
        if e is not None and shape is not None and mesh is not None:
            if shape[i] % _axis_size(mesh, e) != 0:
                e = None
        entries.append(e)
    return spec(*entries)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements, one per mesh dim: ``Shard(d)`` on each mesh
    dim that tensor dim d's entry names (a tuple entry shards d over its
    axes in mesh order, as a ``PartitionSpec`` does), ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    by_axis = {}
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                if a not in names:
                    raise ValueError(f"spec {spec} names axis {a!r} outside {names}")
                by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate() for a in names)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the JAX package's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def param_shardings(specs_tree: Any, mesh, rules: Optional[Dict] = None,
                    params_tree: Any = None):
    """Map the logical-spec tree (``models.init.logical_specs``) to
    ``NamedSharding`` leaves.  ``params_tree`` (meta or real tensors, the
    same structure) enables the divisibility checks."""
    rules = rules or default_rules(mesh)
    if params_tree is None:
        return map_specs(lambda lg: NamedSharding(mesh, logical_to_pspec(lg, rules)),
                         specs_tree)

    def walk(s, p):
        if _is_logical(s):
            return NamedSharding(mesh, logical_to_pspec(s, rules, tuple(p.shape), mesh))
        if isinstance(s, dict):
            return {k: walk(v, p[k]) for k, v in s.items()}
        return tuple(walk(a, b) for a, b in zip(s, p))
    return walk(specs_tree, params_tree)


def param_pspecs(specs_tree: Any, mesh, rules: Optional[Dict] = None):
    rules = rules or default_rules(mesh)
    return map_specs(lambda lg: logical_to_pspec(lg, rules), specs_tree)


# ----------------------------------------------------------------------
# Activation / batch / cache shardings
# ----------------------------------------------------------------------
def batch_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _batch_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def data_spec(mesh, batch: int, rank: int) -> Spec:
    """Shard dim 0 (batch) over (pod, data) when divisible."""
    ba, size, data = batch_axes(mesh), _batch_size(mesh), axis_sizes(mesh)["data"]
    first = ba if batch % size == 0 and batch >= size else (
        ("data",) if batch % data == 0 and batch >= data else None)
    return spec(first, *(None,) * (rank - 1))


def kv_cache_spec(mesh, batch: int, *, seq_shard: bool, n_kv: int = 0,
                  d_head: int = 0) -> Spec:
    """(R, B, S, K, dh) cache sharding.

    Large-batch decode: shard batch on data.  batch==1 long-context:
    shard the sequence dim on data instead (flash-decoding style).
    The head axis prefers K on 'model'; when K doesn't divide the model
    axis (e.g. 8 kv-heads over 16-way TP) it shards d_head instead.
    """
    m = axis_sizes(mesh)["model"]
    if n_kv and n_kv % m == 0:
        head_ax, dh_ax = "model", None
    elif d_head and d_head % m == 0:
        head_ax, dh_ax = None, "model"
    else:
        head_ax, dh_ax = None, None
    ba, size = batch_axes(mesh), _batch_size(mesh)
    if not seq_shard and batch % size == 0 and batch >= size:
        return spec(None, ba, None, head_ax, dh_ax)
    if seq_shard:
        return spec(None, None, "data", head_ax, dh_ax)
    return spec(None, None, None, head_ax, dh_ax)


def ssm_cache_specs(mesh, batch: int, n_heads: int = 0,
                    conv_dim: int = 0) -> Tuple[Spec, Spec]:
    """conv (R, B, K-1, C) and ssm (R, B, H, P, N) state shardings."""
    m = axis_sizes(mesh)["model"]
    c_ax = "model" if (conv_dim == 0 or conv_dim % m == 0) else None
    h_ax = "model" if (n_heads == 0 or n_heads % m == 0) else None
    ba, size = batch_axes(mesh), _batch_size(mesh)
    if batch % size == 0 and batch >= size:
        return spec(None, ba, None, c_ax), spec(None, ba, h_ax, None, None)
    return spec(None, None, None, c_ax), spec(None, None, h_ax, None, None)
