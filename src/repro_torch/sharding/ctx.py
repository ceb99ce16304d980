"""Activation-sharding context, the JAX package's ``sharding/ctx.py``.

Model code is mesh-agnostic; launchers install the active mesh here and
layer code calls ``constrain(x, ...logical axes...)`` at the tensor-
parallel cut points (post-QKV heads, MLP hidden, MoE expert buffers,
SSM inner), where a ``DTensor`` is redistributed to the resolved
placements.  ``local`` runs a function on the local shards
(``torch.distributed.tensor.experimental.local_map``) where an op has no
DTensor strategy, or is a kernel that cannot see a DTensor.

Constraints follow the active mesh (``activation_mesh``), local regions
the mesh of their DTensor operands.  Without either (CPU tests,
serving, the meshless trainer) ``constrain`` returns its input and
``local`` is the function itself.
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Optional

import torch

from .rules import axis_names, axis_sizes

_STATE = threading.local()


def set_mesh(mesh) -> None:
    _STATE.mesh = mesh


def get_mesh():
    return getattr(_STATE, "mesh", None)


def set_seq_sharding(on: bool) -> None:
    """Sequence-parallel layer boundaries: the residual stream is
    sharded over 'model' along its sequence dim between layers."""
    _STATE.seq_shard = on


def seq_sharding() -> bool:
    return getattr(_STATE, "seq_shard", False)


@contextmanager
def activation_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def batch_axes() -> Optional[tuple]:
    mesh = get_mesh()
    if mesh is None:
        return None
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def resolve(shape, axes, mesh) -> tuple:
    """Per-dim mesh-axis entries for ``axes`` ('batch' | 'model' | 'data'
    | None per dim): 'batch' is (pod, data) where that divides the dim,
    else 'data' where that does, else None; an axis that does not divide
    its dim is dropped."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    resolved = []
    for a in axes:
        dim = shape[len(resolved)]
        if a == "batch":
            ba = tuple(ax for ax in ("pod", "data") if ax in names)
            size = 1
            for ax in ba:
                size *= sizes[ax]
            if dim % size == 0 and dim >= size:
                resolved.append(ba)
            elif "data" in names and dim % sizes["data"] == 0 and dim >= sizes["data"]:
                resolved.append("data")
            else:
                resolved.append(None)
        else:
            if a is not None and dim % sizes[a] != 0:
                a = None  # uneven: leave the dim whole
            resolved.append(a)
    return tuple(resolved)


def placements(shape, *axes) -> tuple:
    """The DTensor placements ``constrain`` would give a tensor of
    ``shape`` on the active mesh."""
    from .rules import to_placements
    mesh = get_mesh()
    return to_placements(resolve(shape, axes, mesh), mesh)


@functools.cache
def _dtensor_type():
    """DTensor's class, imported on first use."""
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  A plain tensor or None is answered
    without importing DTensor, so a meshless process never imports it
    (the model code asks on every layer)."""
    if x is None or type(x) is torch.Tensor:
        return False
    return isinstance(x, _dtensor_type())


def mesh_of(*tensors):
    """The device mesh of the first DTensor among ``tensors``; None if
    there is none (local regions follow the operands, constraints the
    active mesh)."""
    for t in tensors:
        if is_dtensor(t):
            return t.device_mesh
    return None


def whole(mesh):
    """The placements of a tensor every rank holds whole (Replicate on
    each mesh dim); None without a mesh."""
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def constrain(x, *axes):
    """axes: per-dim entries of 'batch' | 'model' | 'data' | None.  A
    DTensor is redistributed to the resolved placements on the active
    mesh; anything else, or no active mesh, returns ``x`` as it is."""
    mesh = get_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(x.shape, *axes))


def split_last(x, *sizes):
    """``x`` (..., prod(sizes)) viewed as (..., *sizes).  A DTensor whose
    last dim is split over a mesh axis that does not divide ``sizes[0]``
    (a smoke model's 4 heads over a 16-way axis) is first made whole along
    that axis: DTensor cannot view an uneven split, where GSPMD reshards."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh, last = x.device_mesh, x.dim() - 1
        pl = [Replicate() if p in (Shard(last), Shard(-1)) and sizes[0] % mesh.size(i)
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], *sizes)


def replicated(t: torch.Tensor, mesh):
    """A plain tensor that every rank holds whole, as a replicated DTensor
    on ``mesh`` (positions, masks made inside the step)."""
    if mesh is None or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _grad_placements(in_placements, out_placements) -> tuple:
    """Each input's gradient layout: where an input is whole on a mesh
    dim but some output is split or partial there, the ranks along that
    dim use it differently, so its local gradients are partial sums
    (Partial); elsewhere the input's own placement."""
    from torch.distributed.tensor import Partial, Replicate
    outs = [o for o in out_placements if o is not None]
    split = [any(o[i] != Replicate() for o in outs) for i in range(len(outs[0]))]
    return tuple(
        None if pl is None else tuple(
            Partial() if p == Replicate() and split[i] else p for i, p in enumerate(pl))
        for pl in in_placements)


def local(fn, out_placements, in_placements, mesh):
    """``fn`` run on the local shards of its DTensor arguments on
    ``mesh``, each first redistributed to its entry of ``in_placements``
    (None: not a tensor); its outputs become DTensors with
    ``out_placements``.  Plain tensor arguments count as replicated.  The
    backward sums each input's local gradients over the mesh dims where
    the ranks' outputs differ (``_grad_placements``).  Without a mesh,
    ``fn`` itself."""
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import local_map

    mapped = local_map(fn, out_placements=out_placements, in_placements=in_placements,
                       in_grad_placements=_grad_placements(in_placements, out_placements),
                       device_mesh=mesh, redistribute_inputs=True)

    def run(*args):
        return mapped(*(replicated(a, mesh) if torch.is_tensor(a) else a for a in args))
    return run


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def coordinate(mesh, axes) -> tuple:
    """(index, count) of this rank's shard along ``axes`` (an axis name,
    a tuple of them major first, or None: (0, 1))."""
    i, n = 0, 1
    for ax in axes_of(axes):
        size = mesh.size(mesh.mesh_dim_names.index(ax))
        i, n = i * size + mesh.get_local_rank(ax), n * size
    return i, n


@contextmanager
def whole_mesh_strategies():
    """While active, DTensor takes an op's whole-mesh sharding strategy
    where it also has a single-dim one (torch 2.13 has both for mm,
    addmm, bmm, baddbmm, clone and max/min.out; 2.11 has no single-dim
    strategies, so there this changes nothing).  On the FSDP x TP layouts
    of the rules, 2.13's single-dim expansion runs products whole over one
    mesh axis: deepseek-7b-smoke's train step on a fake 2x2 mesh counts,
    per device, 1.70x the one-device FLOPs over 4 under that expansion
    and 1.00x under the whole-mesh strategies.  So the sharded step and
    the dry run's counts are those of one program on either version.  The
    strategy tables and both sharding caches are restored on exit."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", None)
    if single is None:
        yield
        return
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    dropped = {op: single.pop(op) for op in list(single) if op in prop.op_strategy_funcs}
    _clear_sharding_prop_cache()
    try:
        yield
    finally:
        single.update(dropped)
        _clear_sharding_prop_cache()
