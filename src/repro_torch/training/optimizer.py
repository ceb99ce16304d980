"""AdamW + cosine schedule + global-norm clipping, formula for formula as
the JAX package's ``training/optimizer.py`` (not ``torch.optim.AdamW``,
which applies the decay before the moment step).

The update math is f32 whatever the parameter dtype: the gradient scaled
by the clip factor, moments ``b * m + (1 - b) * g``, bias corrections
``1 - b ** step``, ``delta = mhat / (sqrt(vhat) + eps) + wd * p`` and
``p - lr * delta``, each result cast back to its leaf's dtype.  The
schedule and the bias corrections are f32 scalars computed on the host
from the step count; the clip factor stays on the gradients' device.
``apply_updates`` writes the parameters and moments in place (the
stacked leaves themselves, not views of them) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from ..models.init import map_tree, tree_leaves

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # or "bfloat16"


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Any
    nu: Any


def init_opt_state(params, cfg: OptCfg) -> OptState:
    """Zero moments shaped like ``params`` in the state dtype (a DTensor
    leaf's moments are DTensors of its placements); step 0 on the device
    of the first leaf."""
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else F32

    def zeros(p):
        return torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)

    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    map_tree(zeros, params), map_tree(zeros, params))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def schedule(cfg: OptCfg, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``: an f32
    scalar (CPU tensor) for the integer ``step``."""
    step = _f32(float(step))
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * cos


# a leaf above this many elements is taken in slices along its first
# dimension (the stacked layers), so that its f32 temporaries are one
# slice's: mamba2-2.7b's 64 stacked in_proj hold 1.73 G elements, 6.5 GB
# in f32 for each temporary of the update.  The update is elementwise, so
# slices give the same values; a slice's sum of squares is summed in
# slice order
SLICE_ELEMS = 1 << 28


def _slices(*ts):
    """``ts`` (tensors of one shape) whole, or in matching slices along
    the first dimension of at most about ``SLICE_ELEMS`` elements."""
    t = ts[0]
    if t.numel() <= SLICE_ELEMS or t.dim() == 0:
        yield ts
        return
    per = max(1, SLICE_ELEMS // max(t[0].numel(), 1))
    for i in range(0, t.shape[0], per):
        yield tuple(u[i:i + per] for u in ts)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the JAX package's leaf order) of
    each leaf's f32 sum of squares."""
    total = 0
    for leaf in tree_leaves(tree):
        for (part,) in _slices(leaf):
            total = total + torch.sum(part.to(F32) ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptCfg) -> Tuple[Any, OptState, dict]:
    """One AdamW step over every leaf of ``params`` (``grads`` has the
    same structure; a None gradient counts as zero).  Parameters and
    moments are updated in place; returns (params, the new state,
    {"lr", "grad_norm"})."""
    step = int(state.step) + 1
    lr = schedule(cfg, step)
    flat_g = [g if g is not None else torch.zeros_like(p)
              for p, g in zip(tree_leaves(params), tree_leaves(grads))]
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - _f32(b1) ** _f32(float(step)))
    bc2 = float(1 - _f32(b2) ** _f32(float(step)))
    lr_f = float(lr)            # an f32 value, exact as a Python float
    for leaf in zip(tree_leaves(params), flat_g, tree_leaves(state.mu),
                    tree_leaves(state.nu)):
        for p, g, m, v in _slices(*leaf):
            g = g.to(F32) * scale
            m_new = b1 * m.to(F32) + (1 - b1) * g
            v_new = b2 * v.to(F32) + (1 - b2) * g * g
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
            p.copy_(p.to(F32) - lr_f * delta)
            m.copy_(m_new)
            v.copy_(v_new)
    new_step = torch.full((), step, dtype=torch.int32, device=state.step.device)
    return params, OptState(new_step, state.mu, state.nu), {"lr": lr, "grad_norm": gnorm}
