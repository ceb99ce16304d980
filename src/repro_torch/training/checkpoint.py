"""Flat-npz checkpoints of parameter and optimizer trees, in the JAX
package's ``training/checkpoint.py`` layout, so each package reads the
other's files.

A leaf's key is its path as ``jax.tree_util.tree_flatten_with_path``
prints it (``models.init.map_paths``), under ``params/`` or ``opt/``
(``opt/.step``, ``opt/.mu/['blocks']/[0]/['mixer']/['wq']``).  bf16 is
stored as f32 (npz has no bf16; the load casts back per the template,
losslessly), the step under ``__step__``.  ``models.init.load_npz_params``
stays the serving reader, which needs no template.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..models.init import leaf_paths, map_paths


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save(path: str, params: Any, opt_state: Any = None, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {k: _to_numpy(t) for k, t in leaf_paths(params, "params/")}
    if opt_state is not None:
        arrays.update({k: _to_numpy(t) for k, t in leaf_paths(opt_state, "opt/")})
    arrays["__step__"] = np.asarray(step)
    np.savez(path, **arrays)


def _restore(data, template, prefix: str):
    def read(key, t):
        arr = data[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {arr.shape} != template {tuple(t.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=t.device, dtype=t.dtype)
    return map_paths(read, template, prefix)


def load(path: str, params_template: Any, opt_template: Any = None):
    """Restore into the structure, dtypes and devices of the templates:
    (params, step), or (params, opt_state, step) with ``opt_template``."""
    with np.load(path, allow_pickle=False) as data:
        params = _restore(data, params_template, "params/")
        step = int(data["__step__"])
        if opt_template is not None:
            return params, _restore(data, opt_template, "opt/"), step
    return params, step
