"""Collective traffic of a step, counted as DTensor issues it: the
counterpart of the JAX package's ``analysis/hlo.py``, which parses the
compiled HLO text.  The port has no HLO, so the functional collectives
(``_c10d_functional.all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single``) are counted where they run, on
local (per-device) tensors, in ``hlo.collective_bytes``' schema:
``{kind: {"count", "operand_bytes", "result_bytes"}}`` with the HLO's
names for the kinds.  An all-gather's operand is the shard and its
result the whole tensor; a reduce-scatter's the reverse.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def collective_kind(func) -> str | None:
    """The HLO name of a functional collective op, None for any other op."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return None
    return _KIND.get(func._schema.name.split("::")[-1])


def nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


class CollectiveCounter:
    """Counts of the collectives ``record`` is given."""

    def __init__(self):
        self.detail = defaultdict(lambda: {"count": 0, "operand_bytes": 0.0,
                                           "result_bytes": 0.0})

    def record(self, kind: str, operand, result) -> None:
        d = self.detail[kind]
        d["count"] += 1
        d["operand_bytes"] += nbytes(operand)
        d["result_bytes"] += nbytes(result)

    def collective_bytes(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.detail.items()}

    def total_collective_bytes(self) -> float:
        """Sum of operand sizes over every collective (the roofline input)."""
        return sum(v["operand_bytes"] for v in self.detail.values())
