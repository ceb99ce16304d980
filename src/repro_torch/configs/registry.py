"""Architecture registry: ``--arch <id>`` resolution for all launchers."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelCfg, smoke_variant

_MODULES = {
    "jamba-v0.1-52b": ".jamba_v01_52b",
    "olmoe-1b-7b": ".olmoe_1b_7b",
    "mamba2-2.7b": ".mamba2_2p7b",
    "mistral-large-123b": ".mistral_large_123b",
    "arctic-480b": ".arctic_480b",
    "deepseek-7b": ".deepseek_7b",
    "internvl2-76b": ".internvl2_76b",
    "moonshot-v1-16b-a3b": ".moonshot_v1_16b_a3b",
    "whisper-large-v3": ".whisper_large_v3",
    "qwen1.5-110b": ".qwen15_110b",
    "internvl3-14b": ".internvl3_14b_paper",
}

ASSIGNED: List[str] = [k for k in _MODULES if k != "internvl3-14b"]


def get_config(name: str) -> ModelCfg:
    if name.endswith("-smoke"):
        return smoke_variant(get_config(name[: -len("-smoke")]))
    mod = importlib.import_module(_MODULES[name], __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelCfg]:
    return {n: get_config(n) for n in _MODULES}


# Shapes an architecture must skip, with the reason (DESIGN.md §5).
SKIPS = {
    ("whisper-large-v3", "long_500k"):
        "full-attention encoder-decoder; no sliding-window analogue",
}

# Dense/MoE/VLM archs run long_500k via the sliding-window variant.
LONG_CONTEXT_WINDOW = 8192


def shape_plan(name: str):
    """(shape_name, runnable, note) for every assigned input shape."""
    from .base import INPUT_SHAPES

    out = []
    for s in INPUT_SHAPES:
        if (name, s) in SKIPS:
            out.append((s, False, SKIPS[(name, s)]))
        else:
            out.append((s, True, ""))
    return out
