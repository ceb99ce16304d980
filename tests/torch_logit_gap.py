"""Largest |yes/no logit| gap between the JAX package and the port, per
parity configuration of the CPU tests; the logit tolerances of
``test_torch_serving.py``, ``torch_mode_parity.py`` and
``test_torch_recurrent.py`` are set from these readings.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_logit_gap.py

Serves each configuration through both lockstep schedulers on the same
weights and videos (``torch_mode_parity.serve``, and
``test_torch_recurrent.serve`` for mamba2-2.7b-smoke) and prints one
line per configuration; a few minutes on a CPU.
"""
import numpy as np

import test_torch_recurrent as recurrent
import torch_mode_parity as parity

ATTENTION = {"codecflow-paged": ("codecflow", True, "bf16", 0.5),
             "codecflow-stream": ("codecflow", False, "bf16", 0.5),
             "codecflow-int8": ("codecflow", True, "int8", 1.0),
             "vlcache-paged": ("vlcache", True, "bf16", 0.5),
             "vlcache-stream": ("vlcache", False, "bf16", 0.5),
             "cacheblend-paged": ("cacheblend", True, "bf16", 0.5),
             "cacheblend-stream": ("cacheblend", False, "bf16", 0.5),
             **{f"{m}-{'paged' if p else 'stream'}": (m, p, "bf16", 0.5)
                for m in ("fullcomp", "prune_only", "refresh_only") for p in (True, False)}}


def gap(results_jax, results_port) -> float:
    return max(float(np.abs(np.asarray(a.stats.logits_yes_no)
                            - np.asarray(b.stats.logits_yes_no)).max())
               for sid, res in results_jax.items()
               for a, b in zip(res, results_port[sid]))


def main() -> None:
    for name, cfg in ATTENTION.items():
        j, t = parity.serve(*cfg)
        print(f"{parity.ARCH} {name}: {gap(j[1], t[1]):.6g}", flush=True)
    for mode in recurrent.MODES:
        j, t, _, _ = recurrent.serve(mode)
        print(f"{recurrent.ARCH} {mode}: {gap(j[1], t[1]):.6g}", flush=True)


if __name__ == "__main__":
    main()
