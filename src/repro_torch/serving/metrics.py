"""Video-level accuracy metrics (paper §5 Metrics).

A video is a True Positive if >= 2 consecutive windows answer 'Yes'
(anomalous) and the ground truth is anomalous; the inverse for normal
videos.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# The kernel ops the stage thread calls (encode, prefill, decode), whose
# verdicts a window's ``kernel_fallbacks`` counts.  The JAX package
# counts its silent oracle fallbacks of flash_refresh, flash_refresh_paged
# and flash_packed; the port has no fallback (a refused call raises on
# the card), so it counts every call the card would refuse, of every op
# on that thread.  ``mv_sad`` runs at ``open`` and in the ingest threads,
# whose calls would land in another window's delta.
FALLBACK_OPS = ("flash_refresh", "flash_refresh_paged", "flash_refresh_paged_int8",
                "flash_packed", "rope_shift", "ssd_scan")


def kernel_fallback_delta(
    before: Dict[str, Dict[str, int]],
    after: Dict[str, Dict[str, int]],
    ops: Sequence[str] = FALLBACK_OPS,
) -> int:
    """Calls the card refuses between two ``kernels.ops.card_verdicts()``
    snapshots: every verdict but ``ok``.  Always 0 on the card, where
    such a call raises; on the CPU, the calls the card would refuse."""
    total = 0
    for op in ops:
        b, a = before.get(op, {}), after.get(op, {})
        for key, n in a.items():
            if key != "ok":
                total += n - b.get(key, 0)
    return total


def video_prediction(window_answers: Sequence[int], consecutive: int = 2) -> int:
    """1 iff >= ``consecutive`` consecutive positive windows."""
    run = 0
    for a in window_answers:
        run = run + 1 if a else 0
        if run >= consecutive:
            return 1
    return 0


def precision_recall_f1(
    preds: Sequence[int], truths: Sequence[int]
) -> Tuple[float, float, float]:
    tp = sum(1 for p, t in zip(preds, truths) if p == 1 and t == 1)
    fp = sum(1 for p, t in zip(preds, truths) if p == 1 and t == 0)
    fn = sum(1 for p, t in zip(preds, truths) if p == 0 and t == 1)
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return prec, rec, f1


def agreement(preds_a: Sequence[int], preds_b: Sequence[int]) -> float:
    """Output agreement between two system variants on the same inputs
    (isolates the system's approximation error from model quality)."""
    assert len(preds_a) == len(preds_b)
    if not preds_a:
        return 1.0
    return sum(1 for a, b in zip(preds_a, preds_b) if a == b) / len(preds_a)
