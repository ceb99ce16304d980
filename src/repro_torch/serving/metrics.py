"""Video-level accuracy metrics (paper §5 Metrics).

A video is a True Positive if >= 2 consecutive windows answer 'Yes'
(anomalous) and the ground truth is anomalous; the inverse for normal
videos.
"""
from __future__ import annotations

from typing import Sequence, Tuple


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
