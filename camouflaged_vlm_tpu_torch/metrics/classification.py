"""Open-vocabulary classification evaluator.

The port's copy of `camouflaged_vlm_tpu/metrics/classification.py` kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
results.

Equivalent of the reference's `recorder/new_evaluator.py:22-119`:
top-1 / top-5 accuracy and macro-F1 over class logits.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def macro_f1_score(y_true: Sequence[int], y_pred: Sequence[int]) -> float:
    """Macro F1 over the classes present in `y_true`, an undefined precision
    counting as 0: sklearn's `f1_score(average="macro",
    labels=np.unique(y_true))`, which the JAX package calls (the card's
    host has no sklearn). Per class F1 = 2 tp / (2 tp + fp + fn)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    scores = []
    for c in np.unique(y_true):
        tp = np.count_nonzero((y_true == c) & (y_pred == c))
        fp = np.count_nonzero((y_true != c) & (y_pred == c))
        fn = np.count_nonzero((y_true == c) & (y_pred != c))
        scores.append(2.0 * tp / (2 * tp + fp + fn))
    return float(np.mean(scores))


class ClassificationEvaluator:
    def __init__(self, class_names: Optional[Sequence[str]] = None):
        self.class_names = list(class_names) if class_names else None
        self.reset()

    def reset(self):
        self._correct = 0
        self._correct5 = 0
        self._total = 0
        self._y_true = []
        self._y_pred = []

    def process(self, logits: np.ndarray, labels: np.ndarray) -> None:
        """logits: (B, C) scores; labels: (B,) int."""
        logits = np.asarray(logits)
        labels = np.asarray(labels).reshape(-1)
        pred = logits.argmax(axis=1)
        k = min(5, logits.shape[1])
        top5 = np.argpartition(-logits, k - 1, axis=1)[:, :k]
        self._correct += int((pred == labels).sum())
        self._correct5 += int(sum(labels[i] in top5[i] for i in range(len(labels))))
        self._total += len(labels)
        self._y_true.extend(labels.tolist())
        self._y_pred.extend(pred.tolist())

    def evaluate(self) -> Dict[str, float]:
        acc = 100.0 * self._correct / self._total
        top5 = 100.0 * self._correct5 / self._total
        macro_f1 = 100.0 * macro_f1_score(self._y_true, self._y_pred)
        return {
            "accuracy": acc,
            "error_rate": 100.0 - acc,
            "top5": top5,
            "macro_f1": macro_f1,
        }
