# Copied from src/repro/core/metrics.py; only the import paths differ.
"""Performance metrics exactly as defined in the paper (Section 5.2).

Precision (eq. 3) is the *overall accuracy* (the paper's idiosyncratic
definition), recall (eq. 4) is macro-averaged per-class accuracy, and the
F-measure (eq. 5) is their harmonic mean.
"""
from __future__ import annotations

import numpy as np


def precision(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(y_true == y_pred))


def recall(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> float:
    vals = []
    for c in range(num_classes):
        m = y_true == c
        if m.sum() == 0:
            continue
        vals.append(float(np.mean(y_pred[m] == c)))
    return float(np.mean(vals)) if vals else 0.0


def f_measure(y_true: np.ndarray, y_pred: np.ndarray,
              num_classes: int) -> float:
    p = precision(y_true, y_pred)
    r = recall(y_true, y_pred, num_classes)
    if p + r == 0:
        return 0.0
    return 2.0 * p * r / (p + r)


# ---------------------------------------------------------------------------
# confusion-count forms — the streamed-eval path of the scan engine
# (repro.core.cityscan) evaluates on device and brings back only an integer
# confusion matrix per window; these helpers recover the EXACT paper metrics
# from those counts. Bitwise equality with the label-array forms above holds
# because every quantity is an integer/integer float64 division (exact for
# counts < 2^53) followed by the same float ops in the same order
# (tests/test_cityscan.py property-checks the equivalence).
# ---------------------------------------------------------------------------

def confusion_counts(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """Confusion matrix ``cm[true, pred]`` as int64 counts."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (np.asarray(y_true, np.int64), np.asarray(y_pred, np.int64)),
              1)
    return cm


def precision_from_confusion(cm: np.ndarray) -> float:
    return float(np.trace(cm) / cm.sum())


def recall_from_confusion(cm: np.ndarray) -> float:
    vals = []
    for c in range(cm.shape[0]):
        row = cm[c].sum()
        if row == 0:
            continue
        vals.append(float(cm[c, c] / row))
    return float(np.mean(vals)) if vals else 0.0


def f_measure_from_confusion(cm: np.ndarray) -> float:
    p = precision_from_confusion(cm)
    r = recall_from_confusion(cm)
    if p + r == 0:
        return 0.0
    return 2.0 * p * r / (p + r)


# ---------------------------------------------------------------------------
# Robust aggregation (DESIGN.md §13): coordinate-wise trimmed mean over the
# leading axis — the all-to-all combine's defence against faulty/byzantine
# DCs. With n contributions and trim fraction ``frac``, ``k = floor(frac*n)``
# extremes are dropped per coordinate from each end; k == 0 degrades to the
# plain mean bit-for-bit (same np.mean call), which is what keeps
# ``robust_agg="mean"`` runs bitwise identical to pre-robust builds.
# ---------------------------------------------------------------------------

def trimmed_mean(stack: np.ndarray, frac: float, axis: int = 0) -> np.ndarray:
    """Coordinate-wise ``frac``-trimmed mean along ``axis``."""
    if not 0.0 <= frac < 0.5:
        raise ValueError(f"trim fraction must be in [0, 0.5), got {frac}")
    n = stack.shape[axis]
    k = int(frac * n)
    if k == 0:
        return np.mean(stack, axis=axis)
    s = np.sort(stack, axis=axis)
    sl = [slice(None)] * s.ndim
    sl[axis] = slice(k, n - k)
    return np.mean(s[tuple(sl)], axis=axis)
