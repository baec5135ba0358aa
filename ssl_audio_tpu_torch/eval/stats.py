"""Per-class classification statistics: AP (mAP), ROC AUC, d-prime (port
of ssl_audio_tpu/eval/stats.py; reference old/utils/stats.py:17-60).

The JAX package takes average precision and ROC AUC from scikit-learn,
which the card's machine does not have; here they are numpy, with
scikit-learn's definitions: scores ranked high to low, tied scores one
threshold, AP = sum over thresholds of (recall step) x precision, AUC the
trapezoid under (false positive rate, true positive rate) from (0, 0).
"""
from __future__ import annotations

from typing import List

import numpy as np


def _binary_clf_curve(target: np.ndarray, score: np.ndarray):
    """Positives and negatives at or above each distinct score, highest
    score first: (tps, fps)."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, target = score[order], target[order]
    last = np.r_[np.where(np.diff(score))[0], target.size - 1]
    tps = np.cumsum(target, dtype=np.float64)[last]
    return tps, 1.0 + last - tps


def binary_average_precision(target: np.ndarray, score: np.ndarray) -> float:
    """sklearn.metrics.average_precision_score of one binary column: 0.0
    when it has no positive (scikit-learn warns and gives 0)."""
    tps, fps = _binary_clf_curve(np.asarray(target), np.asarray(score))
    if tps[-1] == 0:
        return 0.0
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(recall, prepend=0.0) * precision))


def average_precision(target: np.ndarray, score: np.ndarray) -> float:
    """Macro-averaged AP over the columns of (N, C) targets and scores, or
    the AP of one binary (N,) column (sklearn's average_precision_score)."""
    target, score = np.asarray(target), np.asarray(score)
    if target.ndim == 1:
        return binary_average_precision(target, score)
    return float(np.mean([binary_average_precision(target[:, k], score[:, k])
                          for k in range(target.shape[1])]))


def roc_auc(target: np.ndarray, score: np.ndarray) -> float:
    """sklearn.metrics.roc_auc_score of one binary column with both
    classes present."""
    tps, fps = _binary_clf_curve(np.asarray(target), np.asarray(score))
    tpr = np.r_[0.0, tps] / tps[-1]
    fpr = np.r_[0.0, fps] / fps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def d_prime(auc: float) -> float:
    # scipy.stats costs ~3 s to import: only here, where it is used
    from scipy import stats as scipy_stats

    return scipy_stats.norm().ppf(auc) * np.sqrt(2.0)


def calculate_stats(output: np.ndarray, target: np.ndarray) -> List[dict]:
    """output: (N, C) scores; target: (N, C) binary.  One dict per class
    with AP, AUC and d-prime; classes without a positive or without a
    negative are skipped."""
    stats = []
    for k in range(target.shape[1]):
        t, o = target[:, k], output[:, k]
        if t.sum() == 0 or t.sum() == len(t):
            continue
        auc = roc_auc(t, o)
        stats.append({"AP": binary_average_precision(t, o), "auc": auc,
                      "d_prime": d_prime(auc), "class": k})
    return stats


def mean_average_precision(output: np.ndarray, target: np.ndarray) -> float:
    s = calculate_stats(output, target)
    return float(np.mean([x["AP"] for x in s])) if s else float("nan")
