"""Evaluation metrics: AUROC, AUPRC, best-threshold F1.

The port's own copy of ``medical_tri_modal_pilot_tpu/train/metrics.py``,
with the same F1-sweep deviation from the reference (PARITY.md §2.6).

Reimplements the reference Evaluator (builder/utils/metrics.py:26-107):
batches of (y_true, sigmoid(y_pred)) accumulate on host; AUROC/AUPRC match
torchmetrics/sklearn definitions; F1 is maximized by sweeping the 99
thresholds 0.01..0.99 (metrics.py:64-92). Pure numpy — runs on host once
per validation, off the device hot path.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Rank-statistic AUROC with tie handling (== sklearn roc_auc_score)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = y_true.sum()
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks over ties
    i = 0
    r = np.arange(1, len(y_score) + 1, dtype=np.float64)
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i:j + 1] = (i + j + 2) / 2.0
        i = j + 1
    ranks[order] = r
    return float((ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def auprc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision (== sklearn average_precision_score)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = y_true.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    s = y_score[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1 - y)
    precision = tp / (tp + fp)
    recall = tp / n_pos
    # collapse ties: keep last point of each distinct score
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, len(s) - 1]
    precision, recall = precision[idx], recall[idx]
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def best_f1(y_true: np.ndarray, y_score: np.ndarray
            ) -> Tuple[float, float, float, float]:
    """Sweep thresholds 0.01..0.99; return (f1, threshold, tpr, tnr)."""
    y_true = np.asarray(y_true).astype(bool)
    best = (0.0, 0.5, 0.0, 0.0)
    for t in np.arange(0.01, 1.0, 0.01):
        pred = y_score >= t
        tp = np.sum(pred & y_true)
        fp = np.sum(pred & ~y_true)
        fn = np.sum(~pred & y_true)
        tn = np.sum(~pred & ~y_true)
        denom = 2 * tp + fp + fn
        f1 = 2 * tp / denom if denom else 0.0
        if f1 > best[0]:
            tpr = tp / max(tp + fn, 1)
            tnr = tn / max(tn + fp, 1)
            best = (float(f1), float(t), float(tpr), float(tnr))
    return best


class Evaluator:
    """Accumulates predictions per eval pass (metrics.py:26-107)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._y: List[np.ndarray] = []
        self._p: List[np.ndarray] = []
        self._rmse: List[np.ndarray] = []
        self.best_auc = 0.0

    def add_batch(self, y_true, y_prob, rmse: Optional[np.ndarray] = None):
        y = np.asarray(y_true)
        p = np.asarray(y_prob)
        if p.ndim == 2 and y.ndim == 1:
            # classification/softmax mode: integer hour-bucket labels vs
            # [B, K] probabilities — micro-average by one-hotting (the
            # reference's evaluator cannot consume this combination at
            # all, metrics.py:49-70; this is the graceful equivalent)
            y = np.eye(p.shape[1], dtype=np.float32)[y.astype(int).clip(
                0, p.shape[1] - 1)]
        self._y.append(y.reshape(-1))
        self._p.append(p.reshape(-1))
        if rmse is not None:
            self._rmse.append(np.asarray(rmse).reshape(-1))

    def performance_metric(self):
        y = np.concatenate(self._y) if self._y else np.zeros(0)
        p = np.concatenate(self._p) if self._p else np.zeros(0)
        # aux-rmse aggregate (metrics.py:83-88): the mean of the per-batch
        # rmse scalars passed to add_batch — reported next to auc/apr/f1
        # whenever any were accumulated
        rmse = (dict(rmse=float(np.mean(np.concatenate(self._rmse))))
                if self._rmse else {})
        if len(y) == 0:
            return dict(auc=float("nan"), apr=float("nan"), f1=0.0,
                        threshold=0.5, tpr=0.0, tnr=0.0, **rmse)
        auc = auroc(y, p)
        apr = auprc(y, p)
        f1, thr, tpr, tnr = best_f1(y, p)
        return dict(auc=auc, apr=apr, f1=f1, threshold=thr, tpr=tpr,
                    tnr=tnr, **rmse)
