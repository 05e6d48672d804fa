"""Evaluation metrics — host copy of ``misinfo_tpu/train/metrics.py``
(numpy only; held to the original by tests/test_torch_host.py): numpy
implementations of the sklearn reports the
reference trainers rely on as their de-facto test harness
(classification_report / confusion_matrix, reference
train_roberta_detective.py:295-299, train_ai_head.py:485-488), so eval
summaries don't require sklearn at serving time (it is used when present
for cross-checking in tests).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def confusion_matrix(y_true: Sequence[int], y_pred: Sequence[int],
                     num_classes: Optional[int] = None) -> np.ndarray:
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    n = num_classes or int(max(y_true.max(initial=0),
                               y_pred.max(initial=0))) + 1
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def classification_report(y_true: Sequence[int], y_pred: Sequence[int],
                          target_names: Optional[List[str]] = None) -> Dict:
    """→ {class: {precision, recall, f1, support}, accuracy, macro_*}."""
    cm = confusion_matrix(y_true, y_pred)
    n = cm.shape[0]
    names = target_names or [str(i) for i in range(n)]
    report: Dict = {}
    precs, recs, f1s = [], [], []
    for c in range(n):
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c, :].sum() - tp
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        report[names[c]] = {"precision": float(prec), "recall": float(rec),
                            "f1": float(f1), "support": int(cm[c, :].sum())}
        precs.append(prec)
        recs.append(rec)
        f1s.append(f1)
    report["accuracy"] = float(np.trace(cm) / max(1, cm.sum()))
    report["macro_precision"] = float(np.mean(precs))
    report["macro_recall"] = float(np.mean(recs))
    report["macro_f1"] = float(np.mean(f1s))
    return report


def format_report(report: Dict) -> str:
    lines = [f"{'class':>12}  {'prec':>6} {'recall':>6} {'f1':>6} {'support':>8}"]
    for k, v in report.items():
        if isinstance(v, dict):
            lines.append(f"{k:>12}  {v['precision']:6.3f} {v['recall']:6.3f} "
                         f"{v['f1']:6.3f} {v['support']:8d}")
    lines.append(f"accuracy: {report['accuracy']:.4f}   "
                 f"macro-f1: {report['macro_f1']:.4f}")
    return "\n".join(lines)
