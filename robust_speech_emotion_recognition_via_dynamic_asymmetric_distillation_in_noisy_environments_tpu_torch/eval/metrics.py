"""Deterministic numpy metrics with sklearn-equivalent semantics.

The reference leans on sklearn everywhere (train.py:20-24, 553-564); report
JSONs are scraped downstream by the ablation harness, so numbers must match
sklearn's conventions exactly:
- balanced_accuracy = mean recall over classes PRESENT in y_true
- precision/recall/f1 with zero_division=0
- weighted F1 weighted by support
A copy of the JAX package's metrics (numpy only).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    if len(y_true) and (y_true.min() < 0 or y_pred.min() < 0):
        # sklearn raises too; negative ids (e.g. the -1 "unlabeled"
        # sentinel) would otherwise wrap into the LAST class row silently
        raise ValueError("negative label ids — filter unlabeled rows first")
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if len(y_true) else 0.0


def balanced_accuracy(y_true, y_pred, num_classes: int) -> float:
    cm = confusion_matrix(y_true, y_pred, num_classes)
    support = cm.sum(axis=1)
    present = support > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.where(present, np.diag(cm) / np.maximum(support, 1), np.nan)
    return float(np.nanmean(recall[present])) if present.any() else 0.0


def precision_recall_fscore_support(y_true, y_pred, num_classes: int):
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)
    pred_count = cm.sum(axis=0).astype(np.float64)
    precision = np.where(pred_count > 0, tp / np.maximum(pred_count, 1), 0.0)
    recall = np.where(support > 0, tp / np.maximum(support, 1), 0.0)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-300), 0.0)
    return precision, recall, f1, support.astype(np.int64)


def f1_scores(y_true, y_pred, num_classes: int) -> Dict[str, float]:
    precision, recall, f1, support = precision_recall_fscore_support(
        y_true, y_pred, num_classes
    )
    total = support.sum()
    weighted = float((f1 * support).sum() / total) if total else 0.0
    # sklearn with labels=None averages over the union of labels OBSERVED in
    # y_true/y_pred (the reference calls f1_score(average='macro') with no
    # labels arg, train.py:560) — classes absent from both sets don't count
    observed = np.zeros(num_classes, dtype=bool)
    observed[np.unique(np.concatenate([np.asarray(y_true), np.asarray(y_pred)]).astype(np.int64))] = True
    macro = float(f1[observed].mean()) if observed.any() else 0.0
    return {"weighted": weighted, "macro": macro}


def evaluate_domain(y_true, y_pred, num_classes: int) -> Dict:
    """The validate() metric bundle (reference train.py:553-564), percentages
    like the reference reports them."""
    prec, rec, f1, sup = precision_recall_fscore_support(y_true, y_pred, num_classes)
    f1s = f1_scores(y_true, y_pred, num_classes)
    return {
        "accuracy": accuracy(y_true, y_pred) * 100,
        "weighted_accuracy": balanced_accuracy(y_true, y_pred, num_classes) * 100,
        "f1_weighted": f1s["weighted"] * 100,
        "f1_macro": f1s["macro"] * 100,
        "precision_per_class": prec.tolist(),
        "recall_per_class": rec.tolist(),
        "f1_per_class": f1.tolist(),
        "support_per_class": sup.tolist(),
        "confusion_matrix": confusion_matrix(y_true, y_pred, num_classes),
    }


def classification_report_text(
    y_true, y_pred, class_names: Sequence[str], digits: int = 4
) -> str:
    """Plain-text report in sklearn's classification_report layout."""
    C = len(class_names)
    prec, rec, f1, sup = precision_recall_fscore_support(y_true, y_pred, C)
    width = max(max(len(c) for c in class_names), len("weighted avg"))
    head = f"{'':>{width}} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}\n"
    lines = [head]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name:>{width}} {prec[i]:>9.{digits}f} {rec[i]:>9.{digits}f} "
            f"{f1[i]:>9.{digits}f} {sup[i]:>9}\n"
        )
    total = sup.sum()
    acc = accuracy(y_true, y_pred)
    lines.append(f"\n{'accuracy':>{width}} {'':>9} {'':>9} {acc:>9.{digits}f} {total:>9}\n")
    macro = (prec.mean(), rec.mean(), f1.mean())
    w = sup / max(total, 1)
    weighted = ((prec * w).sum(), (rec * w).sum(), (f1 * w).sum())
    lines.append(
        f"{'macro avg':>{width}} {macro[0]:>9.{digits}f} {macro[1]:>9.{digits}f} "
        f"{macro[2]:>9.{digits}f} {total:>9}\n"
    )
    lines.append(
        f"{'weighted avg':>{width}} {weighted[0]:>9.{digits}f} "
        f"{weighted[1]:>9.{digits}f} {weighted[2]:>9.{digits}f} {total:>9}\n"
    )
    return "".join(lines)
