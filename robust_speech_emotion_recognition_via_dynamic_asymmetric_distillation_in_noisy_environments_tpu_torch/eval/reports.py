"""Report writers reproducing the reference's load-bearing JSON schemas.

The ablation harness scrapes ``BEST_detailed_results_epoch_*.json``, so
field names, nesting and the percent-string formatting are the
reference's (train.py:608-633 and 729-759) and the JAX package's, byte for
byte but for the final report's timestamp. The PNGs (confusion matrices,
inference's per-class bars) need matplotlib; without it they are skipped
with a warning, as in the JAX package.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils import dump_json, get_logger

logger = get_logger(__name__)


def _per_class_accuracy(cm: np.ndarray):
    return [
        (cm[i, i] / cm[i, :].sum()) if cm[i, :].sum() > 0 else 0.0
        for i in range(len(cm))
    ]


def _pct(x: float) -> str:
    return f"{x:.2f}%"


def best_detailed_results(
    results_dir: str,
    noise_info: Dict,
    fold: int,
    epoch: int,
    clean_results: Dict,
    noisy_results: Dict,
    class_names: Sequence[str],
    is_best: bool = True,
) -> str:
    def details(res):
        return {
            "precision": res["precision_per_class"],
            "recall": res["recall_per_class"],
            "f1": res["f1_per_class"],
            "support": res["support_per_class"],
            "accuracy": _per_class_accuracy(np.asarray(res["confusion_matrix"])),
        }

    def summary_of(res):
        return {
            "acc": _pct(res["accuracy"]),
            "w_acc": _pct(res["weighted_accuracy"]),
            "w_f1": _pct(res["f1_weighted"]),
        }

    summary = {
        "info": {
            "noise_config": noise_info,
            "fold": fold + 1,
            "epoch": epoch + 1,
            "is_best": is_best,
        },
        "summary": {"clean": summary_of(clean_results), "noisy": summary_of(noisy_results)},
        "details": {
            "class_names": list(class_names),
            "clean": details(clean_results),
            "noisy": details(noisy_results),
        },
    }
    name = (
        f"BEST_detailed_results_epoch_{epoch + 1}.json"
        if is_best
        else f"detailed_results_epoch_{epoch + 1}.json"
    )
    path = os.path.join(results_dir, "reports", name)
    dump_json(summary, path)
    return path


def final_test_report(
    results_dir: str,
    noise_info: Dict,
    fold: int,
    clean_test: Dict,
    noisy_test: Dict,
    best_noisy_weighted_acc: float,
) -> str:
    def domain(res):
        return {
            "accuracy": _pct(res["accuracy"]),
            "weighted_accuracy": _pct(res["weighted_accuracy"]),
            "weighted_f1": _pct(res["f1_weighted"]),
        }

    summary = {
        "info": {
            "noise_config": noise_info,
            "fold": fold + 1,
            "evaluation_type": "Final Test Set Evaluation",
            "timestamp": datetime.now().isoformat(),
        },
        "final_test_results": {
            "clean_domain": domain(clean_test),
            "noisy_domain": domain(noisy_test),
        },
        "comparison_with_validation": {
            "validation_best_noisy_weighted_acc": _pct(best_noisy_weighted_acc),
            "test_noisy_weighted_acc": _pct(noisy_test["weighted_accuracy"]),
            "performance_gap": _pct(
                noisy_test["weighted_accuracy"] - best_noisy_weighted_acc
            ),
        },
    }
    path = os.path.join(results_dir, "reports", "FINAL_test_set_results.json")
    dump_json(summary, path)
    return path


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed: confusion-matrix plots are skipped")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _heatmap(fig, ax, res: Dict, class_names: Sequence[str], title: str, cmap: str) -> None:
    cm = np.asarray(res["confusion_matrix"])
    im = ax.imshow(cm, cmap=cmap)
    ax.set_xticks(range(len(class_names)), class_names)
    ax.set_yticks(range(len(class_names)), class_names)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center")
    ax.set_title(
        f"{title}\nAcc: {res['accuracy']:.2f}%, "
        f"W-Acc: {res['weighted_accuracy']:.2f}%"
    )
    fig.colorbar(im, ax=ax)


def save_per_class_bars(
    out_dir: str,
    results: Dict,
    class_names: Sequence[str],
    name: str = "per_class_metrics.png",
) -> Optional[str]:
    """Per-class precision/recall/F1 bars (reference inference.py:476-524)."""
    plt = _pyplot()
    if plt is None:
        return None
    x = np.arange(len(class_names))
    w = 0.25
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.bar(x - w, results["precision_per_class"], w, label="precision")
    ax.bar(x, results["recall_per_class"], w, label="recall")
    ax.bar(x + w, results["f1_per_class"], w, label="f1")
    ax.set_xticks(x, class_names)
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    ax.set_title("Per-class metrics")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def save_confusion_matrices(
    results_dir: str,
    clean_results: Dict,
    noisy_results: Dict,
    epoch: int,
    class_names: Sequence[str],
    noise_display: str,
    is_best: bool = False,
) -> Optional[str]:
    """Confusion heatmap PNG pair (train.py:594-606)."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 7))
    _heatmap(fig, ax1, clean_results, class_names, f"Clean Domain (Epoch {epoch + 1})",
             "Blues")
    _heatmap(fig, ax2, noisy_results, class_names,
             f"Noisy Domain ({noise_display}) (Epoch {epoch + 1})", "Oranges")
    if is_best:
        fig.suptitle("BEST RESULTS", fontsize=16, weight="bold")
    plots_dir = os.path.join(results_dir, "plots")
    os.makedirs(plots_dir, exist_ok=True)
    name = (
        f"BEST_confusion_matrices_epoch_{epoch + 1}.png"
        if is_best
        else f"confusion_matrices_epoch_{epoch + 1}.png"
    )
    path = os.path.join(plots_dir, name)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def save_single_confusion(
    out_dir: str,
    results: Dict,
    class_names: Sequence[str],
    title: str,
    filename: str = "confusion_matrix.png",
) -> Optional[str]:
    """One-panel confusion heatmap, for single-dataset runs (inference)."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 7))
    _heatmap(fig, ax, results, class_names, title, "Blues")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
