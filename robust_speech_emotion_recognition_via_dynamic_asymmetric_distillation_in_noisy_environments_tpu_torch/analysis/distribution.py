"""Corpus distribution analysis at reference depth
(analyze_iemocap_distribution.py:31-513).

Per-class and per-group (session or speaker) distributions of a feature
store, with the reference's full artifact set:
- ``overall_distribution_pie.png`` / ``overall_distribution_bars.png``
- ``session_comparison.png`` (grouped bars per class x group)
- ``session_stacked_distribution.png`` (stacked percentage bars)
- ``detailed_statistics_table.png`` (rendered count/percent table)
- frame-length histogram + stats (framework extra)
- ``{corpus}_distribution_analysis_report.json`` + a text report
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.store import FeatureStore
from ..utils import dump_json
from .common import get_pyplot, savefig

_COLORS = ["#e74c3c", "#f39c12", "#95a5a6", "#3498db", "#9b59b6", "#1abc9c"]


def _per_group(labels: np.ndarray, groups: np.ndarray, class_names) -> Dict:
    out = {}
    for g in sorted({str(x) for x in groups.tolist()}):
        mask = np.asarray([str(x) == g for x in groups.tolist()])
        sub = labels[mask]
        counts = Counter(sub.tolist())
        n = int(mask.sum())
        out[g] = {
            "counts": {c: int(counts.get(i, 0)) for i, c in enumerate(class_names)},
            "percentages": {
                c: (counts.get(i, 0) / n * 100 if n else 0.0)
                for i, c in enumerate(class_names)
            },
            "total_samples": n,
        }
    return out


def analyze_distribution(
    store: FeatureStore,
    class_names: Sequence[str],
    out_dir: Optional[str] = None,
    corpus: str = "corpus",
) -> Dict:
    labels = store.labels if store.labels is not None else np.array([], int)
    total = int(store.num)
    counts = Counter(labels.tolist())
    overall = {
        "counts": {c: int(counts.get(i, 0)) for i, c in enumerate(class_names)},
        "percentages": {
            c: (counts.get(i, 0) / total * 100 if total else 0.0)
            for i, c in enumerate(class_names)
        },
        "total_samples": total,
    }
    groups = store.groups
    per_group = (
        _per_group(labels, groups, class_names) if groups is not None and len(labels) else {}
    )
    lengths = store.sizes
    length_stats = {
        "min": int(lengths.min()) if len(lengths) else 0,
        "max": int(lengths.max()) if len(lengths) else 0,
        "mean": float(lengths.mean()) if len(lengths) else 0.0,
        "std": float(lengths.std()) if len(lengths) else 0.0,
        "p50": float(np.percentile(lengths, 50)) if len(lengths) else 0.0,
        "p95": float(np.percentile(lengths, 95)) if len(lengths) else 0.0,
        "total_frames": int(lengths.sum()) if len(lengths) else 0,
    }

    plt = get_pyplot()
    if plt and out_dir and total:
        names = list(class_names)
        vals = [overall["counts"][c] for c in names]

        # pie
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.pie(vals, labels=[n.upper() for n in names], autopct="%1.1f%%",
               colors=_COLORS[: len(names)], startangle=90)
        ax.set_title(f"{corpus.upper()} Overall Emotion Distribution\n"
                     f"(n={total})", fontweight="bold")
        savefig(fig, out_dir, "overall_distribution_pie.png")
        plt.close(fig)

        # bars
        fig, ax = plt.subplots(figsize=(10, 6))
        bars = ax.bar(names, vals, color=_COLORS[: len(names)], alpha=0.85,
                      edgecolor="black")
        for b, v in zip(bars, vals):
            ax.text(b.get_x() + b.get_width() / 2, v, f"{v}\n({v / total:.1%})",
                    ha="center", va="bottom")
        ax.set_title(f"{corpus.upper()} Emotion Class Counts", fontweight="bold")
        ax.set_ylabel("Samples")
        ax.grid(True, alpha=0.3, axis="y")
        savefig(fig, out_dir, "overall_distribution_bars.png")
        plt.close(fig)

        if per_group:
            gnames = list(per_group)
            x = np.arange(len(gnames))
            width = 0.8 / len(names)
            # grouped comparison
            fig, ax = plt.subplots(figsize=(max(10, len(gnames) * 1.2), 6))
            for i, c in enumerate(names):
                ax.bar(x + i * width, [per_group[g]["counts"][c] for g in gnames],
                       width, label=c, color=_COLORS[i % len(_COLORS)], alpha=0.85)
            ax.set_xticks(x + width * (len(names) - 1) / 2)
            ax.set_xticklabels(gnames, rotation=45)
            ax.set_title(f"{corpus.upper()} Per-Group Class Counts", fontweight="bold")
            ax.set_ylabel("Samples")
            ax.legend()
            ax.grid(True, alpha=0.3, axis="y")
            savefig(fig, out_dir, "session_comparison.png")
            plt.close(fig)

            # stacked percentages
            fig, ax = plt.subplots(figsize=(max(10, len(gnames) * 1.2), 6))
            bottom = np.zeros(len(gnames))
            for i, c in enumerate(names):
                pct = np.array([per_group[g]["percentages"][c] for g in gnames])
                ax.bar(gnames, pct, bottom=bottom, label=c,
                       color=_COLORS[i % len(_COLORS)], alpha=0.85)
                bottom += pct
            ax.set_title(f"{corpus.upper()} Per-Group Class Percentages",
                         fontweight="bold")
            ax.set_ylabel("Percent")
            ax.legend()
            plt.setp(ax.get_xticklabels(), rotation=45)
            savefig(fig, out_dir, "session_stacked_distribution.png")
            plt.close(fig)

            # detailed table rendered as a figure
            fig, ax = plt.subplots(figsize=(2 + len(names) * 1.6, 1 + len(gnames) * 0.5))
            ax.axis("off")
            cell_text = [
                [f"{per_group[g]['counts'][c]} ({per_group[g]['percentages'][c]:.1f}%)"
                 for c in names] + [str(per_group[g]["total_samples"])]
                for g in gnames
            ]
            cell_text.append(
                [f"{overall['counts'][c]} ({overall['percentages'][c]:.1f}%)"
                 for c in names] + [str(total)]
            )
            table = ax.table(
                cellText=cell_text,
                rowLabels=gnames + ["TOTAL"],
                colLabels=[c.upper() for c in names] + ["TOTAL"],
                loc="center",
            )
            table.auto_set_font_size(False)
            table.set_fontsize(9)
            ax.set_title(f"{corpus.upper()} Detailed Distribution", fontweight="bold")
            savefig(fig, out_dir, "detailed_statistics_table.png")
            plt.close(fig)

        # framework extra: length distribution
        fig, ax = plt.subplots(figsize=(9, 5))
        ax.hist(lengths, bins=30, color="#3498db", alpha=0.8, edgecolor="black")
        ax.axvline(length_stats["mean"], color="red", linestyle="--",
                   label=f"mean {length_stats['mean']:.0f}")
        ax.set_title("Frame-Length Distribution")
        ax.set_xlabel("Frames per clip")
        ax.legend()
        ax.grid(True, alpha=0.3)
        savefig(fig, out_dir, "length_distribution.png")
        plt.close(fig)

    report = {
        "analysis_info": {"dataset": corpus.upper(), "analyzer": "dad_torch"},
        "dataset_info": {
            "num_clips": total,
            "feature_dim": int(store.dim),
            "num_groups": len(per_group),
        },
        "overall_distribution": overall,
        "session_distributions": per_group,
        "length_stats": length_stats,
    }
    if out_dir:
        dump_json(
            report,
            os.path.join(out_dir, f"{corpus}_distribution_analysis_report.json"),
        )
        lines = [f"{corpus.upper()} distribution ({total} clips)", "-" * 50]
        for c in class_names:
            lines.append(
                f"  {c.upper():>10}: {overall['counts'][c]:5d} "
                f"({overall['percentages'][c]:5.1f}%)"
            )
        for g, row in per_group.items():
            lines.append(f"  group {g}: {row['total_samples']} clips")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "distribution_report.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # back-compat summary
    summary = {
        "num_clips": total,
        "feature_dim": int(store.dim),
        "class_counts": overall["counts"],
        "group_counts": {g: r["total_samples"] for g, r in per_group.items()},
        "length_stats": {
            k: length_stats[k] for k in ("min", "max", "mean", "p50", "p95")
        },
    }
    if out_dir:
        dump_json(summary, os.path.join(out_dir, "distribution_summary.json"))
    return report
