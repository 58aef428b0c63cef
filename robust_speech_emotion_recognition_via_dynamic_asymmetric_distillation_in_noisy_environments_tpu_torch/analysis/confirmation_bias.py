"""Confirmation-bias analysis at reference depth
(analyze_confirmation_bias.py:18-418).

Consumes ``confirmation_bias_log.json`` — per-epoch (pseudo_label,
certainty_score, is_masked_in) for the tracked noisy samples (logged at
reference train.py:278-285, 424-437) — plus ``training_history.json``, and
produces the reference's full artifact set:

- label-consistency statistics (flips per sample/epoch, flip rates,
  never-flipped / highly-unstable counts)
- the 2x2 flip figure (histogram, flips-per-epoch, pseudo-label-evolution
  heatmap of a sample subset, cumulative flip distribution)
- DACP-firewall relationship (threshold>1 activations vs per-epoch flips:
  Pearson r + p, dual-axis time series + scatter-with-fit figure)
- confirmation patterns by certainty level (bins [0,.6,.8,.9,1.0]:
  per-bin sample counts, mean flips, flip rates + bar figure)
- a consolidated JSON report

plus this framework's extra per-sample metrics (mask-in rates, certainty
drift, locked-in count).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..utils import dump_json
from .common import get_pyplot, load_bias_log, load_history, pearsonr, savefig

CERTAINTY_BINS = [0.0, 0.6, 0.8, 0.9, 1.0]
CERTAINTY_LABELS = ["Low(0-0.6)", "Med(0.6-0.8)", "High(0.8-0.9)", "VHigh(0.9-1.0)"]


def _pivot(log: List[dict]):
    """sample x epoch label matrix (NaN where untracked) + sorted axes."""
    samples = sorted({e["sample_id"] for e in log})
    epochs = sorted({e["epoch"] for e in log})
    sidx = {s: i for i, s in enumerate(samples)}
    eidx = {e: i for i, e in enumerate(epochs)}
    mat = np.full((len(samples), len(epochs)), np.nan)
    for e in log:
        mat[sidx[e["sample_id"]], eidx[e["epoch"]]] = e["pseudo_label"]
    return mat, samples, epochs


def _flips_per_sample(mat: np.ndarray) -> np.ndarray:
    """Transitions between consecutive OBSERVED labels per sample."""
    out = np.zeros(mat.shape[0], int)
    for i in range(mat.shape[0]):
        row = mat[i][~np.isnan(mat[i])]
        out[i] = int(np.sum(row[1:] != row[:-1]))
    return out


def _flips_per_epoch(mat: np.ndarray) -> np.ndarray:
    """Label changes vs previous epoch column (0 for the first)."""
    out = np.zeros(mat.shape[1], int)
    for j in range(1, mat.shape[1]):
        a, b = mat[:, j - 1], mat[:, j]
        ok = ~np.isnan(a) & ~np.isnan(b)
        out[j] = int(np.sum(a[ok] != b[ok]))
    return out


def label_consistency(log: List[dict]) -> Dict:
    mat, samples, epochs = _pivot(log)
    flips = _flips_per_sample(mat)
    total_epochs = len(epochs)
    flip_rates = flips / max(total_epochs - 1, 1)
    return {
        "total_samples_tracked": len(samples),
        "total_epochs": total_epochs,
        "mean_flips_per_sample": float(flips.mean()) if len(flips) else 0.0,
        "std_flips_per_sample": float(flips.std()) if len(flips) else 0.0,
        "mean_flip_rate": float(flip_rates.mean()) if len(flips) else 0.0,
        "samples_never_flipped": int(np.sum(flips == 0)),
        "samples_highly_unstable": int(np.sum(flips > total_epochs * 0.5)),
    }


def firewall_relationship(log: List[dict], hist: Optional[dict], warmup_epochs: int) -> Dict:
    """DACP firewall (tau > 1 per class) vs per-epoch label flips
    (reference :146-244)."""
    if not hist or not hist.get("dacp_ema_thresholds"):
        return {}
    thr = np.asarray(hist["dacp_ema_thresholds"], float)  # (E_postwarmup, C)
    activations = (thr > 1.0).sum(axis=1)
    mat, _s, epochs = _pivot(log)
    flips_e = _flips_per_epoch(mat)
    # thresholds are recorded once per post-warmup epoch; align on epoch id
    fire, flips = [], []
    for j, ep in enumerate(epochs):
        k = ep - warmup_epochs
        if 0 <= k < len(activations):
            fire.append(int(activations[k]))
            flips.append(int(flips_e[j]))
    if len(fire) < 5:
        return {}
    r, p = pearsonr(fire, flips)
    return {
        "correlation": r,
        "p_value": p,
        "significant": bool(p < 0.05),
        "epochs_aligned": len(fire),
        "_fire": fire,
        "_flips": flips,
        "_epochs": [e for e in epochs if 0 <= e - warmup_epochs < len(activations)],
    }


def confirmation_patterns(log: List[dict]) -> Dict:
    """Flip stats per certainty-score bin (reference :232-299).

    NB reference-exact semantics, quirks included: entries are binned
    individually (pd.cut analogue), so a sample's bin pivot can contain
    non-adjacent epochs and a "flip" is counted between them even if the
    actual label changes happened while the sample sat in OTHER bins, and
    flip_rate divides by the bin's epoch-union size regardless of how many
    epochs each sample spent there (analyze_confirmation_bias.py:245-265
    does exactly this). Kept so our numbers match the reference tool's."""
    by_bin: Dict[str, List[dict]] = defaultdict(list)
    for e in log:
        s = e["certainty_score"]
        for lo, hi, name in zip(CERTAINTY_BINS, CERTAINTY_BINS[1:], CERTAINTY_LABELS):
            in_bin = (lo <= s <= hi) if hi == 1.0 else (lo <= s < hi)
            if in_bin:
                by_bin[name].append(e)
                break
    out = {}
    for name in CERTAINTY_LABELS:
        entries = by_bin.get(name, [])
        if not entries:
            continue
        mat, samples, epochs = _pivot(entries)
        if len(epochs) > 1:
            flips = _flips_per_sample(mat)
            out[name] = {
                "sample_count": len(samples),
                "mean_flips": float(flips.mean()),
                "flip_rate": float(flips.mean() / (len(epochs) - 1)),
            }
    return out


def analyze_confirmation_bias(
    results_dir: str,
    out_dir: Optional[str] = None,
    warmup_epochs: int = 30,
) -> Dict:
    log = load_bias_log(results_dir)
    try:
        hist = load_history(results_dir)
    except FileNotFoundError:
        hist = None
    out_dir = out_dir or os.path.join(results_dir, "analysis", "confirmation_bias")

    mat, samples, epochs = _pivot(log)
    consistency = label_consistency(log)
    firewall = firewall_relationship(log, hist, warmup_epochs)
    patterns = confirmation_patterns(log)

    # framework extras: mask-in rate / certainty drift / lock-in per sample
    by_sample = defaultdict(list)
    for e in log:
        by_sample[e["sample_id"]].append(e)
    mask_rates, drifts, locked_in = [], [], 0
    flips_s = _flips_per_sample(mat)
    for i, sid in enumerate(samples):
        entries = sorted(by_sample[sid], key=lambda e: e["epoch"])
        mr = float(np.mean([e["is_masked_in"] for e in entries]))
        mask_rates.append(mr)
        drifts.append(entries[-1]["certainty_score"] - entries[0]["certainty_score"])
        if flips_s[i] == 0 and mr > 0.9:
            locked_in += 1
    extras = {
        "mean_mask_in_rate": float(np.mean(mask_rates)) if mask_rates else 0.0,
        "mean_certainty_drift": float(np.mean(drifts)) if drifts else 0.0,
        "locked_in_count": locked_in,
    }

    plt = get_pyplot()
    if plt and len(samples):
        flips_e = _flips_per_epoch(mat)
        fig, axes = plt.subplots(2, 2, figsize=(16, 12))
        fig.suptitle("Pseudo-Label Flip Analysis", fontsize=16, fontweight="bold")
        axes[0, 0].hist(
            flips_s, bins=np.arange(0, flips_s.max() + 2) - 0.5,
            alpha=0.7, color="skyblue", edgecolor="black",
        )
        axes[0, 0].axvline(flips_s.mean(), color="red", linestyle="--",
                           label=f"Mean: {flips_s.mean():.2f}")
        axes[0, 0].set_title("Distribution of Label Flips per Sample")
        axes[0, 0].set_xlabel("Number of Flips")
        axes[0, 0].set_ylabel("Count of Samples")
        axes[0, 0].legend()
        axes[0, 0].grid(True, alpha=0.3)

        axes[0, 1].plot(epochs, flips_e, marker="o", color="orange", linewidth=2)
        axes[0, 1].set_title("Label Flips per Epoch")
        axes[0, 1].set_xlabel("Epoch")
        axes[0, 1].set_ylabel("Number of Flips")
        axes[0, 1].grid(True, alpha=0.3)

        subset = mat[: min(20, len(samples))]
        im = axes[1, 0].imshow(subset, aspect="auto", cmap="viridis",
                               interpolation="nearest")
        fig.colorbar(im, ax=axes[1, 0], label="Pseudo Label")
        axes[1, 0].set_title("Pseudo-Label Evolution (Sample Subset)")
        axes[1, 0].set_xlabel("Epoch index")
        axes[1, 0].set_ylabel("Sample")

        vals, counts = np.unique(flips_s, return_counts=True)
        cum = np.cumsum(counts) / len(flips_s) * 100
        axes[1, 1].bar(vals, cum, alpha=0.7, color="lightcoral")
        axes[1, 1].set_title("Cumulative Distribution of Label Flips")
        axes[1, 1].set_xlabel("Number of Flips")
        axes[1, 1].set_ylabel("Cumulative Percentage (%)")
        axes[1, 1].grid(True, alpha=0.3)
        fig.tight_layout(rect=[0, 0.02, 1, 0.96])
        savefig(fig, out_dir, "pseudo_label_flip_analysis.png")
        plt.close(fig)

        if firewall:
            fig, axes = plt.subplots(2, 1, figsize=(14, 10))
            fig.suptitle("DACP Firewall vs Label Stability Analysis",
                         fontsize=16, fontweight="bold")
            ax1 = axes[0]
            eps = firewall["_epochs"][: len(firewall["_flips"])]
            l1 = ax1.plot(eps, firewall["_flips"], color="tab:blue", marker="o",
                          label="Label Flips", linewidth=2)
            ax1.set_xlabel("Epoch")
            ax1.set_ylabel("Number of Label Flips", color="tab:blue")
            ax1.grid(True, alpha=0.3)
            ax2 = ax1.twinx()
            l2 = ax2.plot(eps, firewall["_fire"], color="tab:red", marker="s",
                          linestyle="--", label="Firewall Activations", linewidth=2)
            ax2.set_ylabel("Classes with Threshold > 1", color="tab:red")
            ax1.legend(l1 + l2, [ln.get_label() for ln in l1 + l2], loc="upper left")
            ax1.set_title(
                f"Temporal Relationship (Correlation: {firewall['correlation']:.3f}, "
                f"p={firewall['p_value']:.3f})"
            )
            axes[1].scatter(firewall["_fire"], firewall["_flips"], alpha=0.7,
                            s=60, color="purple")
            axes[1].set_xlabel("Classes with Firewall Activated (tau > 1)")
            axes[1].set_ylabel("Number of Label Flips")
            axes[1].set_title("Correlation Analysis")
            axes[1].grid(True, alpha=0.3)
            if len(set(firewall["_fire"])) > 1:
                z = np.polyfit(firewall["_fire"], firewall["_flips"], 1)
                xs = np.asarray(firewall["_fire"], float)
                axes[1].plot(xs, np.poly1d(z)(xs), "r--", alpha=0.8,
                             label=f"Fit: y={z[0]:.2f}x+{z[1]:.2f}")
                axes[1].legend()
            fig.tight_layout(rect=[0, 0.02, 1, 0.96])
            savefig(fig, out_dir, "dacp_firewall_vs_label_stability.png")
            plt.close(fig)

        if patterns:
            fig, axes = plt.subplots(1, 2, figsize=(14, 6))
            fig.suptitle("Confirmation Bias Patterns by Certainty Level",
                         fontsize=16, fontweight="bold")
            names = list(patterns)
            axes[0].bar(names, [patterns[n]["mean_flips"] for n in names],
                        color="lightblue", alpha=0.7)
            axes[0].set_title("Mean Flips by Certainty Level")
            axes[0].set_ylabel("Mean Number of Flips")
            axes[0].tick_params(axis="x", rotation=45)
            axes[0].grid(True, alpha=0.3)
            axes[1].bar(names, [patterns[n]["flip_rate"] for n in names],
                        color="lightcoral", alpha=0.7)
            axes[1].set_title("Flip Rate by Certainty Level")
            axes[1].set_ylabel("Flip Rate")
            axes[1].tick_params(axis="x", rotation=45)
            axes[1].grid(True, alpha=0.3)
            fig.tight_layout(rect=[0, 0.02, 1, 0.96])
            savefig(fig, out_dir, "confirmation_bias_patterns.png")
            plt.close(fig)

    report = {
        "analysis_summary": {
            "analysis_type": "confirmation_bias_analysis",
            "description": "pseudo-label trajectory analysis of tracked samples",
        },
        "label_consistency": consistency,
        "firewall_relationship": {
            k: v for k, v in firewall.items() if not k.startswith("_")
        },
        "confirmation_patterns": patterns,
        "per_sample_extras": extras,
    }
    dump_json(report, os.path.join(out_dir, "confirmation_bias_analysis_report.json"))
    # back-compat summary consumed by earlier tests/tools
    summary = {
        "num_tracked_samples": consistency["total_samples_tracked"],
        "mean_label_flips": consistency["mean_flips_per_sample"],
        "never_flipped_fraction": (
            consistency["samples_never_flipped"]
            / max(consistency["total_samples_tracked"], 1)
        ),
        **extras,
    }
    dump_json(summary, os.path.join(out_dir, "confirmation_bias_summary.json"))
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results-dir", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--warmup", type=int, default=30)
    a = p.parse_args(argv)
    report = analyze_confirmation_bias(a.results_dir, a.out_dir, a.warmup)
    print(report["label_consistency"])


if __name__ == "__main__":
    main()
