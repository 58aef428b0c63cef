"""Teacher-student disagreement analysis at reference depth
(analyze_disagreement.py:19-494).

Consumes ``training_history.json`` and produces:
- noisy/clean disagreement trajectories mapped onto training epochs
  (validation runs at warmup + (i+1)*validation_interval — reference :57)
- trend statistics per domain (mean/std/min/max/first/last + linregress
  slope, r^2, p — reference :80-145)
- the main 2x2 figure: evolution with trend fit, rate histograms per domain,
  domain boxplot, rolling mean
- disagreement-vs-mechanisms correlations (firewall activations, mean DACP
  threshold, threshold std — each Pearson r + p, with the 2x2 correlation
  figure — reference :251-361)
- a consolidated JSON report
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..utils import dump_json
from .common import get_pyplot, linregress_stats, load_history, pearsonr, savefig


def _epochs_for(n: int, warmup: int, interval: int) -> List[int]:
    """Epoch of the i-th recorded disagreement point.

    Disagreement is recorded on post-warmup noisy validations, which run
    EVERY epoch (the dead-interval quirk, train.py:642) — so point i is
    epoch ``warmup + i + 1``. NB deliberate deviation: the reference's
    analyzer assumes interval-spaced validations
    (analyze_disagreement.py:57, ``warmup + (i+1)*interval``), stretching
    its own epoch axis by ~interval x against its own trainer's cadence;
    ``interval`` is kept in the signature for compatibility but unused."""
    del interval
    return [warmup + i + 1 for i in range(n)]


def _domain_stats(rates: np.ndarray) -> Dict:
    if len(rates) == 0:
        return {}
    out = {
        "mean_disagreement": float(rates.mean()),
        "std_disagreement": float(rates.std()),
        "max_disagreement": float(rates.max()),
        "min_disagreement": float(rates.min()),
        "final_disagreement": float(rates[-1]),
        "initial_disagreement": float(rates[0]),
    }
    if len(rates) > 1:
        out.update(linregress_stats(rates))
        out["converging"] = bool(out["trend_slope"] < 0)
    return out


def mechanisms_correlation(
    noisy: np.ndarray, hist: dict, warmup: int, interval: int
) -> Dict:
    """Disagreement vs DACP firewall/threshold metrics (reference :251-361)."""
    thr = hist.get("dacp_ema_thresholds")
    if not thr or len(noisy) < 3:
        return {}
    thr = np.asarray(thr, float)
    firewall = (thr > 1.0).sum(axis=1)
    mean_thr = thr.mean(axis=1)
    std_thr = thr.std(axis=1)

    epochs = _epochs_for(len(noisy), warmup, interval)
    idx, dis, eps = [], [], []
    for e, d in zip(epochs, noisy):
        # thresholds and disagreement are BOTH appended once per
        # post-warmup epoch (dad_trainer._epoch_end_dacp / validate), so
        # the series are index-aligned: point i of each is epoch
        # warmup+i+1. No interval division — validations run every epoch
        # post-warmup (the dead-interval quirk).
        k = e - warmup - 1
        if 0 <= k < len(firewall):
            idx.append(k)
            dis.append(d)
            eps.append(e)
    if len(idx) < 3:
        return {}
    dis = np.asarray(dis)
    out = {"epochs_aligned": len(idx)}
    for name, series in (
        ("firewall_vs_disagreement", firewall[idx]),
        ("mean_threshold_vs_disagreement", mean_thr[idx]),
        ("threshold_std_vs_disagreement", std_thr[idx]),
    ):
        r, p = pearsonr(series, dis)
        out[name] = {"r": r, "p": p, "significant": bool(p < 0.05)}
    out["_aligned"] = {
        "firewall": firewall[idx].tolist(),
        "mean_thr": mean_thr[idx].tolist(),
        "std_thr": std_thr[idx].tolist(),
        "disagreement": dis.tolist(),
        "epochs": eps,
    }
    return out


def analyze_disagreement(
    results_dir: str,
    out_dir: Optional[str] = None,
    validation_interval: int = 5,
    warmup_epochs: int = 30,
) -> Dict:
    hist = load_history(results_dir)
    out_dir = out_dir or os.path.join(results_dir, "analysis", "disagreement")
    noisy = np.asarray(hist.get("disagreement_rate_noisy", []), float)
    clean = np.asarray(hist.get("disagreement_rate_clean", []), float)
    ep_noisy = _epochs_for(len(noisy), warmup_epochs, validation_interval)
    ep_clean = _epochs_for(len(clean), warmup_epochs, validation_interval)

    noisy_stats = _domain_stats(noisy)
    clean_stats = _domain_stats(clean)
    corr = mechanisms_correlation(noisy, hist, warmup_epochs, validation_interval)

    plt = get_pyplot()
    if plt and len(noisy):
        fig, axes = plt.subplots(2, 2, figsize=(15, 11))
        fig.suptitle("Teacher-Student Disagreement Analysis",
                     fontsize=16, fontweight="bold")
        ax = axes[0, 0]
        ax.plot(ep_noisy, noisy, marker="o", color="orange", linewidth=2.5,
                label="Noisy Domain")
        if len(clean):
            ax.plot(ep_clean, clean, marker="s", color="blue", linewidth=2.5,
                    label="Clean Domain")
        if len(noisy) > 1:
            z = np.polyfit(ep_noisy, noisy, 1)
            ax.plot(ep_noisy, np.poly1d(z)(ep_noisy), "r--", alpha=0.8,
                    label=f"Noisy Trend: y={z[0]:.6f}x+{z[1]:.3f}")
        ax.set_title("Disagreement Rate Evolution")
        ax.set_xlabel("Training Epoch")
        ax.set_ylabel("Disagreement Rate")
        ax.legend()
        ax.grid(True, alpha=0.3)

        ax = axes[0, 1]
        ax.hist(noisy, bins=15, alpha=0.7, color="orange", edgecolor="black",
                label="Noisy Domain")
        if len(clean):
            ax.hist(clean, bins=15, alpha=0.7, color="blue", edgecolor="black",
                    label="Clean Domain")
        ax.set_title("Disagreement Rate Distribution")
        ax.set_xlabel("Disagreement Rate")
        ax.set_ylabel("Frequency")
        ax.legend()
        ax.grid(True, alpha=0.3)

        ax = axes[1, 0]
        data = [noisy] + ([clean] if len(clean) else [])
        ax.boxplot(data, tick_labels=["noisy"] + (["clean"] if len(clean) else []))
        ax.set_title("Disagreement Rate Comparison")
        ax.set_ylabel("Disagreement Rate")
        ax.grid(True, alpha=0.3)

        ax = axes[1, 1]
        w = max(3, len(noisy) // 10)
        if len(noisy) >= w:
            roll = np.convolve(noisy, np.ones(w) / w, mode="valid")
            ax.plot(ep_noisy[w - 1:], roll, color="purple", linewidth=2,
                    label=f"rolling mean (w={w})")
        ax.plot(ep_noisy, noisy, alpha=0.3, color="orange")
        ax.set_title("Smoothed Trajectory (Noisy)")
        ax.set_xlabel("Training Epoch")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout(rect=[0, 0.02, 1, 0.96])
        savefig(fig, out_dir, "teacher_student_disagreement.png")
        plt.close(fig)

        if corr:
            al = corr["_aligned"]
            fig, axes = plt.subplots(2, 2, figsize=(15, 12))
            fig.suptitle("Disagreement vs Training Mechanisms Correlation",
                         fontsize=16, fontweight="bold")
            for ax, key, series, color, xlabel in (
                (axes[0, 0], "firewall_vs_disagreement", al["firewall"], "red",
                 "Firewall Activations (Classes with tau > 1)"),
                (axes[0, 1], "mean_threshold_vs_disagreement", al["mean_thr"],
                 "blue", "Mean DACP Threshold"),
                (axes[1, 0], "threshold_std_vs_disagreement", al["std_thr"],
                 "green", "Threshold Std Dev"),
            ):
                ax.scatter(series, al["disagreement"], alpha=0.7, s=60, color=color)
                ax.set_xlabel(xlabel)
                ax.set_ylabel("Disagreement Rate")
                ax.set_title(f"{key} (r={corr[key]['r']:.3f})")
                ax.grid(True, alpha=0.3)
            ax1 = axes[1, 1]
            l1 = ax1.plot(al["epochs"], al["disagreement"], "o-",
                          color="tab:orange", label="Disagreement")
            ax1.set_xlabel("Epoch")
            ax1.set_ylabel("Disagreement Rate", color="tab:orange")
            ax2 = ax1.twinx()
            l2 = ax2.plot(al["epochs"], al["firewall"], "s--", color="tab:red",
                          label="Firewall")
            ax2.set_ylabel("Firewall Activations", color="tab:red")
            ax1.legend(l1 + l2, [ln.get_label() for ln in l1 + l2], loc="upper left")
            ax1.set_title("Temporal Relationship")
            ax1.grid(True, alpha=0.3)
            fig.tight_layout(rect=[0, 0.02, 1, 0.96])
            savefig(fig, out_dir, "disagreement_vs_mechanisms.png")
            plt.close(fig)

    report = {
        "analysis_summary": {
            "analysis_type": "teacher_student_disagreement",
            "validation_interval": validation_interval,
            "warmup_epochs": warmup_epochs,
            "num_validation_points_noisy": int(len(noisy)),
            "num_validation_points_clean": int(len(clean)),
        },
        "noisy_domain": noisy_stats,
        "clean_domain": clean_stats,
        "mechanism_correlations": {
            k: v for k, v in corr.items() if not k.startswith("_")
        },
    }
    dump_json(report, os.path.join(out_dir, "disagreement_analysis_report.json"))
    # back-compat summary
    summary = {
        "num_points": int(len(noisy)),
        "mean_disagreement": noisy_stats.get("mean_disagreement", 0.0),
        "final_disagreement": noisy_stats.get("final_disagreement", 0.0),
        "max_disagreement": noisy_stats.get("max_disagreement", 0.0),
        "trend_slope_per_epoch": noisy_stats.get("trend_slope", 0.0),
        "converging": noisy_stats.get("converging", False),
    }
    dump_json(summary, os.path.join(out_dir, "disagreement_summary.json"))
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results-dir", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--validation-interval", type=int, default=5)
    p.add_argument("--warmup", type=int, default=30)
    a = p.parse_args(argv)
    report = analyze_disagreement(
        a.results_dir, a.out_dir, a.validation_interval, a.warmup
    )
    print(report["noisy_domain"])


if __name__ == "__main__":
    main()
