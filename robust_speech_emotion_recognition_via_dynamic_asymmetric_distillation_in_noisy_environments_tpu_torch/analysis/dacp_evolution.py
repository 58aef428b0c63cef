"""DACP/ECDA state-evolution analysis (reference analyze_dacp_evolution.py).

Plots the per-class trajectories of dacp_ema_thresholds, dacp_class_quality
and ecda_class_attention recorded by the trainer (train.py:498-517).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils import dump_json
from .common import get_pyplot, load_history, savefig


def analyze_dacp_evolution(
    results_dir: str, out_dir: Optional[str] = None, class_names=None
) -> Dict:
    hist = load_history(results_dir)
    out_dir = out_dir or os.path.join(results_dir, "analysis")

    series = {
        k: np.asarray(hist[k], dtype=float)
        for k in ("dacp_ema_thresholds", "dacp_class_quality", "ecda_class_attention")
        if k in hist and hist[k]
    }
    summary: Dict = {}
    for k, arr in series.items():
        summary[k] = {
            "final": arr[-1].tolist(),
            "mean": arr.mean(axis=0).tolist(),
            "spread_final": float(arr[-1].max() - arr[-1].min()),
        }

    plt = get_pyplot()
    if plt and series:
        fig, axes = plt.subplots(1, len(series), figsize=(5 * len(series), 4))
        if len(series) == 1:
            axes = [axes]
        for ax, (k, arr) in zip(axes, series.items()):
            C = arr.shape[1]
            names = class_names or [f"class_{c}" for c in range(C)]
            for c in range(C):
                ax.plot(arr[:, c], label=names[c])
            ax.set_title(k)
            ax.set_xlabel("epoch (post-warmup)")
            ax.legend(fontsize=8)
            ax.grid(True, alpha=0.3)
        savefig(fig, out_dir, "dacp_evolution.png")
        plt.close(fig)

    dump_json(summary, os.path.join(out_dir, "dacp_evolution_summary.json"))
    return summary


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--results-dir", required=True)
    p.add_argument("--out-dir", default=None)
    a = p.parse_args(argv)
    print(analyze_dacp_evolution(a.results_dir, a.out_dir))


if __name__ == "__main__":
    main()
