"""Shared plotting/loading helpers for the analysis suite."""

from __future__ import annotations

import json
import os
from typing import Optional


def load_history(results_dir: str) -> dict:
    path = os.path.join(results_dir, "reports", "training_history.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_bias_log(results_dir: str) -> list:
    path = os.path.join(results_dir, "reports", "confirmation_bias_log.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def get_pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:  # pragma: no cover
        return None


def savefig(fig, out_dir: Optional[str], name: str):
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    return path


def pearsonr(x, y):
    """(r, p) — scipy when present, else normal-approx p from the t stat."""
    import numpy as np

    x = np.asarray(x, float)
    y = np.asarray(y, float)
    n = len(x)
    if n < 3 or np.std(x) == 0 or np.std(y) == 0:
        return 0.0, 1.0
    try:
        from scipy import stats

        r, p = stats.pearsonr(x, y)
        return float(r), float(p)
    except Exception:  # pragma: no cover
        import math

        r = float(np.corrcoef(x, y)[0, 1])
        if abs(r) >= 1.0:
            return r, 0.0
        t = abs(r) * math.sqrt((n - 2) / (1 - r * r))
        p = math.erfc(t / math.sqrt(2.0))
        return r, float(p)


def linregress_stats(y):
    """Trend of a series vs its index: slope, r^2, p (reference
    analyze_disagreement.py:94-99 uses scipy.stats.linregress)."""
    import numpy as np

    y = np.asarray(y, float)
    if len(y) < 2:
        return {"trend_slope": 0.0, "trend_r_squared": 0.0, "trend_p_value": 1.0}
    x = np.arange(len(y), dtype=float)
    slope, intercept = np.polyfit(x, y, 1)
    r, p = pearsonr(x, y)
    return {
        "trend_slope": float(slope),
        "trend_r_squared": float(r * r),
        "trend_p_value": float(p),
    }
