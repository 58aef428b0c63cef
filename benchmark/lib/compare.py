"""The comparisons of a training cell's readings with the reference's:
norms of leaves, the worst leaf's gap, the losses' gap."""

from __future__ import annotations

import math
import sys

import numpy as np


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_gap(got: dict, want: dict, keys) -> float:
    """The largest |norm(got) - norm(want)| over the leaves ``keys``,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger; inf where a norm is not finite or no leaf
    counts."""
    vals = [got[k] for k in keys] + [want[k] for k in keys]
    if not keys or not all(math.isfinite(v) for v in vals):
        return math.inf
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def counted(grads: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding: a
    norm of a thousandth of the median leaf's or more (a leaf whose norm is
    not finite counts)."""
    med = float(np.median([v for v in grads.values() if math.isfinite(v)] or [0.0]))
    return [k for k, v in grads.items() if not v < 1e-3 * med]


def loss_gap(got, want) -> float:
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def report(tag: str, what: str, got: dict, want: dict, keys, k: int = 3) -> None:
    """The leaves that part most, to standard error."""
    keys = [x for x in keys if x in want]
    med = float(np.median([want[x] for x in keys])) if keys else 0.0
    worst = sorted(((abs(got[x] - want[x]) / max(want[x], med, 1e-30), x) for x in keys),
                   key=lambda g: -g[0] if math.isfinite(g[0]) else -math.inf)[:k]
    bad = [x for x in got if not (math.isfinite(got[x]) and math.isfinite(want[x]))]
    print(f"{tag}: {what}: worst leaves {[(x, got[x], want[x], g) for g, x in worst]}; "
          f"not finite: {bad[:5]} ({len(bad)})", file=sys.stderr, flush=True)
