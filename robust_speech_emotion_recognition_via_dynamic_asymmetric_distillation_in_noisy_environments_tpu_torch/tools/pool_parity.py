#!/usr/bin/env python3
"""Pooled cross-corpus parity verdict over the port's three reports.

Each per-corpus protocol (``tools/run_parity.py``) gates mean noisy-domain
UA/WA at +/-0.5 pp, but per-seed sigma is ~1-2 pp (the synthetic classes
overlap by design), so a single-corpus run has SE ~0.5 pp: the gate
flickers with the RNG even when there is no systematic difference. This
tool pools the per-corpus estimates into one inverse-variance-weighted
estimate, with a t-statistic so noise and systematic gaps are
distinguishable. It gives two verdicts:

- port - replica, from the paired per-seed deltas (both sides train on the
  same seed's data), as the JAX system's ``tools/pool_parity.py`` pools
  JAX - replica;
- port - JAX, from each report's difference of means against the JAX
  package's committed per-seed results (``delta_vs_jax_pp`` and its SE):
  those seeds are not paired with the port's.

Usage: python -m <pkg>.tools.pool_parity [--tolerance 0.5]
Reads ``tools/reports/PARITY_REPORT_<corpus>.json``, writes
``tools/reports/PARITY_POOLED.json`` (or ``--out``). Exit 0 when both
noisy-UA verdicts are within tolerance, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from .run_parity import CORPUS_META, REPORT_DIR, report_path

POOLED_METRICS = ("noisy_UA", "noisy_WA")


def pool(per_corpus: Dict[str, Tuple[float, float, int]]) -> Dict:
    """Inverse-variance pooled mean of per-corpus estimates ``{corpus:
    (mean, se, n)}``: the pooled delta, its SE and t, and the runs it
    rests on."""
    means = np.asarray([m for m, _se, _n in per_corpus.values()])
    ses = np.asarray([se for _m, se, _n in per_corpus.values()])
    w = 1.0 / np.maximum(ses**2, 1e-12)
    pooled = float((w * means).sum() / w.sum())
    pooled_se = float(np.sqrt(1.0 / w.sum()))
    return {
        "per_corpus": {c: {"delta_pp": float(m), "se_pp": float(se), "n_seeds": int(n)}
                       for c, (m, se, n) in per_corpus.items()},
        "pooled_delta_pp": pooled,
        "pooled_se_pp": pooled_se,
        "pooled_t": pooled / pooled_se if pooled_se > 0 else 0.0,
        "n_runs": int(sum(n for _m, _se, n in per_corpus.values())),
    }


def paired_estimate(metric: Dict, ours: str = "port",
                    theirs: str = "torch") -> Optional[Tuple[float, float, int]]:
    """(mean, SE, n) of the per-seed paired deltas ``ours - theirs`` of one
    report metric; None under 2 seeds (std(ddof=1) of one sample is NaN and
    would poison the pooled weights)."""
    deltas = np.asarray(metric[f"{ours}_per_seed"]) - np.asarray(metric[f"{theirs}_per_seed"])
    if len(deltas) < 2:
        return None
    return float(deltas.mean()), float(deltas.std(ddof=1) / np.sqrt(len(deltas))), len(deltas)


def jax_estimate(metric: Dict) -> Optional[Tuple[float, float, int]]:
    """(port - JAX mean, its SE, the port's seeds) of one report metric."""
    if "delta_vs_jax_pp" not in metric or len(metric["port_per_seed"]) < 2:
        return None
    return (float(metric["delta_vs_jax_pp"]), float(metric["delta_vs_jax_se_pp"]),
            len(metric["port_per_seed"]))


def verdict(per_corpus: Dict, tolerance: float) -> Optional[Dict]:
    if not per_corpus:
        return None
    out = pool(per_corpus)
    out["within_tolerance"] = abs(out["pooled_delta_pp"]) <= tolerance
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tolerance", type=float, default=0.5)
    ap.add_argument("--reports", default=REPORT_DIR,
                    help="directory of the PARITY_REPORT_<corpus>.json files")
    ap.add_argument("--out", default=os.path.join(REPORT_DIR, "PARITY_POOLED.json"))
    args = ap.parse_args(argv)

    reports = {}
    for corpus in CORPUS_META:
        path = os.path.join(args.reports, os.path.basename(report_path(corpus)))
        if os.path.exists(path):
            with open(path) as f:
                reports[corpus] = json.load(f)
    if not reports:
        print("no parity reports found")
        return 1

    metrics = {}
    for name in POOLED_METRICS:
        paired, vs_jax = {}, {}
        for corpus, d in reports.items():
            if (est := paired_estimate(d["metrics"][name])) is not None:
                paired[corpus] = est
            if (est := jax_estimate(d["metrics"][name])) is not None:
                vs_jax[corpus] = est
        metrics[name] = {"port_vs_replica": verdict(paired, args.tolerance),
                         "port_vs_jax": verdict(vs_jax, args.tolerance)}
    gate = metrics["noisy_UA"]
    ok = all(v is not None and v["within_tolerance"] for v in gate.values())
    out = {
        "metric": "noisy_UA",
        "tolerance_pp": args.tolerance,
        "metrics": metrics,
        "within_tolerance": ok,
        "reports": {c: {"protocol": d["protocol"], "seeds": len(d["seed_list"]),
                        "devices": sorted({(r["port_device"], r["replica_device"])
                                           for r in d["runs"]}),
                        "seconds_per_seed": d["seconds_per_seed"]}
                    for c, d in reports.items()},
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    for name, pair in metrics.items():
        for what, v in pair.items():
            if v is None:
                print(f"{name} {what}: no corpus with 2 or more seeds")
                continue
            for c, row in v["per_corpus"].items():
                print(f"{name} {what} {c:<9} delta {row['delta_pp']:+.2f} ± "
                      f"{row['se_pp']:.2f} pp  (n={row['n_seeds']})")
            print(f"{name} {what} pooled    delta {v['pooled_delta_pp']:+.2f} ± "
                  f"{v['pooled_se_pp']:.2f} pp (t {v['pooled_t']:+.2f}) over {v['n_runs']} "
                  f"runs -> {'WITHIN' if v['within_tolerance'] else 'OUTSIDE'} "
                  f"±{args.tolerance} pp")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
