#!/usr/bin/env python3
"""North-star accuracy-parity run on the port: the port against the torch
reference replica (``tools/torch_replica.py``), head-to-head on the same
synthetic corpora, beside the JAX package's committed per-seed results.

The operative target is fold-0 UA/WA parity within +/-0.5 pp against a
reproduced PyTorch reference run. The reference stack itself is not
runnable, so the "reference numbers" come from the reference-faithful
replica; both sides train the full pipeline (supervised pretrain -> DAD
cross-domain) on identical feature stores and fold splits over N seeds,
and the gate compares seed-mean noisy-domain UA/WA.

RNG streams cannot be bit-matched across the two sides, so this is a
statistical-parity protocol: means over seeds, both sides seeing the same
per-seed data, the gate on the means, with each delta's SE and t.

The JAX package's committed report of the corpus (``--jax-report``, by
default ``PARITY_REPORT[_<corpus>].json`` at the repo root, read as JSON
only) gives a second comparison: port mean against JAX mean. Its seeds are
not paired with the port's (the corpus is the same for every seed, only
the training draws differ), so that delta is a difference of means with
SE ``sqrt(s_p^2/n_p + s_j^2/n_j)`` from the reports' std columns.

Usage (the port on the card; chunks of seeds merged into one report):

    python -m <pkg>.tools.run_parity --corpus iemocap --seeds 10
    python -m <pkg>.tools.run_parity --corpus iemocap --seed-start 10 \\
        --seeds 20 --merge-from <pkg>/tools/reports/PARITY_REPORT_iemocap.json

Writes ``tools/reports/PARITY_REPORT_<corpus>.json`` of the package (or
``--out``) and prints a summary table. Exit 0 within tolerance, 1 outside,
2 when the run is refused (a protocol mismatch with ``--jax-report`` or
``--merge-from``, or seeds already in the merged report).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..configs import dad_preset, pretrain_preset
from ..data.store import load_feature_store, write_feature_store
from ..train.dad_trainer import CrossDomainTrainer
from ..train.pretrain import pretrain_fold
from ..utils import resolve_device

IEMOCAP_LABELS = ["ang", "hap", "neu", "sad"]
CASIA_LABELS = ["angry", "happy", "neutral", "sad"]
EMODB_SPEAKERS = ["03", "08", "09", "10", "11", "12", "13", "14", "15", "16"]

CORPUS_META = {
    # labels, speaker/group generator, sidecar kind
    "iemocap": dict(labels=IEMOCAP_LABELS, n_groups=5),
    "casia": dict(labels=CASIA_LABELS, n_groups=4),
    "emodb": dict(labels=CASIA_LABELS, n_groups=10),
}

REPORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reports")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX package's committed reports, at the repo root (tools/pool_parity.py:25)
JAX_REPORTS = {
    "iemocap": "PARITY_REPORT.json",
    "casia": "PARITY_REPORT_casia.json",
    "emodb": "PARITY_REPORT_emodb.json",
}
METRICS = {
    "noisy_UA": ("noisy_test", "weighted_accuracy"),
    "noisy_WA": ("noisy_test", "accuracy"),
    "noisy_WF1": ("noisy_test", "f1_weighted"),
    "clean_UA": ("clean_test", "weighted_accuracy"),
    "clean_WA": ("clean_test", "accuracy"),
    "pretrain_UA": ("pretrain_test_wa",),
}
GATED = ("noisy_UA", "noisy_WA")
PROTOCOL_KEYS = ("epochs", "n_clips", "dim", "preset", "fold")


def report_path(corpus: str) -> str:
    """The port's report of ``corpus`` under ``tools/reports/``."""
    return os.path.join(REPORT_DIR, f"PARITY_REPORT_{corpus}.json")


def make_parity_corpus(
    out_clean: str,
    out_noisy: str,
    n: int = 600,
    dim: int = 48,
    seed: int = 1234,
    class_sep: float = 1.0,
    within_std: float = 2.1,
    frame_std: float = 1.0,
    noisy_shift: float = 1.1,
    noisy_std: float = 1.7,
    corpus: str = "iemocap",
):
    """Separable synthetic corpus pair (clean + noisy domain).

    Each clip has a latent class vector mu_c + within-class jitter; frames are
    the latent + per-frame noise (mean-pooling recovers the latent). The
    noisy domain adds a shared domain-shift bias + extra jitter, so (a) the
    clean task is learnable to ~90%+, (b) the noisy domain degrades, and
    (c) distribution alignment (ECDA) has real work to do. Same clip
    lengths/labels/session ids in both domains, mirroring how the reference
    extracts features from clean and noise-injected copies of the same wavs.

    ``corpus`` controls the group structure and sidecar format: IEMOCAP
    writes ``.emo`` with session-coded names (5-fold session rotation),
    CASIA writes ``.lbl``/``.spk`` with 4 speakers, EMODB with the 10 fixed
    LOSO speakers — so each preset's real fold policy is exercised. The
    store files are byte-identical to the JAX system's
    ``tools/run_parity.py``'s.
    """
    meta = CORPUS_META[corpus]
    label_names = meta["labels"]
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(4, dim)) * class_sep
    shift = rng.normal(size=(dim,)) * noisy_shift
    clean_clips, noisy_clips, labels, names, speakers = [], [], [], [], []
    for i in range(n):
        c = i % 4
        t = int(rng.integers(20, 60))
        latent = mu[c] + rng.normal(size=(dim,)) * within_std
        frames = latent[None, :] + rng.normal(size=(t, dim)) * frame_std
        noisy_latent = latent + shift + rng.normal(size=(dim,)) * noisy_std
        noisy_frames = noisy_latent[None, :] + rng.normal(size=(t, dim)) * frame_std
        clean_clips.append(frames.astype(np.float32))
        noisy_clips.append(noisy_frames.astype(np.float32))
        labels.append(label_names[c])
        group = (i // 4) % meta["n_groups"]  # every group sees every class
        if corpus == "iemocap":
            names.append(f"Ses0{group + 1}F_impro0{i % 9}_F{i:03d}")
            speakers.append(None)
        elif corpus == "casia":
            names.append(f"utt_{i:04d}")
            speakers.append(f"casia_spk_{group + 1}")
        else:  # emodb
            names.append(f"{EMODB_SPEAKERS[group]}a{i % 7}{'ATLN'[c]}a_{i:03d}")
            speakers.append(f"emodb_spk_{EMODB_SPEAKERS[group]}")
    sidecar = "emo" if corpus == "iemocap" else "lbl"
    spk = None if corpus == "iemocap" else speakers
    write_feature_store(out_clean, clean_clips, labels=labels, utt_names=names,
                        speakers=spk, sidecar=sidecar)
    write_feature_store(out_noisy, noisy_clips, labels=labels, utt_names=names,
                        speakers=spk, sidecar=sidecar)


def load_parity_stores(root: str, corpus: str, n_clips: int, dim: int):
    """Writes the corpus pair under ``root`` (clean and ``root2-10db``) and
    loads it: (clean_store, noisy_store)."""
    clean_dir = os.path.join(root, "clean")
    noisy_dir = os.path.join(root, "root2-10db")
    make_parity_corpus(clean_dir, noisy_dir, n=n_clips, dim=dim, corpus=corpus)
    label_map = {k: i for i, k in enumerate(CORPUS_META[corpus]["labels"])}
    return load_feature_store(clean_dir, label_map), load_feature_store(noisy_dir, label_map)


def build_configs(dim: int, epochs: int, seed: int, tmpdir: str,
                  corpus: str = "iemocap"):
    """Corpus presets (the real per-corpus hyperparameter divergences:
    CASIA fixed-threshold/no-ECDA, EMODB beta=0.8/LR=5e-3) scaled down to
    parity-protocol size."""
    pre_cfg = pretrain_preset(
        corpus,
        input_dim=dim,
        batch_size=32,
        max_epochs=max(epochs, 30),
        random_seed=seed,
        save_dir=os.path.join(tmpdir, f"pretrain_s{seed}"),
    )
    warm = max(epochs // 5, 2)
    dad_cfg = dad_preset(
        corpus,
        input_dim=dim,
        batch_size=32,
        epochs=epochs,
        warmup_epochs=warm,
        ecda_start_epoch=warm,
        weight_ramp_epochs=warm,
        validation_interval=5,
        random_seed=seed,
        results_base_dir=os.path.join(tmpdir, f"dad_s{seed}"),
    )
    return pre_cfg, dad_cfg


def run_port_side(pre_cfg, dad_cfg, clean_store, noisy_store, fold=0, device="cuda",
                  init_params=None, step_draws: Optional[Callable] = None) -> Dict:
    """The port's two stages: ``pretrain_fold`` then ``CrossDomainTrainer``
    from its best params. ``init_params`` (the pretrain head's first
    weights) and ``step_draws(epoch, step)`` (the DAD steps' weak/strong
    draws) are the trainers' test hooks."""
    pre = pretrain_fold(pre_cfg, clean_store, fold, device=device, init_params=init_params)
    trainer = CrossDomainTrainer(
        dad_cfg,
        fold=fold,
        clean_store=clean_store,
        noisy_store=noisy_store,
        pretrain_params=pre["params"],
        device=device,
        step_draws=step_draws,
    )
    out = trainer.train()
    if "noisy_test" not in out:
        raise RuntimeError(
            "no best checkpoint was saved — parity cannot score last-epoch "
            "weights as a best-model result"
        )
    return {
        "pretrain_test_wa": pre["test"]["weighted_accuracy"] * 100,
        "best_noisy_val_wa": trainer.best_noisy_weighted_acc,
        "clean_test": out["clean_test"],
        "noisy_test": out["noisy_test"],
    }


def run_replica_side(pre_cfg, dad_cfg, clean_store, noisy_store, fold=0,
                     device="cuda") -> Dict:
    """The reference replica's two stages on ``device``. Raises, as
    ``run_port_side`` does, when no validation saved a best state (the
    replica then scores its last-epoch weights)."""
    from .torch_replica import dad_train_fold_torch, pretrain_fold_torch

    pre = pretrain_fold_torch(pre_cfg, clean_store, fold, device=device)
    out = dad_train_fold_torch(dad_cfg, clean_store, noisy_store, fold,
                               pretrain_sd=pre["state_dict"], device=device)
    if out["best_noisy_weighted_acc"] <= 0:
        raise RuntimeError("the replica saved no best state — parity cannot score "
                           "last-epoch weights as a best-model result")
    return {
        "pretrain_test_wa": pre["test"]["weighted_accuracy"],
        "best_noisy_val_wa": out["best_noisy_weighted_acc"],
        "clean_test": out["clean_test"],
        "noisy_test": out["noisy_test"],
    }


def per_seed(rows, key_path) -> list:
    """Each row's value at ``key_path`` (the values of the JAX tool's
    ``summarize``; ``metric_row`` takes their statistics)."""
    def get(r):
        v = r
        for k in key_path:
            v = v[k]
        return float(v)

    return [get(r) for r in rows]


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def protocol_of(args) -> Dict:
    return {"epochs": args.epochs, "n_clips": args.n_clips, "dim": args.dim,
            "preset": args.corpus, "fold": args.fold}


def protocol_mismatch(report: Dict, args, what: str) -> Optional[str]:
    """Why ``report`` was made under another protocol than this run, or None."""
    want = protocol_of(args)
    for k in PROTOCOL_KEYS:
        old = report["protocol"].get(k)
        if old != want[k]:
            return f"{what} protocol mismatch on {k}: {old} != {want[k]}"
    return None


def metric_row(pv, tv, jax_metric: Optional[Dict]) -> Dict:
    """One metric of the report from the port's and the replica's per-seed
    values (and the JAX report's metric, if given)."""
    pm, ps = float(np.mean(pv)), float(np.std(pv))
    tm, ts = float(np.mean(tv)), float(np.std(tv))
    delta = pm - tm
    # SE of the delta + Welch t so a gate miss can be read as noise vs
    # systematic (both sides train on the same per-seed data, but RNG
    # streams differ); the JAX report's formula
    n = max(len(pv), 1)
    se = float(np.sqrt(ps**2 / n + ts**2 / n))
    row = {
        "port_mean": pm, "port_std": ps, "port_per_seed": list(pv),
        "torch_mean": tm, "torch_std": ts, "torch_per_seed": list(tv),
        "delta_pp": delta,
        "delta_se_pp": se,
        "welch_t": delta / se if se > 0 else 0.0,
    }
    if jax_metric is not None:
        jm, js, nj = (float(jax_metric["jax_mean"]), float(jax_metric["jax_std"]),
                      len(jax_metric["jax_per_seed"]))
        dj = pm - jm
        se_j = float(np.sqrt(ps**2 / n + js**2 / nj))
        row.update({
            "jax_mean": jm, "jax_std": js, "jax_n": nj,
            "delta_vs_jax_pp": dj,
            "delta_vs_jax_se_pp": se_j,
            "delta_vs_jax_t": dj / se_j if se_j > 0 else 0.0,
        })
    return row


def run_seeds(args, seeds, run, port_rows, torch_rows, tmpdir) -> None:
    """Both sides over ``seeds`` on the corpus written under ``tmpdir``:
    appends each seed's rows and seconds."""
    clean_store, noisy_store = load_parity_stores(tmpdir, args.corpus, args.n_clips,
                                                  args.dim)
    for seed in seeds:
        pre_cfg, dad_cfg = build_configs(args.dim, args.epochs, seed, tmpdir,
                                         corpus=args.corpus)
        t0 = time.perf_counter()
        torch_rows.append(run_replica_side(pre_cfg, dad_cfg, clean_store, noisy_store,
                                           args.fold, args.replica_device))
        t1 = time.perf_counter()
        port_rows.append(run_port_side(pre_cfg, dad_cfg, clean_store, noisy_store,
                                       args.fold, args.device))
        t2 = time.perf_counter()
        run["torch_seconds"].append(t1 - t0)
        run["port_seconds"].append(t2 - t1)
        print(
            f"seed {seed}: replica noisy UA "
            f"{torch_rows[-1]['noisy_test']['weighted_accuracy']:.2f}% ({t1 - t0:.1f}s) | "
            f"port noisy UA {port_rows[-1]['noisy_test']['weighted_accuracy']:.2f}% "
            f"({t2 - t1:.1f}s)",
            flush=True,
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5,
                    help="end of the seed range (exclusive)")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--n-clips", type=int, default=600)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--tolerance", type=float, default=0.5)
    ap.add_argument("--corpus", choices=["iemocap", "casia", "emodb"],
                    default="iemocap")
    ap.add_argument("--out", default=None,
                    help="default tools/reports/PARITY_REPORT_<corpus>.json of the package")
    ap.add_argument("--seed-start", type=int, default=0,
                    help="first seed to run (extend an earlier report's "
                         "0..N-1 range without re-running it)")
    ap.add_argument("--merge-from", action="append", default=[],
                    help="existing report whose per-seed values are "
                         "prepended before the summary stats (protocol "
                         "must match: same corpus/epochs/n_clips/dim/fold); "
                         "repeat it to merge chunks run side by side, with an "
                         "empty seed range to merge only")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (default cuda; cpu for a CPU run)")
    ap.add_argument("--replica-device", default="cuda",
                    help="the reference replica's device (default cuda)")
    ap.add_argument("--jax-report", default=None,
                    help="the JAX package's committed report of the corpus (default "
                         "PARITY_REPORT[_<corpus>].json at the repo root); its protocol "
                         "must match; 'none' leaves the JAX comparison out")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    resolve_device(args.replica_device)
    if args.out is None:
        args.out = report_path(args.corpus)
    if args.jax_report is None:
        args.jax_report = os.path.join(REPO_ROOT, JAX_REPORTS[args.corpus])

    jax_report = None
    if args.jax_report != "none":
        with open(args.jax_report) as f:
            jax_report = json.load(f)
        why = protocol_mismatch(jax_report, args, "--jax-report")
        if why:
            print(why, file=sys.stderr)
            return 2
    seeds = list(range(args.seed_start, args.seeds))
    prevs, seen = [], set(seeds)
    for path in args.merge_from:
        with open(path) as f:
            prevs.append(json.load(f))
        why = protocol_mismatch(prevs[-1], args, "--merge-from")
        if why is None and seen & set(prevs[-1]["seed_list"]):
            why = f"--merge-from {path} repeats seeds {sorted(seen & set(prevs[-1]['seed_list']))}"
        if why:
            print(why, file=sys.stderr)
            return 2
        seen |= set(prevs[-1]["seed_list"])

    run = {"seeds": seeds, "port_device": card_line(args.device) if seeds else None,
           "replica_device": card_line(args.replica_device) if seeds else None,
           "port_seconds": [], "torch_seconds": []}
    port_rows, torch_rows = [], []
    if seeds:
        with tempfile.TemporaryDirectory(prefix="parity_") as tmpdir:
            run_seeds(args, seeds, run, port_rows, torch_rows, tmpdir)

    table, worst, worst_jax = {}, 0.0, 0.0
    for name, path in METRICS.items():
        pv = [v for p in prevs for v in p["metrics"][name]["port_per_seed"]]
        tv = [v for p in prevs for v in p["metrics"][name]["torch_per_seed"]]
        pv += per_seed(port_rows, path)
        tv += per_seed(torch_rows, path)
        row = metric_row(pv, tv, jax_report["metrics"][name] if jax_report else None)
        table[name] = row
        if name in GATED:
            worst = max(worst, abs(row["delta_pp"]))
            if jax_report:
                worst_jax = max(worst_jax, abs(row["delta_vs_jax_pp"]))

    ok = worst <= args.tolerance and worst_jax <= args.tolerance
    runs = [r for p in prevs for r in p["runs"]] + ([run] if seeds else [])
    report = {
        "protocol": {
            "seeds": args.seeds, **protocol_of(args),
            "corpus": f"synthetic {args.corpus}-style "
                      "(see tools/run_parity.py:make_parity_corpus)",
            "gate": f"mean noisy-domain UA/WA delta within +/-{args.tolerance} pp",
        },
        "seed_list": [s for p in prevs for s in p["seed_list"]] + seeds,
        "jax_report": (None if jax_report is None
                       else os.path.relpath(os.path.abspath(args.jax_report), REPO_ROOT)),
        "jax_numbers": None if jax_report is None else (
            "the JAX package's committed per-seed accuracies (CPU runs of "
            "tools/run_parity.py), not speeds"),
        "metrics": table,
        "worst_noisy_delta_pp": worst,
        "worst_noisy_delta_vs_jax_pp": worst_jax if jax_report else None,
        "within_tolerance": ok,
        "runs": runs,
        "seconds_per_seed": {
            side: (float(np.mean(t)) if (t := [s for r in runs for s in r[f"{side}_seconds"]])
                   else None)
            for side in ("port", "torch")
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)

    head = f"\n{'metric':<14}{'port':>10}{'replica':>10}{'delta':>9}{'±SE':>7}{'t':>7}"
    print(head + (f"{'jax':>10}{'delta':>9}{'±SE':>7}{'t':>7}" if jax_report else ""))
    for name, row in table.items():
        line = (f"{name:<14}{row['port_mean']:>9.2f}%{row['torch_mean']:>9.2f}%"
                f"{row['delta_pp']:>+9.2f}{row['delta_se_pp']:>7.2f}{row['welch_t']:>+7.1f}")
        if jax_report:
            line += (f"{row['jax_mean']:>9.2f}%{row['delta_vs_jax_pp']:>+9.2f}"
                     f"{row['delta_vs_jax_se_pp']:>7.2f}{row['delta_vs_jax_t']:>+7.1f}")
        print(line)
    print(
        f"\nnoisy-domain parity: worst |port - replica| = {worst:.2f} pp"
        + (f", worst |port - jax| = {worst_jax:.2f} pp" if jax_report else "")
        + f" ({'WITHIN' if ok else 'OUTSIDE'} +/-{args.tolerance} pp) -> {args.out}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
