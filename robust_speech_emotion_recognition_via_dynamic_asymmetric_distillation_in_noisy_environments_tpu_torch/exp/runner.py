"""Experiment runner: one named experiment = one config-override dict.

The reference's importlib.reload + setattr flag system
(run_ablation_studies_iemocap.py:14-67) becomes ``apply_overrides`` on the
frozen config tree. Results are scraped from the same
``BEST_detailed_results_epoch_*.json`` contract the reference harness uses.

Each experiment builds its trainer, trains it and lets it go before the
next one starts: the trainer's device state (the resident corpus, the
train state) is freed, so a sweep's peak device memory stays that of one
experiment. The peak is logged after each experiment.
"""

from __future__ import annotations

import gc
import glob
import json
import os
from typing import Any, Dict, Mapping, Optional

import torch

from ..configs import DADConfig, apply_overrides
from ..train.dad_trainer import CrossDomainTrainer
from ..utils import get_logger, resolve_device

logger = get_logger(__name__)


def scrape_best_results(results_dir: str) -> Optional[Dict[str, Any]]:
    """Parses WA / W-F1 out of the newest BEST_detailed_results json
    (reference run_ablation_studies_iemocap.py:50-67)."""
    pattern = os.path.join(results_dir, "reports", "BEST_detailed_results_epoch_*.json")
    files = sorted(glob.glob(pattern), key=os.path.getmtime)
    if not files:
        return None
    with open(files[-1], encoding="utf-8") as f:
        data = json.load(f)
    summary = data["summary"]["noisy"]
    return {
        "epoch": data["info"]["epoch"],
        "noisy_wa": float(summary["w_acc"].rstrip("%")),
        "noisy_wf1": float(summary["w_f1"].rstrip("%")),
        "clean_wa": float(data["summary"]["clean"]["w_acc"].rstrip("%")),
        "source": files[-1],
    }


# Injection knobs a fused experiment may override (no reference counterpart:
# the reference expresses noise conditions as NOISY_DATA_DIR swaps into
# offline-preprocessed trees; fused training expresses them as on-device
# injection config). Values mirror cli.py `dad --from-wav` flags.
FUSED_INJECTION_KEYS = (
    "INJECT_SNR_DB",        # float | None
    "INJECT_SNR_CHOICES",   # iterable of floats | None
    "INJECT_NOISE_MODE",    # None (white) | "fixed" (root1) | "random" (root2)
    "INJECT_NOISE_TYPE",    # NOISEX type name (str) or bank index (int)
)


def split_fused_overrides(overrides: Mapping[str, Any]):
    """Splits an experiment override dict into (DAD-config overrides,
    FusedConfig injection replacements)."""
    from ..audio.noise import NOISE_TYPES

    dad_ov, inj = {}, {}
    for k, v in overrides.items():
        if k not in FUSED_INJECTION_KEYS:
            dad_ov[k] = v
        elif k == "INJECT_SNR_DB":
            inj["inject_snr_db"] = None if v is None else float(v)
        elif k == "INJECT_SNR_CHOICES":
            inj["inject_snr_choices"] = (
                None if v is None else tuple(float(x) for x in v)
            )
        elif k == "INJECT_NOISE_MODE":
            if v not in (None, "fixed", "random"):
                raise ValueError(f"INJECT_NOISE_MODE={v!r}: expected "
                                 "None, 'fixed' or 'random'")
            inj["inject_noise_bank_mode"] = v
        else:  # INJECT_NOISE_TYPE
            inj["inject_noise_type"] = (
                NOISE_TYPES.index(v) if isinstance(v, str) else int(v)
            )
    # a multi-SNR override supersedes the base single SNR and vice versa
    if inj.get("inject_snr_choices") and "inject_snr_db" not in inj:
        inj["inject_snr_db"] = None
    if inj.get("inject_snr_db") is not None and "inject_snr_choices" not in inj:
        inj["inject_snr_choices"] = None
    return dad_ov, inj


def _train_and_release(name: str, make_trainer, device) -> Dict[str, Any]:
    """Builds the experiment's trainer, trains it, and frees it (and its
    device state) before returning; logs the experiment's peak device
    memory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = make_trainer()
    try:
        return trainer.train()
    finally:
        del trainer
        gc.collect()
        if dev.type == "cuda":
            logger.info("experiment %s: peak device memory %.2f GB", name,
                        torch.cuda.max_memory_allocated(dev) / 1e9)


def _result_row(name: str, overrides: Mapping[str, Any], out: Dict) -> Dict[str, Any]:
    scraped = scrape_best_results(out["results_dir"]) or {}
    return {
        "name": name,
        "overrides": dict(overrides),
        "best_noisy_weighted_acc": out["best_noisy_weighted_acc"],
        "results_dir": out["results_dir"],
        **scraped,
    }


def run_single_fused_experiment(
    base_cfg: DADConfig,
    name: str,
    overrides: Mapping[str, Any],
    manifest_dir: str,
    encoder_cfg,
    enc_params,
    base_fused_cfg=None,
    noise_root: Optional[str] = None,
    fold: int = 0,
    shared: Optional[dict] = None,
    pretrain_params=None,
    mesh=None,
    prefetch_depth: int = 2,
    transfer_dtype: Optional[str] = None,
    device="cuda",
    trainer_kw: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """One named FUSED experiment: DAD-config overrides route through
    ``apply_overrides`` exactly like the feature-level runner; injection
    overrides (FUSED_INJECTION_KEYS) route into the FusedConfig. When the
    experiment changes the injection, only the fixed noisy val/test domain
    of ``shared`` is rebuilt (``refresh_noisy_domain``); the wav decode and
    the clean extraction pass are reused.

    ``trainer_kw``: further keyword arguments of the
    ``FusedCrossDomainTrainer`` (``resident``, the ``step_draws`` test
    hook)."""
    from dataclasses import replace

    from ..train.fused_trainer import (
        FusedCrossDomainTrainer,
        _normalize_fused_cfg,
        refresh_noisy_domain,
    )

    dad_ov, inj = split_fused_overrides(overrides)
    cfg = apply_overrides(base_cfg, dad_ov)
    fused_cfg = base_fused_cfg
    if fused_cfg is None:
        from ..parallel.fused import FusedConfig

        fused_cfg = FusedConfig(
            encoder=encoder_cfg, dad=cfg, inject_snr_db=10.0,
            cache_clean_features=True,
        )
    if inj:
        fused_cfg = _normalize_fused_cfg(
            cfg, encoder_cfg, replace(fused_cfg, **inj), noise_root
        )
        if shared is not None:
            shared = refresh_noisy_domain(shared, fused_cfg, noise_root)
    logger.info("=== fused experiment %s (fold %d) overrides=%s ===",
                name, fold + 1, dict(overrides))
    out = _train_and_release(name, lambda: FusedCrossDomainTrainer(
        cfg,
        manifest_dir,
        encoder_cfg,
        enc_params,
        fused_cfg=fused_cfg,
        noise_root=noise_root,
        fold=fold,
        experiment_name=name,
        pretrain_params=pretrain_params,
        prefetch_depth=prefetch_depth,
        transfer_dtype=transfer_dtype,
        shared=shared,
        mesh=mesh,
        device=device,
        **dict(trainer_kw or {}),
    ), device if mesh is None else mesh.device)
    return _result_row(name, overrides, out)


def run_single_experiment(
    base_cfg: DADConfig,
    name: str,
    overrides: Mapping[str, Any],
    fold: int = 0,
    clean_store=None,
    noisy_store=None,
    pretrain_params=None,
    device="cuda",
    trainer_kw: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """One named feature-level experiment. ``trainer_kw``: further keyword
    arguments of the ``CrossDomainTrainer`` (``resident``, the
    ``step_draws`` test hook)."""
    cfg = apply_overrides(base_cfg, overrides)
    # a data-dir override is silently dead when a preloaded store is passed
    # (the trainer only reads cfg.*_data_dir with store=None) — every noise
    # condition would train on the same data while labeled differently
    if noisy_store is not None and "NOISY_DATA_DIR" in overrides:
        logger.info("NOISY_DATA_DIR override: reloading noisy store from %s",
                    cfg.noisy_data_dir)
        noisy_store = None
    if clean_store is not None and "CLEAN_DATA_DIR" in overrides:
        logger.info("CLEAN_DATA_DIR override: reloading clean store from %s",
                    cfg.clean_data_dir)
        clean_store = None
    logger.info("=== experiment %s (fold %d) overrides=%s ===", name, fold + 1, dict(overrides))
    out = _train_and_release(name, lambda: CrossDomainTrainer(
        cfg,
        fold=fold,
        experiment_name=name,
        clean_store=clean_store,
        noisy_store=noisy_store,
        pretrain_params=pretrain_params,
        device=device,
        **dict(trainer_kw or {}),
    ), device)
    return _result_row(name, overrides, out)
