"""Per-corpus presets.

One framework, three corpus presets — collapsing the reference's three copied
trees. Values trace to:
- IEMOCAP DAD: IEMOCAP/DAD-train-IEMOCAP/config.py:24-148
- CASIA DAD:   CASIA/DAD-train-CASIA/config_casia.py:25-152
- EMODB DAD:   EMODB/DAD-train-EMODB/config_emodb.py:25-152
- pretrain:    IEMOCAP/pretrain-and-processed-IEMOCAP/config.py:4-147 (and
  EMODB/CASIA variants)
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Mapping, Optional

from .base import (
    AugmentConfig,
    DACPConfig,
    DADConfig,
    ECDAConfig,
    PretrainConfig,
    apply_overrides,
)

IEMOCAP_LABELS = (("ang", 0), ("hap", 1), ("neu", 2), ("sad", 3))
CASIA_LABELS = (("angry", 0), ("happy", 1), ("neutral", 2), ("sad", 3))
EMODB_LABELS = (("angry", 0), ("happy", 1), ("neutral", 2), ("sad", 3))

# Fold counts per corpus: IEMOCAP 5-fold by session (data.py:39-61), CASIA
# 4-fold by speaker (dataload_casia_clean.py:84-91), EMODB 10-fold LOSO
# (dataload_emodb_clean.py:21-47 — the code, not the README, is authoritative).
CORPUS_PRESETS = {
    "iemocap": dict(labels=IEMOCAP_LABELS, num_folds=5, fold_policy="session"),
    "casia": dict(labels=CASIA_LABELS, num_folds=4, fold_policy="speaker"),
    "emodb": dict(labels=EMODB_LABELS, num_folds=10, fold_policy="speaker_loso"),
}


# Pretrain config variants mirroring the reference's TrainingConfig class
# hierarchy (pretrain config.py:4-147: default / AdvancedConfig /
# CosineConfig / DebugConfig).
_PRETRAIN_VARIANTS: dict = {
    "default": {},
    "advanced": dict(
        early_stopping_patience=30,
        learning_rate=1e-4,
        lr_scheduler_patience=12,
        lr_scheduler_type="CosineAnnealingWarmRestarts",
        cosine_t_0=15,
        cosine_t_mult=2,
        cosine_eta_min=5e-7,
        batch_size=128,
    ),
    "cosine": dict(
        lr_scheduler_type="CosineAnnealingWarmRestarts",
        learning_rate=3e-4,
        cosine_t_0=12,
        cosine_t_mult=2,
        cosine_eta_min=1e-7,
        early_stopping_patience=25,
        max_epochs=120,
    ),
    "debug": dict(max_epochs=10, early_stopping_patience=3),
}


def pretrain_preset(corpus: str, variant: str = "default", **kwargs: Any) -> PretrainConfig:
    corpus = corpus.lower()
    preset = CORPUS_PRESETS[corpus]
    base = PretrainConfig(
        corpus=corpus,
        label_dict=preset["labels"],
        n_folds=preset["num_folds"],
    )
    if corpus == "emodb":
        # EMODB pretrain uses batch 32 (EMODB pretrain config EmoDBConfig:98
        # uses 128 in an advanced variant; the committed driver path uses the
        # 10-fold LOSO trainer with small batches for ~291 clips).
        base = replace(base, batch_size=32)
    if variant != "default":
        base = replace(base, **_PRETRAIN_VARIANTS[variant])
    return replace(base, **kwargs) if kwargs else base


def dad_preset(
    corpus: str,
    overrides: Optional[Mapping[str, Any]] = None,
    **kwargs: Any,
) -> DADConfig:
    corpus = corpus.lower()
    preset = CORPUS_PRESETS[corpus]
    common = dict(
        corpus=corpus,
        label_dict=preset["labels"],
        results_base_dir=f"{corpus}_mutil-noisy_cross_domain_results"
        if corpus == "iemocap"
        else f"{corpus}_cross_domain_results",
    )
    if corpus == "iemocap":
        cfg = DADConfig(
            **common,
            learning_rate=5e-4,
            weight_ecda=0.3,
            dacp=DACPConfig(
                use_dacp=True,
                quality_smoothing_beta=0.9,
                calibration_strength_lambda=0.9,
                fixed_confidence_threshold=0.9,
            ),
            ecda=ECDAConfig(
                use_ecda=True,
                compactness_weight_gamma=0.1,
                repulsion_weight_delta=0.1,
            ),
        )
    elif corpus == "casia":
        # CASIA committed config ships USE_DACP/USE_ECDA = False with a fixed
        # threshold of 0.75 (config_casia.py:85-87).
        cfg = DADConfig(
            **common,
            learning_rate=5e-4,
            weight_ecda=0.35,
            dacp=DACPConfig(
                use_dacp=False,
                quality_smoothing_beta=0.9,
                calibration_strength_lambda=0.1,
                fixed_confidence_threshold=0.75,
            ),
            ecda=ECDAConfig(
                use_ecda=False,
                compactness_weight_gamma=0.05,
                repulsion_weight_delta=0.05,
            ),
        )
    elif corpus == "emodb":
        cfg = DADConfig(
            **common,
            learning_rate=5e-3,
            weight_ecda=0.1,
            dacp=DACPConfig(
                use_dacp=True,
                quality_smoothing_beta=0.8,
                calibration_strength_lambda=0.3,
                fixed_confidence_threshold=0.75,
            ),
            ecda=ECDAConfig(
                use_ecda=True,
                compactness_weight_gamma=0.1,
                repulsion_weight_delta=0.1,
            ),
        )
    else:
        raise KeyError(f"unknown corpus {corpus!r}")
    if kwargs:
        cfg = replace(cfg, **kwargs)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
