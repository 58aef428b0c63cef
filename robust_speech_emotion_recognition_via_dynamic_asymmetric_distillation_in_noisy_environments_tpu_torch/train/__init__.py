from .early_stopping import EarlyStopper
from .schedules import LRScheduler, make_lr_scheduler
from .pretrain import pretrain_fold, train_with_early_stopping
from .dad_trainer import CrossDomainTrainer, extract_noise_info, run_cv
from .fused_trainer import (
    FusedCrossDomainTrainer,
    injection_display_name,
    prepare_fused_shared,
    refresh_noisy_domain,
    run_fused_cv,
)

__all__ = [
    "EarlyStopper",
    "LRScheduler",
    "make_lr_scheduler",
    "pretrain_fold",
    "train_with_early_stopping",
    "CrossDomainTrainer",
    "extract_noise_info",
    "run_cv",
    "FusedCrossDomainTrainer",
    "injection_display_name",
    "prepare_fused_shared",
    "refresh_noisy_domain",
    "run_fused_cv",
]
