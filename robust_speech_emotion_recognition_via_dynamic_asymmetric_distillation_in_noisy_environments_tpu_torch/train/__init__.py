from .dad_trainer import CrossDomainTrainer, extract_noise_info, run_cv
from .fused_trainer import (
    FusedCrossDomainTrainer,
    injection_display_name,
    prepare_fused_shared,
    refresh_noisy_domain,
    run_fused_cv,
)

__all__ = [
    "CrossDomainTrainer",
    "extract_noise_info",
    "run_cv",
    "FusedCrossDomainTrainer",
    "injection_display_name",
    "prepare_fused_shared",
    "refresh_noisy_domain",
    "run_fused_cv",
]
