from .base import (
    DACPConfig,
    DADConfig,
    D2vDecoderConfig,
    D2vPretrainConfig,
    ECDAConfig,
    EncoderConfig,
    AugmentConfig,
    PretrainConfig,
    apply_overrides,
)
from .presets import (
    CORPUS_PRESETS,
    dad_preset,
    pretrain_preset,
)

__all__ = [
    "DACPConfig",
    "DADConfig",
    "D2vDecoderConfig",
    "D2vPretrainConfig",
    "ECDAConfig",
    "EncoderConfig",
    "AugmentConfig",
    "PretrainConfig",
    "apply_overrides",
    "CORPUS_PRESETS",
    "dad_preset",
    "pretrain_preset",
]
