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
    encoder_config,
    load_encoder_json,
    wavlm_large_config,
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
    "encoder_config",
    "load_encoder_json",
    "wavlm_large_config",
    "CORPUS_PRESETS",
    "dad_preset",
    "pretrain_preset",
]
