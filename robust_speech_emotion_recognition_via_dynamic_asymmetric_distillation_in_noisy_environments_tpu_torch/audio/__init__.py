from .noise import (
    NOISE_FILE_MAPPING,
    NOISE_TYPES,
    add_real_noise,
    add_white_noise,
    batch_add_white_noise,
    batch_mix_noise_bank,
    tile_noise,
)

__all__ = [
    "NOISE_FILE_MAPPING",
    "NOISE_TYPES",
    "add_real_noise",
    "add_white_noise",
    "batch_add_white_noise",
    "batch_mix_noise_bank",
    "tile_noise",
]
