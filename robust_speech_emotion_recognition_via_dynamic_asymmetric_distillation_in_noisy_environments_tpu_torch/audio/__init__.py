from .noise import (
    NOISE_FILE_MAPPING,
    NOISE_TYPES,
    add_real_noise,
    add_real_noise_np,
    add_white_noise,
    add_white_noise_np,
    batch_add_white_noise,
    batch_mix_noise_bank,
    load_noise_bank,
    load_noise_clips,
    tile_noise,
    tile_noise_np,
)
from .wavio import read_mono, read_wav, write_wav

__all__ = [
    "NOISE_FILE_MAPPING",
    "NOISE_TYPES",
    "add_real_noise",
    "add_real_noise_np",
    "add_white_noise",
    "add_white_noise_np",
    "batch_add_white_noise",
    "batch_mix_noise_bank",
    "load_noise_bank",
    "load_noise_clips",
    "read_mono",
    "read_wav",
    "tile_noise",
    "tile_noise_np",
    "write_wav",
]
