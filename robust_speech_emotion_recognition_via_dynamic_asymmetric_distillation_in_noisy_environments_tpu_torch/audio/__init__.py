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
from .format import check_audio_format, fix_audio_format
from .verify import estimate_snr, verify_noise_injection
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
    "check_audio_format",
    "estimate_snr",
    "fix_audio_format",
    "load_noise_bank",
    "load_noise_clips",
    "read_mono",
    "read_wav",
    "tile_noise",
    "tile_noise_np",
    "verify_noise_injection",
    "write_wav",
]
