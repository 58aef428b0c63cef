"""Audio format gate: 16 kHz mono checks and fixes.

Mirrors check_and_fix_audio_format.py:19-60 (resample + downmix before
feature extraction) using scipy's polyphase resampler.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.signal import resample_poly

from .wavio import read_wav, write_wav

TARGET_SR = 16000


def check_audio_format(path: str, target_sr: int = TARGET_SR) -> Tuple[bool, int, int]:
    """Returns (ok, sample_rate, channels)."""
    audio, sr = read_wav(path)
    channels = audio.shape[1] if audio.ndim == 2 else 1
    return (sr == target_sr and channels == 1), sr, channels


def fix_audio_format(
    in_path: str, out_path: str, target_sr: int = TARGET_SR
) -> np.ndarray:
    """Downmixes to mono and resamples to target_sr, writing 16-bit PCM."""
    audio, sr = read_wav(in_path)
    if audio.ndim == 2:
        audio = np.mean(audio, axis=1)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        audio = resample_poly(audio, target_sr // g, sr // g)
    write_wav(out_path, audio, target_sr)
    return audio
