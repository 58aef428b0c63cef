"""Noise-injection verification (reference verify_noise_injection.py:45-60).

Reconstructs the injected noise as ``noisy - clean`` and checks the achieved
SNR against the target within a dB tolerance. Used as a gating step by the
offline injection CLI, mirroring real_noise_preprocessing.ps1:262-276.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import get_logger
from .wavio import read_wav

logger = get_logger(__name__)


def estimate_snr(clean: np.ndarray, noisy: np.ndarray) -> float:
    n = min(len(clean), len(noisy))
    clean, noisy = clean[:n], noisy[:n]
    noise = noisy - clean
    signal_power = np.mean(clean**2)
    noise_power = np.mean(noise**2)
    if noise_power <= 0:
        return float("inf")
    return float(10.0 * np.log10(signal_power / noise_power))


def estimate_snr_scale_corrected(
    clean: np.ndarray, noisy: np.ndarray
) -> Tuple[float, float]:
    """(achieved SNR, fitted scale): least-squares fit of
    ``noisy ~ alpha * clean`` undoes the mixer's peak normalization
    (``noisy = (clean + noise)/p`` when the raw mix clips), which shifts the
    naive noisy-minus-clean estimate by up to ~+3 dB for loud clips at low
    SNR. For unnormalized mixes alpha ~ 1 and this reduces to the naive
    estimator."""
    n = min(len(clean), len(noisy))
    clean, noisy = clean[:n], noisy[:n]
    cc = float(np.dot(clean, clean))
    if cc <= 0:
        return float("inf"), 1.0
    alpha = float(np.dot(noisy, clean) / cc)
    noise = noisy - alpha * clean
    signal_power = np.mean((alpha * clean) ** 2)
    noise_power = np.mean(noise**2)
    if noise_power <= 0:
        return float("inf"), alpha
    return float(10.0 * np.log10(signal_power / noise_power)), alpha


def verify_noise_injection(
    clean_root: str,
    noisy_root: str,
    relpaths: Sequence[str],
    target_snr_db: float,
    tolerance_db: float = 2.0,
    num_samples: Optional[int] = 20,
    seed: int = 42,
) -> Tuple[bool, List[Tuple[str, float]]]:
    """Samples pairs and checks |achieved - target| <= tolerance.

    NB: the mixer peak-normalizes clips whose mix exceeds 1.0, which shifts
    the naive noisy-minus-clean estimate; such clips are reported but judged
    with a relaxed bound, like the reference tolerates in practice.
    """
    rng = np.random.default_rng(seed)
    relpaths = list(relpaths)
    if num_samples is not None and len(relpaths) > num_samples:
        relpaths = [relpaths[i] for i in rng.choice(len(relpaths), num_samples, replace=False)]
    results = []
    ok = True
    for rel in relpaths:
        clean, _ = read_wav(os.path.join(clean_root, rel))
        noisy, _ = read_wav(os.path.join(noisy_root, rel))
        # the injector mono-mixes multi-channel input before mixing, so a
        # stereo CLEAN source must be mono-mixed the same way or the
        # noisy-minus-clean reconstruction is a shape mismatch
        if clean.ndim == 2:
            clean = clean.mean(axis=1)
        if noisy.ndim == 2:
            noisy = noisy.mean(axis=1)
        snr = estimate_snr(clean, noisy)
        if abs(snr - target_snr_db) > tolerance_db:
            # the naive estimate is biased for peak-normalized mixes; re-judge
            # with the scale-corrected estimator before failing the gate
            corrected, alpha = estimate_snr_scale_corrected(clean, noisy)
            if alpha < 0.995 and abs(corrected - target_snr_db) <= tolerance_db:
                logger.info(
                    "%s: naive SNR %.2f dB off target but mix was "
                    "peak-normalized (scale %.3f); corrected %.2f dB is "
                    "within tolerance", rel, snr, alpha, corrected,
                )
                snr = corrected
            else:
                logger.warning(
                    "SNR off target for %s: achieved %.2f dB vs target %.2f dB",
                    rel,
                    snr,
                    target_snr_db,
                )
                ok = False
        results.append((rel, snr))
    return ok, results
