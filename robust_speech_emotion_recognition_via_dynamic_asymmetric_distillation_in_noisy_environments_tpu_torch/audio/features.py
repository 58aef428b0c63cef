"""Spectral front end: framing, rFFT, log-mel filterbank (fbank).

emotion2vec takes raw 16 kHz waveforms, so nothing in the training or
serving path calls this; it serves spectrogram-based encoders. The frames
are the JAX package's: a strided gather of ``frame_length`` samples every
``hop``, no centring and no padding (``torch.stft``'s defaults centre and
reflect-pad, and give other frames). The mel projection is one matmul.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    num_mels: int = 80,
    n_fft: int = 400,
    sample_rate: int = 16000,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """(n_fft//2+1, num_mels) triangular mel filter matrix with continuous
    frequency triangles (no degenerate filters at low num_mels/n_fft ratios)."""
    fmax = fmax or sample_rate / 2
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz_pts = mel_to_hz(mel_pts)  # (num_mels + 2,)
    fft_freqs = np.linspace(0, sample_rate / 2, n_bins)  # (n_bins,)

    lower = hz_pts[:-2][None, :]  # (1, num_mels)
    center = hz_pts[1:-1][None, :]
    upper = hz_pts[2:][None, :]
    f = fft_freqs[:, None]  # (n_bins, 1)
    up = (f - lower) / np.maximum(center - lower, 1e-9)
    down = (upper - f) / np.maximum(upper - center, 1e-9)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def frame_signal(wav: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, F, frame_length) by strided gather."""
    T = wav.shape[1]
    num_frames = max(1 + (T - frame_length) // hop, 0)
    starts = torch.arange(num_frames, device=wav.device) * hop
    idx = starts[:, None] + torch.arange(frame_length, device=wav.device)[None, :]
    return wav[:, idx]


def log_mel_spectrogram(
    wav: torch.Tensor,  # (B, T)
    num_mels: int = 80,
    n_fft: int = 400,
    hop: int = 160,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """(B, T) -> (B, F, num_mels) log-mel features (25 ms window / 10 ms hop
    defaults), on the waveform's device."""
    frames = frame_signal(wav, n_fft, hop)
    if frames.shape[1] == 0:  # shorter than one window
        return wav.new_zeros((wav.shape[0], 0, num_mels))
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(wav.device)
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filterbank(num_mels, n_fft, sample_rate)).to(wav.device)
    return torch.log(torch.clamp(power @ fb, min=1e-10))


def fbank_lengths(wav_lengths: torch.Tensor, n_fft: int = 400, hop: int = 160) -> torch.Tensor:
    return torch.clamp(1 + (wav_lengths - n_fft) // hop, min=0)
