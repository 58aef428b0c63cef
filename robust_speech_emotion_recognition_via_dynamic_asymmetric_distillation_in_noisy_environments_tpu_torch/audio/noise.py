"""SNR-matched noise injection as tensor ops on the device.

Semantics of the reference injectors:
- white noise: noise_power = signal_power / 10^(SNR/10), gaussian noise,
  then the mix is peak-normalised if |x| > 1;
- real (NOISEX-92) noise: the noise clip is tiled or cropped to the signal
  length, scaled so that its power hits the target, mixed, peak-normalised.

The batched variants work on (B, T) padded waveforms with a validity mask,
so injection runs inside the fused extract+train step. Random draws come
from an explicit ``torch.Generator`` on the tensors' device; each function
also takes its draws ready-made (``noise``, ``types``, ``offsets``), which
is how the tests feed both frameworks the same numbers. The file loaders
(``load_noise_clips``, ``load_noise_bank``) come with the host plumbing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NOISE_TYPES = ("babble", "f16", "factory", "hfchannel", "volvo")

# filename -> type in the NOISEX-92 5types directory, in bank order
NOISE_FILE_MAPPING = {
    "babble.wav": "babble",
    "f16.wav": "f16",
    "factory1.wav": "factory",
    "hfchannel.wav": "hfchannel",
    "volvo.wav": "volvo",
}

Scalar = Union[float, torch.Tensor]


def _snr_factor(snr_db: Scalar, like: torch.Tensor) -> torch.Tensor:
    """10^(SNR/10) as a tensor on ``like``'s device (scalar or (B,))."""
    snr = torch.as_tensor(snr_db, dtype=like.dtype, device=like.device)
    return 10.0 ** (snr / 10.0)


def _peak_normalize(noisy: torch.Tensor) -> torch.Tensor:
    peak = torch.amax(torch.abs(noisy), dim=-1, keepdim=True)
    return torch.where(peak > 1.0, noisy / peak, noisy)


def add_white_noise(
    audio: torch.Tensor,
    snr_db: Scalar,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,  # standard normal, audio's shape
) -> torch.Tensor:
    """One clip: gaussian noise at ``snr_db``, then peak normalisation."""
    if noise is None:
        noise = torch.randn(audio.shape, generator=generator,
                            device=audio.device, dtype=audio.dtype)
    noise_power = torch.mean(audio**2) / _snr_factor(snr_db, audio)
    return _peak_normalize(audio + noise * torch.sqrt(noise_power))


def tile_noise(noise: torch.Tensor, target_length: int,
               offset: Union[int, torch.Tensor]) -> torch.Tensor:
    """Fixed-shape tile + crop: ``target_length`` samples starting at
    ``offset``, modulo the noise length."""
    idx = (torch.arange(target_length, device=noise.device) + offset) % noise.shape[0]
    return noise[idx]


def _noise_scale(target: torch.Tensor, noise_power: torch.Tensor) -> torch.Tensor:
    """sqrt(target / noise_power), or 1 for silent noise."""
    return torch.where(
        noise_power > 0,
        torch.sqrt(target / torch.clamp(noise_power, min=1e-20)),
        torch.ones_like(noise_power),
    )


def add_real_noise(audio: torch.Tensor, noise: torch.Tensor, snr_db: Scalar) -> torch.Tensor:
    """One clip: ``noise`` (audio's length) scaled to ``snr_db``, mixed,
    peak-normalised."""
    target = torch.mean(audio**2) / _snr_factor(snr_db, audio)
    scale = _noise_scale(target, torch.mean(noise**2))
    return _peak_normalize(audio + noise * scale)


def _masked_power(wavs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-row mean power over valid samples. wavs (B, T), valid (B, T)."""
    denom = torch.clamp(torch.sum(valid, dim=-1), min=1)
    return torch.sum((wavs**2) * valid, dim=-1) / denom


def batch_add_white_noise(
    wavs: torch.Tensor,  # (B, T) padded waveforms
    valid: torch.Tensor,  # (B, T) bool, True = real sample
    snr_db: Scalar,  # scalar or (B,)
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,  # (B, T) standard normal
) -> torch.Tensor:
    """White noise at ``snr_db`` on the valid samples of each row."""
    valid = valid.to(wavs.dtype)
    if noise is None:
        noise = torch.randn(wavs.shape, generator=generator,
                            device=wavs.device, dtype=wavs.dtype)
    noise_power = _masked_power(wavs, valid) / _snr_factor(snr_db, wavs)
    noisy = wavs + noise * torch.sqrt(noise_power)[:, None] * valid
    return _peak_normalize(noisy)


def batch_mix_noise_bank(
    wavs: torch.Tensor,  # (B, T)
    valid: torch.Tensor,  # (B, T) bool
    noise_bank: torch.Tensor,  # (K, Tn) noise clips on the device
    snr_db: Scalar,  # scalar or (B,)
    generator: Optional[torch.Generator] = None,
    noise_type: Optional[int] = None,  # fixed index into the bank (root1)
    per_sample_type: bool = False,  # a random type per clip (root2)
    types: Optional[torch.Tensor] = None,  # (B,) drawn bank rows
    offsets: Optional[torch.Tensor] = None,  # (B,) drawn circular offsets
) -> torch.Tensor:
    """Mixes real noise from the bank at the target SNR.

    root1 mode (``noise_type``): every clip gets the same noise type.
    root2 mode (``per_sample_type=True``): a random type per clip. A random
    circular offset into the noise clip decorrelates the rows."""
    B, T = wavs.shape
    K, Tn = noise_bank.shape
    if types is None:
        if per_sample_type:
            types = torch.randint(0, K, (B,), generator=generator, device=wavs.device)
        else:
            types = torch.full((B,), noise_type or 0, dtype=torch.long,
                               device=wavs.device)
    if offsets is None:
        offsets = torch.randint(0, Tn, (B,), generator=generator, device=wavs.device)
    idx = (torch.arange(T, device=wavs.device)[None, :] + offsets[:, None]) % Tn
    noise = torch.gather(noise_bank[types.long()], 1, idx)

    valid_f = valid.to(wavs.dtype)
    noise = noise * valid_f
    target = _masked_power(wavs, valid_f) / _snr_factor(snr_db, wavs)
    scale = _noise_scale(target, _masked_power(noise, valid_f))
    return _peak_normalize(wavs + noise * scale[:, None])
