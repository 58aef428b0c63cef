"""Fused extract+train: waveform -> emotion2vec encoder -> DAD step, in one
call on one GPU.

The clean and noisy waveform batches go through the frozen encoder and
straight into the teacher-student DAD losses without touching the host.
Noise is injected on the device (``audio/noise.py``), so the reference's
preprocessing and training run as one step. This is the path the JAX
package's ``bench.py`` times.

The encoder runs under ``torch.no_grad()``, not ``torch.inference_mode()``:
the head's first Linear saves its input for the weight gradient, and
inference tensors cannot be saved for backward. Only the student gets
gradients; the teacher's forward builds no graph.

The encoder module holds its own parameters, so the JAX functions'
``enc_params`` argument has no counterpart here. Multi-GPU placement
(``mesh``, ``place_fused``) comes with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..audio.noise import batch_add_white_noise, batch_mix_noise_bank
from ..configs import DADConfig, EncoderConfig
from ..dad.train_step import (
    DADTrainState,
    Optimizer,
    StepDraws,
    StepScalars,
    dad_losses,
    init_dad_train_state,
    student_update,
)
from ..models.emotion2vec import Emotion2vecEncoder, normalize_wav
from ..models.heads import DADHead
from ..utils.device import resolve_device


@dataclass(frozen=True)
class FusedConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    dad: DADConfig = field(default_factory=DADConfig)
    # white-noise SNR injected on the device into the noisy stream
    inject_snr_db: Optional[float] = None
    # one of these SNRs per clip per step (takes precedence over
    # inject_snr_db): the reference's multi-SNR noisy trees
    inject_snr_choices: Optional[Tuple[float, ...]] = None
    # real (NOISEX-92) noise from a (K, Tn) bank on the device instead of
    # white noise: "fixed" = inject_noise_type for every clip (root1),
    # "random" = a random type per clip (root2). The step then takes the
    # bank as ``noise_bank``; the SNR still comes from the fields above.
    inject_noise_bank_mode: Optional[str] = None  # None | "fixed" | "random"
    inject_noise_type: int = 0
    # the clean stream has no wav-level randomness, so its features are
    # fixed across steps: with this on, the step takes a CleanFeatureBatch
    # (precompute_clean_features) and only the noisy stream runs the encoder
    cache_clean_features: bool = False


class FusedBatch(NamedTuple):
    wav: torch.Tensor  # (B, T) waveforms
    wav_mask: torch.Tensor  # (B, T) bool True=pad
    labels: torch.Tensor  # (B,)
    row_valid: torch.Tensor  # (B,)
    # clip indices for per-sample confirmation-bias tracking; None skips
    # the tracking outputs
    ids: Optional[torch.Tensor] = None


class CleanFeatureBatch(NamedTuple):
    feats: torch.Tensor  # (B, T', D) f32 encoder features
    frame_mask: torch.Tensor  # (B, T') bool True=pad
    labels: torch.Tensor  # (B,)
    row_valid: torch.Tensor  # (B,)


def extract(encoder: Emotion2vecEncoder, cfg: FusedConfig, wav: torch.Tensor,
            wav_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """normalize_wav (if configured) + the frozen encoder -> f32 features
    and the frame mask, with no graph."""
    if cfg.encoder.normalize_input:
        wav = normalize_wav(wav, wav_mask)
    with torch.no_grad():
        feats, frame_mask = encoder(wav, wav_mask)
    return feats.float(), frame_mask


def precompute_clean_features(encoder: Emotion2vecEncoder, cfg: FusedConfig,
                              clean: FusedBatch) -> CleanFeatureBatch:
    """One extraction pass turning a clean wav batch into the fixed feature
    batch that the cache_clean_features step takes."""
    feats, frame_mask = extract(encoder, cfg, clean.wav, clean.wav_mask)
    return CleanFeatureBatch(feats, frame_mask, clean.labels, clean.row_valid)


def init_fused(cfg: FusedConfig, encoder_state: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda"):
    """The frozen encoder (from ``encoder_state``, e.g. a converted
    emotion2vec checkpoint), the DAD head, its optimizer and train state,
    on ``device``. Returns (encoder, head, tx, state)."""
    dev = resolve_device(device)
    with dev:
        encoder = Emotion2vecEncoder(cfg.encoder)
    encoder.load_state_dict(encoder_state)
    encoder.requires_grad_(False)
    head, tx, state = init_dad_train_state(cfg.dad, generator, device=dev)
    return encoder, head, tx, state


def validate_injection(cfg: FusedConfig) -> None:
    if cfg.inject_noise_bank_mode not in (None, "fixed", "random"):
        raise ValueError(f"bad inject_noise_bank_mode {cfg.inject_noise_bank_mode!r}")
    if cfg.inject_noise_bank_mode is not None and not (
        cfg.inject_snr_choices or cfg.inject_snr_db is not None
    ):
        raise ValueError("inject_noise_bank_mode needs inject_snr_db or inject_snr_choices")


def inject_noise(cfg: FusedConfig, noisy_wav: torch.Tensor, wav_mask: torch.Tensor,
                 generator: Optional[torch.Generator], noise_bank=None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """On-device counterpart of the reference injectors: white noise or
    NOISEX bank mixing, at a fixed or per-clip SNR. ``noise`` supplies the
    white noise's standard-normal draws."""
    if cfg.inject_snr_choices:
        snrs = torch.tensor(cfg.inject_snr_choices, dtype=torch.float32,
                            device=noisy_wav.device)
        snr = snrs[torch.randint(0, len(snrs), (noisy_wav.shape[0],),
                                 generator=generator, device=noisy_wav.device)]
    elif cfg.inject_snr_db is not None:
        snr = cfg.inject_snr_db
    else:
        return noisy_wav
    if cfg.inject_noise_bank_mode is not None:
        return batch_mix_noise_bank(
            noisy_wav, ~wav_mask, noise_bank, snr, generator,
            noise_type=cfg.inject_noise_type,
            per_sample_type=cfg.inject_noise_bank_mode == "random",
        )
    return batch_add_white_noise(noisy_wav, ~wav_mask, snr, generator, noise=noise)


def build_fused_step(encoder: Emotion2vecEncoder, head: DADHead, tx: Optimizer,
                     cfg: FusedConfig):
    """step(state, clean, noisy, scalars, anchors, generator=None,
    noise_bank=None, draws=None) -> (state', metrics).

    ``clean`` is a ``CleanFeatureBatch`` with cache_clean_features, else a
    ``FusedBatch``. Random numbers come from ``generator`` (on the batch's
    device) unless ``draws`` supplies them."""
    validate_injection(cfg)

    def step(state: DADTrainState, clean: Union[FusedBatch, CleanFeatureBatch],
             noisy: FusedBatch, scalars: StepScalars, anchors: torch.Tensor,
             generator: Optional[torch.Generator] = None, noise_bank=None,
             draws: Optional[StepDraws] = None):
        draws = draws or StepDraws()
        noisy_wav = inject_noise(cfg, noisy.wav, noisy.wav_mask, generator,
                                 noise_bank, noise=draws.inject)
        if cfg.cache_clean_features:
            clean_feats, clean_fmask = clean.feats, clean.frame_mask
        else:
            clean_feats, clean_fmask = extract(encoder, cfg, clean.wav, clean.wav_mask)
        noisy_feats, noisy_fmask = extract(encoder, cfg, noisy_wav, noisy.wav_mask)

        student = {k: v.detach().requires_grad_(True) for k, v in state.ssrl.student.items()}
        total, new_dacp, metrics, tracking = dad_losses(
            head, cfg.dad, student, state.ssrl.teacher, state.dacp,
            clean_feats, clean_fmask, clean.labels, clean.row_valid,
            noisy_feats, noisy_fmask, noisy.row_valid, noisy.ids,
            scalars, anchors, generator, draws,
        )
        new_state = student_update(state, total, student, new_dacp, scalars, tx, cfg.dad)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if noisy.ids is not None:
            metrics["tracking"] = tracking
        return new_state, metrics

    return step


def make_fused_extract_train_step(encoder: Emotion2vecEncoder, head: DADHead,
                                  tx: Optimizer, cfg: FusedConfig, mesh=None):
    """The fused step on one device. The encoder is frozen; only the head's
    student gets gradients."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (tp/dp sharding) comes with the multi-GPU slice"
        )
    return build_fused_step(encoder, head, tx, cfg)
