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
``enc_params`` argument has no counterpart here. Over a (dp, tp) mesh
(``parallel/mesh.py``) each rank runs its tp shard of the encoder
(``place_fused``) on its dp rows of the batch, and the head step is the
data-parallel one of ``parallel/sharded.py``: losses over the whole batch.
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
from ..models.layers import conv_out_lengths, convert_padding_mask
from ..utils.device import resolve_device
from .mesh import Mesh, batch_rows, batch_sharding, replicated, shard_encoder_state
from .sharded import as_tensor, draw_head, dp_head_step, shard_dad_state, slice_draws, valid_max


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


def frozen_encoder(cfg: EncoderConfig, encoder_state: Dict[str, torch.Tensor],
                   device: Union[str, torch.device], mesh: Optional[Mesh] = None
                   ) -> Emotion2vecEncoder:
    """The frozen encoder on ``device`` from a full state dict; over a
    mesh with tp > 1, this rank's tensor-parallel shard of it."""
    group = mesh.tp_group if mesh is not None and mesh.tp > 1 else None
    if group is not None:
        encoder_state = shard_encoder_state(encoder_state, mesh)
    with torch.device(device):
        encoder = Emotion2vecEncoder(cfg, tp_group=group)
    encoder.load_state_dict(encoder_state)
    return encoder.requires_grad_(False)


def init_fused(cfg: FusedConfig, encoder_state: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda"):
    """The frozen encoder (from ``encoder_state``, e.g. a converted
    emotion2vec checkpoint), the DAD head, its optimizer and train state,
    on ``device``. Returns (encoder, head, tx, state)."""
    dev = resolve_device(device)
    encoder = frozen_encoder(cfg.encoder, encoder_state, dev)
    head, tx, state = init_dad_train_state(cfg.dad, generator, device=dev)
    return encoder, head, tx, state


def place_fused(cfg: FusedConfig, encoder_state: Dict[str, torch.Tensor],
                state: DADTrainState, mesh: Mesh):
    """Placement over a mesh: the encoder tp-sharded (this rank's shard, on
    its device), the DAD state replicated. Returns (encoder, state)."""
    return (frozen_encoder(cfg.encoder, encoder_state, mesh.device, mesh),
            shard_dad_state(state, mesh))


def validate_injection(cfg: FusedConfig) -> None:
    if cfg.inject_noise_bank_mode not in (None, "fixed", "random"):
        raise ValueError(f"bad inject_noise_bank_mode {cfg.inject_noise_bank_mode!r}")
    if cfg.inject_noise_bank_mode is not None and not (
        cfg.inject_snr_choices or cfg.inject_snr_db is not None
    ):
        raise ValueError("inject_noise_bank_mode needs inject_snr_db or inject_snr_choices")


def inject_noise(cfg: FusedConfig, noisy_wav: torch.Tensor, wav_mask: torch.Tensor,
                 generator: Optional[torch.Generator], noise_bank=None,
                 noise: Optional[torch.Tensor] = None,
                 bank_offsets: Optional[torch.Tensor] = None,
                 bank_types: Optional[torch.Tensor] = None,
                 snr_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """On-device counterpart of the reference injectors: white noise or
    NOISEX bank mixing, at a fixed or per-clip SNR. ``noise`` supplies the
    white noise's standard-normal draws, ``bank_offsets`` / ``bank_types``
    the bank mix's circular offsets and random-mode rows, ``snr_index`` the
    per-clip SNR picks; the rest is drawn from ``generator`` in that order
    (SNR picks, then the noise)."""
    if cfg.inject_snr_choices:
        snrs = torch.tensor(cfg.inject_snr_choices, dtype=torch.float32,
                            device=noisy_wav.device)
        if snr_index is None:
            snr_index = torch.randint(0, len(snrs), (noisy_wav.shape[0],),
                                      generator=generator, device=noisy_wav.device)
        snr = snrs[snr_index]
    elif cfg.inject_snr_db is not None:
        snr = cfg.inject_snr_db
    else:
        return noisy_wav
    if cfg.inject_noise_bank_mode is not None:
        return batch_mix_noise_bank(
            noisy_wav, ~wav_mask, noise_bank, snr, generator,
            noise_type=cfg.inject_noise_type,
            per_sample_type=cfg.inject_noise_bank_mode == "random",
            types=bank_types, offsets=bank_offsets,
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
                                 noise_bank, noise=draws.inject,
                                 bank_offsets=draws.bank_offsets, bank_types=draws.bank_types,
                                 snr_index=draws.snr_index)
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


def draw_injection(cfg: FusedConfig, generator, given: StepDraws, B: int, T: int, device,
                   noise_bank=None) -> StepDraws:
    """The injection's draws for a global batch of B waveforms of T
    samples, in ``inject_noise``'s order; what ``given`` holds is kept."""
    d = given
    if not (cfg.inject_snr_choices or cfg.inject_snr_db is not None):
        return d
    if cfg.inject_snr_choices and d.snr_index is None:
        d = d._replace(snr_index=torch.randint(0, len(cfg.inject_snr_choices), (B,),
                                               generator=generator, device=device))
    if cfg.inject_noise_bank_mode is None:
        if d.inject is None:
            d = d._replace(inject=torch.randn((B, T), generator=generator, device=device))
        return d
    K, Tn = noise_bank.shape
    if cfg.inject_noise_bank_mode == "random" and d.bank_types is None:
        d = d._replace(bank_types=torch.randint(0, K, (B,), generator=generator, device=device))
    if d.bank_offsets is None:
        d = d._replace(bank_offsets=torch.randint(0, Tn, (B,), generator=generator,
                                                  device=device))
    return d


def build_sharded_fused_step(encoder: Emotion2vecEncoder, head: DADHead, tx: Optimizer,
                             cfg: FusedConfig, mesh: Mesh):
    """The fused step over a (dp, tp) mesh, with ``build_fused_step``'s
    signature. ``clean`` and ``noisy`` are the GLOBAL batches (host or
    device); this rank injects noise into its dp rows (its rows of the
    global batch's draws), runs its tp shard of the encoder on them, and
    takes the data-parallel head step. ``encoder`` is this rank's shard
    (``place_fused``); the noise bank is replicated."""
    validate_injection(cfg)
    layers = cfg.encoder.conv_feature_layers
    dropout_rate = head.classifier.dropout_rate

    def step(state: DADTrainState, clean: Union[FusedBatch, CleanFeatureBatch],
             noisy: FusedBatch, scalars: StepScalars, anchors: torch.Tensor,
             generator: Optional[torch.Generator] = None, noise_bank=None,
             draws: Optional[StepDraws] = None):
        dev = mesh.device
        B, T = noisy.wav.shape
        rows = batch_rows(mesh, B)
        # the whole batch's frame mask: its longest valid length sets the
        # strong view's temporal mask on every rank
        wav_mask = as_tensor(noisy.wav_mask, dev)
        frames = int(conv_out_lengths(torch.tensor([T]), layers)[0])
        noisy_fmask = convert_padding_mask(wav_mask, frames, layers)
        d = draw_injection(cfg, generator, replicated(mesh, draws or StepDraws()), B, T, dev,
                           noise_bank)
        d = draw_head(generator, cfg.dad, d, B, (B, frames, cfg.encoder.embed_dim), dev,
                      valid_max(noisy_fmask), dropout_rate, trainer_order=False)
        local = slice_draws(d, rows)
        wav = batch_sharding(mesh, noisy.wav, B)
        noisy_wav = inject_noise(cfg, wav, wav_mask[rows], None, noise_bank,
                                 noise=local.inject, bank_offsets=local.bank_offsets,
                                 bank_types=local.bank_types, snr_index=local.snr_index)
        if cfg.cache_clean_features:
            clean_feats, clean_fmask = batch_sharding(mesh, (clean.feats, clean.frame_mask), B)
            clean_feats = clean_feats.float()
        else:
            cw, cm = batch_sharding(mesh, (clean.wav, clean.wav_mask), B)
            clean_feats, clean_fmask = extract(encoder, cfg, cw, cm)
        noisy_feats, fmask = extract(encoder, cfg, noisy_wav, wav_mask[rows])
        ids = None if noisy.ids is None else as_tensor(noisy.ids, dev)
        new_state, metrics, tracking = dp_head_step(
            head, tx, cfg.dad, mesh, state, clean_feats, clean_fmask, noisy_feats, fmask,
            as_tensor(clean.labels, dev), as_tensor(clean.row_valid, dev),
            as_tensor(noisy.row_valid, dev), ids, scalars, anchors, local,
            valid_max(noisy_fmask))
        if ids is not None:
            metrics["tracking"] = tracking
        return new_state, metrics

    return step


def make_fused_extract_train_step(encoder: Emotion2vecEncoder, head: DADHead,
                                  tx: Optimizer, cfg: FusedConfig, mesh: Optional[Mesh] = None):
    """The fused step. The encoder is frozen; only the head's student gets
    gradients. With a mesh, batches are split over dp and the encoder is
    this rank's tp shard (``build_sharded_fused_step``)."""
    if mesh is not None:
        return build_sharded_fused_step(encoder, head, tx, cfg, mesh)
    return build_fused_step(encoder, head, tx, cfg)
