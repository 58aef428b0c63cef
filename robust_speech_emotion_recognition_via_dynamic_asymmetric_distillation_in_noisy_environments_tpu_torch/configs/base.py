"""Typed configuration tree.

Replaces the reference's per-corpus module-constant config files
(``IEMOCAP/DAD-train-IEMOCAP/config.py``, ``CASIA/DAD-train-CASIA/
config_casia.py``, ``EMODB/DAD-train-EMODB/config_emodb.py`` and the pretrain
``config.py`` class hierarchies) with frozen dataclasses plus an override
mechanism — the reference's de-facto flag system was
``importlib.reload(config); setattr(...)`` (run_ablation_studies_iemocap.py:25-40),
which we replace with ``apply_overrides(cfg, {...})``.

Knob names intentionally mirror the reference constants (USE_DACP,
WEIGHT_ECDA, DACP_QUANTILE_START, ...) in snake_case for traceability.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Tuple, Union


@dataclass(frozen=True)
class EncoderConfig:
    """emotion2vec (data2vec-multi audio) encoder hyperparameters.

    Mirrors upstream/models/config.py:14-113 and audio.py:22-45 of the
    reference (only the ``features_only`` inference path matters downstream).
    """

    embed_dim: int = 768
    depth: int = 8
    num_heads: int = 12
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6
    layer_norm_first: bool = False  # post-LN blocks (reference config.py:40)
    prenet_depth: int = 4  # base.py:28
    # wav2vec2-style conv feature extractor spec: (dim, kernel, stride)
    # reference audio.py:27
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    conv_pos_width: int = 95  # audio.py:33
    conv_pos_groups: int = 16  # audio.py:37
    conv_pos_depth: int = 5  # audio.py:41
    # dropouts (inference path runs deterministic; kept for completeness)
    encoder_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    post_mlp_drop: float = 0.1
    dropout_input: float = 0.0
    # whether raw waveforms are layer-normed before the conv stack
    # (emotion2vec_speech_features.py:69-70 honors task.cfg.normalize)
    normalize_input: bool = True
    # compute dtype for the transformer stack ("bfloat16" rides the MXU)
    dtype: str = "bfloat16"
    # keep conv-stack LayerNorms in the compute dtype (bandwidth win in bf16;
    # the f32-statistics reference behavior is used when False)
    fast_conv_norm: bool = False
    # tanh-approximate GELU: ~2x faster conv front end on v5e with error at
    # the bf16 noise floor; False = the reference's exact erf formulation
    gelu_approximate: bool = False
    # LayerNorms with f32 statistics but compute-dtype normalize arithmetic
    # (~30% cheaper LN ops, which dominate the fused step — PERFORMANCE.md);
    # False = the reference's full-f32 LN path used by parity tests
    fast_ln: bool = False
    # attention softmax in the compute dtype (exp still f32): halves the
    # materialized score traffic; False = f32 softmax (reference semantics)
    fast_softmax: bool = False
    # route attention through the Pallas kernel (ops/attention.py).
    # False (default): XLA's fused attention measured faster than the hand
    # kernel at EVERY probed length on v5e — 33 vs 46 ms for the 12-block
    # stack at N=256 (round 2), and 0.84x relative step speed at the
    # 800/1500-frame product buckets (round 5) — so no shipped config
    # enables this. "auto": route per compiled shape (frame count is
    # static under jit), Pallas at N >= layers.FLASH_AUTO_MIN_FRAMES —
    # a hardware-conditional knob for chips/models where the streaming
    # kernel wins, not for this one. True forces it everywhere.
    # NB: the kernel is forward-only — "auto"/True apply to frozen-encoder
    # or inference paths (fused DAD, extract, serving); the differentiated
    # d2v pretrain stack keeps False.
    use_flash_attention: Union[bool, str] = False
    # optional reference branches, dead with the shipped config but ported
    # for config-completeness (see PARITY.md dead-branch ledger):
    # Swin-v2-style cosine attention (modules.py:274-300)
    cosine_attention: bool = False
    # alibi positional bias instead of pure conv positions (base.py:538-642;
    # when on, the bias is ADDED alongside the conv positional encoder just
    # like contextualized_features composes them)
    use_alibi_encoder: bool = False
    alibi_scale: float = 1.0
    # stochastic per-block skip during training (modules.py:78-92,
    # emotion2vec.py:136-141); inference is always deterministic
    layerdrop: float = 0.0
    prenet_layerdrop: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass(frozen=True)
class D2vDecoderConfig:
    """Grouped-conv d2v decoder (reference upstream/models/modules.py:22-35)."""

    decoder_dim: int = 384
    decoder_groups: int = 16
    decoder_kernel: int = 5
    decoder_layers: int = 5
    input_dropout: float = 0.1
    decoder_residual: bool = True
    projection_layers: int = 1
    projection_ratio: float = 2.0


@dataclass(frozen=True)
class D2vPretrainConfig:
    """Self-supervised data2vec-2.0 pretraining of the emotion2vec encoder.

    The reference ships only the inference half (its Data2VecMultiModel
    forward returns nothing unless features_only, upstream/models/
    emotion2vec.py:97-175, and ``self.ema = None`` :65); masking and decoder
    machinery live in base.py:74-519 and modules.py:126-181, and these knobs
    mirror upstream/models/config.py:14-113 + base.py:26-67 defaults.
    """

    # masking (base.py:37-48)
    mask_prob: float = 0.7
    mask_length: int = 5  # 1 = MAE-style random token masking
    inverse_mask: bool = False
    mask_noise_std: float = 0.01
    encoder_zero_mask: bool = True
    # channel masking (base.py:27-28 + 456-469): span-mask embedding
    # channels per clip and zero them across ALL timesteps, applied after
    # the time mask, default off
    mask_channel_prob: float = 0.0
    mask_channel_length: int = 64
    clone_batch: int = 8  # d2v-2.0 multi-mask efficiency trick
    # targets (config.py:42-54)
    average_top_k_layers: int = 8
    instance_norm_target_layer: bool = True
    layer_norm_target_layer: bool = False
    layer_norm_targets: bool = False
    instance_norm_targets: bool = False
    # losses (config.py:16-24, 92-94; cls = emotion2vec's utterance loss)
    loss_beta: float = 0.0  # 0 = L2, else smooth-L1 beta
    loss_scale: Optional[float] = None  # None = 1/sqrt(dim)
    d2v_loss: float = 1.0
    cls_loss: float = 1.0
    # EMA teacher (config.py:56-71)
    ema_decay: float = 0.999
    ema_end_decay: float = 0.9999
    ema_anneal_end_step: int = 75_000
    ema_encoder_only: bool = True  # EMA only the shared transformer blocks
    # collapse guards (config.py:77-83)
    min_target_var: float = 0.1
    min_pred_var: float = 0.01
    decoder: D2vDecoderConfig = field(default_factory=D2vDecoderConfig)
    # optimization
    learning_rate: float = 7.5e-4
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 0.01
    warmup_steps: int = 8_000
    max_steps: int = 100_000
    grad_clip: float = 4.0
    batch_size: int = 16
    # raw-wav dataset (task audio_pretraining.py:40-70)
    sample_rate: int = 16_000
    crop_size: int = 160_000  # 10 s static crop (max_sample_size analogue)
    min_sample_size: int = 32_000
    normalize: bool = True
    random_seed: int = 42
    # Crop-start granularity in samples (8 ms at 16 kHz when 128). Crop
    # offsets are drawn as in fairseq then floored to this grid — BOTH the
    # streaming loop and the resident index projection, so the two stay
    # bit-identical. 128-aligned starts let the resident crop gather take
    # the block fast path: the arbitrary-offset element gather measured
    # 0.1 GB/s at an IEMOCAP-size corpus (98.7 ms of a ~220 ms step;
    # PERFORMANCE.md round 5). Set 1 for fairseq's exact sample-level
    # distribution (element gather on the resident path).
    crop_align: int = 128
    # PRNG implementation for the training stream. "rbg" uses the TPU's
    # hardware generator: measured 1.15-1.25x faster d2v steps (threefry's
    # counter arithmetic is pure VPU work — dropout + mask draws are ~25
    # ms/step at B=8) and ~13x faster XLA compiles (tools/roofline_d2v.py,
    # PERFORMANCE.md round 3). Different random stream than the default;
    # resume stays bit-exact within either choice.
    rng_impl: str = "threefry"
    # storage dtypes for the B-invariant f32 state streams the round-3
    # roofline blamed for the bandwidth floor (PERFORMANCE.md): EMA-teacher
    # copies and the AdamW first moment. "bfloat16" halves their HBM
    # traffic; EMA arithmetic stays f32 (upcast-compute-downcast), only the
    # STORAGE quantizes — an opt-in numerics change (the teacher sees
    # bf16-rounded EMA weights; it already RUNS in the student's compute
    # dtype, merge_teacher_params). See PERFORMANCE.md round 4 for the
    # accept/reject measurement.
    ema_dtype: str = "float32"
    adam_mu_dtype: Optional[str] = None  # optax adamw mu_dtype
    # rematerialize the transformer blocks in the backward pass
    # (jax.checkpoint): trades recompute FLOPs for activation HBM traffic.
    # Bit-identical gradients (tests/test_d2v_pretrain.py); see
    # PERFORMANCE.md round 4 for the accept/reject measurement at the
    # roofline settings.
    remat_blocks: bool = False


@dataclass(frozen=True)
class AugmentConfig:
    """Feature-space weak/strong augmentation (reference utils.py:317-375)."""

    weak_noise_std: float = 0.01  # WEAK_NOISE_STD
    strong_noise_std: float = 0.05  # STRONG_NOISE_STD
    feature_dropout_rate: float = 0.1  # DROPOUT_RATE used for channel dropout
    temporal_mask_ratio: float = 0.1  # TEMPORAL_MASK_RATIO


@dataclass(frozen=True)
class DACPConfig:
    """Dynamic Adaptive Confidence Pruning (reference utils.py:379-507)."""

    use_dacp: bool = True  # USE_DACP
    use_entropy_in_score: bool = True  # USE_ENTROPY_IN_SCORE
    fixed_confidence_threshold: float = 0.9  # FIXED_CONFIDENCE_THRESHOLD
    quality_smoothing_beta: float = 0.9  # DACP_QUALITY_SMOOTHING_BETA
    sensitivity_k: float = 10.0  # DACP_SENSITIVITY_K
    quantile_start: float = 0.4  # DACP_QUANTILE_START
    quantile_end: float = 0.8  # DACP_QUANTILE_END
    calibration_strength_lambda: float = 0.9  # DACP_CALIBRATION_STRENGTH_LAMBDA
    threshold_smoothing_alpha: float = 0.9  # DACP_THRESHOLD_SMOOTHING_ALPHA
    anchor_calibration_enabled: bool = True  # ANCHOR_CALIBRATION_ENABLED
    anchor_std_k: float = 1.5  # ANCHOR_STD_K


@dataclass(frozen=True)
class ECDAConfig:
    """Energy/Class-aware Distribution Alignment (reference utils.py:510-652)."""

    use_ecda: bool = True  # USE_ECDA
    use_class_aware_mmd: bool = True  # USE_CLASS_AWARE_MMD
    kernel_mul: float = 2.0
    kernel_num: int = 5
    class_attention_lambda: float = 1.0  # ECDA_CLASS_ATTENTION_LAMBDA
    compactness_weight_gamma: float = 0.1  # ECDA_COMPACTNESS_WEIGHT_GAMMA
    repulsion_weight_delta: float = 0.1  # ECDA_REPULSION_WEIGHT_DELTA


@dataclass(frozen=True)
class PretrainConfig:
    """Supervised pretrain stage (reference pretrain config.py:4-147)."""

    corpus: str = "iemocap"
    feat_path: str = ""
    save_dir: str = "train_for_clean_models"
    label_dict: Tuple[Tuple[str, int], ...] = (
        ("ang", 0),
        ("hap", 1),
        ("neu", 2),
        ("sad", 3),
    )
    input_dim: int = 768
    hidden_dim: int = 256
    num_classes: int = 4
    max_epochs: int = 100
    batch_size: int = 64
    learning_rate: float = 2e-4
    weight_decay: float = 1e-5
    early_stopping_patience: int = 20
    early_stopping_min_delta: float = 0.001
    early_stopping_metric: str = "val_weighted_acc"
    early_stopping_mode: str = "max"
    lr_scheduler_type: str = "ReduceLROnPlateau"
    lr_scheduler_factor: float = 0.7
    lr_scheduler_patience: int = 8
    lr_scheduler_min_lr: float = 1e-6
    cosine_t_0: int = 10
    cosine_t_mult: int = 2
    cosine_eta_min: float = 1e-6
    n_folds: int = 5
    random_seed: int = 42
    # Static-shape batching: pad sequence lengths up to the nearest bucket.
    length_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)

    @property
    def label_map(self) -> Dict[str, int]:
        return dict(self.label_dict)

    @property
    def class_names(self) -> Tuple[str, ...]:
        # id-sorted: name[i] must be the class with label id i everywhere
        # (metric rows, serving probs) even if label_dict is declared out
        # of id order
        return tuple(k for k, _ in sorted(self.label_dict, key=lambda kv: kv[1]))


@dataclass(frozen=True)
class DADConfig:
    """DAD cross-domain stage (reference DAD config.py:24-218 and siblings)."""

    corpus: str = "iemocap"
    clean_data_dir: str = ""
    noisy_data_dir: str = ""
    pretrained_weight: str = ""
    results_base_dir: str = "cross_domain_results"
    label_dict: Tuple[Tuple[str, int], ...] = (
        ("ang", 0),
        ("hap", 1),
        ("neu", 2),
        ("sad", 3),
    )
    batch_size: int = 64
    input_dim: int = 768
    hidden_dim: int = 256
    num_classes: int = 4
    dropout_rate: float = 0.1
    ema_momentum: float = 0.995  # EMA_MOMENTUM
    warmup_epochs: int = 30  # WARMUP_EPOCHS
    ecda_start_epoch: int = 30  # ECDA_START_EPOCH
    epochs: int = 500
    learning_rate: float = 5e-4
    weight_decay: float = 1e-5
    lr_scheduler: str = "cosine"  # LEARNING_RATE_SCHEDULER
    n_folds: int = 2  # NB: reference overloads this as "fold index + 1"
    gradient_clipping: bool = True
    max_grad_norm: float = 1.0
    use_label_smoothing: bool = True
    label_smoothing_factor: float = 0.05
    weight_consistency: float = 1.0  # WEIGHT_CONSISTENCY
    weight_ecda: float = 0.3  # WEIGHT_ECDA
    progressive_training: bool = True
    initial_consistency_weight: float = 0.1
    final_consistency_weight: float = 0.3
    weight_ramp_epochs: int = 30
    early_stopping: bool = True
    patience: int = 50
    min_delta: float = 0.001
    validation_interval: int = 5
    random_seed: int = 42
    num_tracked_samples: int = 50  # confirmation-bias tracking (train.py:279)
    length_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    # TPU-first deviation knob, OFF by default (PARITY.md): regroup each
    # training epoch's shuffled clips into bucket-homogeneous batches
    # (data/batching.py epoch_order). At IEMOCAP scale the reference-shaped
    # uniform shuffle pads 3.9x more audio than it trains on — one
    # lognormal-tail clip promotes the whole static-shape batch to the 16 s
    # or 30 s bucket (PERFORMANCE.md round 5). Changes only which clips
    # share a batch; clip multiset, batch count and shuffle stream per
    # epoch are unchanged. No reference counterpart (torch pads each batch
    # to its own max at dynamic shapes, so it never pays this tax).
    bucket_batches: bool = False

    dacp: DACPConfig = field(default_factory=DACPConfig)
    ecda: ECDAConfig = field(default_factory=ECDAConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)

    @property
    def label_map(self) -> Dict[str, int]:
        return dict(self.label_dict)

    @property
    def class_names(self) -> Tuple[str, ...]:
        # id-sorted: name[i] must be the class with label id i everywhere
        # (metric rows, serving probs) even if label_dict is declared out
        # of id order
        return tuple(k for k, _ in sorted(self.label_dict, key=lambda kv: kv[1]))


def apply_overrides(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    """Returns a copy of ``cfg`` with (possibly nested) field overrides.

    Keys may be top-level field names or dotted paths into nested dataclasses
    (``"dacp.use_dacp"``). Reference-style UPPER_SNAKE constant names are also
    accepted and routed to the right nested config, replacing the reference's
    ``importlib.reload`` + ``setattr`` harness mechanism.
    """
    out = cfg
    for key, value in overrides.items():
        out = _apply_one(out, key, value)
    return out


def load_encoder_json(arg: str) -> Dict[str, Any]:
    """``--encoder-json``: an inline JSON object or the path of a JSON file;
    ``conv_feature_layers`` lists become tuples, as the frozen config needs."""
    import json

    if arg.lstrip().startswith("{"):
        kw = json.loads(arg)
    else:
        with open(arg, encoding="utf-8") as f:
            kw = json.load(f)
    if "conv_feature_layers" in kw:
        kw["conv_feature_layers"] = tuple(tuple(x) for x in kw["conv_feature_layers"])
    return kw


def encoder_config(encoder_json: Optional[str] = None, **kw: Any) -> EncoderConfig:
    """The config of a frozen encoder (``extract``, ``preprocess``, ``serve``,
    ``dad --from-wav``): attention through the kernel unless
    ``encoder_json`` sets ``use_flash_attention``; ``kw`` (e.g. ``dtype``)
    under the JSON's overrides."""
    fields: Dict[str, Any] = {"use_flash_attention": True, **kw}
    if encoder_json:
        fields.update(load_encoder_json(encoder_json))
    return EncoderConfig(**fields)


# Maps reference UPPER_SNAKE knobs to dotted dataclass paths.
_REFERENCE_KNOBS = {
    "USE_DACP": "dacp.use_dacp",
    "USE_ENTROPY_IN_SCORE": "dacp.use_entropy_in_score",
    "FIXED_CONFIDENCE_THRESHOLD": "dacp.fixed_confidence_threshold",
    "DACP_QUALITY_SMOOTHING_BETA": "dacp.quality_smoothing_beta",
    "DACP_SENSITIVITY_K": "dacp.sensitivity_k",
    "DACP_QUANTILE_START": "dacp.quantile_start",
    "DACP_QUANTILE_END": "dacp.quantile_end",
    "DACP_CALIBRATION_STRENGTH_LAMBDA": "dacp.calibration_strength_lambda",
    "DACP_THRESHOLD_SMOOTHING_ALPHA": "dacp.threshold_smoothing_alpha",
    "ANCHOR_CALIBRATION_ENABLED": "dacp.anchor_calibration_enabled",
    "ANCHOR_STD_K": "dacp.anchor_std_k",
    "USE_ECDA": "ecda.use_ecda",
    "USE_CLASS_AWARE_MMD": "ecda.use_class_aware_mmd",
    "ECDA_CLASS_ATTENTION_LAMBDA": "ecda.class_attention_lambda",
    "ECDA_COMPACTNESS_WEIGHT_GAMMA": "ecda.compactness_weight_gamma",
    "ECDA_REPULSION_WEIGHT_DELTA": "ecda.repulsion_weight_delta",
    "WEAK_NOISE_STD": "augment.weak_noise_std",
    "STRONG_NOISE_STD": "augment.strong_noise_std",
    "TEMPORAL_MASK_RATIO": "augment.temporal_mask_ratio",
    "WEIGHT_ECDA": "weight_ecda",
    "WEIGHT_CONSISTENCY": "weight_consistency",
    "EMA_MOMENTUM": "ema_momentum",
    "WARMUP_EPOCHS": "warmup_epochs",
    "ECDA_START_EPOCH": "ecda_start_epoch",
    "EPOCHS": "epochs",
    "LEARNING_RATE": "learning_rate",
    "BATCH_SIZE": "batch_size",
    "N_FOLDS": "n_folds",
    "NOISY_DATA_DIR": "noisy_data_dir",
    "CLEAN_DATA_DIR": "clean_data_dir",
    "PATIENCE": "patience",
    "EARLY_STOPPING": "early_stopping",
    "PROGRESSIVE_TRAINING": "progressive_training",
    "INITIAL_CONSISTENCY_WEIGHT": "initial_consistency_weight",
    "FINAL_CONSISTENCY_WEIGHT": "final_consistency_weight",
    "WEIGHT_RAMP_EPOCHS": "weight_ramp_epochs",
    "LABEL_SMOOTHING_FACTOR": "label_smoothing_factor",
    "USE_LABEL_SMOOTHING": "use_label_smoothing",
    "RANDOM_SEED": "random_seed",
    "BUCKET_BATCHES": "bucket_batches",
    "VALIDATION_INTERVAL": "validation_interval",
    "MIN_DELTA": "min_delta",
}


def _apply_one(cfg: Any, key: str, value: Any) -> Any:
    key = _REFERENCE_KNOBS.get(key, key)
    if "." in key:
        head, rest = key.split(".", 1)
        sub = getattr(cfg, head)
        return replace(cfg, **{head: _apply_one(sub, rest, value)})
    if not any(f.name == key for f in dataclasses.fields(cfg)):
        raise KeyError(f"unknown config field {key!r} on {type(cfg).__name__}")
    return replace(cfg, **{key: value})
