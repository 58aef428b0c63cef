#!/usr/bin/env python3
"""Drives the PyTorch port's paths on one NVIDIA GPU and checks them: the
serving path, the fused-norm probe, the conv front end through its kernel,
the fused extract+train step, the feature-level trainer, the fused
wav->train trainer, stage 1 (manifest, injection, extraction) with
inference, the supervised pretrain, the experiment harness and the
analyses, and d2v self-supervised pretraining of the encoder.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for the f32 checks.
2. build: compiles every CUDA source of the port with nvcc (sm_90a), one
   nvcc per source, all started together, and prints the build seconds.
3. kernel vs plain: the attention kernel against its plain PyTorch version
   at B=16, H=12, D=64 and the frame count of every wav bucket (N in {49,
   99, 199, 399, 799, 1499}) in bf16 and at N in {49, 399, 1499} in f32, and
   at the fused steps' B=64 (N in {199, 799, 1499}, bf16), with suffix
   padding and one fully masked batch row, on contiguous operands and on the encoder's
   strided views; times the kernel in turns with torch's
   scaled_dot_product_attention (a yardstick only: the port never calls
   it) with the measures of phase 5 below, the plain version's call ms,
   and computes the bound; then the kernel against plain on a tensor-parallel
   rank's heads (H 6 and 3, the rank's own qkv views). ``--only attention``
   stops after this phase.
4. the slice: full-width emotion2vec-base (768-d, 12 heads, 4 prenet + 8
   blocks, 7-layer conv front end, 5-layer positional conv) from seeded
   random weights in the fairseq layout, bf16, attention through the
   kernel; FeatureExtractor -> EmotionPredictor(int16 transfer) ->
   PredictionServer, warmed over every bucket up to 30 s; 12 concurrent
   /predict requests (0.5-30 s clips) as JSON ``wav`` bodies, the same 12
   as ``pcm16`` bodies, one features request and /healthz. Checks replies,
   launch counts, and logits against the plain-attention path; an f32 run
   of the same encoder holds the kernel path to the plain one more
   tightly. Prints requests/s, batch latency per bucket, and a
   torch.profiler breakdown of one batch at the 1 s and 30 s buckets.
5. fused LN and copy vs plain: the three ``fused_layernorm`` variants at
   the fused step's shapes, bf16 and f32, plus one backward, and
   ``copy_rows`` (bf16 and f32); each timed beside its plain version,
   ``F.layer_norm`` (+ add / GELU) or ``Tensor.copy_`` and its bound. The
   kernel and its PyTorch call are measured in turns (kernel, library,
   library, kernel) with ``utils/timing.py``: device ms with cold L2 (CUDA
   graph replays over a rotation of input sets larger than L2; the ``ms``
   of the line), device ms with warm L2, call ms (events around eager
   calls) and host µs per call, with ``nvidia-smi``'s clocks and power
   sampled beside each case. Then the probe (``ops/norm_probe.py``) runs
   as the path of these two kernels, with their launch counts read around
   it.
6. conv stack vs plain: ``fused_conv_ln_gelu`` per layer of the
   emotion2vec front end at B = 64, 4 s clips, on the encoder's own conv
   weights and the training slice's noisy batch (erf GELU, and tanh for
   layers 1-6), held against the plain version, then timed in turns with
   F.conv1d + F.layer_norm + F.gelu by phase 5's measures (the ``ms`` of a
   layer is its device ms with cold L2), beside the plain version's call
   ms and the bound; then the whole front end through the kernel (layer 0
   + ``pallas_conv_stack``, its path, launches counted) held against the
   port's ``ConvFeatureExtractor`` (plain path, erf GELU, f32 LN), bf16
   and f32. ``--only conv`` builds conv.cu and runs phases 1, 2 and 6,
   then times the tensor-core path's grid (a block per SM walking the
   tiles) against a block per tile at layers 1-6.
7. the training slice: ``bench.py``'s configuration (full-width
   emotion2vec-base, bf16, tanh GELU, iemocap DAD preset, B = 64 clips of
   4 s per stream, white noise at 10 dB, cached clean features, epoch 40
   scalars) with ``use_flash_attention=True``: ``precompute_clean_features``
   once, then 20 fused extract+train steps. Checks finite losses, that
   the student and teacher moved, the attention launch count; then 3
   steps through the kernel and 3 through the plain attention path from
   the same state and generator seed must agree, with one filler row
   (all samples padded, ``row_valid`` False) in the noisy batch. Prints
   ms/step, training clips/s and a torch.profiler breakdown of one step.
8. the feature-level trainer: a synthetic IEMOCAP-layout clean store and
   its noisy twin at the corpus's size (5531 clips over Ses01-Ses05,
   50-1000 frames, 768-d f32, 3.8 GB each) written with the port's
   ``write_feature_store`` to a temporary directory, then ``cli.main(["dad",
   "--corpus", "iemocap", "--clean", ..., "--noisy", ..., "--fold", "0",
   "--epochs", "3", "--warmup-epochs", "1"])`` on the card (the iemocap
   preset at full width). Checks rc 0, a finite history of the right
   lengths, that the best .pth reloads and re-validates to the logged best
   noisy WA, and noisy test WA above chance; then ``--scan-chunk 4`` must
   give the same history, resident and with ``--resident off``, the pinned prefetch path must deliver batches
   unaltered under a slow consumer, and the same trainer on the card and
   on the CPU, from one pretrain head and fed the same draws through its
   hook for 3 steps, must agree. Prints ms/step (epoch 2), epoch and
   validation seconds, clips/s, H2D MB per step (f32 and bf16 transfer),
   the kernels' launches on this path (none lies on it) and a
   torch.profiler breakdown of one step. The fold's stores are resident on
   the card (``--resident auto``), and the same first steps of a resident
   and a ``--resident off`` trainer from one seed must agree.
   ``--only trainer`` runs this phase alone.
9. the fused trainer: a synthetic IEMOCAP wav corpus (5531 clips over
   Ses01-Ses05, 16 kHz int16, lognormal lengths of mean ~4.5 s clipped to
   0.6-30 s, a tone per class) in IEMOCAP's raw layout, its manifest and
   ``.emo`` sidecar from ``cli manifest`` (phase 10), and a random
   emotion2vec-base checkpoint, then ``cli.main(["dad", "--corpus",
   "iemocap", "--from-wav", ..., "--checkpoint", ..., "--fold", "0",
   "--epochs", "3", "--warmup-epochs", "1", "--snr", "10"])`` on the card:
   the iemocap preset at full width, bf16, attention through the kernel,
   the corpus resident. Checks rc 0, the resident corpus, the attention
   launches (12 per extraction batch of both startup passes and per
   training step; the other kernels none), the history, the best .pth
   re-validating to the logged best noisy WA, noisy test WA above chance,
   the final report; then a resident and a streamed trainer over the same
   3 steps from one seed; then a second startup whose encoder takes the
   plain attention path extracts its own stores, which hold the kernel's
   stores clip by clip, and a trainer on them holds the kernel trainer's
   3 steps (metrics, every row's certainty score, the student's update,
   the DACP state). Prints the startup
   seconds by stage, resident MB, peak device memory, ms/step, epoch
   seconds, clips/s, H2D bytes a step (resident and streamed), the wav
   buckets of the steps and a torch.profiler breakdown of one step.
   ``--only fused`` builds attention.cu and runs phases 1, 2 and 9.
10. stage 1 and inference: the corpus of phase 9 is written before it, as
    IEMOCAP's raw tree (``Session{N}/sentences/wav/<dialog>/<utt>.wav`` and
    EmoEvaluation files), and ``cli manifest --corpus iemocap`` builds the
    manifest that phase 9 trains from. After phase 9: ``cli inject
    --snr_db 10 --verify`` with the native engine and with the numpy
    engine (both must pass verification; seconds and achieved SNR
    printed); ``cli extract`` of the clean tree and of the numpy-injected
    tree (bf16, attention through the kernel: seconds, clips/s, 12
    attention launches per batch of 16, peak device GB), whole batches of
    each over every wav bucket extracted again through the plain attention
    path and held against the store clip by clip; ``cli infer --split test
    --fold 0`` of phase 9's best .pth over the noisy store on the card and
    on the CPU (noisy WA above chance; predictions equal or flipped only at
    a near-tie, with the count and margins printed); ``cli preprocess``
    over the whole corpus for one condition of each real-noise mode of the
    reference's grid (babble at 10 dB, and a random NOISEX type a clip at
    10 dB; a seeded synthetic bank of the five NOISEX-92 files; native
    engine, verification, extraction on the card): seconds a condition,
    its injection and its extraction pass. ``--only preprocess`` builds
    attention.cu and runs phases 1, 2, 9 and 10.
11. pretrain, experiments and analysis, on phase 10's clean and noisy
    stores and phase 9's corpus and checkpoint: ``cli pretrain --corpus
    iemocap --feat-path <clean> --folds 0 --max-epochs 5`` on the card (rc
    0, the .ckpt's shapes, at most 5 epochs, test accuracy well above
    chance, the .ckpt re-evaluating to the logged accuracy), then 2 epochs
    of the same fold on the card and on the CPU from one init; ``cli
    ablation --from-wav ... --weights <pretrain .ckpt> --suite standard
    --experiments full_method,no_dacp --epochs 2 --warmup-epochs 1 --snr
    10`` (bf16, attention through the kernel, resident: two rows without
    an error, 12 attention launches per extraction batch of ONE shared
    startup and per step of both experiments, each student at step 0 the
    .ckpt's, DACP off in no_dacp, device memory not growing from one
    experiment to the next); ``cli sensitivity`` on the stores over two
    values of WEIGHT_ECDA (feature mode, resident, no kernel); ``cli
    analyze`` (dacp, disagreement, bias on the full_method fold;
    distribution on the clean store); the tsne embedding pass of both
    param sets on the card against the CPU (t-SNE itself needs
    scikit-learn, which that machine lacks); log-mel of one batch, card
    against CPU. Prints pretrain s/epoch and ms/step, the ablation's
    startup seconds by stage, seconds and peak device GB per experiment,
    the attention launches, the sensitivity's seconds per point and the
    seconds per analysis. ``--only experiments`` builds attention.cu and
    runs phases 1, 2, 9, 10 and 11.
12. d2v pretraining, on phase 9's corpus and checkpoint: ``cli
    d2v-pretrain`` at the JAX defaults and full width (bf16, B 16, 10 s
    crops, clone_batch 8, span masks at 0.7, ``--init-checkpoint`` phase
    9's, resident auto) for 40 steps (warmup 10) over Sessions 1-4,
    validating every 20 steps on Session 5: rc 0, the resident corpus,
    no kernel launched by the differentiated step, a finite history
    without a collapse, the last loss under step 1's, the best state and
    both encoder exports loading. Then 3-step agreement runs over 48 clips
    from one init: two identical runs (the card's drift), resident vs
    ``--resident off``, ``--scan-chunk 2`` vs per-step, ``d2v-pack`` +
    ``--binarized`` vs the wav manifest, ``--remat`` vs none (dropout on),
    each within 4x that drift; 2 steps on the card and the CPU from one
    init and the same draws (f32, B 2, 2 s crops); the exported encoder
    extracting Session 5 through the attention kernel (12 launches a
    batch of 16) against plain attention. Prints ms a step (median and
    range of steps 5-39 less the profiled one and those followed by a
    validation or a checkpoint), student tokens/s, the derived FLOPs a step and
    their share of the bf16 peak, a torch.profiler breakdown of step 30
    with the device's busy share, peak device GB, startup (decode,
    resident commit), validation and checkpoint-write seconds.
    ``--only d2v`` builds attention.cu and runs phases 1, 2 and 12 (with
    phase 9's corpus and checkpoint, not its trainer).
13. the DAD paths over a (dp, tp) process grid, on phase 9's corpus and
    checkpoint. (a) ``cli dad --from-wav`` on every 8th clip, 2 epochs,
    once plain and once under ``torchrun --nproc_per_node 1`` with ``--dp
    1`` (a world of one over NCCL), each in a worker process of this
    script (``--worker``): the same history, best .pth and final report,
    bit for bit; ms a step (epoch 2's median, CUDA events) both ways. (b)
    two worker processes on the one card over gloo, through the library
    API: a probe of gloo's all-reduce and all-gather on CUDA f32 and bf16
    tensors, then 3 fused steps at (dp, tp) = (2, 1), extraction of a batch
    of 16 and 3 fused steps at (1, 2) (full width, bf16, attention through
    the kernel on 6 heads a rank), held to one process at the global batch
    by phase 9's kernel-vs-plain criteria, launches counted. ``--only
    parallel`` builds attention.cu, writes phase 9's corpus and runs phases
    1, 2 and 13.
14. prints the ``nvidia-smi`` line, a ``kernels`` JSON line (all four
    kernels; the conv entry sums its seven layers' numbers), then the
    result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.analysis import (
    tsne as tsne_mod,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    D2vPretrainConfig,
    EncoderConfig,
    dad_preset,
    pretrain_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    StepScalars,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad.train_step import (
    draw_feature_step,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio import (
    NOISE_FILE_MAPPING,
    cli as audio_cli,
    features as features_mod,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio.wavio import (
    read_wav,
    write_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    PaddedBatchIterator,
    corpus_fold_split,
    load_feature_store,
    prefetch,
    read_manifest,
    write_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.batching import (
    pad_to_bucket,
    paired_epoch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval import (
    accuracy,
    inference,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval.serving import (
    EmotionPredictor,
    PredictionServer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.exp import (
    ablation as ablation_mod,
    sensitivity as sensitivity_mod,
    write_noisy_manifest,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
    load_emotion2vec_checkpoint,
    load_pretrain_head_checkpoint,
    load_torch_file,
    torch_state_dict_to_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    d2v_pretrain as d2v_models,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.d2v_masking import (
    span_mask_counts,
    span_mask_uniforms,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.d2v_pretrain import (
    D2vDraws,
    conv_frames,
    init_d2v_state,
    init_ema_blocks,
    make_d2v_train_step,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.emotion2vec import (
    normalize_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
    FeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.heads import (
    SSRLState,
    init_pretrain_head,
    init_ssrl,
    load_pretrain_into_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    ConvFeatureExtractor,
    draw_keep,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
    attention,
    conv,
    cuda_build,
    fused_norm,
    norm_probe,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.utils import (
    timing,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    CleanFeatureBatch,
    FusedBatch,
    FusedConfig,
    init_fused,
    make_fused_extract_train_step,
    precompute_clean_features,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    resident as resident_mod,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.fused import (
    extract,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    CrossDomainTrainer,
    FusedCrossDomainTrainer,
    d2v_pretrain as d2v_train_mod,
    dad_trainer,
    fused_trainer,
    pretrain as pretrain_mod,
)

PORT_PKG = attention.__name__.split(".")[0]
JAX_PKG = PORT_PKG[: -len("_torch")]
SOURCES = ("attention", "fused_norm", "conv")  # csrc/<name>.cu
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain on valid rows: f32 by summation order only (as the JAX
# package's kernel test); bf16 by two bf16 ulps, since the plain version
# rounds p after normalising and the kernel before (online softmax)
ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 1.6e-2)}
# serving logits, kernel path vs plain-attention path, both bf16 end to end:
# the plain path rounds scores to bf16 (einsum output), the kernel keeps f32
LOGIT_TOL_BF16 = 0.1
# f32 encoder features, kernel path vs plain path, 12 blocks deep
FEAT_TOL_F32 = 1e-3
SAMPLE_RATE = 16000
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores: the elementwise work
# fused LN, kernel vs plain: f32 by summation order and rsqrtf; bf16 by one
# rounding of outputs up to ~4 (two bf16 ulps)
LN_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1.6e-2)}
# LN backward through the kernel's autograd Function vs autograd through the
# plain ops: both f32 inside, and the x / residual gradients are rounded to
# bf16 once
LN_GRAD_TOL = (2e-2, 1.6e-2)
# conv + LN + GELU per layer, kernel vs plain on the same input: both
# accumulate in f32, so f32 by summation order and bf16 by one rounding
CONV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}
# the whole front end through the kernel vs the port's ConvFeatureExtractor:
# the module rounds every conv output to bf16 before its f32 LN, the kernel
# does not, so bf16 differs by a few bf16 ulps compounded over 7 layers
# (outputs are GELUs of unit-variance rows, O(1)); f32 by summation order
STACK_TOL = {torch.bfloat16: 0.25, torch.float32: 1e-3}
STACK_MEAN_TOL_BF16 = 0.01
# the training slice (bench.py's configuration)
TRAIN_B, TRAIN_T, TRAIN_STEPS, COMPARE_STEPS = 64, 64000, 20, 3
# kernel path vs plain attention path after 3 steps from one state: losses
# move with the bf16 features (the plain path rounds scores to bf16); each
# Adam step moves a parameter by at most lr * (1 - b1) / sqrt(1 - b2)
# = 3.2 lr, so two paths part by at most 2 * 3.2 * lr per step
METRIC_TOL = 0.02  # |a - b| <= 0.02 (1 + |b|)
ADAM_STEP_BOUND = 3.17
# DACP thresholds/sums and certainty scores: scores move by the bf16 feature
# differences averaged over 199 frames by the pooling
DACP_TOL = 0.01
# DACP opened: the threshold is each class's low quantile of its scores, so
# rows pass the mask and the consistency and ECDA terms carry weight
DACP_OPEN = dict(quantile_start=0.0, quantile_end=0.2, threshold_smoothing_alpha=0.0)
# phase 9, kernel vs plain attention path, each extracting its own stores:
# a clip's bf16 features by the norm of their difference over the plain
# ones' norm. The plain path rounds the scores to bf16 before the softmax
# (a score near 10 moves by up to half its ulp, 0.031, so its probability
# by up to 3 %), the kernel keeps them f32; 12 blocks compound it, to a median of
# 8.5e-3 and a maximum of 1.02e-2 over the 5531 clean clips on an H100
# (this phase). In f32, where neither rounds, the two paths agree to 6e-6
# (phase 4), and a wrong tile or mask moves a clip by O(1): 2e-2 holds
# the spread with room and catches those. The trainers' epoch metrics
# relative to their size (the consistency loss is ~0.01); the student's
# 3-step update by the norm of its difference over the plain update's
# norm (Adam's update is about lr * sign(g), so it parts only where a
# gradient is near 0)
FEAT_REL_TOL_BF16 = 2e-2
TRAINER_REL_TOL = dict(atol=1e-4, rtol=0.02)
UPDATE_REL_TOL = 0.25


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def random_fairseq_state_dict(cfg: EncoderConfig, seed: int):
    """Seeded random weights in the fairseq emotion2vec key layout."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.06, offset=0.0):
        return offset + torch.randn(*shape, generator=g) * scale

    A = "modality_encoders.AUDIO."
    sd = {}
    in_c = 1
    for i, (dim, k, _s) in enumerate(cfg.conv_feature_layers):
        sd[f"{A}local_encoder.conv_layers.{i}.0.weight"] = t(dim, in_c, k, scale=0.3)
        sd[f"{A}local_encoder.conv_layers.{i}.2.1.weight"] = t(dim, offset=1.0)
        sd[f"{A}local_encoder.conv_layers.{i}.2.1.bias"] = t(dim)
        in_c = dim
    E, feat = cfg.embed_dim, cfg.conv_feature_layers[-1][0]
    sd[f"{A}project_features.1.weight"] = t(feat, offset=1.0)
    sd[f"{A}project_features.1.bias"] = t(feat)
    sd[f"{A}project_features.2.weight"] = t(E, feat, scale=feat**-0.5)
    sd[f"{A}project_features.2.bias"] = t(E)
    kpos = max(3, cfg.conv_pos_width // cfg.conv_pos_depth)
    for i in range(cfg.conv_pos_depth):
        fan_in = (E // cfg.conv_pos_groups) * kpos
        sd[f"{A}relative_positional_encoder.{i + 1}.0.weight"] = t(
            E, E // cfg.conv_pos_groups, kpos, scale=fan_in**-0.5)
        sd[f"{A}relative_positional_encoder.{i + 1}.0.bias"] = t(E)
    sd[f"{A}context_encoder.norm.weight"] = t(E, offset=1.0)
    sd[f"{A}context_encoder.norm.bias"] = t(E)
    hid = int(E * cfg.mlp_ratio)
    prefixes = [f"{A}context_encoder.blocks.{i}" for i in range(cfg.prenet_depth)]
    prefixes += [f"blocks.{i}" for i in range(cfg.depth)]
    for p in prefixes:
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = t(E, offset=1.0)
            sd[f"{p}.{n}.bias"] = t(E)
        for n, (o, i) in (("attn.qkv", (3 * E, E)), ("attn.proj", (E, E)),
                          ("mlp.fc1", (hid, E)), ("mlp.fc2", (E, hid))):
            sd[f"{p}.{n}.weight"] = t(o, i, scale=i**-0.5)
            sd[f"{p}.{n}.bias"] = t(o)
    return sd


def random_ssrl_state_dict(input_dim: int, hidden: int, classes: int, seed: int):
    """Seeded random DAD head weights in the reference SSRL layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for role in ("student", "teacher"):
        sd[f"{role}_encoder.pre_net.weight"] = torch.randn(hidden, input_dim, generator=g) * input_dim**-0.5
        sd[f"{role}_encoder.pre_net.bias"] = torch.randn(hidden, generator=g) * 0.1
        sd[f"{role}_classifier.fc_layer.weight"] = torch.randn(classes, hidden, generator=g) * hidden**-0.5
        sd[f"{role}_classifier.fc_layer.bias"] = torch.randn(classes, generator=g) * 0.1
    return sd


def attention_mask(B: int, N: int, seed: int) -> torch.Tensor:
    """(B, N) padding mask: suffix padding of random length on most rows,
    one unpadded row, one fully padded row. The lengths are drawn after
    three (B, 12, N, 64) normal draws, where this phase once drew q, k and
    v, so that the masks, and with them the work and the bounds, stay those
    of the phase's earlier versions and its numbers compare across them."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(3):
        torch.randn(B, 12, N, 64, generator=g)
    lengths = torch.randint(max(1, N // 3), N + 1, (B,), generator=g)
    lengths[0], lengths[-1] = N, 0
    return (torch.arange(N)[None, :] >= lengths[:, None]).cuda()


def attention_operands(B, H, N, D, dtype, layout: str, gen: torch.Generator) -> tuple:
    """q (pre-scaled), k, v on the card: contiguous (B, H, N, D) tensors
    ("heads"), or the encoder's (B, H, N, D) views of one (B, N, 3, H, D)
    projection output ("encoder")."""
    if layout == "heads":
        q, k, v = (device_randn((B, H, N, D), dtype, gen) for _ in range(3))
    else:
        qkv = device_randn((B, N, 3, H, D), dtype, gen)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    with torch.no_grad():
        q.mul_(D**-0.5)
    return q, k, v


def attention_bound_ms(q: torch.Tensor, mask: torch.Tensor) -> tuple:
    """Least time for this call on an H100: the larger of the bytes (q, k,
    v, out once each, plus the mask) over HBM bandwidth and the operations
    this data needs (each query row against its item's valid keys only:
    QK^T and PV, 2 FLOP per multiply-add) over the dtype's peak."""
    B, H, N, D = q.shape
    valid_keys = int((~mask).sum())
    flops = 4.0 * H * N * D * valid_keys
    nbytes = 4 * q.numel() * q.element_size() + mask.numel()
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_error(out, ref, mask, what: str) -> float:
    """Max error on items with a valid key; raises past ATTN_TOL."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"attention kernel: non-finite output ({what})")
    rows = (~mask).any(dim=1)  # items with at least one valid key
    err = (out[rows].float() - ref[rows].float()).abs()
    atol, rtol = ATTN_TOL[ref.dtype]
    if not bool((err <= atol + rtol * ref[rows].float().abs()).all()):
        raise AssertionError(f"attention kernel disagrees with plain ({what}): max err "
                             f"{float(err.max()):.3e}, tolerance {atol} + {rtol}*|ref|")
    return float(err.max())


def check_attention_kernel(N: int, dtype: torch.dtype, clocks: timing.ClockSampler,
                           B: int = 16) -> dict:
    """Kernel vs plain version at (B, 12, N, 64), then timed in turns with
    SDPA on the same inputs (a yardstick: the port never calls it), with
    every measure of phase 5, in two layouts: contiguous operands and the
    encoder's strided views (the layout of the main path, whose numbers
    the kernels line reports)."""
    t0 = time.perf_counter()
    H, D = 12, 64
    mask = attention_mask(B, N, seed=N)
    sdpa_mask = ~mask[:, None, None, :]
    gen = torch.Generator(device="cuda").manual_seed(N)
    n_sets = timing.rotation(4 * B * H * N * D * dtype.itemsize)
    r = dict(B=B, N=N, dtype=str(dtype).replace("torch.", ""), rotation=n_sets)
    for layout in ("heads", "encoder"):
        sets = [attention_operands(B, H, N, D, dtype, layout, gen) for _ in range(n_sets)]
        q, k, v = sets[0]
        out = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.flash_attention_reference(q, k, v, mask)
        err = attention_error(out, ref, mask, f"N={N}, {dtype}, {layout}")
        del out, ref
        times = in_turns(
            [lambda s=s: attention.flash_attention(*s, mask) for s in sets],
            [lambda s=s: F.scaled_dot_product_attention(*s, attn_mask=sdpa_mask, scale=1.0)
             for s in sets])
        r[layout] = dict(max_abs_err=err, **times)
        if layout == "heads":
            r["plain_ms"] = timing.call_ms(
                lambda: attention.flash_attention_reference(q, k, v, mask))
            r["bound_ms"], r["bound_by"] = attention_bound_ms(q, mask)
        del sets, q, k, v
        torch.cuda.empty_cache()
    main = r["encoder"]
    r.update(max_abs_err=main["max_abs_err"], ms=main["device_ms_cold"],
             library_ms=main["library_device_ms_cold"],
             clocks=clocks.summary(t0, time.perf_counter()))
    return r


def run_attention_phase() -> dict:
    """Phase 3: B = 16 at every frame count of the 1-30 s wav buckets (N 49,
    99, 199, 399, 799, 1499: the serving batches and the fused trainer's
    extraction passes) in bf16, the serving shapes (N 49, 399, 1499) in
    f32, and B = 64 at the fused steps' frame counts (N 199: 4 s clips, as
    bench.py's; 799 and 1499: the 16 s and 30 s buckets of phase 9)."""
    results = {}
    with timing.ClockSampler(gpu=torch.cuda.current_device()) as clocks:
        cases = [(torch.bfloat16, N, 16) for N in (49, 99, 199, 399, 799, 1499)]
        cases += [(torch.float32, N, 16) for N in (49, 399, 1499)]
        cases += [(torch.bfloat16, N, TRAIN_B) for N in (199, 799, 1499)]
        for dtype, N, B in cases:
            r = check_attention_kernel(N, dtype, clocks, B=B)
            results[(dtype, N, B)] = r
            print("kernel: " + json.dumps(r), flush=True)
    print(f"kernel: attention phase clocks {clocks.summary()}", flush=True)
    print("kernel: tensor-parallel heads " + json.dumps(check_rank_heads()), flush=True)
    return results


def check_rank_heads() -> dict:
    """The kernel against its plain version on a tensor-parallel rank's
    heads (H 6 at tp 2, H 3 at tp 4): the rank's own qkv projection
    output, whose q, k and v views have an n-stride of 3 * H * 64."""
    errs = {}
    for H in (6, 3):
        for dtype, N, B in ((torch.bfloat16, 199, TRAIN_B), (torch.bfloat16, 1499, 16),
                            (torch.float32, 399, 16)):
            gen = torch.Generator(device="cuda").manual_seed(H * N)
            mask = attention_mask(B, N, seed=N)
            q, k, v = attention_operands(B, H, N, 64, dtype, "encoder", gen)
            out = attention.flash_attention(q, k, v, mask)
            ref = attention.flash_attention_reference(q, k, v, mask)
            what = f"H={H}, N={N}, B={B}, {dtype}"
            errs[what] = attention_error(out, ref, mask, what)
    return errs


def synthetic_clip(n: int, seed: int) -> np.ndarray:
    """A voiced-like tone with vibrato plus noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SAMPLE_RATE
    f0 = 120 + 80 * rng.random()
    x = 0.4 * np.sin(2 * np.pi * f0 * t + 3 * np.sin(2 * np.pi * 5 * t))
    return np.clip(x + 0.05 * rng.standard_normal(n), -1, 1).astype(np.float32)


def post(base: str, payload: dict):
    req = urllib.request.Request(
        base + "/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.getcode(), json.loads(r.read())


def check_reply(code: int, out: dict, classes) -> None:
    if code != 200:
        raise AssertionError(f"/predict returned {code}: {out}")
    probs = np.array([out["probs"][c] for c in classes])
    if not np.isfinite(probs).all() or abs(probs.sum() - 1.0) > 1e-4:
        raise AssertionError(f"bad probabilities {out['probs']}")


# kernel-name fragments -> layer of the serving path, for the profile
KERNEL_GROUPS = (
    ("attention kernel", ("attn_fwd",)),
    ("convolution", ("fprop", "conv", "cudnn", "dgrad")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("layer norm", ("norm",)),
    ("gelu", ("gelu",)),
    ("softmax", ("softmax",)),
    ("copy / cast / transpose", ("copy", "cast", "transpose", "cat")),
)


def profile_batch(predictor, n_samples: int) -> dict:
    """torch.profiler over one batch of 16 clips filling a bucket: device
    time by layer of the path, the top kernels, and the device's busy
    share of the call's host wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    batch = [synthetic_clip(n_samples, seed=300 + i) for i in range(16)]
    predictor.predict_wavs(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_wavs(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    device_ms = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)),
                     "other elementwise")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        bucket_s=n_samples / SAMPLE_RATE, batch=16, wall_ms=wall_ms,
        device_ms=device_ms,
        device_busy_share=device_ms / wall_ms if wall_ms else None,
        by_layer_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        top_kernels_ms=[(name[:90], ms) for name, ms in top],
    )


def build_predictor(enc_cfg, enc_sd, ssrl, dad_cfg):
    extractor = FeatureExtractor(enc_cfg, enc_sd, batch_size=16, device="cuda")
    return EmotionPredictor(dad_cfg, ssrl, extractor=extractor, batch_size=16,
                            wav_transfer_dtype="int16", device="cuda")


def run_slice() -> dict:
    """Phase 4: the serving path at full width through HTTP."""
    enc_cfg = EncoderConfig(dtype="bfloat16", use_flash_attention=True)
    fairseq_sd = random_fairseq_state_dict(enc_cfg, seed=0)
    enc_sd = fairseq_to_torch_encoder(fairseq_sd, enc_cfg)
    dad_cfg = dad_preset("iemocap")
    ssrl = torch_state_dict_to_ssrl(random_ssrl_state_dict(
        dad_cfg.input_dim, dad_cfg.hidden_dim, dad_cfg.num_classes, seed=1))
    predictor = build_predictor(enc_cfg, enc_sd, ssrl, dad_cfg)
    blocks = enc_cfg.prenet_depth + enc_cfg.depth

    t0 = time.perf_counter()
    predictor.warmup()
    print(f"slice: warmup over buckets {predictor.extractor.buckets} "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)

    lengths = np.geomspace(0.5 * SAMPLE_RATE, 30 * SAMPLE_RATE, 12).astype(int)
    clips = [synthetic_clip(int(n), seed=i) for i, n in enumerate(lengths)]
    server = PredictionServer(predictor, port=0, max_wait_ms=5.0)
    server.start()
    try:
        base = f"http://{server.host}:{server.port}"
        # the same 12 clips as JSON float lists, then as base64 int16 PCM
        rounds = {
            "wav": [{"wav": np.round(c, 5).tolist(), "sr": SAMPLE_RATE} for c in clips],
            "pcm16": [{"pcm16": base64.b64encode(
                np.clip(np.rint(c * 32768.0), -32768, 32767).astype("<i2").tobytes()
            ).decode(), "sr": SAMPLE_RATE} for c in clips],
        }
        wall = {}
        attention.flash_attention.launches = 0
        for kind, bodies in rounds.items():
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
                replies = list(pool.map(lambda b: post(base, b), bodies))
            wall[kind] = time.perf_counter() - t0
            for code, out in replies:
                check_reply(code, out, predictor.class_names)
        launches = attention.flash_attention.launches
        wav_batches = predictor.batches_run
        if launches == 0 or launches != blocks * wav_batches:
            raise AssertionError(
                f"attention kernel launches {launches} != {blocks} x "
                f"{wav_batches} wav batches"
            )
        feat_clip = np.random.default_rng(7).standard_normal(
            (150, dad_cfg.input_dim)).astype(np.float32)
        check_reply(*post(base, {"features": feat_clip.tolist()}),
                    predictor.class_names)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        n_requests = sum(len(b) for b in rounds.values())
        if health["status"] != "ok" or health["requests_served"] != n_requests + 1:
            raise AssertionError(f"bad /healthz {health}")
    finally:
        server.shutdown()
    for kind, seconds in wall.items():
        print(f"slice: 12 concurrent '{kind}' requests (0.5-30 s clips) in "
              f"{seconds:.3f} s: {12 / seconds:.2f} requests/s", flush=True)
    print(f"slice: {wav_batches} wav batches, {launches} attention kernel "
          f"launches ({blocks} per batch); /healthz {health}", flush=True)

    # per-bucket latency of a full batch (16 clips filling the bucket),
    # median of 3 after one untimed call
    bucket_ms = {}
    for n in predictor.extractor.buckets:
        batch = [synthetic_clip(n, seed=100 + i) for i in range(16)]
        predictor.predict_wavs(batch)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            predictor.predict_wavs(batch)
            times.append((time.perf_counter() - t0) * 1e3)
        bucket_ms[n] = float(np.median(times))
    print("slice: batch-of-16 latency per bucket (ms): "
          + json.dumps({f"{n / SAMPLE_RATE:g}s": round(v, 3) for n, v in bucket_ms.items()}),
          flush=True)
    for n in (predictor.extractor.buckets[0], predictor.extractor.buckets[-1]):
        print("profile: " + json.dumps(profile_batch(predictor, n)), flush=True)

    # the same batch through the plain attention path: logits must agree
    plain = build_predictor(
        EncoderConfig(dtype="bfloat16", use_flash_attention=False),
        enc_sd, ssrl, dad_cfg)
    pcm = [np.clip(np.rint(c * 32768.0), -32768, 32767).astype(np.int16) for c in clips]
    wav = np.zeros((16, 480000), np.int16)
    mask = np.ones((16, 480000), bool)
    for i, c in enumerate(pcm):
        wav[i, : len(c)] = c
        mask[i, : len(c)] = False
    wav_t, mask_t = torch.from_numpy(wav).cuda(), torch.from_numpy(mask).cuda()
    logits_k = predictor._wav_eval(wav_t, mask_t)[: len(pcm)].float()
    logits_p = plain._wav_eval(wav_t, mask_t)[: len(pcm)].float()
    logit_err = float((logits_k - logits_p).abs().max())
    if not torch.isfinite(logits_k).all() or logit_err > LOGIT_TOL_BF16:
        raise AssertionError(f"bf16 logits: kernel vs plain path differ by {logit_err}")
    print(f"slice: bf16 logits, kernel vs plain attention path: max |diff| "
          f"{logit_err:.4f} (tolerance {LOGIT_TOL_BF16})", flush=True)
    del plain

    # f32: the same encoder, kernel path vs plain path, on 4 clips of 2-8 s
    feats = {}
    for flash in (True, False):
        ext = FeatureExtractor(EncoderConfig(dtype="float32", use_flash_attention=flash),
                               enc_sd, batch_size=4, device="cuda")
        feats[flash] = ext.extract_clips(
            [synthetic_clip(n, seed=200 + n) for n in (32000, 64000, 96000, 128000)])
        del ext
    f32_err = max(float(np.abs(a - b).max()) for a, b in zip(feats[True], feats[False]))
    if f32_err > FEAT_TOL_F32:
        raise AssertionError(f"f32 features: kernel vs plain path differ by {f32_err}")
    print(f"slice: f32 features, kernel vs plain attention path: max |diff| "
          f"{f32_err:.2e} (tolerance {FEAT_TOL_F32})", flush=True)
    return dict(launches=launches, wav_batches=wav_batches, enc_sd=enc_sd)


def bound(nbytes: float, ops: float, peak: float) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes over HBM
    bandwidth and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: tuple, what: str) -> float:
    """Max |out - ref|; raises unless |out - ref| <= atol + rtol * |ref|
    everywhere and out is finite."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (out - ref).abs()
    atol, rtol = tol
    if not bool((err <= atol + rtol * ref.abs()).all()):
        raise AssertionError(f"{what}: kernel disagrees with plain: max err "
                             f"{float(err.max()):.3e}, tolerance {atol} + {rtol}*|ref|")
    return float(err.max())


# the measures of phase 5, each taken for the kernel and its PyTorch call in
# turns (kernel, library, library, kernel): device ms with cold L2 (inputs
# rotated, the number held to the HBM bound), device ms with warm L2, call ms
# (events around eager calls, host launch cost included) and host µs per call
MEASURES = ("device_ms_cold", "device_ms_warm", "call_ms", "host_us")


def measure(calls, what: str, launches: int = 20) -> float:
    if what == "device_ms_cold":
        return timing.device_ms(calls, cold=True, launches=launches)
    if what == "device_ms_warm":
        return timing.device_ms(calls[:1], cold=False, launches=launches)
    if what == "call_ms":
        return timing.call_ms(calls[0])
    return timing.host_us(calls[0])


def in_turns(kernel_calls, library_calls, launches: int = 20) -> dict:
    """Every measure of the kernel and of the library call, in the order
    kernel, library, library, kernel: the mean of each pair, and the four.
    ``launches``: calls captured in one CUDA graph for the device ms."""
    out = {}
    for what in MEASURES:
        k1, l1 = measure(kernel_calls, what, launches), measure(library_calls, what, launches)
        l2, k2 = measure(library_calls, what, launches), measure(kernel_calls, what, launches)
        out[what], out[f"library_{what}"] = (k1 + k2) / 2, (l1 + l2) / 2
        out[f"{what}_turns"] = [k1, l1, l2, k2]
    return out


def device_randn(shape, dtype, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def ln_case(name: str, shape, dtype, residual: bool, gelu: bool, seed: int,
            clocks: timing.ClockSampler) -> dict:
    """One fused_layernorm variant (always affine, as the encoder's LNs)
    against its plain version, then timed beside F.layer_norm (+ add, +
    GELU) on a rotation of input sets."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    C, numel = shape[-1], math.prod(shape)
    set_bytes = (2 + residual) * numel * dtype.itemsize
    sets = [(device_randn(shape, dtype, gen),
             device_randn(shape, dtype, gen) if residual else None)
            for _ in range(timing.rotation(set_bytes))]
    scale = device_randn((C,), torch.float32, gen) * 0.5 + 1
    bias = device_randn((C,), torch.float32, gen) * 0.1
    act = "gelu_tanh" if gelu else None
    x, res = sets[0]
    with torch.no_grad():
        out = fused_norm.fused_layernorm(x, scale, bias, residual=res, activation=act)
        torch.cuda.synchronize()
        ref = fused_norm.fused_layernorm_reference(x, scale, bias, res, act)
    err = max_err(out, ref, LN_TOL[dtype], f"fused_layernorm {name} {dtype}")
    del out, ref
    sc, bi = scale.to(dtype), bias.to(dtype)

    def kernel(x, res):
        return lambda: fused_norm.fused_layernorm(x, scale, bias, residual=res, activation=act)

    def library(x, res):
        def fn():
            y = F.layer_norm(x if res is None else x + res, (C,), sc, bi, 1e-6)
            return F.gelu(y, approximate="tanh") if gelu else y
        return fn

    # f32 operations per element: 3 for the sums, 2 to normalise, 2 affine,
    # 1 residual add, 9 tanh-GELU
    b, by = bound(set_bytes + 2 * C * 4, numel * (7 + residual + 9 * gelu), F32_OPS_PER_S)
    with torch.no_grad():
        times = in_turns([kernel(*s) for s in sets], [library(*s) for s in sets])
        plain = timing.call_ms(lambda: fused_norm.fused_layernorm_reference(x, scale, bias,
                                                                            res, act))
    return dict(kernel="fused_layernorm", case=name, shape=list(shape),
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                ms=times["device_ms_cold"], library_ms=times["library_device_ms_cold"],
                plain_ms=plain, bound_ms=b, bound_by=by, rotation=len(sets), **times,
                clocks=clocks.summary(t0, time.perf_counter()))


def check_ln_backward() -> float:
    """The autograd Function's backward (after the kernel's forward) against
    autograd through the plain ops, at the block norm shape, bf16 + residual."""
    g = torch.Generator().manual_seed(7)
    shape = (TRAIN_B, 199, 768)
    base = [torch.randn(*shape, generator=g).to("cuda", torch.bfloat16),
            torch.randn(*shape, generator=g).to("cuda", torch.bfloat16),
            (torch.randn(768, generator=g) * 0.5 + 1).cuda(),
            (torch.randn(768, generator=g) * 0.1).cuda()]
    upstream = torch.randn(*shape, generator=g).cuda()
    grads = []
    for fn in (fused_norm.fused_layernorm, fused_norm.fused_layernorm_reference):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out = fn(leaves[0], leaves[2], leaves[3], leaves[1], "gelu_tanh")
        (out.float() * upstream).sum().backward()
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    return max(max_err(a, b, LN_GRAD_TOL, f"fused_layernorm backward ({name})")
               for a, b, name in zip(grads[0], grads[1], ("x", "residual", "scale", "bias")))


def copy_case(dtype, clocks: timing.ClockSampler) -> dict:
    """copy_rows at the probe's shape: bit-exact, then timed beside
    Tensor.copy_ into a preallocated output on a rotation of buffers."""
    t0 = time.perf_counter()
    shape = (TRAIN_B * 3199, 512)
    gen = torch.Generator(device="cuda").manual_seed(8)
    nbytes = math.prod(shape) * dtype.itemsize
    srcs = [device_randn(shape, dtype, gen) for _ in range(timing.rotation(2 * nbytes))]
    dsts = [torch.empty_like(s) for s in srcs]
    out = fused_norm.copy_rows(srcs[0])
    torch.cuda.synchronize()
    if not torch.equal(out, srcs[0]):
        raise AssertionError(f"copy kernel: the copy differs from its source ({dtype})")
    del out
    b, by = bound(2 * nbytes, 0, F32_OPS_PER_S)
    times = in_turns([lambda s=s: fused_norm.copy_rows(s) for s in srcs],
                     [lambda s=s, d=d: d.copy_(s) for s, d in zip(srcs, dsts)])
    return dict(kernel="copy_rows", shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                max_abs_err=0.0, ms=times["device_ms_cold"],
                library_ms=times["library_device_ms_cold"],
                plain_ms=timing.call_ms(srcs[0].clone), bound_ms=b, bound_by=by,
                rotation=len(srcs), **times, clocks=clocks.summary(t0, time.perf_counter()))


def run_norm_phase() -> dict:
    """Phase 5: fused LN and copy vs plain and timed beside their PyTorch
    calls, with the card's clocks sampled; then the probe as their path."""
    rows = {}
    shapes = {"res_ln": (TRAIN_B, 199, 768), "ln": (TRAIN_B, 199, 768),
              "ln_gelu": (TRAIN_B, 3199, 512)}
    with timing.ClockSampler(gpu=torch.cuda.current_device()) as clocks:
        for dtype in (torch.bfloat16, torch.float32):
            for i, (name, shape) in enumerate(shapes.items()):
                r = ln_case(name, shape, dtype, residual=name == "res_ln",
                            gelu=name == "ln_gelu", seed=10 + i, clocks=clocks)
                rows[(name, dtype)] = r
                print("kernel: " + json.dumps(r), flush=True)
        grad_err = check_ln_backward()
        print(f"kernel: fused_layernorm backward (bf16, residual, gelu_tanh) vs autograd "
              f"through the plain ops: max |diff| {grad_err:.3e} (tolerance {LN_GRAD_TOL})",
              flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            rows[("copy", dtype)] = copy_case(dtype, clocks)
            print("kernel: " + json.dumps(rows[("copy", dtype)]), flush=True)
        torch.cuda.empty_cache()

        fused_norm.fused_layernorm.launches = fused_norm.copy_rows.launches = 0
        probe = norm_probe.run_probe("cuda", iters=20)
        launches = dict(fused_layernorm=fused_norm.fused_layernorm.launches,
                        copy_rows=fused_norm.copy_rows.launches)
    for row in probe:
        print("probe: " + json.dumps(row), flush=True)
    if not all(launches.values()):
        raise AssertionError(f"the probe did not launch every kernel of its path: {launches}")
    print(f"probe: launches {launches}; clocks over the phase {clocks.summary()}", flush=True)
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches)


def conv_bound(x, w, t_out: int) -> tuple:
    """x and w read once, the output written once; the conv's multiply-adds
    (2 k C_in C_out per output row) at the input type's peak."""
    B, _L, c_in = x.shape
    k, _, c_out = w.shape
    nbytes = (x.numel() + w.numel() + B * t_out * c_out) * x.element_size() + 2 * c_out * 4
    return bound(nbytes, 2.0 * B * t_out * c_out * k * c_in, PEAK_FLOPS[x.dtype])


# graph launches for a conv layer's device ms: a cold graph keeps every
# output (up to 839 MB at layer 0), so fewer than the default 20
CONV_LAUNCHES = 8


def rotated_inputs(x: torch.Tensor, set_bytes: int) -> list:
    """x and as many copies rolled along the batch as one cold rotation
    needs (``timing.rotation``)."""
    return [x] + [x.roll(n, dims=0) for n in range(1, timing.rotation(set_bytes))]


def conv_case(i: int, x, w, scale, bias, k, s, approx: bool,
              clocks: timing.ClockSampler) -> tuple:
    """Layer i: kernel vs plain on the same input, then the kernel timed in
    turns with F.conv1d + F.layer_norm + F.gelu (every measure of phase 5)
    on a rotation of inputs; returns (numbers, the plain output)."""
    t0 = time.perf_counter()
    B, L, c_in = x.shape
    c_out = w.shape[2]
    path = conv.conv_plan(B, L, c_in, c_out, k, s, x.dtype).path
    with torch.no_grad():
        out = conv.fused_conv_ln_gelu(x, w, scale, bias, k, s, approx_gelu=approx)
        torch.cuda.synchronize()
        ref = conv.fused_conv_ln_gelu_reference(x, w, scale, bias, k, s, approx)
        err = max_err(out, ref, CONV_TOL[x.dtype], f"conv layer {i} ({x.dtype}, "
                      f"{'tanh' if approx else 'erf'})")
        del out
        t_out = ref.shape[1]
        sets = rotated_inputs(x, (x.numel() + B * t_out * c_out) * x.element_size())
        n_sets = len(sets)
        wt, sc, bi = w.permute(2, 1, 0).contiguous(), scale.to(x.dtype), bias.to(x.dtype)

        def library(xs):
            y = F.conv1d(xs.transpose(1, 2), wt, stride=s).transpose(1, 2)
            y = F.layer_norm(y, (c_out,), sc, bi, 1e-5)
            return F.gelu(y, approximate="tanh" if approx else "none")

        times = in_turns(
            [lambda xs=xs: conv.fused_conv_ln_gelu(xs, w, scale, bias, k, s, approx_gelu=approx)
             for xs in sets],
            [lambda xs=xs: library(xs) for xs in sets], launches=CONV_LAUNCHES)
        plain = timing.call_ms(lambda: conv.fused_conv_ln_gelu_reference(
            x, w, scale, bias, k, s, approx), iters=3, warmup=1)
        del sets
    b, by = conv_bound(x, w, t_out)
    r = dict(kernel="fused_conv_ln_gelu", layer=i, gelu="tanh" if approx else "erf",
             x=list(x.shape), k=k, s=s, dtype=str(x.dtype).replace("torch.", ""), path=path,
             max_abs_err=err, ms=times["device_ms_cold"],
             library_ms=times["library_device_ms_cold"], plain_ms=plain, bound_ms=b,
             bound_by=by, share_of_bound=b / times["device_ms_cold"], rotation=n_sets,
             **times, clocks=clocks.summary(t0, time.perf_counter()))
    torch.cuda.empty_cache()
    return r, ref


def run_conv_phase(enc_sd, wav: torch.Tensor, wav_mask: torch.Tensor) -> dict:
    """Phase 6: each conv layer vs plain and timed in turns with its PyTorch
    call, then the front end through the kernel (its path) vs the port's
    ConvFeatureExtractor."""
    layers = EncoderConfig().conv_feature_layers
    front = conv_front_params(enc_sd)
    x0 = normalize_wav(wav, wav_mask)[:, :, None]
    rows = []
    x = x0.to(torch.bfloat16)
    with timing.ClockSampler(gpu=torch.cuda.current_device()) as clocks:
        for i, (_dim, k, s) in enumerate(layers):
            w, scale, bias = conv.conv_layer_params(front, i, torch.bfloat16)
            for approx in ((False,) if i == 0 else (False, True)):
                r, ref = conv_case(i, x, w, scale, bias, k, s, approx, clocks)
                rows.append(r)
                print("kernel: " + json.dumps(r), flush=True)
                if not approx:
                    nxt = ref
            x = nxt
            del ref
    print(f"kernel: conv phase clocks {clocks.summary()}", flush=True)

    stack = {}
    for dtype, n in ((torch.bfloat16, TRAIN_B), (torch.float32, 16)):
        module = ConvFeatureExtractor(layers, dtype=dtype).cuda()
        module.load_state_dict(front)
        xin = x0[:n].to(dtype)
        w0, scale0, bias0 = conv.conv_layer_params(front, 0, dtype)
        with torch.no_grad():
            conv.fused_conv_ln_gelu.launches = 0
            out = conv.pallas_conv_stack(
                conv.fused_conv_ln_gelu(xin, w0, scale0, bias0, layers[0][1], layers[0][2]),
                front, layers)
            torch.cuda.synchronize()
            launches = conv.fused_conv_ln_gelu.launches
            ref = module(xin[:, :, 0])
        if launches != len(layers):
            raise AssertionError(f"front end through the kernel: {launches} launches, "
                                 f"expected {len(layers)}")
        diff = (out.float() - ref.float()).abs()
        mean = float(diff.mean())
        if (not torch.isfinite(out).all() or float(diff.max()) > STACK_TOL[dtype]
                or (dtype == torch.bfloat16 and mean > STACK_MEAN_TOL_BF16)):
            raise AssertionError(f"front end through the kernel vs ConvFeatureExtractor "
                                 f"({dtype}): max |diff| {float(diff.max()):.3e}, "
                                 f"mean {mean:.3e}")
        stack[str(dtype).replace("torch.", "")] = dict(
            launches=launches, max_abs_diff=float(diff.max()), mean_abs_diff=mean,
            shape=list(out.shape))
        del module, out, ref, diff
    print("conv: front end through the kernel vs ConvFeatureExtractor: "
          + json.dumps(stack) + f" (tolerance {STACK_TOL}, bf16 mean {STACK_MEAN_TOL_BF16})",
          flush=True)
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=stack["bfloat16"]["launches"])


def conv_front_params(enc_sd) -> dict:
    """The encoder's ConvFeatureExtractor state dict, on the card."""
    return {k[len("local_encoder."):]: v.cuda() for k, v in enc_sd.items()
            if k.startswith("local_encoder.")}


def run_conv_grid(enc_sd, wav: torch.Tensor, wav_mask: torch.Tensor) -> list:
    """The tensor-core path at each of layers 1-6 (erf GELU) with a block
    per tile against its grid of a block per SM walking the tiles: device
    ms cold, in turns (tiles, SMs, SMs, tiles), on each layer's input from
    the kernel's own front end."""
    layers = EncoderConfig().conv_feature_layers
    front = conv_front_params(enc_sd)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = normalize_wav(wav, wav_mask)[:, :, None].to(torch.bfloat16)
    rows = []
    with torch.no_grad():
        for i, (_dim, k, s) in enumerate(layers):
            w, scale, bias = conv.conv_layer_params(front, i, torch.bfloat16)
            B, L, c_in = x.shape
            plans = [conv.conv_plan(B, L, c_in, w.shape[2], k, s, x.dtype, sms=n)
                     for n in (10**6, sms)]
            if plans[0].path == "tc":
                out_bytes = B * plans[0].t_out * w.shape[2] * x.element_size()
                sets = rotated_inputs(x, x.numel() * x.element_size() + out_bytes)
                calls = [[lambda xs=xs, p=p: conv.launch_plan(xs, w, scale, bias, k, s, False, p)
                          for xs in sets] for p in plans]
                turns = [timing.device_ms(calls[n], cold=True, launches=CONV_LAUNCHES)
                         for n in (0, 1, 1, 0)]
                rows.append(dict(layer=i, tiles=plans[0].grid, blocks=plans[1].grid,
                                 tiles_device_ms_cold=(turns[0] + turns[3]) / 2,
                                 device_ms_cold=(turns[1] + turns[2]) / 2, turns=turns))
                print("conv grid: " + json.dumps(rows[-1]), flush=True)
                del sets, calls
            x = conv.fused_conv_ln_gelu(x, w, scale, bias, k, s)
    torch.cuda.empty_cache()
    return rows


def training_batches():
    """bench.py's batches, N(0, 0.1) wavs of 4 s: a labelled clean stream,
    an unlabelled noisy stream whose last row is a filler row."""
    rng = np.random.default_rng(0)
    B, T = TRAIN_B, TRAIN_T

    def wav():
        return torch.from_numpy((rng.normal(size=(B, T)) * 0.1).astype(np.float32)).cuda()

    clean = FusedBatch(wav=wav(), wav_mask=torch.zeros(B, T, dtype=torch.bool, device="cuda"),
                       labels=torch.from_numpy(rng.integers(0, 4, B)).cuda(),
                       row_valid=torch.ones(B, dtype=torch.bool, device="cuda"))
    noisy_wav, noisy_mask = wav(), torch.zeros(B, T, dtype=torch.bool, device="cuda")
    noisy_wav[-1] = 0.0
    noisy_mask[-1] = True
    row_valid = torch.ones(B, dtype=torch.bool, device="cuda")
    row_valid[-1] = False
    noisy = FusedBatch(wav=noisy_wav, wav_mask=noisy_mask,
                       labels=torch.full((B,), -1, device="cuda"), row_valid=row_valid)
    return clean, noisy


# kernel-name fragments -> layer of the training step, for the profile
STEP_GROUPS = (
    ("attention kernel", ("attn_fwd",)),
    ("convolution", ("fprop", "conv", "cudnn", "dgrad", "wgrad")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("layer norm", ("norm",)),
    ("gelu", ("gelu",)),
    ("softmax", ("softmax",)),
    ("random draws", ("philox", "normal", "uniform", "random")),
    ("reductions", ("reduce",)),
    ("copy / cast / transpose", ("copy", "cast", "transpose", "cat")),
)


def profile_step(fn) -> dict:
    """torch.profiler over one call: device time by group, top kernels, the
    launch count and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
            launches += ev.count
    device_ms = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in STEP_GROUPS if any(k in low for k in keys)),
                     "other elementwise")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_kernels=launches,
                device_busy_share=device_ms / wall_ms if wall_ms else None,
                by_group_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                top_kernels_ms=[(name[:90], ms) for name, ms in top])


def compare_paths(ends, lr: float) -> dict:
    """Checks two (state, metrics) ends of the same steps, kernel path
    first: metrics, student, DACP state and the tracked certainty scores
    within their tolerances, the filler row's score exactly equal."""
    (sk, mk), (sp, mp) = ends
    out = dict(metrics={k: [float(mk[k]), float(mp[k])] for k in mk if k != "tracking"})
    errors = []
    for k, (a, b) in out["metrics"].items():
        if abs(a - b) > METRIC_TOL * (1 + abs(b)):
            errors.append(f"{k}: {a} vs {b}")
    student = max(float((sk.ssrl.student[k] - sp.ssrl.student[k]).abs().max())
                  for k in sk.ssrl.student)
    student_tol = COMPARE_STEPS * 2 * ADAM_STEP_BOUND * lr
    if student > student_tol:
        errors.append(f"student max |diff| {student:.3e} > {student_tol:.3e}")
    dacp = max(float((getattr(sk.dacp, f) - getattr(sp.dacp, f)).abs().max())
               for f in sk.dacp._fields)
    if dacp > DACP_TOL:
        errors.append(f"DACP state max |diff| {dacp:.3e} > {DACP_TOL}")
    sc_k, sc_p = mk["tracking"]["certainty_score"], mp["tracking"]["certainty_score"]
    valid = sc_k.new_ones(sc_k.shape, dtype=torch.bool)
    valid[-1] = False
    scores = float((sc_k - sc_p).abs()[valid].max())
    if scores > DACP_TOL:
        errors.append(f"certainty scores max |diff| {scores:.3e} > {DACP_TOL}")
    if float(sc_k[-1]) != float(sc_p[-1]):
        errors.append(f"filler row score {float(sc_k[-1])} vs {float(sc_p[-1])}")
    if errors:
        raise AssertionError("kernel vs plain attention path: " + "; ".join(errors))
    out.update(student_max_diff=student, student_tol=student_tol, dacp_max_diff=dacp,
               score_max_diff=scores, filler_score=float(sc_k[-1]))
    return out


def run_training_slice(enc_sd, clean: FusedBatch, noisy: FusedBatch) -> dict:
    """Phase 7: the fused extract+train step at bench.py's configuration."""
    dad_cfg = dad_preset("iemocap", batch_size=TRAIN_B, warmup_epochs=1, ecda_start_epoch=1,
                         epochs=500)

    def cfg_for(flash: bool) -> FusedConfig:
        enc_cfg = EncoderConfig(dtype="bfloat16", gelu_approximate=True,
                                use_flash_attention=flash)
        return FusedConfig(encoder=enc_cfg, dad=dad_cfg, inject_snr_db=10.0,
                           cache_clean_features=True)

    cfg = cfg_for(True)
    encoder, head, tx, state0 = init_fused(cfg, enc_sd, torch.Generator().manual_seed(1),
                                           device="cuda")
    step = make_fused_extract_train_step(encoder, head, tx, cfg)
    scalars = StepScalars.for_epoch(dad_cfg, 40)
    anchors = torch.zeros(4, device="cuda")
    blocks = cfg.encoder.prenet_depth + cfg.encoder.depth

    attention.flash_attention.launches = 0
    t0 = time.perf_counter()
    clean_f = precompute_clean_features(encoder, cfg, clean)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, history, times = state0, [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, clean_f, noisy, scalars, anchors, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append(metrics)
    launches = attention.flash_attention.launches
    if launches != blocks * (1 + TRAIN_STEPS):
        raise AssertionError(f"attention launches {launches} != {blocks} x (1 clean "
                             f"precompute + {TRAIN_STEPS} noisy extractions)")
    losses = torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in history]).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training metrics: {losses}")
    for role in ("student", "teacher"):
        before, after = getattr(state0.ssrl, role), getattr(state.ssrl, role)
        moved = max(float((after[k] - before[k]).abs().max()) for k in before)
        if not moved > 0:
            raise AssertionError(f"the {role} did not move in {TRAIN_STEPS} post-warmup steps")
    ms_step = float(np.median(times[2:]))
    print(f"train: clean precompute {precompute_s * 1e3:.1f} ms; {TRAIN_STEPS} steps, "
          f"median {ms_step:.2f} ms/step (first {times[0]:.1f} ms), "
          f"{2 * TRAIN_B * 1e3 / ms_step:.1f} training clips/s (2 x {TRAIN_B} per step); "
          f"attention launches {launches} ({blocks} per extraction)", flush=True)
    print("train: metrics of the last step " + json.dumps(
        {k: float(v) for k, v in history[-1].items()}), flush=True)
    print("profile: train step " + json.dumps(profile_step(
        lambda: step(state, clean_f, noisy, scalars, anchors, gen))), flush=True)

    # 3 steps through the kernel and through the plain attention path, from
    # the same state with the same generator seed: at bench.py's DACP
    # settings, and with DACP opened so that the noisy stream reaches the
    # loss through the consistency and ECDA terms
    plain_cfg = cfg_for(False)
    plain_encoder, _, _, _ = init_fused(plain_cfg, enc_sd, device="cuda")
    tracked = noisy._replace(ids=torch.arange(TRAIN_B, device="cuda"))
    for label, dad in (("bench DACP", dad_cfg),
                       ("DACP open", dataclasses.replace(dad_cfg, dacp=dataclasses.replace(
                           dad_cfg.dacp, **DACP_OPEN)))):
        ends = []
        for enc, c in ((encoder, cfg), (plain_encoder, plain_cfg)):
            fn = make_fused_extract_train_step(enc, head, tx, dataclasses.replace(c, dad=dad))
            g, s = torch.Generator(device="cuda").manual_seed(123), state
            for _ in range(COMPARE_STEPS):
                s, m = fn(s, clean_f, tracked, scalars, anchors, g)
            ends.append((s, m))
        report = compare_paths(ends, float(state.opt_state.learning_rate))
        losses = report["metrics"]
        if dad is not dad_cfg and not (losses["consistency_loss"][0] > 0
                                       and losses["ecda_loss"][0] > 0):
            raise AssertionError(f"DACP open: the consistency and ECDA terms stayed 0: {losses}")
        print(f"train: kernel vs plain attention path, {label}, {COMPARE_STEPS} steps from one "
              f"state and seed, filler row in the noisy batch: " + json.dumps(report),
              flush=True)

    # the filler row: the kernel writes 0 where the plain path averages v;
    # its features differ, and nothing downstream reads them
    with torch.no_grad():
        fk, fmask = extract(encoder, cfg, noisy.wav, noisy.wav_mask)
        fp, _ = extract(plain_encoder, plain_cfg, noisy.wav, noisy.wav_mask)
    valid = ~fmask
    filler = dict(
        valid_rows_max_diff=float((fk - fp).abs()[valid].max()),
        filler_row_max_diff=float((fk[-1] - fp[-1]).abs().max()),
        filler_row_finite=bool(torch.isfinite(fk[-1]).all()),
    )
    if not filler["filler_row_finite"]:
        raise AssertionError("the filler row's features are not finite on the kernel path")
    print("train: noisy features, kernel vs plain attention path: " + json.dumps(filler),
          flush=True)
    del plain_encoder
    return dict(launches=launches, ms_step=ms_step)


# the feature-level trainer (phase 8): the 4-class IEMOCAP clip count
# (ang 1103, hap + exc 1636, neu 1708, sad 1084), 768-d features with a
# class-dependent mean, lognormal lengths of 50-1000 frames (1-20 s at 50
# frames/s, mean ~225), and a noisy twin of each clip
FEATURE_CLASSES = {"ang": 1103, "hap": 1636, "neu": 1708, "sad": 1084}
FEATURE_DIM, FEATURE_FRAMES, FEATURE_NOISE_STD = 768, (50, 1000), 0.5
FEATURE_EPOCHS, FEATURE_CHUNK, CARD_CPU_STEPS = 3, 4, 3
# card vs CPU over the trainer's first steps and --scan-chunk vs per-step:
# tests/test_torch_train_step.py's METRIC_TOL / STATE_TOL
TRAINER_METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
TRAINER_STATE_TOL = dict(atol=2e-6, rtol=1e-4)


def write_feature_corpus(root: str, seed: int) -> tuple:
    """A clean and a noisy IEMOCAP-layout feature store (Ses01-Ses05) in
    ``root`` through the port's ``write_feature_store``; returns their
    directories and the corpus's sizes."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(list(FEATURE_CLASSES), list(FEATURE_CLASSES.values()))
    rng.shuffle(labels)
    n = len(labels)
    lengths = np.clip(rng.lognormal(np.log(200.0), 0.5, n), *FEATURE_FRAMES).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    names = [f"Ses0{i % 5 + 1}{'FM'[i // 5 % 2]}_impro0{i % 7}_{'FM'[i // 5 % 2]}{i:04d}"
             for i in range(n)]
    class_ids = np.searchsorted(list(FEATURE_CLASSES), labels)  # names are sorted
    means = rng.standard_normal((len(FEATURE_CLASSES), FEATURE_DIM), dtype=np.float32) * 0.5
    clean = rng.standard_normal((int(lengths.sum()), FEATURE_DIM), dtype=np.float32)
    for o, t, c in zip(offsets, lengths, class_ids):
        clean[o:o + t] += means[c]
    noisy = rng.standard_normal(clean.shape, dtype=np.float32)
    noisy *= FEATURE_NOISE_STD
    noisy += clean
    dirs = (f"{root}/clean", f"{root}/root1-white-10db")
    for d, flat in zip(dirs, (clean, noisy)):
        write_feature_store(d, [flat[o:o + t] for o, t in zip(offsets, lengths)],
                            labels=labels.tolist(), utt_names=names)
    return dirs, dict(clips=n, frames=int(lengths.sum()), mean_frames=float(lengths.mean()),
                      max_frames=int(lengths.max()), store_gb=clean.nbytes / 1e9)


def batch_bytes(args) -> tuple:
    """(f32 bytes, other bytes) of a streamed step's two batches."""
    leaves = [x for b in args[1:3] for x in b if isinstance(x, torch.Tensor)]
    f32 = sum(x.nbytes for x in leaves if x.dtype == torch.float32)
    return f32, sum(x.nbytes for x in leaves) - f32


def index_bytes(args) -> tuple:
    """(0, bytes) of a resident step's two index vectors, its only upload."""
    return 0, args[3].nbytes + args[4].nbytes


class TrainerProbe:
    """Measures a trainer from outside while ``cli.main`` drives it: a CUDA
    event recorded before every training step (on the stream, so the
    spacing of two is the device's time per step, idle gaps included), the
    bytes the step was shipped (the streamed step's batches, f32 leaves and
    the rest; the resident step's index vectors), and host clocks around
    ``train_epoch`` and ``validate``, each of which ends in a host read of
    device values. ``makers`` names the step factories of ``module`` to
    wrap, each with the function that counts its step's bytes. Keeps the
    trainers it saw. The patches are undone on exit."""

    def __init__(self, module=dad_trainer, cls=None, makers=None):
        self.module = module
        self.cls = cls or dad_trainer.CrossDomainTrainer
        self.makers = makers or {"make_dad_train_step": batch_bytes,
                                 "make_resident_dad_step": index_bytes}
        self.events, self.epochs, self.validations, self.trainers = [], [], [], []
        self.step_bytes = []

    def _wrap_maker(self, make, count):
        probe = self

        def wrapped(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(*a, **kw):
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                probe.events.append(event)
                probe.step_bytes.append(count(a))
                return step(*a, **kw)

            return timed

        return wrapped

    def __enter__(self) -> "TrainerProbe":
        cls, probe = self.cls, self
        self._saved_makers = {n: getattr(self.module, n) for n in self.makers}
        self._saved_cls = {n: cls.__dict__.get(n) for n in ("__init__", "train_epoch", "validate")}
        init, train_epoch, validate = cls.__init__, cls.train_epoch, cls.validate

        def probed_init(obj, *args, **kwargs):
            init(obj, *args, **kwargs)
            probe.trainers.append(obj)

        def probed_train_epoch(obj, epoch):
            first, t0 = len(probe.events), time.perf_counter()
            out = train_epoch(obj, epoch)
            probe.epochs.append(dict(epoch=epoch, seconds=time.perf_counter() - t0,
                                     first=first, last=len(probe.events)))
            return out

        def probed_validate(obj, it, domain, epoch=0):
            t0 = time.perf_counter()
            out = validate(obj, it, domain, epoch)
            probe.validations.append(dict(epoch=epoch, domain=domain,
                                          seconds=time.perf_counter() - t0))
            return out

        for n, count in self.makers.items():
            setattr(self.module, n, self._wrap_maker(self._saved_makers[n], count))
        cls.__init__, cls.train_epoch, cls.validate = (probed_init, probed_train_epoch,
                                                       probed_validate)
        return self

    def __exit__(self, *exc) -> None:
        for n, f in self._saved_makers.items():
            setattr(self.module, n, f)
        for n, f in self._saved_cls.items():
            if f is None:
                delattr(self.cls, n)
            else:
                setattr(self.cls, n, f)

    def step_ms(self, epoch: int) -> list:
        rec = next(e for e in self.epochs if e["epoch"] == epoch)
        ev = self.events[rec["first"]:rec["last"]]
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]

    def h2d_mb_per_step(self, epoch: int) -> dict:
        """Host-to-device MB per step of ``epoch``: the batches as shipped
        in float32, and with float32 leaves shipped as bfloat16."""
        rec = next(e for e in self.epochs if e["epoch"] == epoch)
        got = self.step_bytes[rec["first"]:rec["last"]]
        return dict(float32=sum(f + o for f, o in got) / len(got) / 1e6,
                    bfloat16=sum(f / 2 + o for f, o in got) / len(got) / 1e6)


def kernel_launches() -> dict:
    return dict(flash_attention=attention.flash_attention.launches,
                fused_layernorm=fused_norm.fused_layernorm.launches,
                fused_conv_ln_gelu=conv.fused_conv_ln_gelu.launches,
                copy_rows=fused_norm.copy_rows.launches)


def zero_kernel_launches() -> None:
    attention.flash_attention.launches = fused_norm.fused_layernorm.launches = 0
    conv.fused_conv_ln_gelu.launches = fused_norm.copy_rows.launches = 0


def read_history(trainer) -> dict:
    with open(f"{trainer.results_dir}/reports/training_history.json") as f:
        return json.load(f)


def close(a, b, tol: dict) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(np.all(np.abs(a - b) <= tol["atol"] + tol["rtol"] * np.abs(b)))


def check_trainer_run(trainer, epochs: int, min_test_wa=25.0) -> dict:
    """The checks of one ``cli dad`` run: finite history of the right
    lengths, the best .pth reloads and re-validates to the logged best noisy
    WA, and the final test report exists and (with ``min_test_wa``) beats
    chance."""
    history = read_history(trainer)
    post = epochs - trainer.cfg.warmup_epochs
    for k in ("total_loss", "supervised_ce_loss", "consistency_loss", "ecda_loss"):
        if len(history[k]) != epochs or not np.all(np.isfinite(history[k])):
            raise AssertionError(f"history {k}: {history[k]}")
    for k in ("dacp_ema_thresholds", "dacp_class_quality", "ecda_class_attention"):
        if len(history[k]) != post or not np.all(np.isfinite(history[k])):
            raise AssertionError(f"history {k}: {history[k]}")
    best = torch_state_dict_to_ssrl(load_torch_file(trainer.best_path))
    trainer.state = trainer.state._replace(ssrl=SSRLState(
        *({k: v.to(trainer.device) for k, v in p.items()} for p in best)))
    revalidated = trainer.validate(trainer.noisy_val, "Best", 0)["weighted_accuracy"]
    if revalidated != trainer.best_noisy_weighted_acc:
        raise AssertionError(f"best .pth re-validates to noisy WA {revalidated}, "
                             f"logged {trainer.best_noisy_weighted_acc}")
    with open(f"{trainer.results_dir}/reports/FINAL_test_set_results.json") as f:
        final = json.load(f)
    test_wa = float(final["final_test_results"]["noisy_domain"]["weighted_accuracy"][:-1])
    if min_test_wa is not None and not test_wa > min_test_wa:
        raise AssertionError(f"noisy test WA {test_wa} % is not above chance")
    return dict(best_noisy_wa=trainer.best_noisy_weighted_acc, best_epoch=trainer.best_results["epoch"],
                noisy_test_wa=test_wa, losses=history["total_loss"],
                consistency=history["consistency_loss"], ecda=history["ecda_loss"])


def compare_histories(got: dict, want: dict) -> dict:
    """``--scan-chunk`` run against the per-step run: every series within
    TRAINER_METRIC_TOL; returns the largest difference of each."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"history keys {sorted(got)} vs {sorted(want)}")
    diffs = {k: float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k]))))
             for k in want}
    bad = [k for k in want if not close(got[k], want[k], TRAINER_METRIC_TOL)]
    if bad:
        raise AssertionError(f"--scan-chunk {FEATURE_CHUNK} history differs from per-step at "
                             f"{bad}: {diffs}")
    return diffs


def card_against_cpu(cfg, clean_store, noisy_store) -> dict:
    """The same trainer on the card and on the CPU from one pretrain head
    (anchors calibrated on each), fed the same draws through the hook for
    its first steps at epoch 2's scalars (ECDA's weight is 0 at epoch 1,
    where its ramp starts): anchors and metrics within
    TRAINER_METRIC_TOL, the state within TRAINER_STATE_TOL. The consistency
    and ECDA terms must carry weight."""
    g = torch.Generator().manual_seed(5)
    hidden, classes = cfg.hidden_dim, cfg.num_classes
    pretrain = {"pre_net.weight": torch.randn(hidden, FEATURE_DIM, generator=g) * 0.03,
                "pre_net.bias": torch.randn(hidden, generator=g) * 0.03,
                "post_net.weight": torch.randn(classes, hidden, generator=g) * 0.06,
                "post_net.bias": torch.zeros(classes)}
    trainers = [CrossDomainTrainer(cfg, experiment_name=f"card_cpu_{d}", clean_store=clean_store,
                                   noisy_store=noisy_store, pretrain_params=pretrain, device=d,
                                   prefetch_depth=0)
                for d in ("cuda", "cpu")]
    card, cpu = trainers
    anchors = [card.anchors.cpu(), cpu.anchors]
    if not close(*anchors, TRAINER_METRIC_TOL):
        raise AssertionError(f"anchors card {anchors[0].tolist()} vs CPU {anchors[1].tolist()}")
    epoch = 2
    scalars = StepScalars.for_epoch(cfg, epoch)
    pairs = list(itertools.islice(paired_epoch(card.clean_train, card.noisy_train, epoch),
                                  CARD_CPU_STEPS))
    draws = [draw_feature_step(g, torch.from_numpy(n.feats), torch.from_numpy(n.padding_mask),
                               cfg.augment) for _c, n in pairs]
    worst = dict(metrics=0.0, scores=0.0, consistency=0.0, ecda=0.0)
    for t in trainers:
        t.step_draws = lambda epoch, step: draws[step]
    for s, (clean_b, noisy_b) in enumerate(pairs):
        out = []
        for t in trainers:
            (c, n), = prefetch([(clean_b, noisy_b)], depth=0, to_device=True, device=t.device)
            t.state, m, tr = t.train_step(t.state, c, n, scalars, t.anchors, t.generator,
                                          t._draws(epoch, s, n.feats, n.padding_mask))
            out.append((m, tr))
        (m_card, tr_card), (m_cpu, tr_cpu) = out
        worst["consistency"] = max(worst["consistency"], float(m_cpu["consistency_loss"]))
        worst["ecda"] = max(worst["ecda"], float(m_cpu["ecda_loss"]))
        for k in m_cpu:
            a, b = float(m_card[k]), float(m_cpu[k])
            worst["metrics"] = max(worst["metrics"], abs(a - b))
            if not close(a, b, TRAINER_METRIC_TOL):
                raise AssertionError(f"step {s} {k}: card {a} vs CPU {b}")
        sc_card, sc_cpu = tr_card["certainty_score"].cpu(), tr_cpu["certainty_score"]
        worst["scores"] = max(worst["scores"], float((sc_card - sc_cpu).abs().max()))
        if not close(sc_card, sc_cpu, TRAINER_METRIC_TOL):
            raise AssertionError(f"step {s}: certainty scores differ by {worst['scores']}")
    if not (worst["consistency"] > 0 and worst["ecda"] > 0):
        raise AssertionError(f"card vs CPU: the consistency and ECDA terms stayed 0: {worst}")
    state = {}
    for name, a, b in (("student", card.state.ssrl.student, cpu.state.ssrl.student),
                       ("teacher", card.state.ssrl.teacher, cpu.state.ssrl.teacher),
                       ("adam mu", card.state.opt_state.mu, cpu.state.opt_state.mu),
                       ("adam nu", card.state.opt_state.nu, cpu.state.opt_state.nu),
                       ("dacp", card.state.dacp._asdict(), cpu.state.dacp._asdict())):
        for k in b:
            x, y = a[k].cpu(), b[k]
            state[f"{name} {k}"] = float((x - y).abs().max())
            if not close(x, y, TRAINER_STATE_TOL):
                bad = int((~((x - y).abs() <= TRAINER_STATE_TOL["atol"]
                             + TRAINER_STATE_TOL["rtol"] * y.abs())).sum())
                raise AssertionError(f"{name} {k}: card vs CPU max |diff| {state[f'{name} {k}']:.3e}"
                                     f", {bad} of {y.numel()} elements outside STATE_TOL")
    return dict(anchors_card=anchors[0].tolist(), anchors_cpu=anchors[1].tolist(),
                metrics_max_diff=worst["metrics"], scores_max_diff=worst["scores"],
                max_consistency=worst["consistency"], max_ecda=worst["ecda"],
                state_max_diff=max(state.values()))


def check_prefetch_on_card(trainer, transfer_dtype, n_items: int = 6) -> float:
    """The trainer's batches through the pinned-memory path with the
    consumer kept slower than the copies (a device sleep per item), so
    pinned buffers would be overwritten in flight if they were reused:
    every batch must arrive equal to its host arrays (rounded through
    ``transfer_dtype`` where given). Returns the seconds taken."""
    t0 = time.perf_counter()
    host = list(itertools.islice(paired_epoch(trainer.clean_train, trainer.noisy_train, 2),
                                 n_items))
    got = prefetch(iter(host), depth=2, to_device=True, transfer_fp32_as=transfer_dtype,
                   device="cuda")
    for i, ((hc, hn), (dc, dn)) in enumerate(zip(host, got)):
        torch.cuda._sleep(20_000_000)  # ~10 ms of device time before the batch is read
        for h, d in ((hc, dc), (hn, dn)):
            want = torch.from_numpy(h.feats)
            if transfer_dtype:
                want = want.to(getattr(torch, transfer_dtype)).float()
            if not torch.equal(d.feats.cpu(), want) or not torch.equal(
                    d.padding_mask.cpu(), torch.from_numpy(h.padding_mask)):
                raise AssertionError(f"prefetch ({transfer_dtype}): batch {i} arrived altered")
    return time.perf_counter() - t0


@contextlib.contextmanager
def cut_epochs(steps: int):
    """Both trainers' epochs cut to their first ``steps`` steps: the
    streamed and the index pairings of each trainer module, sliced."""
    saved = [(m, n, getattr(m, n)) for m in (dad_trainer, fused_trainer)
             for n in ("paired_epoch", "paired_index_epoch")]
    for m, n, f in saved:
        setattr(m, n, lambda *a, f=f: itertools.islice(f(*a), steps))
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def first_steps(trainer, epoch: int, steps: int) -> tuple:
    """Runs ``steps`` steps of ``trainer.train_epoch(epoch)`` through the
    trainer's own path (streamed or resident); returns (the epoch's metric
    averages, wall ms per step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cut_epochs(steps):
        avg = trainer.train_epoch(epoch)
    torch.cuda.synchronize()
    return avg, (time.perf_counter() - t0) * 1e3 / steps


def state_max_diffs(a, b) -> dict:
    """Max |a - b| of two DAD train states, by part."""
    out = {}
    for name, x, y in (("student", a.ssrl.student, b.ssrl.student),
                       ("teacher", a.ssrl.teacher, b.ssrl.teacher),
                       ("adam mu", a.opt_state.mu, b.opt_state.mu),
                       ("adam nu", a.opt_state.nu, b.opt_state.nu),
                       ("dacp", a.dacp._asdict(), b.dacp._asdict())):
        out[name] = max(float((x[k].float() - y[k].float()).abs().max()) for k in y)
    return out


def resident_against_streamed(make, epoch: int) -> dict:
    """``make(resident)`` builds a trainer; a resident and a streamed one
    take the same first steps of ``epoch`` (one seed, so the same draws):
    metrics within TRAINER_METRIC_TOL and the state within
    TRAINER_STATE_TOL (0 expected: the batches are bit-equal). Returns the
    max differences, each path's ms/step and the resident trainer."""
    out, runs = {}, {}
    for resident in (True, False):
        t = make(resident)
        if (t._resident is not None) != resident:
            raise AssertionError(f"resident={resident} trainer has _resident {t._resident}")
        avg, ms = first_steps(t, epoch, COMPARE_STEPS)
        runs[resident] = (t, avg)
        out["resident_ms_per_step" if resident else "streamed_ms_per_step"] = ms
    (res, a), (stream, b) = runs[True], runs[False]
    out["metrics_max_diff"] = max(abs(a[k] - b[k]) for k in b)
    bad = [k for k in b if not close(a[k], b[k], TRAINER_METRIC_TOL)]
    out["state_max_diff"] = state_max_diffs(res.state, stream.state)
    for name, (x, y) in (("student", (res.state.ssrl.student, stream.state.ssrl.student)),
                         ("teacher", (res.state.ssrl.teacher, stream.state.ssrl.teacher))):
        bad += [f"{name} {k}" for k in y if not close(x[k].cpu(), y[k].cpu(), TRAINER_STATE_TOL)]
    if bad:
        raise AssertionError(f"resident vs streamed: {bad}: {out}")
    out["metrics"] = a
    del stream
    return out, res


def run_feature_trainer() -> dict:
    """Phase 8: ``cli dad --clean --noisy`` on the card at the iemocap
    preset's full width; the fold's stores resident on the card."""
    with tempfile.TemporaryDirectory(prefix="dad_feature_trainer_") as root, \
            contextlib.chdir(root):  # the results directories are relative, as the reference's
        t0 = time.perf_counter()
        (clean_dir, noisy_dir), corpus = write_feature_corpus(root, seed=0)
        write_s = time.perf_counter() - t0
        print(f"train_features: corpus {json.dumps(corpus)}, generated and written in "
              f"{write_s:.1f} s", flush=True)
        argv = ["dad", "--corpus", "iemocap", "--clean", clean_dir, "--noisy", noisy_dir,
                "--fold", "0", "--epochs", str(FEATURE_EPOCHS), "--warmup-epochs", "1"]

        zero_kernel_launches()
        with TrainerProbe() as probe:
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--name", "per_step"])
            run_s = time.perf_counter() - t0
        launches = kernel_launches()
        if rc != 0:
            raise AssertionError(f"cli dad returned {rc}")
        trainer = probe.trainers[-1]
        if trainer._resident is None:
            raise AssertionError("--resident auto did not engage the resident feature corpus")
        resident_mb = sum(c.flat.nbytes for c in trainer._resident) / 1e6
        checks = check_trainer_run(trainer, FEATURE_EPOCHS)
        last = FEATURE_EPOCHS - 1
        rec = next(e for e in probe.epochs if e["epoch"] == last)
        steps = rec["last"] - rec["first"]
        ms = probe.step_ms(last)
        clips = 2 * min(steps * trainer.cfg.batch_size, trainer.clean_train.store.num)
        timing_info = dict(
            run_s=run_s, steps_per_epoch=steps,
            ms_per_step_median=float(np.median(ms)), ms_per_step_range=[min(ms), max(ms)],
            epoch_s=[e["seconds"] for e in probe.epochs],
            validation_s={e["epoch"]: sum(v["seconds"] for v in probe.validations
                                          if v["epoch"] == e["epoch"]) for e in probe.epochs},
            clips_per_s=clips / rec["seconds"], kernel_launches=launches)
        print("train_features: per-step run " + json.dumps(checks), flush=True)
        print("train_features: times " + json.dumps(timing_info), flush=True)
        h2d = probe.h2d_mb_per_step(last)
        streamed = streamed_mb_per_step(trainer.clean_train, trainer.noisy_train, last,
                                        FEATURE_DIM)
        print(f"train_features: resident corpus {resident_mb:.1f} MB on the card; H2D per "
              f"step (epoch {last}, {steps} steps): resident {h2d['float32'] * 1e6:.0f} bytes "
              f"of indices; streamed {streamed['float32']:.1f} MB as float32, "
              f"{streamed['bfloat16']:.1f} MB with --transfer-dtype bfloat16", flush=True)
        pf = [check_prefetch_on_card(trainer, d) for d in (None, "bfloat16")]
        print(f"train_features: prefetch pinned path, batches equal to the host's under a slow "
              f"consumer (float32 {pf[0]:.1f} s, bfloat16 {pf[1]:.1f} s)", flush=True)

        # one step of the trainer's own, profiled: its draws, then the step
        (c, n), = prefetch(itertools.islice(paired_epoch(trainer.clean_train,
                                                         trainer.noisy_train, last), 1),
                           depth=0, to_device=True, device=trainer.device)
        scalars = StepScalars.for_epoch(trainer.cfg, last)
        step = dad_trainer.make_dad_train_step(trainer.head, trainer.tx, trainer.cfg)
        profile = profile_step(lambda: step(trainer.state, c, n, scalars, trainer.anchors,
                                            trainer.generator,
                                            trainer._draws(last, 0, n.feats, n.padding_mask)))
        profile["batch_frames"] = int(n.feats.shape[1])
        print("profile: feature train step " + json.dumps(profile), flush=True)
        history = read_history(trainer)
        cfg, stores = trainer.cfg, (trainer.clean_store, trainer.noisy_store)
        del trainer, probe, c, n

        # resident against --resident off: the same first steps of epoch 2,
        # DACP opened so that the noisy stream reaches the loss
        open_cfg = dataclasses.replace(cfg, results_base_dir="resident_vs_streamed",
                                       dacp=dataclasses.replace(cfg.dacp, **DACP_OPEN))
        report, res = resident_against_streamed(
            lambda r: CrossDomainTrainer(open_cfg, experiment_name=f"resident_{r}",
                                         clean_store=stores[0], noisy_store=stores[1],
                                         resident=r), epoch=2)
        del res
        print(f"train_features: resident vs --resident off, {COMPARE_STEPS} steps of epoch 2 "
              f"from one seed: " + json.dumps(report), flush=True)

        # --scan-chunk on both paths: the resident chunk runner, and the
        # streamed chunks (stacked on the host by the prefetch worker)
        for resident in ("auto", "off"):
            with TrainerProbe() as probe_chunk:
                rc = cli.main(argv + ["--name", f"chunk_{resident}", "--resident", resident,
                                      "--scan-chunk", str(FEATURE_CHUNK)])
            if rc != 0:
                raise AssertionError(f"cli dad --scan-chunk --resident {resident} returned {rc}")
            chunked = probe_chunk.trainers[-1]
            if (chunked._resident is None) != (resident == "off"):
                raise AssertionError(f"--scan-chunk --resident {resident}: _resident is "
                                     f"{chunked._resident}")
            if resident == "off" and chunked._epoch_runner is None:
                raise AssertionError("--scan-chunk --resident off: the streamed chunk runner "
                                     "is not engaged")
            diffs = compare_histories(read_history(chunked), history)
            chunk_s = [e["seconds"] for e in probe_chunk.epochs]
            print(f"train_features: --scan-chunk {FEATURE_CHUNK} --resident {resident} history "
                  f"equals per-step within METRIC_TOL, max |diff| by series "
                  f"{json.dumps(diffs)}; epoch s {chunk_s}", flush=True)
            del chunked, probe_chunk

        # DACP opened, so that the consistency and ECDA terms carry weight
        cpu_cfg = dataclasses.replace(cfg, dropout_rate=0.0, results_base_dir="card_cpu",
                                      dacp=dataclasses.replace(cfg.dacp, **DACP_OPEN))
        t0 = time.perf_counter()
        report = card_against_cpu(cpu_cfg, *stores)
        print(f"train_features: card vs CPU, {CARD_CPU_STEPS} steps from one pretrain head, the "
              f"same draws through the hook ({time.perf_counter() - t0:.1f} s): "
              + json.dumps(report), flush=True)
    return dict(timing=timing_info, checks=checks)


def streamed_mb_per_step(clean_it, noisy_it, epoch: int, dim: int) -> dict:
    """The MB a streamed step of ``epoch`` would ship, from the shapes of
    its two batches: a feature batch's (B, T, dim) f32 features and (B, T)
    mask, or a wav batch's (B, T) f32 samples and mask, plus (B,) labels,
    ids and row flags; as float32 and with f32 leaves shipped as bf16."""
    f32 = other = 0
    pairs = list(resident_mod.paired_index_epoch(clean_it, noisy_it, epoch))
    for (cidx, tc), (nidx, tn) in pairs:
        for idx, t, width in ((cidx, tc, dim), (nidx, tn, dim if hasattr(noisy_it, "max_frames")
                                                      else 1)):
            B = len(idx)
            f32 += B * t * width * 4
            other += B * t + B * (4 + 4 + 1)
    n = len(pairs)
    return dict(float32=(f32 + other) / n / 1e6, bfloat16=(f32 / 2 + other) / n / 1e6)


# the fused trainer (phase 9): wavs of the same 4-class IEMOCAP clip count
# over Ses01-Ses05, lognormal lengths of mean ~4.5 s clipped to 0.6-30 s,
# 16 kHz int16; a tone per class (frequency and amplitude) plus low noise
WAV_SECONDS, WAV_MEAN_SECONDS, WAV_SIGMA = (0.6, 30.0), 4.5, 0.6
FUSED_EPOCHS, EXTRACT_BATCH = 3, 16


def write_iemocap_corpus(root: str, seed: int) -> dict:
    """IEMOCAP's raw layout, written with the port's ``write_wav``:
    ``IEMOCAP/Session{N}/sentences/wav/<dialog>/<utt>.wav`` and one
    EmoEvaluation file per dialog (``[start - end]\tutt\tlabel\t[v, a, d]``
    lines; every other happy clip labelled ``exc``, which the parser folds
    into ``hap``, and a ``fru`` line per dialog, which it drops). Returns the
    two directories and the corpus's sizes."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(list(FEATURE_CLASSES), list(FEATURE_CLASSES.values()))
    rng.shuffle(labels)
    n = len(labels)
    mu = np.log(WAV_MEAN_SECONDS) - WAV_SIGMA**2 / 2
    lengths = (np.clip(rng.lognormal(mu, WAV_SIGMA, n), *WAV_SECONDS) * SAMPLE_RATE).astype(
        np.int64)
    class_ids = np.searchsorted(list(FEATURE_CLASSES), labels)
    raw, eval_dir = f"{root}/IEMOCAP", f"{root}/EmoEvaluation"
    os.makedirs(eval_dir)
    dialogs = collections.defaultdict(list)
    for i, (t, c, label) in enumerate(zip(lengths, class_ids, labels)):
        gender = "FM"[i // 5 % 2]
        dialog = f"Ses0{i % 5 + 1}{gender}_impro0{i % 7}"
        name = f"{dialog}_{gender}{i:04d}"
        f = 150.0 * (c + 1) * (1 + 0.02 * rng.standard_normal())
        x = (0.05 + 0.1 * c) * np.sin(2 * np.pi * f / SAMPLE_RATE * np.arange(t, dtype=np.float32))
        x += 0.005 * rng.standard_normal(t, dtype=np.float32)
        wav_dir = f"{raw}/Session{i % 5 + 1}/sentences/wav/{dialog}"
        os.makedirs(wav_dir, exist_ok=True)
        write_wav(f"{wav_dir}/{name}.wav", x, SAMPLE_RATE)
        start = 2.0 * len(dialogs[dialog])
        emo = "exc" if label == "hap" and i % 2 else str(label)
        dialogs[dialog].append(f"[{start:.4f} - {start + t / SAMPLE_RATE:.4f}]\t{name}\t{emo}\t"
                               "[2.5000, 2.5000, 2.5000]")
    for dialog, rows in dialogs.items():
        rows.append(f"[0.0000 - 1.0000]\t{dialog}_X9999\tfru\t[2.0000, 3.5000, 3.5000]")
        with open(f"{eval_dir}/{dialog}.txt", "w") as fh:
            fh.write("% [START_TIME - END_TIME] TURN_NAME EMOTION [V, A, D]\n\n"
                     + "\n\n".join(rows) + "\n")
    return dict(raw=raw, eval_dir=eval_dir, clips=n, dialogs=len(dialogs),
                hours=float(lengths.sum() / SAMPLE_RATE / 3600),
                mean_s=float(lengths.mean() / SAMPLE_RATE),
                max_s=float(lengths.max() / SAMPLE_RATE))


class StartupProbe:
    """Host seconds of the fused trainer's startup stages: the wav decode,
    each extraction pass and the fixed injection (each ends in host data)."""

    def __init__(self):
        self.stages = []

    def _timed(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.stages.append((name, time.perf_counter() - t0))
            return out

        return timed

    def __enter__(self) -> "StartupProbe":
        self._saved = (fused_trainer.load_wav_store, fused_trainer.inject_fixed,
                       FeatureExtractor.extract_clips)
        fused_trainer.load_wav_store = self._timed("wav decode", self._saved[0])
        fused_trainer.inject_fixed = self._timed("fixed injection", self._saved[1])
        FeatureExtractor.extract_clips = self._timed("extraction", self._saved[2])
        return self

    def __exit__(self, *exc) -> None:
        (fused_trainer.load_wav_store, fused_trainer.inject_fixed,
         FeatureExtractor.extract_clips) = self._saved

    def summary(self) -> dict:
        out, n = {}, 0
        for name, sec in self.stages:
            if name == "extraction":
                name = ("clean", "noisy")[n] + " extraction"
                n += 1
            out[name] = sec
        return out


def record_tracking(trainer):
    """Keeps each training step's tracking outputs (every row's id and
    certainty score, on the device) in ``trainer.step_tracking``."""
    name = "_resident_step" if trainer._resident is not None else "_fused_step"
    step, trainer.step_tracking = getattr(trainer, name), []

    def recorded(*a, **kw):
        state, metrics = step(*a, **kw)
        trainer.step_tracking.append(metrics["tracking"])
        return state, metrics

    setattr(trainer, name, recorded)
    return trainer


def store_against_plain(kernel_store, plain_store, what: str, errors: list) -> dict:
    """A startup store extracted through the attention kernel against the
    same clips extracted through the plain attention path: per clip, the
    norm of the difference over the norm of the plain features, within
    FEAT_REL_TOL_BF16 (else an entry in ``errors``)."""
    sizes = kernel_store.sizes
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for st in (kernel_store, plain_store):
        if not (np.array_equal(st.sizes, sizes) and np.array_equal(st.offsets, offsets)):
            raise AssertionError(f"{what} stores differ in layout")
    k, p = kernel_store.feats, plain_store.feats
    if not np.isfinite(k).all():
        raise AssertionError(f"{what} store: non-finite features through the kernel")
    d = k - p
    rel = np.sqrt(np.add.reduceat(np.einsum("fd,fd->f", d, d), offsets)
                  / np.add.reduceat(np.einsum("fd,fd->f", p, p), offsets))
    out = dict(clips=int(len(sizes)), clip_rel_err_max=float(rel.max()),
               clip_rel_err_median=float(np.median(rel)), max_abs_diff=float(np.abs(d).max()),
               plain_max_abs=float(np.abs(p).max()))
    if not rel.max() <= FEAT_REL_TOL_BF16:
        errors.append(f"{what} store: clip {int(rel.argmax())} relative error {rel.max():.3e} "
                      f"> {FEAT_REL_TOL_BF16}")
    return out


def kernel_against_plain(res_trainer, res_avg: dict, make_plain, epoch: int,
                         errors: list) -> dict:
    """A resident trainer's metrics, certainty scores and student update
    after ``first_steps`` (attention through the kernel, its stores
    extracted through the kernel) against a trainer whose encoder takes the
    plain attention path and whose stores the plain path extracted, the
    same steps from one seed: metrics within TRAINER_REL_TOL, every valid
    row's certainty score and the DACP state within DACP_TOL, the student's
    update within UPDATE_REL_TOL of the plain one's; each miss an entry in
    ``errors``."""
    plain = make_plain()
    before = {k: v.clone() for k, v in plain.state.ssrl.student.items()}
    avg, _ms = first_steps(plain, epoch, COMPARE_STEPS)
    out = dict(metrics={k: [res_avg[k], avg[k]] for k in avg})
    for k, (a, b) in out["metrics"].items():
        if not close(a, b, TRAINER_REL_TOL):
            errors.append(f"{k}: {a} vs {b}")
    ids, scores = ([torch.cat([tr[key] for tr in t.step_tracking]) for t in (res_trainer, plain)]
                   for key in ("ids", "certainty_score"))
    if not torch.equal(*ids):
        errors.append("the steps saw different rows")
    valid = ids[0] >= 0
    out["score_max_diff"] = float((scores[0].float() - scores[1].float()).abs()[valid].max())
    if out["score_max_diff"] > DACP_TOL:
        errors.append(f"certainty scores max |diff| {out['score_max_diff']:.3e} > {DACP_TOL}")
    diffs = state_max_diffs(res_trainer.state, plain.state)
    if diffs["dacp"] > DACP_TOL:
        errors.append(f"DACP state max |diff| {diffs['dacp']:.3e} > {DACP_TOL}")
    sq = dict(diff=0.0, plain=0.0)
    for k, s0 in before.items():
        dk, dp = res_trainer.state.ssrl.student[k] - s0, plain.state.ssrl.student[k] - s0
        sq["diff"] += float(((dk - dp) ** 2).sum())
        sq["plain"] += float((dp**2).sum())
    out["student_update_rel_diff"] = math.sqrt(sq["diff"] / sq["plain"])
    if not out["student_update_rel_diff"] <= UPDATE_REL_TOL:
        errors.append(f"student update relative |diff| {out['student_update_rel_diff']:.3e} > "
                      f"{UPDATE_REL_TOL}")
    out.update(rows=int(valid.sum()), state_max_diff=diffs)
    del plain
    return out


def run_fused_trainer(root: str, manifests: str, ckpt: str) -> dict:
    """Phase 9: ``cli dad --from-wav`` on the card at the iemocap preset's
    full width, attention through the kernel, the corpus resident; from the
    manifest that phase 10's ``cli manifest`` built, in its directory."""
    enc_cfg = EncoderConfig(dtype="bfloat16", use_flash_attention=True)
    argv = ["dad", "--corpus", "iemocap", "--from-wav", manifests, "--checkpoint", ckpt,
            "--fold", "0", "--epochs", str(FUSED_EPOCHS), "--warmup-epochs", "1",
            "--snr", "10", "--name", "fused"]

    zero_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' tensors, in the peak
    probe = TrainerProbe(fused_trainer, FusedCrossDomainTrainer,
                         {"make_fused_extract_train_step": batch_bytes,
                          "make_resident_fused_step": index_bytes})
    with probe, StartupProbe() as startup:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        run_s = time.perf_counter() - t0
    launches = kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"cli dad --from-wav returned {rc}")
    trainer = probe.trainers[-1]
    if trainer._resident is None:
        raise AssertionError("--resident auto did not engage the resident corpus")
    resident_mb = sum(c.flat.nbytes for c in trainer._resident) / 1e6
    blocks = trainer.fused_cfg.encoder.prenet_depth + trainer.fused_cfg.encoder.depth
    n = trainer.wav_store.num
    extract_batches = -(-n // EXTRACT_BATCH)
    steps = len(probe.events)
    per_epoch = min(len(trainer.clean_train), len(trainer.noisy_wav_train))
    if steps != FUSED_EPOCHS * per_epoch:
        raise AssertionError(f"{steps} training steps, expected {FUSED_EPOCHS} x {per_epoch}")
    want = dict(flash_attention=blocks * (2 * extract_batches + steps), fused_layernorm=0,
                fused_conv_ln_gelu=0, copy_rows=0)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want} ({blocks} x (2 x "
                             f"{extract_batches} extraction batches + {steps} steps))")
    checks = check_trainer_run(trainer, FUSED_EPOCHS)
    best_path = trainer.best_path
    history = read_history(trainer)
    if not history["supervised_ce_loss"][2] < history["supervised_ce_loss"][0]:
        raise AssertionError(f"clean CE did not fall: {history['supervised_ce_loss']}")
    last = FUSED_EPOCHS - 1
    rec = next(e for e in probe.epochs if e["epoch"] == last)
    ms = probe.step_ms(last)
    clips = 2 * min(per_epoch * trainer.cfg.batch_size, trainer.clean_train.store.num)
    buckets = collections.Counter(
        t for e in range(FUSED_EPOCHS)
        for _c, (_i, t) in resident_mod.paired_index_epoch(trainer.clean_train,
                                                           trainer.noisy_wav_train, e))
    streamed = streamed_mb_per_step(trainer.clean_train, trainer.noisy_wav_train, last,
                                    trainer.cfg.input_dim)
    info = dict(
        startup_s=startup.summary(), run_s=run_s, resident_mb=resident_mb,
        peak_device_gb=peak_gb, held_before_gb=held_gb, steps_per_epoch=per_epoch,
        ms_per_step_median=float(np.median(ms)), ms_per_step_range=[min(ms), max(ms)],
        epoch_s=[e["seconds"] for e in probe.epochs], clips_per_s=clips / rec["seconds"],
        h2d_bytes_per_step_resident=probe.h2d_mb_per_step(last)["float32"] * 1e6,
        h2d_mb_per_step_streamed=streamed,
        wav_buckets_of_steps={str(k): v for k, v in sorted(buckets.items())},
        kernel_launches=launches)
    print("train_fused: run " + json.dumps(checks), flush=True)
    print("train_fused: times " + json.dumps(info), flush=True)
    del probe

    # one resident step at the most common wav bucket, profiled
    t_wav = buckets.most_common(1)[0][0]
    (cidx, t_c), (widx, _t) = next(
        p for p in resident_mod.paired_index_epoch(trainer.clean_train,
                                                   trainer.noisy_wav_train, last)
        if p[1][1] == t_wav)
    step = fused_trainer.make_resident_fused_step(trainer.encoder, trainer.head, trainer.tx,
                                                  trainer.fused_cfg)
    scalars = StepScalars.for_epoch(trainer.cfg, last)
    clean_c, wav_c = trainer._resident
    args = (trainer.state, clean_c, wav_c, torch.from_numpy(cidx).cuda(),
            torch.from_numpy(widx).cuda(), scalars, trainer.anchors, trainer.generator)
    step(*args, t_clean=t_c, t_wav=t_wav, frame_cap=trainer.clean_train.max_frames)
    profile = profile_step(lambda: step(*args, t_clean=t_c, t_wav=t_wav,
                                        frame_cap=trainer.clean_train.max_frames))
    attn = profile["by_group_ms"].get("attention kernel", 0.0)
    profile.update(wav_bucket=t_wav, clean_frames=t_c,
                   attention_share=attn / profile["device_ms"])
    print("profile: fused train step " + json.dumps(profile), flush=True)

    # resident against streamed, then kernel against plain attention:
    # fresh trainers, DACP opened; the kernel's from this run's startup
    shared = dict(wav_store=trainer.wav_store, extractor=trainer.extractor,
                  clean_store=trainer.clean_store, noisy_store=trainer.noisy_store,
                  noise_clips=None)
    cfg = dataclasses.replace(trainer.cfg, results_base_dir="compare",
                              dacp=dataclasses.replace(trainer.cfg.dacp, **DACP_OPEN))
    fused_cfg = trainer.fused_cfg
    del trainer, step, args, clean_c, wav_c
    torch.cuda.empty_cache()

    def make(resident, startup=shared, name="kernel"):
        enc = startup["extractor"].cfg
        return record_tracking(FusedCrossDomainTrainer(
            cfg, manifests, enc, None, fused_cfg=dataclasses.replace(fused_cfg, encoder=enc),
            experiment_name=f"{name}_{resident}", shared=startup, resident=resident))

    report, res = resident_against_streamed(make, epoch=last)
    print(f"train_fused: resident vs --resident off, {COMPARE_STEPS} steps of epoch {last} "
          "from one seed: " + json.dumps(report), flush=True)

    # the plain attention path's own startup: both extraction passes
    # through it, so that the stores the kernel extracted are held
    # against it too
    plain_cfg = dataclasses.replace(enc_cfg, use_flash_attention=False)
    zero_kernel_launches()
    t0 = time.perf_counter()
    plain_shared = fused_trainer.prepare_fused_shared(
        cfg, manifests, plain_cfg, load_emotion2vec_checkpoint(ckpt, plain_cfg),
        dataclasses.replace(fused_cfg, encoder=plain_cfg), None)
    plain_s = time.perf_counter() - t0
    if attention.flash_attention.launches:
        raise AssertionError("the plain attention path launched the kernel")
    errors = []
    stores = {what: store_against_plain(shared[f"{what}_store"],
                                        plain_shared[f"{what}_store"], what, errors)
              for what in ("clean", "noisy")}
    print(f"train_fused: startup stores, kernel vs plain attention path (plain startup "
          f"{plain_s:.1f} s): " + json.dumps(stores), flush=True)
    kp = kernel_against_plain(res, report["metrics"],
                              lambda: make(True, plain_shared, "plain"), last, errors)
    print(f"train_fused: kernel vs plain attention, each with its own stores, "
          f"{COMPARE_STEPS} resident steps of epoch {last} from one seed: " + json.dumps(kp),
          flush=True)
    if errors:
        raise AssertionError("fused trainer, kernel vs plain attention: " + "; ".join(errors))
    del res, plain_shared, shared
    torch.cuda.empty_cache()
    return dict(launches=launches["flash_attention"], info=info, best_path=best_path)


# phase 10, stage 1 and inference: the injection SNR of the reference's
# grid that phase 9 trains at; whole extraction batches of the CLI's own
# order held against the plain attention path (every bucket's batches, up
# to this many); one ``cli preprocess`` condition of each real-noise mode
# of the reference's grid over the whole corpus (root1 = one type for every
# clip, root2 = a type drawn a clip), from a synthetic bank whose files
# last as long as NOISEX-92's
STAGE1_SNR_DB, PLAIN_BATCHES, NOISE_SECONDS = 10.0, 24, 235
GRID_CONDITIONS = {"root1-babble-10db": ["--noise-types", "babble"],
                   "root2-10db": ["--root2"]}
# card vs CPU inference over the same store and weights: the head runs in
# f32 on both (TF32 off), so the logits differ by summation order, ~1e-6;
# a prediction may flip only where the top two logits are that close
INFER_TIE_MARGIN = 1e-3


def timed_cli(argv: list) -> float:
    """Seconds of one ``cli.main(argv)`` call that must return 0, the card
    synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv[:1])} returned {rc}")
    return time.perf_counter() - t0


@contextlib.contextmanager
def stage1_probe(target, name: str):
    """Wraps ``target.name`` for the block: the list it yields collects
    (seconds, result) of each call, the card synchronised before each."""
    calls, real = [], getattr(target, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(target, name, timed)
    try:
        yield calls
    finally:
        setattr(target, name, real)


def verified_snrs(what: str, verified: list) -> dict:
    """The one verification of an injection pass (the gate's own sample of
    20 clips), which must pass."""
    (_sec, (ok, results)), = verified
    snrs = [snr for _rel, snr in results]
    if not ok:
        raise AssertionError(f"{what}: verification FAILED: {results}")
    return dict(mean_snr_db=float(np.mean(snrs)), min_snr_db=float(min(snrs)),
                max_snr_db=float(max(snrs)), verified_clips=len(results))


def run_inject(engine: str, raw: str, manifests: str, out: str) -> dict:
    """``cli inject --snr_db 10 --verify`` with one engine; its verification
    must pass."""
    with stage1_probe(audio_cli, "verify_noise_injection") as verified:
        sec = timed_cli(["inject", "--input_root", raw, "--output_root", out, "--snr_db",
                         str(STAGE1_SNR_DB), "--manifest_path", manifests, "--engine", engine,
                         "--verify"])
    return dict(seconds=sec, **verified_snrs(f"{engine} injection", verified))


def check_attention_launches(what: str, clips: int) -> int:
    """The launches since the counts were zeroed: 12 per extraction batch of
    16 (one a block), the other kernels none."""
    launches = kernel_launches()
    batches = -(-clips // EXTRACT_BATCH)
    want = dict(flash_attention=12 * batches, fused_layernorm=0, fused_conv_ln_gelu=0,
                copy_rows=0)
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {want} "
                             f"(12 x {batches} batches)")
    return launches["flash_attention"]


def run_extract(manifests: str, ckpt: str, save_dir: str, clips: int) -> dict:
    """``cli extract`` (bf16, attention through the kernel) on the card:
    the CLI's seconds, the extraction pass's own seconds and clips/s, the
    attention launches (12 per batch of 16, the other kernels none) and the
    peak device memory (with what earlier phases still held before it)."""
    zero_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' tensors, in the peak
    with stage1_probe(FeatureExtractor, "extract_clips") as passes:
        sec = timed_cli(["extract", "--data", manifests, "--checkpoint", ckpt, "--save-dir",
                         save_dir])
    launches = check_attention_launches("extract", clips)
    ((pass_s, _feats),) = passes
    with open(f"{save_dir}/train.lengths") as f:
        frames = sum(int(x) for x in f)
    return dict(cli_seconds=sec, pass_seconds=pass_s, clips_per_s=clips / pass_s,
                batches=-(-clips // EXTRACT_BATCH), attention_launches=launches, frames=frames,
                peak_device_gb=torch.cuda.max_memory_allocated() / 1e9, held_before_gb=held_gb)


def extraction_against_plain(manifests: str, store_dir: str, ckpt: str, errors: list) -> dict:
    """Whole batches of the CLI's extraction order (clips sorted by length,
    16 a batch), up to PLAIN_BATCHES spread over every wav bucket, through
    an extractor whose encoder takes the plain attention path: each clip's
    features against the CLI's store, the norm of the difference over the
    plain features' norm, within FEAT_REL_TOL_BF16 (phase 9's limit, for
    its reason)."""
    root, files = read_manifest(manifests)
    lengths = np.array([frames for _rel, frames in files])
    with open(f"{store_dir}/train.lengths") as f:
        sizes = np.array([int(x) for x in f])
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    feats = np.load(f"{store_dir}/train.npy", mmap_mode="r")
    plain_cfg = EncoderConfig(dtype="bfloat16", use_flash_attention=False)
    plain = FeatureExtractor(plain_cfg, load_emotion2vec_checkpoint(ckpt, plain_cfg),
                             batch_size=EXTRACT_BATCH)
    order = np.argsort(lengths, kind="stable")
    batches = [order[i:i + EXTRACT_BATCH] for i in range(0, len(order), EXTRACT_BATCH)]
    by_bucket = collections.defaultdict(list)
    for b in batches:
        by_bucket[pad_to_bucket(int(lengths[b].max()), plain.buckets)].append(b)
    per_bucket = -(-PLAIN_BATCHES // len(by_bucket))
    chosen = [bs[int(k)] for bs in by_bucket.values()
              for k in np.unique(np.linspace(0, len(bs) - 1, per_bucket).round())]
    zero_kernel_launches()
    rel = []
    for idx in chosen:
        clips = []
        for i in idx:
            wav, _sr = read_wav(os.path.join(root, files[i][0]))
            clips.append(wav.astype(np.float32))
        for i, ref in zip(idx, plain.extract_clips(clips)):
            got = np.asarray(feats[offsets[i]:offsets[i] + sizes[i]])
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise AssertionError(f"clip {i}: store {got.shape} vs plain {ref.shape}")
            rel.append(float(np.linalg.norm(got - ref) / np.linalg.norm(ref)))
    if attention.flash_attention.launches:
        raise AssertionError("the plain attention path launched the kernel")
    out = dict(batches=len(chosen), clips=len(rel),
               batches_per_bucket={str(k): min(len(v), per_bucket) for k, v in
                                   sorted(by_bucket.items())},
               clip_rel_err_max=max(rel), clip_rel_err_median=float(np.median(rel)))
    if not max(rel) <= FEAT_REL_TOL_BF16:
        errors.append(f"{store_dir}: a clip's relative error {max(rel):.3e} > "
                      f"{FEAT_REL_TOL_BF16}")
    del plain
    torch.cuda.empty_cache()
    return out


class PredictionProbe:
    """Keeps the predictions and logits of every ``infer`` batch's clips (its
    rows with a valid frame) on the host (``eval/inference.py``'s eval step,
    wrapped for the probe's duration)."""

    def __enter__(self) -> "PredictionProbe":
        self.batches, self._make = [], inference.make_eval_step

        def make(head):
            step = self._make(head)

            def recorded(params, feats, padding_mask):
                preds, logits = step(params, feats, padding_mask)
                rows = (~padding_mask.all(dim=-1)).cpu().numpy()
                self.batches.append((preds.cpu().numpy()[rows],
                                     logits.float().cpu().numpy()[rows]))
                return preds, logits

            return recorded

        inference.make_eval_step = make
        return self

    def __exit__(self, *exc) -> None:
        inference.make_eval_step = self._make


def run_infer(best_pth: str, store_dir: str, out_dir: str, device: str) -> dict:
    argv = ["infer", "--weights", best_pth, "--test-data", store_dir, "--split", "test",
            "--fold", "0", "--output-dir", out_dir, "--device", device]
    with PredictionProbe() as probe:
        sec = timed_cli(argv)
    (run,) = os.listdir(out_dir)
    with open(f"{out_dir}/{run}/inference_results.json") as f:
        res = json.load(f)
    return dict(seconds=sec, metrics={k: res["metrics"][k] for k in
                                      ("accuracy", "weighted_accuracy", "f1_weighted")},
                num_samples=res["info"]["num_samples"], confidence=res["confidence_stats"],
                preds=np.concatenate([p for p, _ in probe.batches]),
                logits=np.concatenate([lg for _, lg in probe.batches]))


def top_margin(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def write_noise_bank(root: str, seed: int) -> str:
    """The five NOISEX-92 files of the 5types directory, synthetic: seeded
    Gaussian noise through a different short filter per type, 16 kHz,
    NOISE_SECONDS long."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    n = NOISE_SECONDS * SAMPLE_RATE
    for k, fname in enumerate(NOISE_FILE_MAPPING):
        taps = np.hanning(2 * k + 3)  # low-pass, narrower as k grows
        if k % 2:
            taps *= (-1.0) ** np.arange(len(taps))  # high-pass
        x = np.convolve(rng.standard_normal(n), taps / np.abs(taps).sum(), mode="same")
        write_wav(f"{root}/{fname}", (0.3 * x / np.abs(x).max()).astype(np.float32),
                  SAMPLE_RATE)
    return root


def run_noise_grid_conditions(root: str, corpus: dict, manifests: str, ckpt: str) -> dict:
    """``cli preprocess`` (native engine, verification, extraction on the
    card) over the whole corpus, one call and one condition a real-noise
    mode: the call's seconds, its injection's and its extraction pass's,
    the verification, the attention launches and a store of every clip."""
    bank = write_noise_bank(f"{root}/5types", seed=1)
    n, out, info = corpus["clips"], f"{root}/grid", {}
    for name, flags in GRID_CONDITIONS.items():
        zero_kernel_launches()
        with stage1_probe(audio_cli, "verify_noise_injection") as verified, \
                stage1_probe(audio_cli, "inject_files_native") as injected, \
                stage1_probe(FeatureExtractor, "extract_clips") as passes:
            sec = timed_cli(["preprocess", "--manifest-dir", manifests, "--clean-root",
                             corpus["raw"], "--output-base", out, "--snrs",
                             str(int(STAGE1_SNR_DB)), "--noise-root", bank, "--checkpoint",
                             ckpt, "--engine", "native", *flags])
        launches = check_attention_launches(f"preprocess {name}", n)
        st = load_feature_store(f"{out}/features-{name}", dad_preset("iemocap").label_map)
        if not (st.validate() and st.num == n and st.dim == 768
                and np.isfinite(st.feats).all()):
            raise AssertionError(f"preprocess {name}: the store is not {n} finite 768-d clips")
        ((inject_s, _), (pass_s, _)) = injected[0], passes[0]
        info[name] = dict(seconds=sec, inject_seconds=inject_s, pass_seconds=pass_s,
                          clips=n, attention_launches=launches,
                          **verified_snrs(f"preprocess {name}", verified))
        print(f"stage1: preprocess {name}: verification PASSED " + json.dumps(info[name]),
              flush=True)
        del st
        shutil.rmtree(out)
    return info


def run_preprocess(root: str, corpus: dict, manifests: str, ckpt: str, best_pth: str) -> dict:
    """Phase 10 after phase 9: ``cli inject`` with both engines, ``cli
    extract`` of the clean and the numpy-injected noisy trees, the stores
    held against the plain attention path, ``cli infer`` on the card and on
    the CPU, and ``cli preprocess`` of one real-noise condition a mode."""
    n = corpus["clips"]
    info = {}
    for engine in ("native", "numpy"):
        info[f"inject_{engine}"] = run_inject(engine, corpus["raw"], manifests,
                                              f"{root}/root1-white-10db-{engine}")
        print(f"stage1: inject --engine {engine}: verification PASSED "
              + json.dumps(info[f"inject_{engine}"]), flush=True)
    shutil.rmtree(f"{root}/root1-white-10db-native")
    noisy_wavs = f"{root}/root1-white-10db-numpy"
    noisy_manifests = write_noisy_manifest(manifests, noisy_wavs, f"{root}/manifests-noisy")
    errors, launches = [], 0
    for what, mdir in (("clean", manifests), ("noisy", noisy_manifests)):
        ext = run_extract(mdir, ckpt, f"{root}/features-{what}", n)
        launches += ext["attention_launches"]
        ext["against_plain"] = extraction_against_plain(mdir, f"{root}/features-{what}", ckpt,
                                                        errors)
        info[f"extract_{what}"] = ext
        print(f"stage1: extract {what}: " + json.dumps(ext), flush=True)
    if errors:
        raise AssertionError("extraction, kernel vs plain attention: " + "; ".join(errors))

    store = f"{root}/features-noisy"
    gpu = run_infer(best_pth, store, f"{root}/inference-cuda", "cuda")
    cpu = run_infer(best_pth, store, f"{root}/inference-cpu", "cpu")
    if not gpu["metrics"]["weighted_accuracy"] > 25.0:
        raise AssertionError(f"infer: noisy WA {gpu['metrics']['weighted_accuracy']} % is not "
                             "above chance")
    differ = np.nonzero(gpu["preds"] != cpu["preds"])[0]
    margins = np.minimum(top_margin(gpu["logits"][differ]), top_margin(cpu["logits"][differ]))
    agreement = dict(clips=int(len(gpu["preds"])), predictions_differ=int(len(differ)),
                     margins_of_those=margins.tolist(),
                     logit_max_abs_diff=float(np.abs(gpu["logits"] - cpu["logits"]).max()))
    for key in ("preds", "logits"):
        gpu.pop(key), cpu.pop(key)
    info["infer_cuda"], info["infer_cpu"], info["infer_card_vs_cpu"] = gpu, cpu, agreement
    print("stage1: infer --split test --fold 0 on the card " + json.dumps(gpu)
          + "; --device cpu " + json.dumps(cpu) + "; card vs CPU " + json.dumps(agreement),
          flush=True)
    if len(differ) and margins.max() > INFER_TIE_MARGIN:
        raise AssertionError(f"infer: {len(differ)} predictions differ between the card and "
                             f"the CPU, with top-2 logit margins up to {margins.max():.3e}")

    info["preprocess"] = run_noise_grid_conditions(root, corpus, manifests, ckpt)
    grid_launches = sum(c["attention_launches"] for c in info["preprocess"].values())
    return dict(launches=launches + grid_launches, info=info,
                stores={what: f"{root}/features-{what}" for what in ("clean", "noisy")})


# phase 11, pretrain, the experiment harness and the analyses, on phase 10's
# stores and phase 9's corpus and checkpoint: 5 pretrain epochs (the tones
# separate within a few), 2 epochs an experiment (warmup 1, so that DACP,
# ECDA and the consistency term run in the second)
PRETRAIN_EPOCHS, EXPERIMENT_EPOCHS, PRETRAIN_COMPARE_EPOCHS = 5, 2, 2
# pretrain test accuracy "well above" chance (4 classes)
PRETRAIN_MIN_TEST_ACC = 0.5
# card vs CPU pretrain, 2 epochs (~100 Adam steps at lr 2e-4) from one init,
# f32 on both with TF32 off: the gradients differ by summation order only,
# but Adam divides each by its running RMS, so a weight whose gradient
# cancels to ~0 can take a step a few percent of lr apart on each device:
# the weights within 1e-4, the losses within a relative 1e-3
PRETRAIN_CARD_CPU_TOL = dict(atol=1e-4, rtol=1e-3)
# the tsne embedding pass (768 -> 256 matmul, ReLU, mean over the clip's
# frames), card vs CPU in f32 with TF32 off: summation order only
EMBED_CARD_CPU_TOL = dict(atol=2e-5, rtol=1e-4)
# log-mel of one batch, card (cuFFT) vs CPU, f32 FFTs of one frame layout:
# an FFT rounds relative to its frame's energy, not to each bin's, so a
# tone's near-silent mel bins (60-80 dB under the frame's peak) part by
# ~1e-3 in the log (1.78e-3 on an H100 when the check was on the log at
# 1e-4). The mel power is held within this share of its frame's largest
# mel power (f32 rounding is ~1e-6 of it)
LOGMEL_FRAME_REL_TOL = 1e-5
# an experiment's peak device memory may pass the first one's by this share
# (allocator rounding), no more: the trainer before it is freed
PEAK_GROWTH = 0.01
SUMMARIES = {"dacp": "dacp_evolution_summary.json", "disagreement": "disagreement_summary.json",
             "bias": "confirmation_bias_summary.json",
             "distribution": "distribution_summary.json"}


class PretrainProbe:
    """A CUDA event before every pretrain training step (their spacing is
    the device's time per step) and the host clock at the first step and
    after every evaluation pass (each ends in a host read): an epoch runs
    from one validation's end to the next."""

    def __enter__(self) -> "PretrainProbe":
        self.events, self.marks, self.first_step = [], [], None
        self._saved = (pretrain_mod.make_pretrain_steps, pretrain_mod._run_eval)
        make, run_eval = self._saved
        probe = self

        def wrapped_make(*args, **kwargs):
            train_step, eval_step = make(*args, **kwargs)

            def timed(*a, **kw):
                if probe.first_step is None:
                    probe.first_step = time.perf_counter()
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                probe.events.append(event)
                return train_step(*a, **kw)

            return timed, eval_step

        def timed_eval(*a, **kw):
            out = run_eval(*a, **kw)
            probe.marks.append((len(probe.events), time.perf_counter()))
            return out

        pretrain_mod.make_pretrain_steps, pretrain_mod._run_eval = wrapped_make, timed_eval
        return self

    def __exit__(self, *exc) -> None:
        pretrain_mod.make_pretrain_steps, pretrain_mod._run_eval = self._saved

    def summary(self) -> dict:
        """Seconds of each epoch (training and validation), the steps of an
        epoch and the median ms per step of the last."""
        vals = self.marks[:-1]  # the last pass is the test split's
        starts = [(0, self.first_step)] + vals[:-1]
        (i0, _), (i1, _) = starts[-1], vals[-1]
        ev = self.events[i0:i1]
        ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        return dict(epoch_s=[t1 - t0 for (_, t0), (_, t1) in zip(starts, vals)],
                    steps_per_epoch=i1 - i0,
                    ms_per_step_median=float(np.median(ms)) if ms else None,
                    ms_per_step_range=[min(ms), max(ms)] if ms else None)


def pretrain_card_against_cpu(cfg, store) -> dict:
    """``pretrain_fold`` on the card and on the CPU from one init for
    PRETRAIN_COMPARE_EPOCHS epochs: the loss series and the weights within
    PRETRAIN_CARD_CPU_TOL."""
    cfg = dataclasses.replace(cfg, max_epochs=PRETRAIN_COMPARE_EPOCHS)
    _head, init = init_pretrain_head(torch.Generator().manual_seed(7), cfg.input_dim,
                                     cfg.hidden_dim, cfg.num_classes)
    runs, secs = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[device] = pretrain_mod.pretrain_fold(cfg, store, 0, device=device,
                                                  init_params=init)
        secs[device] = time.perf_counter() - t0
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {k: float(np.max(np.abs(np.subtract(card["history"][k], cpu["history"][k]))))
              for k in ("train_loss", "val_loss")}
    weights = {k: float((v.cpu() - cpu["params"][k]).abs().max())
               for k, v in card["params"].items()}
    bad = [k for k in losses if not close(card["history"][k], cpu["history"][k],
                                          PRETRAIN_CARD_CPU_TOL)]
    bad += [k for k, v in card["params"].items()
            if not close(v.cpu().numpy(), cpu["params"][k].numpy(), PRETRAIN_CARD_CPU_TOL)]
    out = dict(epochs=PRETRAIN_COMPARE_EPOCHS, seconds=secs, loss_max_abs_diff=losses,
               weight_max_abs_diff=weights,
               val_acc=dict(card=card["history"]["val_acc"], cpu=cpu["history"]["val_acc"]),
               test_acc=dict(card=card["test"]["accuracy"], cpu=cpu["test"]["accuracy"]))
    if bad:
        raise AssertionError(f"pretrain, card vs CPU over {PRETRAIN_COMPARE_EPOCHS} epochs: "
                             f"{bad} beyond {PRETRAIN_CARD_CPU_TOL}: {json.dumps(out)}")
    return out


def run_pretrain(root: str, clean_dir: str) -> dict:
    """``cli pretrain`` on the card over phase 10's clean store (the
    iemocap preset at full width, fold 0, PRETRAIN_EPOCHS epochs): rc 0, the
    .ckpt's shapes, the history, test accuracy well above chance, the .ckpt
    re-evaluating to the logged test accuracy; then card against CPU."""
    save_dir = f"{root}/pretrain"
    zero_kernel_launches()
    with PretrainProbe() as probe:
        sec = timed_cli(["pretrain", "--corpus", "iemocap", "--feat-path", clean_dir,
                         "--folds", "0", "--max-epochs", str(PRETRAIN_EPOCHS),
                         "--save-dir", save_dir])
    if any(kernel_launches().values()):
        raise AssertionError(f"pretrain launched a kernel: {kernel_launches()}")
    ckpt = f"{save_dir}/best_model_fold_1.ckpt"
    params = load_pretrain_head_checkpoint(ckpt)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    if shapes != {"pre_net.weight": (256, 768), "pre_net.bias": (256,),
                  "post_net.weight": (4, 256), "post_net.bias": (4,)}:
        raise AssertionError(f"pretrain .ckpt shapes {shapes}")
    with open(f"{save_dir}/training_history.json") as f:
        history = json.load(f)["fold_1"]
    with open(f"{save_dir}/test_results.json") as f:
        logged = json.load(f)["fold_test_accuracies"][0]
    if not (0 < len(history["epochs"]) <= PRETRAIN_EPOCHS
            and np.all(np.isfinite(history["train_loss"]))):
        raise AssertionError(f"pretrain history {history}")
    if not logged > PRETRAIN_MIN_TEST_ACC:
        raise AssertionError(f"pretrain test accuracy {logged} is not well above chance")

    cfg = pretrain_preset("iemocap", feat_path=clean_dir)
    store = load_feature_store(clean_dir, cfg.label_map)
    head, _ = init_pretrain_head(None, device="cuda")
    _train, eval_step = pretrain_mod.make_pretrain_steps(
        head, pretrain_mod.build_pretrain_optimizer(cfg))
    _tr, _va, te = corpus_fold_split("iemocap", 0, store.groups)
    _loss, y_true, y_pred = pretrain_mod._run_eval(
        eval_step, {k: v.cuda() for k, v in params.items()},
        PaddedBatchIterator(store.subset(te), cfg.batch_size, cfg.length_buckets), "cuda")
    if accuracy(y_true, y_pred) != logged:
        raise AssertionError(f"the reloaded .ckpt re-evaluates to test accuracy "
                             f"{accuracy(y_true, y_pred)}, logged {logged}")
    info = dict(cli_seconds=sec, **probe.summary(), epochs=len(history["epochs"]),
                test_accuracy=logged, val_acc=history["val_acc"],
                train_loss=history["train_loss"])
    print("experiments: pretrain " + json.dumps(info), flush=True)
    compare = pretrain_card_against_cpu(cfg, store)
    print(f"experiments: pretrain card vs CPU, {PRETRAIN_COMPARE_EPOCHS} epochs from one init "
          + json.dumps(compare), flush=True)
    del store
    return dict(ckpt=ckpt, info=info, card_vs_cpu=compare)


class ExperimentProbe:
    """Around a sweep's experiments (``target.name``, the runner the suite
    calls): each experiment's seconds, the device memory held when it starts
    and its peak (reset before it), and at each trainer's construction
    (``cls``) its student's pre_net and classifier on the host and its steps
    an epoch. No trainer is kept, so that the memory check sees what the
    sweep frees."""

    def __init__(self, target, name: str, cls):
        self.target, self.name, self.cls = target, name, cls
        self.experiments, self.trainers = [], []

    def __enter__(self) -> "ExperimentProbe":
        real, init, probe = getattr(self.target, self.name), self.cls.__init__, self

        def timed(*a, **kw):
            gc.collect()  # earlier phases' garbage out of the held bytes and the peak
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            row = real(*a, **kw)
            torch.cuda.synchronize()
            probe.experiments.append(dict(
                name=row["name"], seconds=time.perf_counter() - t0, held_gb=held / 1e9,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            return row

        def probed_init(obj, *a, **kw):
            init(obj, *a, **kw)
            student = obj.state.ssrl.student
            probe.trainers.append(dict(
                name=obj.experiment_name, resident=obj._resident is not None,
                steps_per_epoch=min(len(obj.clean_train),
                                    len(getattr(obj, "noisy_wav_train", obj.noisy_train))),
                student={k: v.detach().cpu().clone() for k, v in student.items()}))

        self._saved = (real, self.cls.__dict__.get("__init__"))
        setattr(self.target, self.name, timed)
        self.cls.__init__ = probed_init
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.target, self.name, self._saved[0])
        if self._saved[1] is None:
            del self.cls.__init__
        else:
            self.cls.__init__ = self._saved[1]

    def check_memory(self, what: str) -> None:
        """The memory held at each experiment's start and its peak do not
        grow past the first experiment's (PEAK_GROWTH)."""
        first = self.experiments[0]
        for e in self.experiments[1:]:
            if e["held_gb"] > first["held_gb"] * (1 + PEAK_GROWTH) + 1e-3 or \
                    e["peak_gb"] > first["peak_gb"] * (1 + PEAK_GROWTH):
                raise AssertionError(f"{what}: device memory grew from experiment to "
                                     f"experiment: {self.experiments}")


def check_rows(path: str, names: list, what: str) -> list:
    with open(path) as f:
        rows = json.load(f)
    if [r["name"] for r in rows] != names or any("error" in r for r in rows):
        raise AssertionError(f"{what}: rows {rows}")
    return rows


def run_ablation(root: str, manifests: str, ckpt: str, pm_ckpt: str, clips: int) -> dict:
    """``cli ablation --from-wav`` (bf16, attention through the kernel, the
    corpus resident) over two experiments of the standard suite: rc 0, the
    rows, one shared startup (the attention launches), each student at its
    first step the pretrain .ckpt, DACP off in no_dacp, memory not growing."""
    out = f"{root}/ablation/ablation_results.json"
    names = ["full_method", "no_dacp"]
    zero_kernel_launches()
    with StartupProbe() as startup, \
            ExperimentProbe(ablation_mod, "run_single_fused_experiment",
                            FusedCrossDomainTrainer) as probe:
        sec = timed_cli(["ablation", "--corpus", "iemocap", "--from-wav", manifests,
                         "--checkpoint", ckpt, "--weights", pm_ckpt, "--suite", "standard",
                         "--experiments", ",".join(names), "--fold", "0", "--epochs",
                         str(EXPERIMENT_EPOCHS), "--warmup-epochs", "1", "--snr", "10",
                         "--output", out])
    launches = kernel_launches()
    rows = check_rows(out, names, "ablation")
    if not all("noisy_wa" in r for r in rows) or not os.path.exists(out[:-5] + ".md"):
        raise AssertionError(f"ablation: noisy_wa not scraped or no .md: {rows}")
    passes = sum(1 for name, _s in startup.stages if name == "extraction")
    steps = sum(EXPERIMENT_EPOCHS * t["steps_per_epoch"] for t in probe.trainers)
    batches = -(-clips // EXTRACT_BATCH)
    want = dict(flash_attention=12 * (2 * batches + steps), fused_layernorm=0,
                fused_conv_ln_gelu=0, copy_rows=0)
    if passes != 2 or launches != want:
        raise AssertionError(f"ablation: {passes} extraction passes, kernel launches {launches}, "
                             f"expected 2 and {want} (12 x (2 x {batches} + {steps} steps))")
    pretrained = load_pretrain_head_checkpoint(pm_ckpt)
    for t in probe.trainers:
        if not (t["resident"] and all(torch.equal(t["student"][f"encoder.pre_net.{k}"],
                                                  pretrained[f"pre_net.{k}"])
                                      and torch.equal(t["student"][f"classifier.fc_layer.{k}"],
                                                      pretrained[f"post_net.{k}"])
                                      for k in ("weight", "bias"))):
            raise AssertionError(f"ablation {t['name']}: not resident, or its student at step "
                                 "0 is not the pretrain .ckpt")
    hist = {}
    for r in rows:
        with open(f"{r['results_dir']}/reports/training_history.json") as f:
            hist[r["name"]] = json.load(f)
    off = np.asarray(hist["no_dacp"]["dacp_ema_thresholds"])
    on = np.asarray(hist["full_method"]["dacp_ema_thresholds"])
    if not (off.size and np.all(off == 0.5) and np.any(on != 0.5)):
        raise AssertionError(f"ablation: DACP thresholds full_method {on.tolist()}, "
                             f"no_dacp {off.tolist()} (DACP off keeps 0.5)")
    probe.check_memory("ablation")
    info = dict(cli_seconds=sec, startup_s=startup.summary(), experiments=probe.experiments,
                steps=steps, attention_launches=launches["flash_attention"],
                rows=[{k: r[k] for k in ("name", "noisy_wa", "noisy_wf1", "clean_wa", "epoch")}
                      for r in rows],
                dacp_thresholds=dict(full_method=on.tolist(), no_dacp=off.tolist()))
    print("experiments: ablation --from-wav " + json.dumps(info), flush=True)
    return dict(launches=launches["flash_attention"], info=info,
                fold_dir=rows[0]["results_dir"])


def run_sensitivity(root: str, stores: dict, pm_ckpt: str) -> dict:
    """``cli sensitivity`` on phase 10's stores (feature mode, resident, no
    kernel on it) over two values of WEIGHT_ECDA: rc 0, two rows, no error."""
    out_dir = f"{root}/sensitivity"
    zero_kernel_launches()
    with ExperimentProbe(sensitivity_mod, "run_single_experiment",
                         dad_trainer.CrossDomainTrainer) as probe:
        sec = timed_cli(["sensitivity", "--corpus", "iemocap", "--clean", stores["clean"],
                         "--noisy", stores["noisy"], "--weights", pm_ckpt, "--knob",
                         "WEIGHT_ECDA", "--values", "0.0,0.5", "--epochs",
                         str(EXPERIMENT_EPOCHS), "--warmup-epochs", "1", "--output-dir",
                         out_dir])
    rows = check_rows(f"{out_dir}/sensitivity_WEIGHT_ECDA.json",
                      ["sens_WEIGHT_ECDA_0.0", "sens_WEIGHT_ECDA_0.5"], "sensitivity")
    if any(kernel_launches().values()) or not all(t["resident"] for t in probe.trainers):
        raise AssertionError(f"sensitivity: kernels {kernel_launches()}, resident "
                             f"{[t['resident'] for t in probe.trainers]}")
    probe.check_memory("sensitivity")
    info = dict(cli_seconds=sec, points=probe.experiments,
                rows=[{k: r.get(k) for k in ("name", "value", "noisy_wa", "epoch")}
                      for r in rows])
    print("experiments: sensitivity " + json.dumps(info), flush=True)
    return info


def embedding_card_against_cpu(noisy_dir: str, pm_ckpt: str, dad_pth: str) -> dict:
    """The tsne embedding pass (``DADHead.embed``) for both param sets of
    ``analyze --kind tsne`` over the noisy store's fold-0 test split, on the
    card and on the CPU, within EMBED_CARD_CPU_TOL."""
    cfg = dad_preset("iemocap")
    store = load_feature_store(noisy_dir, cfg.label_map)
    _tr, _va, te = corpus_fold_split("iemocap", 0, store.groups)
    sub = store.subset(te)
    _h, fresh = init_ssrl(torch.Generator().manual_seed(0), cfg.input_dim, cfg.hidden_dim)
    sets = {"pretrain": load_pretrain_into_ssrl(fresh, load_pretrain_head_checkpoint(pm_ckpt))
            .student, "dad": torch_state_dict_to_ssrl(load_torch_file(dad_pth)).student}
    out = {}
    for name, params in sets.items():
        res = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[device] = tsne_mod.embed_all(tsne_mod.make_embedder(cfg, params, device),
                                             PaddedBatchIterator(sub, cfg.batch_size,
                                                                 cfg.length_buckets), device)
            res[f"{device}_s"] = time.perf_counter() - t0
        (X, y), (X_cpu, y_cpu) = res["cuda"], res["cpu"]
        if not (np.array_equal(y, y_cpu) and close(X, X_cpu, EMBED_CARD_CPU_TOL)):
            raise AssertionError(f"tsne embedding {name}: card vs CPU beyond "
                                 f"{EMBED_CARD_CPU_TOL}: {np.abs(X - X_cpu).max()}")
        out[name] = dict(clips=len(y), card_s=res["cuda_s"], cpu_s=res["cpu_s"],
                         max_abs_diff=float(np.abs(X - X_cpu).max()))
    if importlib.util.find_spec("sklearn") is None:
        try:
            tsne_mod.analyze_tsne(cfg, sub, sets, "tsne-unused", device="cuda")
        except ImportError as e:
            if "scikit-learn" not in str(e):
                raise
        else:
            raise AssertionError("analyze_tsne ran without scikit-learn")
        print("experiments: analyze --kind tsne not run: scikit-learn is not installed here "
              "(its embedding pass, above, is the device's half; it raised ImportError "
              "naming scikit-learn)", flush=True)
    else:
        print("experiments: analyze --kind tsne not run: t-SNE of the corpus on the host "
              "takes minutes (its embedding pass, above, is the device's half)", flush=True)
    return out


def logmel_card_against_cpu(manifests: str) -> dict:
    """Log-mel of one batch of the corpus (16 clips cut or padded to 4 s)
    on the card against the CPU: the mel power within LOGMEL_FRAME_REL_TOL
    of each frame's largest."""
    root, files = read_manifest(manifests)
    n = 4 * SAMPLE_RATE
    wav = np.zeros((16, n), np.float32)
    for i, (rel, _frames) in enumerate(files[:16]):
        x, _sr = read_wav(os.path.join(root, rel))
        wav[i, :min(n, len(x))] = x[:n]
    cpu = features_mod.log_mel_spectrogram(torch.from_numpy(wav)).double()
    card = features_mod.log_mel_spectrogram(torch.from_numpy(wav).cuda()).cpu().double()
    p_cpu, p_card = cpu.exp(), card.exp()
    peak = p_cpu.amax(dim=-1, keepdim=True)
    rel = float(((p_card - p_cpu).abs() / peak).max())
    near = p_cpu >= 1e-6 * peak  # within 60 dB of the frame's peak
    out = dict(shape=list(card.shape), power_max_diff_over_frame_peak=rel,
               log_max_abs_diff=float((card - cpu).abs().max()),
               log_max_abs_diff_within_60db=float((card - cpu).abs()[near].max()))
    if not (card.shape == cpu.shape == (16, 1 + (n - 400) // 160, 80)
            and rel <= LOGMEL_FRAME_REL_TOL):
        raise AssertionError(f"log-mel card vs CPU: {json.dumps(out)}")
    return out


def run_experiments(root: str, manifests: str, ckpt: str, stores: dict) -> dict:
    """Phase 11: ``cli pretrain`` (card, then card vs CPU), ``cli ablation
    --from-wav`` through the attention kernel, ``cli sensitivity`` on the
    stores, ``cli analyze`` (dacp, disagreement, bias on the full_method
    fold; distribution on the clean store), the tsne embedding pass card vs
    CPU and log-mel card vs CPU."""
    t0 = time.perf_counter()
    _root, files = read_manifest(manifests)
    pre = run_pretrain(root, stores["clean"])
    abl = run_ablation(root, manifests, ckpt, pre["ckpt"], len(files))
    sens = run_sensitivity(root, stores, pre["ckpt"])
    analyze = {}
    for kind in ("dacp", "disagreement", "bias", "distribution"):
        src = (["--feat-dir", stores["clean"]] if kind == "distribution"
               else ["--results-dir", abl["fold_dir"]])
        out = f"{root}/analysis/{kind}"
        analyze[kind] = timed_cli(["analyze", "--kind", kind, *src, "--out-dir", out])
        if not os.path.exists(f"{out}/{SUMMARIES[kind]}"):
            raise AssertionError(f"analyze --kind {kind} wrote no {SUMMARIES[kind]}")
    print("experiments: analyze seconds " + json.dumps(analyze), flush=True)
    embed = embedding_card_against_cpu(
        stores["noisy"], pre["ckpt"], f"{abl['fold_dir']}/models/iemocap_cross_domain_best.pth")
    print("experiments: tsne embedding pass, card vs CPU " + json.dumps(embed), flush=True)
    logmel = logmel_card_against_cpu(manifests)
    print("experiments: log-mel, card vs CPU " + json.dumps(logmel), flush=True)
    print(f"experiments: phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=abl["launches"], pretrain=pre["info"], ablation=abl["info"],
                sensitivity=sens, analyze_s=analyze, embedding=embed, logmel=logmel)


# phase 12, d2v pretraining at the JAX defaults and full width (bf16,
# B 16, 10 s crops, clone_batch 8, span masks at 0.7), cut in steps only:
# 40 steps with a 10-step warmup, validation every 20 steps on Session 5
D2V_STEPS, D2V_WARMUP, D2V_VALID_EVERY, D2V_CKPT_EVERY = 40, 10, 20, 20
D2V_PROFILE_STEP = 30  # the step profiled with torch.profiler (its spacing left out)
# the agreement runs: 3 steps from one init over 48 clips of Sessions 1-4.
# The card's backward is not bitwise deterministic (scatter-adds by atomics
# in the gathers' backward, cuDNN's weight gradients), so each pair is held
# within D2V_DRIFT_FACTOR x the drift between two identical runs of the same
# call (and reported bit-equal where it is)
D2V_AGREE_STEPS, D2V_AGREE_CLIPS, D2V_DRIFT_FACTOR = 3, 48, 4.0
D2V_HIST_KEYS = ("loss", "d2v_loss", "cls_loss", "target_var", "pred_var")
# card vs CPU: f32, B 2, 2 s crops, clone_batch 2, encoder dropout off (the
# CUDA and CPU generators draw different streams), the masks, mask tokens
# and decoder-input dropout fed as D2vDraws; phase 11's pretrain criterion.
# A key projection's bias has no gradient (softmax ignores a constant per
# query), so Adam turns rounding noise there into steps of about lr: those
# slices are held to 2 lr a step instead
D2V_CPU_CROP, D2V_CPU_B, D2V_CPU_CLONE, D2V_CPU_STEPS = 32000, 2, 2, 2


def write_d2v_manifests(manifests: str, out: str) -> dict:
    """The d2v phase's manifests from phase 10's: ``full`` (train.tsv:
    Sessions 1-4, valid.tsv: Session 5) and ``small`` (train.tsv: the first
    D2V_AGREE_CLIPS clips of Sessions 1-4 that the d2v dataset keeps, 2 s
    or longer)."""
    root, files = read_manifest(manifests)
    train = [(r, n) for r, n in files if "Ses05" not in r]
    valid = [(r, n) for r, n in files if "Ses05" in r]
    min_n = D2vPretrainConfig().min_sample_size
    small = [(r, n) for r, n in train if n >= min_n][:D2V_AGREE_CLIPS]
    dirs = {}
    for name, splits in (("full", {"train": train, "valid": valid}), ("small", {"train": small})):
        d = dirs[name] = f"{out}/{name}"
        os.makedirs(d)
        for split, rows in splits.items():
            with open(f"{d}/{split}.tsv", "w") as f:
                f.write(root + "\n" + "".join(f"{r}\t{n}\n" for r, n in rows))
    return dict(dirs, train_clips=len(train), valid_clips=len(valid), valid_files=valid,
                root=root)


def d2v_step_flops(cfg: EncoderConfig, pcfg, batch: int, frames: int, keep: int) -> dict:
    """Matmul and convolution FLOPs of one d2v update, derived from the
    shapes (2 per multiply-add; elementwise work not counted): the conv
    front end and projection once per clip, forward and backward (x3); the
    teacher's positional conv and blocks forward only (x1) over every frame
    of B clips; the student's positional conv (all frames), blocks (the kept
    tokens) and decoder (all frames) over B x clone_batch rows, x3."""
    e, h = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    rows = batch * pcfg.clone_batch
    n, c_in, front = pcfg.crop_size, 1, 0.0
    for dim, k, s in cfg.conv_feature_layers:
        n = (n - k) // s + 1
        front += 2.0 * batch * n * dim * c_in * k
        c_in = dim
    front += 2.0 * batch * frames * c_in * e
    kpos = max(3, cfg.conv_pos_width // cfg.conv_pos_depth)
    pos = 2.0 * frames * e * (e // cfg.conv_pos_groups) * kpos * cfg.conv_pos_depth

    def blocks(tokens_per_row: int) -> float:
        dense = 2.0 * (e * 3 * e + e * e + 2 * e * h)
        attn = 2.0 * 2 * tokens_per_row * e
        return tokens_per_row * (dense + attn) * (cfg.prenet_depth + cfg.depth)

    dc = pcfg.decoder
    dec, c = 0.0, e
    for _ in range(dc.decoder_layers):
        dec += 2.0 * frames * dc.decoder_dim * (c // dc.decoder_groups) * dc.decoder_kernel
        c = dc.decoder_dim
    dec += 2.0 * frames * c * e
    teacher = batch * (pos + blocks(frames))
    student = rows * (pos + blocks(keep) + dec)
    total = 3 * front + teacher + 3 * student
    return dict(total=total, front_end=3 * front, teacher=teacher, student=3 * student)


class D2vProbe:
    """Measures ``cli d2v-pretrain`` from outside: a CUDA event recorded
    before every train step (their spacing is the device's time a step,
    idle gaps included), the host time of the first step, a torch.profiler
    breakdown of step D2V_PROFILE_STEP, the host seconds of each
    validation pass (the valid dataset's epoch, which ends in a host read
    of every batch's loss), of each checkpoint write, of the corpus decode
    and of its commit to the card. Undone on exit."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.events, self.first_step_t, self.prof = [], None, None
        self.valid_s, self.ckpt_s, self.startup = [], [], {}

    def __enter__(self) -> "D2vProbe":
        probe = self
        self._saved = (d2v_models.make_d2v_train_step, d2v_train_mod.WavCropDataset.batches,
                       d2v_train_mod.save_train_state, d2v_train_mod.WavCropDataset.load_all_audio,
                       resident_mod.resident_from_flat)
        make, batches, save, load_all, commit = self._saved

        def make_probed(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(*a, **kw):
                if probe.first_step_t is None:
                    probe.first_step_t = time.perf_counter()
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                probe.events.append(event)
                if probe.profile and len(probe.events) == D2V_PROFILE_STEP:
                    out = []
                    probe.prof = profile_step(lambda: out.append(step(*a, **kw)))
                    return out[0]
                return step(*a, **kw)

            return timed

        def timed_batches(ds, *a, **kw):
            t0 = time.perf_counter()
            yield from batches(ds, *a, **kw)
            probe.valid_s.append(time.perf_counter() - t0)

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            save(*a, **kw)
            probe.ckpt_s.append((os.path.basename(a[0]), time.perf_counter() - t0))

        def timed_load_all(ds):
            t0 = time.perf_counter()
            out = load_all(ds)
            probe.startup["decode_s"] = time.perf_counter() - t0
            return out

        def timed_commit(*a, **kw):
            t0 = time.perf_counter()
            out = commit(*a, **kw)
            torch.cuda.synchronize()
            probe.startup["resident_commit_s"] = time.perf_counter() - t0
            probe.startup["resident_mb"] = out.flat.nbytes / 1e6
            return out

        d2v_models.make_d2v_train_step = make_probed
        d2v_train_mod.WavCropDataset.batches = timed_batches
        d2v_train_mod.save_train_state = timed_save
        d2v_train_mod.WavCropDataset.load_all_audio = timed_load_all
        resident_mod.resident_from_flat = timed_commit
        return self

    def __exit__(self, *exc) -> None:
        (d2v_models.make_d2v_train_step, d2v_train_mod.WavCropDataset.batches,
         d2v_train_mod.save_train_state, d2v_train_mod.WavCropDataset.load_all_audio,
         resident_mod.resident_from_flat) = self._saved

    def step_ms(self) -> list:
        """Spacing of consecutive step events: step i's entry is the time
        from step i's start to step i+1's (1-based)."""
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def d2v_history(save_dir: str) -> tuple:
    with open(f"{save_dir}/d2v_training_history.json") as f:
        hist = json.load(f)
    steps = [e for e in hist if "loss" in e]
    valid = [e for e in hist if "valid_loss" in e]
    return steps, valid


def run_d2v_main(dirs: dict, ckpt: str, out: str) -> dict:
    """``cli d2v-pretrain`` at the JAX defaults, full width, resident auto,
    from phase 9's checkpoint; its checks and measures."""
    cfg = EncoderConfig()  # the d2v default: bf16, plain attention (the kernel is forward-only)
    pcfg = D2vPretrainConfig()
    argv = ["d2v-pretrain", "--manifests", dirs["full"], "--save-dir", out, "--init-checkpoint",
            ckpt, "--steps", str(D2V_STEPS), "--warmup-steps", str(D2V_WARMUP),
            "--valid-manifests", dirs["full"], "--valid-every", str(D2V_VALID_EVERY),
            "--log-every", "1", "--checkpoint-every", str(D2V_CKPT_EVERY)]
    gc.collect()
    torch.cuda.empty_cache()
    zero_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' tensors, in the peak
    with D2vProbe(profile=True) as probe:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel_launches()
    if rc != 0:
        raise AssertionError(f"cli d2v-pretrain returned {rc}")
    if any(launches.values()):
        raise AssertionError(f"d2v training launched a kernel: {launches} (the attention "
                             "kernel is forward-only and must stay off a differentiated step)")
    if "resident_mb" not in probe.startup:
        raise AssertionError("--resident auto did not engage the resident corpus")
    steps, valid = d2v_history(out)
    if [e["step"] for e in steps] != list(range(1, D2V_STEPS + 1)):
        raise AssertionError(f"history steps {[e['step'] for e in steps]}: the run stopped early "
                             "(a collapse guard fired?)")
    vals = np.array([[e[k] for k in D2V_HIST_KEYS] for e in steps] + [[e["valid_loss"]] * 5
                                                                      for e in valid])
    if not np.isfinite(vals).all():
        raise AssertionError("non-finite d2v history")
    if any(e["target_var"] < pcfg.min_target_var or e["pred_var"] < pcfg.min_pred_var
           for e in steps):
        raise AssertionError("a collapse guard's statistic fell under its limit")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"loss did not fall: step 1 {steps[0]['loss']:.4f}, step "
                             f"{D2V_STEPS} {steps[-1]['loss']:.4f}")
    if [e["step"] for e in valid] != list(range(D2V_VALID_EVERY, D2V_STEPS + 1, D2V_VALID_EVERY)):
        raise AssertionError(f"validation at steps {[e['step'] for e in valid]}")
    best = d2v_train_mod.load_pretrained_encoder(out, cfg, "cuda")
    best.load_state_dict(torch.load(f"{out}/encoder_params_best.pt", map_location="cuda",
                                    weights_only=True))
    del best
    # steps 5-39 by their spacing to the next step's event, less the
    # profiled step and the steps followed by a validation or a checkpoint
    ms = probe.step_ms()
    busy = {D2V_PROFILE_STEP} | set(range(D2V_VALID_EVERY, D2V_STEPS, D2V_VALID_EVERY)) | set(
        range(D2V_CKPT_EVERY, D2V_STEPS, D2V_CKPT_EVERY))
    kept = [m for i, m in enumerate(ms, start=1) if i >= 5 and i not in busy]
    frames = conv_frames(pcfg.crop_size, cfg.conv_feature_layers)
    n_masked = span_mask_counts(frames, pcfg.mask_prob, pcfg.mask_length)[1]
    keep = frames - n_masked
    flops = d2v_step_flops(cfg, pcfg, pcfg.batch_size, frames, keep)
    median = float(np.median(kept))
    info = dict(
        step_ms_median=median, step_ms_min=min(kept), step_ms_max=max(kept), steps_timed=len(kept),
        student_tokens_per_step=pcfg.batch_size * pcfg.clone_batch * keep,
        student_tokens_per_s=pcfg.batch_size * pcfg.clone_batch * keep / (median / 1e3),
        teacher_frames_per_step=pcfg.batch_size * frames,
        flops_per_step_derived=flops,
        flops_share_of_bf16_peak=flops["total"] / (median / 1e3) / PEAK_FLOPS[torch.bfloat16],
        peak_device_gb=peak_gb, held_before_gb=held_gb,
        startup_s=probe.first_step_t - t0, **probe.startup,
        valid_pass_s=probe.valid_s, checkpoint_write_s=probe.ckpt_s, run_s=run_s,
        loss_first=steps[0]["loss"], loss_last=steps[-1]["loss"],
        valid_loss=[e["valid_loss"] for e in valid],
        target_var_min=min(e["target_var"] for e in steps),
        pred_var_min=min(e["pred_var"] for e in steps),
    )
    print("d2v: main run " + json.dumps(info), flush=True)
    print("d2v: profile of step " + str(D2V_PROFILE_STEP) + " " + json.dumps(probe.prof),
          flush=True)
    return info


def d2v_agree_run(name: str, manifests: str, ckpt: str, root: str, extra: list) -> dict:
    out = f"{root}/agree/{name}"
    argv = ["d2v-pretrain", "--manifests", manifests, "--save-dir", out, "--init-checkpoint",
            ckpt, "--steps", str(D2V_AGREE_STEPS), "--warmup-steps", "1", "--log-every", "1",
            "--checkpoint-every", "0", *extra]
    with D2vProbe() as probe:
        sec = timed_cli(argv)
    steps, _ = d2v_history(out)
    if [e["step"] for e in steps] != list(range(1, D2V_AGREE_STEPS + 1)):
        raise AssertionError(f"agreement run {name}: history steps {[e['step'] for e in steps]}")
    return dict(hist=np.array([[e[k] for k in D2V_HIST_KEYS] for e in steps], np.float64),
                params=torch.load(f"{out}/encoder_params.pt", weights_only=True),
                resident="resident_mb" in probe.startup, seconds=sec)


def d2v_diff(a: dict, b: dict) -> dict:
    return dict(history=float(np.abs(a["hist"] - b["hist"]).max()),
                params=max(float((a["params"][k].double() - b["params"][k].double()).abs().max())
                           for k in a["params"]))


def run_d2v_agreement(dirs: dict, ckpt: str, root: str) -> dict:
    """Two identical runs (the drift), then resident vs streamed,
    --scan-chunk 2 vs per-step, d2v-pack + --binarized vs the wav manifest
    and --remat vs none (dropout on: the default rates), each over 3 steps
    from one init."""
    small = dirs["small"]
    packed = f"{root}/agree/packed"
    pack_s = timed_cli(["d2v-pack", "--manifests", small, "--out-dirs", packed])
    runs = {
        "resident": d2v_agree_run("resident", small, ckpt, root, []),
        "resident_again": d2v_agree_run("resident_again", small, ckpt, root, []),
        "streamed": d2v_agree_run("streamed", small, ckpt, root, ["--resident", "off"]),
        "chunked": d2v_agree_run("chunked", small, ckpt, root, ["--scan-chunk", "2"]),
        "packed": d2v_agree_run("packed", packed, ckpt, root,
                                ["--binarized", "--resident", "off"]),
        "remat": d2v_agree_run("remat", small, ckpt, root, ["--remat"]),
    }
    if not (runs["resident"]["resident"] and runs["remat"]["resident"]) or any(
            runs[n]["resident"] for n in ("streamed", "chunked", "packed")):
        raise AssertionError("agreement runs: the resident corpus engaged where it should "
                             "not, or not where it should")
    drift = d2v_diff(runs["resident"], runs["resident_again"])
    tol = {k: D2V_DRIFT_FACTOR * v for k, v in drift.items()}
    pairs = {"resident vs streamed": ("resident", "streamed"),
             "scan-chunk 2 vs per-step": ("chunked", "streamed"),
             "packed vs wav": ("packed", "streamed"),
             "remat vs none": ("remat", "resident")}
    out = dict(drift=drift, tolerance=tol, pack_s=pack_s,
               seconds={n: r["seconds"] for n, r in runs.items()})
    for what, (a, b) in pairs.items():
        d = d2v_diff(runs[a], runs[b])
        d["bit_equal"] = d["history"] == 0.0 and d["params"] == 0.0
        out[what] = d
        if not all(d[k] <= tol[k] for k in tol):
            raise AssertionError(f"d2v {what}: {d} beyond {D2V_DRIFT_FACTOR} x the drift of "
                                 f"two identical runs {drift}")
    print("d2v: agreement over 3 steps " + json.dumps(out), flush=True)
    return out


def d2v_card_against_cpu(small: str, ckpt: str) -> dict:
    """2 steps on the card and on the CPU from one init with the same
    batch and the same draws; losses and parameters within
    PRETRAIN_CARD_CPU_TOL (key-projection biases within 2 lr a step)."""
    cfg = EncoderConfig(dtype="float32", encoder_dropout=0.0, attention_dropout=0.0,
                        post_mlp_drop=0.0)
    pcfg = D2vPretrainConfig(batch_size=D2V_CPU_B, crop_size=D2V_CPU_CROP,
                             clone_batch=D2V_CPU_CLONE, max_steps=D2V_CPU_STEPS, warmup_steps=1)
    model_c, tx_c, st = init_d2v_state(cfg, pcfg, torch.Generator().manual_seed(0), "cpu")
    params = {**st.params, **load_emotion2vec_checkpoint(ckpt, cfg)}
    st_c = st._replace(params=params, ema_blocks=init_ema_blocks(params, cfg, pcfg))
    model_g, tx_g, _ = init_d2v_state(cfg, pcfg, None, "cuda")
    st_g = d2v_train_mod.to_device(st_c, torch.device("cuda"))
    wav, pad = next(d2v_train_mod.WavCropDataset([small], pcfg).batches(0, D2V_CPU_B))
    rows = D2V_CPU_B * D2V_CPU_CLONE
    frames = conv_frames(pcfg.crop_size, cfg.conv_feature_layers)
    n_masked = span_mask_counts(frames, pcfg.mask_prob, pcfg.mask_length)[1]
    gen = torch.Generator().manual_seed(1)
    step_c, step_g = make_d2v_train_step(model_c, tx_c), make_d2v_train_step(model_g, tx_g)
    losses = []
    t0 = time.perf_counter()
    for _ in range(D2V_CPU_STEPS):
        draws = D2vDraws(
            mask=span_mask_uniforms(rows, frames, pcfg.mask_length, gen),
            din=draw_keep((rows, frames - n_masked, cfg.embed_dim), pcfg.decoder.input_dropout,
                          gen, "cpu"),
            dtok=torch.randn((rows, n_masked, cfg.embed_dim), generator=gen))
        st_c, m_c = step_c(st_c, torch.from_numpy(wav), torch.from_numpy(pad), None, draws)
        st_g, m_g = step_g(st_g, torch.from_numpy(wav).cuda(), torch.from_numpy(pad).cuda(), None,
                           d2v_train_mod.to_device(draws, torch.device("cuda")))
        losses.append((float(m_g["loss"]), float(m_c["loss"])))
    cpu_s = time.perf_counter() - t0
    tol = PRETRAIN_CARD_CPU_TOL
    bad = [(g, c) for g, c in losses if not close(g, c, tol)]
    lr_bound = 2 * pcfg.learning_rate * D2V_CPU_STEPS
    worst, worst_kbias = 0.0, 0.0
    for k, want in st_c.params.items():
        got = st_g.params[k].cpu()
        excess = ((got - want).abs() - tol["atol"] - tol["rtol"] * want.abs())
        if k.endswith("attn.qkv.bias"):  # the key slice: no gradient, Adam's noise steps
            e = cfg.embed_dim
            worst_kbias = max(worst_kbias, float((got - want)[e:2 * e].abs().max()))
            excess = torch.cat([excess[:e], excess[2 * e:]])
        worst = max(worst, float(excess.max()))
    out = dict(losses_card_cpu=losses, param_excess_over_tol=worst,
               key_bias_max_abs_diff=worst_kbias, key_bias_bound=lr_bound,
               cpu_and_card_seconds=cpu_s)
    if bad or worst > 0 or worst_kbias > lr_bound:
        raise AssertionError(f"d2v card vs CPU: {out}")
    print("d2v: card vs CPU, 2 steps " + json.dumps(out), flush=True)
    return out


def d2v_downstream(out: str, valid_files: list, root: str) -> dict:
    """The pretrained encoder (``load_pretrained_encoder``) extracting the
    Session 5 clips through the attention kernel (12 launches a batch of
    16), then the same weights through plain attention: each clip within
    FEAT_REL_TOL_BF16 (phase 9's limit)."""
    train_cfg = EncoderConfig()
    sd = d2v_train_mod.load_pretrained_encoder(out, train_cfg, "cuda").state_dict()
    clips = [read_wav(os.path.join(root, rel))[0].astype(np.float32) for rel, _n in valid_files]
    kern = FeatureExtractor(dataclasses.replace(train_cfg, use_flash_attention=True), sd,
                            batch_size=EXTRACT_BATCH)
    zero_kernel_launches()
    t0 = time.perf_counter()
    feats_k = kern.extract_clips(clips)
    kern_s = time.perf_counter() - t0
    launches = check_attention_launches("d2v downstream extraction", len(clips))
    del kern
    plain = FeatureExtractor(train_cfg, sd, batch_size=EXTRACT_BATCH)
    feats_p = plain.extract_clips(clips)
    if attention.flash_attention.launches != launches:
        raise AssertionError("the plain attention path launched the kernel")
    rel = [float(np.linalg.norm(k - p) / np.linalg.norm(p)) for k, p in zip(feats_k, feats_p)]
    if not all(np.isfinite(k).all() and k.shape == p.shape for k, p in zip(feats_k, feats_p)):
        raise AssertionError("d2v downstream: non-finite or misshapen features")
    info = dict(clips=len(clips), attention_launches=launches, kernel_pass_s=kern_s,
                clip_rel_err_max=max(rel), clip_rel_err_median=float(np.median(rel)))
    if not max(rel) <= FEAT_REL_TOL_BF16:
        raise AssertionError(f"d2v downstream: a clip's relative error {max(rel):.3e} > "
                             f"{FEAT_REL_TOL_BF16}: {info}")
    del plain
    torch.cuda.empty_cache()
    print("d2v: downstream extraction, kernel vs plain " + json.dumps(info), flush=True)
    return info


def run_d2v(root: str, manifests: str, ckpt: str) -> dict:
    """Phase 12: d2v pretraining on phase 9's corpus and checkpoint."""
    t0 = time.perf_counter()
    dirs = write_d2v_manifests(manifests, f"{root}/d2v_manifests")
    print(f"d2v: {dirs['train_clips']} train clips (Sessions 1-4), {dirs['valid_clips']} valid "
          "(Session 5)", flush=True)
    out = f"{root}/d2v"
    main_info = run_d2v_main(dirs, ckpt, out)
    agree = run_d2v_agreement(dirs, ckpt, f"{root}/d2v_agree")
    cpu = d2v_card_against_cpu(dirs["small"], ckpt)
    down = d2v_downstream(out, dirs["valid_files"], dirs["root"])
    print(f"d2v: phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=down["attention_launches"], main=main_info, agreement=agree,
                card_cpu=cpu, downstream=down)


# ---------------------------------------------------------------------------
# phase 13: the DAD paths over a (dp, tp) process grid

# 13(a): every PAR_EVERY-th clip of phase 9's corpus, PAR_EPOCHS epochs
PAR_EVERY, PAR_EPOCHS = 8, 2
# 13(b): the fused step at a global batch of PAR_B clips of 4 s, PAR_STEPS steps
PAR_B, PAR_STEPS = 16, 3


def subset_manifest(manifests: str, out: str, every: int) -> int:
    """Every ``every``-th clip of a manifest (train.tsv and its .emo
    sidecar, line by line) in ``out``; returns the clip count."""
    os.makedirs(out)
    with open(f"{manifests}/train.tsv") as f:
        root, *rows = f.read().splitlines()
    with open(f"{manifests}/train.emo") as f:
        emo = [line for line in f.read().splitlines() if line.strip()]
    if len(emo) != len(rows):
        raise AssertionError(f"manifest: {len(rows)} rows but {len(emo)} .emo lines")
    keep = range(0, len(rows), every)
    with open(f"{out}/train.tsv", "w") as f:
        f.write(root + "\n" + "".join(rows[i] + "\n" for i in keep))
    with open(f"{out}/train.emo", "w") as f:
        f.write("".join(emo[i] + "\n" for i in keep))
    return len(keep)


def run_worker(spec: dict, path: str, torchrun: bool = False, env=None,
               timeout: float = 300.0) -> subprocess.Popen:
    """This script as a worker process (``--worker``) on ``spec``, under
    ``torchrun`` (one process, the standalone rendezvous) if asked."""
    with open(path, "w") as f:
        json.dump(spec, f)
    me = os.path.abspath(__file__)
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", me] if torchrun else [sys.executable, me])
    return subprocess.Popen(cmd + ["--worker", path], env={**os.environ, **(env or {})},
                            cwd=spec.get("cwd"))


def wait_workers(procs: list, what: str, timeout: float = 300.0) -> None:
    """Waits for every worker; kills the rest and raises if one fails."""
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            if rc != 0:
                raise AssertionError(f"{what}: worker exited with {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def cli_worker(spec: dict) -> None:
    """13(a) in a worker process: ``cli.main(argv)`` under a
    ``TrainerProbe``, with the process group's backend recorded."""
    import torch.distributed as dist

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
        mesh as mesh_mod,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seen = {}
    make = mesh_mod.make_mesh

    def spy(*a, **kw):
        m = make(*a, **kw)
        seen.update(backend=dist.get_backend(), dp=m.dp, tp=m.tp, device=str(m.device))
        return m

    mesh_mod.make_mesh = spy
    zero_kernel_launches()
    probe = TrainerProbe(fused_trainer, FusedCrossDomainTrainer,
                         {"make_fused_extract_train_step": batch_bytes,
                          "make_resident_fused_step": index_bytes})
    with probe:
        t0 = time.perf_counter()
        rc = cli.main(spec["argv"])
        run_s = time.perf_counter() - t0
    trainer = probe.trainers[-1]
    ms = probe.step_ms(PAR_EPOCHS - 1)
    out = dict(rc=rc, run_s=run_s, mesh=seen, resident=trainer._resident is not None,
               results_dir=os.path.abspath(trainer.results_dir),
               step_ms=float(np.median(ms)), step_ms_range=[min(ms), max(ms)], steps=len(ms) + 1,
               launches=kernel_launches())
    with open(spec["out"], "w") as f:
        json.dump(out, f)


def run_parallel_cli(root: str, manifests: str, ckpt: str) -> dict:
    """13(a): ``cli dad --from-wav --dp 1`` under ``torchrun
    --nproc_per_node 1`` (NCCL) against the same command without
    ``torchrun`` and without ``--dp``, each in a worker process of its own,
    on a subset of phase 9's corpus: the same history, best checkpoint and
    test report, bit for bit."""
    sub = f"{root}/par_manifests"
    clips = subset_manifest(manifests, sub, PAR_EVERY)
    argv = ["dad", "--corpus", "iemocap", "--from-wav", sub, "--checkpoint", ckpt,
            "--fold", "0", "--epochs", str(PAR_EPOCHS), "--warmup-epochs", "1", "--snr", "10"]
    runs = {}
    for name, extra, torchrun in (("plain", [], False), ("nccl_world1", ["--dp", "1"], True)):
        cwd = f"{root}/par_{name}"
        os.makedirs(cwd)
        spec = dict(kind="cli", argv=argv + extra, cwd=cwd, out=f"{cwd}/worker.json")
        t0 = time.perf_counter()
        wait_workers([run_worker(spec, f"{cwd}/spec.json", torchrun=torchrun)],
                     f"13(a) {name}")
        with open(spec["out"]) as f:
            runs[name] = dict(json.load(f), wall_s=time.perf_counter() - t0)
    plain, nccl = runs["plain"], runs["nccl_world1"]
    if plain["rc"] != 0 or nccl["rc"] != 0:
        raise AssertionError(f"13(a): cli dad returned {plain['rc']} / {nccl['rc']}")
    if nccl["mesh"].get("backend") != "nccl" or (nccl["mesh"]["dp"], nccl["mesh"]["tp"]) != (1, 1):
        raise AssertionError(f"13(a): expected a (1, 1) NCCL mesh, got {nccl['mesh']}")
    if plain["mesh"] or not (plain["resident"] and nccl["resident"]):
        raise AssertionError("13(a): the runs' meshes or resident corpora are not as meant")
    same = {}
    for rel in ("reports/training_history.json", "reports/FINAL_test_set_results.json"):
        with open(f"{plain['results_dir']}/{rel}") as f, open(f"{nccl['results_dir']}/{rel}") as g:
            a, b = json.load(f), json.load(g)
        for d in (a, b):  # the final report's own clock
            d.get("info", {}).pop("timestamp", None)
        same[rel] = a == b
    pth = "models/iemocap_cross_domain_best.pth"
    a, b = (load_torch_file(f"{r['results_dir']}/{pth}") for r in (plain, nccl))
    same[pth] = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    if not all(same.values()):
        raise AssertionError(f"13(a): the world-1 NCCL run differs from the plain run: {same}")
    for r in (plain, nccl):
        attn = r["launches"]["flash_attention"]
        if attn <= 0 or attn % 12:
            raise AssertionError(f"13(a): {attn} attention launches, not 12 per encoder pass")
    out = dict(clips=clips, epochs=PAR_EPOCHS, bit_equal=same,
               **{n: {k: r[k] for k in ("step_ms", "step_ms_range", "steps", "run_s", "wall_s",
                                        "mesh", "launches")} for n, r in runs.items()})
    print("parallel: world-1 " + json.dumps(out), flush=True)
    return dict(launches=plain["launches"]["flash_attention"]
                + nccl["launches"]["flash_attention"], **out)


def parallel_inputs():
    """13(b)'s full-width encoder (seeded fairseq weights, bf16, attention
    through the kernel), its DAD config and a global batch pair: 4 s wavs,
    the last noisy row a filler row. The same in every process."""
    enc_cfg = EncoderConfig(dtype="bfloat16", use_flash_attention=True)
    enc_sd = fairseq_to_torch_encoder(random_fairseq_state_dict(enc_cfg, seed=0), enc_cfg)
    dad_cfg = dad_preset("iemocap", {f"dacp.{k}": v for k, v in DACP_OPEN.items()},
                         batch_size=PAR_B, warmup_epochs=1, ecda_start_epoch=1)
    cfg = FusedConfig(encoder=enc_cfg, dad=dad_cfg, inject_snr_db=10.0, cache_clean_features=True)
    rng = np.random.default_rng(13)
    T = TRAIN_T
    lengths = rng.integers(T // 2, T + 1, PAR_B)
    lengths[0] = T

    def batch(labeled: bool, filler: bool) -> FusedBatch:
        wav = (rng.normal(size=(PAR_B, T)) * 0.1).astype(np.float32)
        mask = np.arange(T)[None, :] >= lengths[:, None]
        valid = np.ones(PAR_B, bool)
        if filler:
            mask[-1], valid[-1] = True, False
        wav[mask] = 0.0
        labels = rng.integers(0, 4, PAR_B) if labeled else np.full(PAR_B, -1)
        return FusedBatch(*(torch.from_numpy(x).cuda() for x in (wav, mask, labels, valid)),
                          ids=torch.arange(PAR_B, device="cuda") if not labeled else None)

    return enc_cfg, enc_sd, cfg, batch(True, False), batch(False, True)


def parallel_steps(cfg, enc_sd, clean, noisy, mesh=None) -> dict:
    """PAR_STEPS fused steps (epochs 2-4, after warmup: consistency and ECDA
    weigh) from one seeded head state and a generator seeded alike; over
    ``mesh`` the rank's view."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
        place_fused,
    )

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
        init_dad_train_state,
    )

    head, tx, state = init_dad_train_state(cfg.dad, torch.Generator("cuda").manual_seed(3),
                                           device=torch.device("cuda", 0))
    if mesh is None:
        encoder, *_ = init_fused(cfg, enc_sd, device="cuda")
    else:
        encoder, state = place_fused(cfg, enc_sd, state, mesh)
    step = make_fused_extract_train_step(encoder, head, tx, cfg, mesh)
    gen = torch.Generator("cuda").manual_seed(4)
    student0 = {k: v.float().cpu() for k, v in state.ssrl.student.items()}
    zero_kernel_launches()
    metrics, scores = [], []
    for epoch in range(2, 2 + PAR_STEPS):
        state, m = step(state, clean, noisy, StepScalars.for_epoch(cfg.dad, epoch),
                        torch.zeros(4, device="cuda"), gen)
        metrics.append({k: float(v) for k, v in m.items() if k != "tracking"})
        scores.append(m["tracking"]["certainty_score"].float().cpu().numpy().tolist())
    return dict(metrics=metrics, scores=scores, launches=kernel_launches()["flash_attention"],
                update={k: v.float().cpu() - student0[k] for k, v in state.ssrl.student.items()},
                dacp={k: v.float().cpu() for k, v in state.dacp._asdict().items()})


def rank_worker(spec: dict) -> None:
    """13(b) in one of two processes on ``cuda:0``, over gloo: collective
    probes, extraction at (dp, tp) = (1, 2), fused steps at (2, 1) and
    (1, 2). Writes its results with ``torch.save``."""
    import torch.distributed as dist

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
        make_mesh,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    enc_cfg, enc_sd, cfg, clean, noisy = parallel_inputs()
    cached = torch.load(spec["cached"])
    clean_feats = CleanFeatureBatch(*(x.cuda() for x in cached))
    out = {}
    mesh = make_mesh(2, tp=1, backend="gloo", device="cuda:0")
    probe = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((4,), float(mesh.rank + 1), dtype=dtype, device="cuda")
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        dist.all_reduce(x)
        probe[str(dtype)] = dict(all_reduce=x.float().cpu().tolist(),
                                 all_gather=torch.cat(parts).float().cpu().tolist())
    out["probe"] = probe
    out["fused_21"] = parallel_steps(cfg, enc_sd, clean_feats, noisy, mesh)
    mesh = make_mesh(2, tp=2, backend="gloo", device="cuda:0")
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
        FeatureExtractor as Extractor,
    )

    ex = Extractor(enc_cfg, enc_sd, batch_size=PAR_B, mesh=mesh)
    zero_kernel_launches()
    feats, _ = ex.forward_batch(noisy.wav, noisy.wav_mask)
    out["extract_12"] = dict(feats=feats.cpu(), launches=kernel_launches()["flash_attention"],
                             heads=ex.model.block_0.attn.num_heads)
    del ex
    out["fused_12"] = parallel_steps(cfg, enc_sd, clean_feats, noisy, mesh)
    torch.save(out, spec["out"])
    dist.destroy_process_group()


def run_two_ranks(root: str) -> dict:
    """13(b): two processes on the one card over gloo, through the library
    API, held against one process at the global batch: extraction at
    (dp, tp) = (1, 2) (attention through the kernel on 6 heads a rank) and
    PAR_STEPS fused steps at (2, 1) and (1, 2)."""
    enc_cfg, enc_sd, cfg, clean, noisy = parallel_inputs()
    enc = FeatureExtractor(enc_cfg, enc_sd, batch_size=PAR_B)
    cached = precompute_clean_features(enc.model, cfg, clean)
    torch.save(tuple(x.cpu() for x in cached), f"{root}/cached.pt")
    zero_kernel_launches()
    want_feats, fmask = enc.forward_batch(noisy.wav, noisy.wav_mask)
    single_launches = kernel_launches()["flash_attention"]
    del enc
    single = parallel_steps(cfg, enc_sd, cached, noisy)
    torch.cuda.empty_cache()
    port = str(_free_port())
    procs, outs = [], []
    for rank in range(2):
        spec = dict(kind="ranks", cached=f"{root}/cached.pt", out=f"{root}/rank{rank}.pt")
        env = dict(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK="0")
        procs.append(run_worker(spec, f"{root}/rank{rank}.json", env=env))
        outs.append(spec["out"])
    t0 = time.perf_counter()
    wait_workers(procs, "13(b)")
    ranks_s = time.perf_counter() - t0
    got = [torch.load(o) for o in outs]
    probe = got[0]["probe"]
    for dtype, p in probe.items():
        if p["all_reduce"] != [3.0] * 4 or p["all_gather"] != [1.0] * 4 + [2.0] * 4:
            raise AssertionError(f"13(b): gloo collectives on CUDA tensors ({dtype}): {p}")
    valid = ~fmask
    errors, out = [], dict(probe="gloo all_reduce and all_gather of CUDA f32 and bf16 tensors",
                           ranks_s=ranks_s, single_launches=single_launches)
    for r, g in enumerate(got):
        ex = g["extract_12"]
        rel = [float((ex["feats"][i][valid[i].cpu()].float() - want_feats[i][valid[i]].float().cpu())
                     .norm() / want_feats[i][valid[i]].float().norm()) for i in range(PAR_B - 1)]
        if ex["heads"] != 6 or ex["launches"] != single_launches:
            errors.append(f"rank {r} extraction: {ex['heads']} heads, {ex['launches']} launches")
        if max(rel) > FEAT_REL_TOL_BF16:
            errors.append(f"rank {r} extraction (1, 2): clip relative error {max(rel):.3e}")
        out[f"rank{r}_extract_12"] = dict(heads=ex["heads"], launches=ex["launches"],
                                          max_clip_rel_err=max(rel))
        for case in ("fused_21", "fused_12"):
            c = g[case]
            keys = list(single["metrics"][0])
            diffs = dict(
                metrics_close=all(close([m[k] for m in c["metrics"]],
                                        [m[k] for m in single["metrics"]], TRAINER_REL_TOL)
                                  for k in keys),
                metrics_max_abs_diff=max(abs(a[k] - b[k]) for a, b in
                                         zip(c["metrics"], single["metrics"]) for k in keys),
                scores_max_abs_diff=float(np.max(np.abs(np.asarray(c["scores"])
                                                        - np.asarray(single["scores"])))),
                dacp_max_abs_diff=max(float((c["dacp"][k] - single["dacp"][k]).abs().max())
                                      for k in single["dacp"]),
                update_rel_diff=math.sqrt(
                    sum(float((c["update"][k] - u).norm()) ** 2
                        for k, u in single["update"].items())
                    / sum(float(u.norm()) ** 2 for u in single["update"].values())))
            if not diffs["metrics_close"] or diffs["scores_max_abs_diff"] > DACP_TOL \
                    or diffs["dacp_max_abs_diff"] > DACP_TOL \
                    or diffs["update_rel_diff"] > UPDATE_REL_TOL:
                errors.append(f"rank {r} {case}: {diffs}")
            out[f"rank{r}_{case}"] = dict(diffs, launches=c["launches"])
    if not max(m["consistency_loss"] for m in single["metrics"]) > 0:
        errors.append("13(b): the consistency term never weighed")
    if errors:
        raise AssertionError("13(b): " + "; ".join(errors))
    print("parallel: two ranks " + json.dumps(out), flush=True)
    return dict(launches=sum(g["extract_12"]["launches"] + g["fused_21"]["launches"]
                             + g["fused_12"]["launches"] for g in got), **out)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_parallel(root: str, manifests: str, ckpt: str) -> dict:
    """Phase 13: 13(a) then 13(b); the attention launches of both."""
    t0 = time.perf_counter()
    a = run_parallel_cli(root, manifests, ckpt)
    b = run_two_ranks(root)
    print(f"parallel: phase 13 in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=a["launches"] + b["launches"], world1=a, two_ranks=b)


def run_stage1_and_fused(only_fused: bool = False, experiments: bool = True,
                         d2v: bool = True, fused: bool = True, parallel: bool = True) -> tuple:
    """Phases 9-13 in one directory: the raw IEMOCAP-layout corpus and
    ``cli manifest`` (phase 10's first steps), the fused trainer on that
    manifest (phase 9, unless not ``fused``), then unless ``only_fused`` the
    rest of phase 10, and with ``experiments`` phase 11 on its stores; with
    ``d2v`` phase 12 on phase 9's corpus and checkpoint; with ``parallel``
    phase 13 on them."""
    with tempfile.TemporaryDirectory(prefix="dad_stage1_") as root, contextlib.chdir(root):
        t0 = time.perf_counter()
        corpus = write_iemocap_corpus(root, seed=0)
        write_s = time.perf_counter() - t0
        enc_cfg = EncoderConfig(dtype="bfloat16", use_flash_attention=True)
        ckpt = f"{root}/emotion2vec_base.pt"
        torch.save({"model": random_fairseq_state_dict(enc_cfg, seed=0)}, ckpt)
        manifests = f"{root}/manifests"
        manifest_s = timed_cli(["manifest", "--corpus", "iemocap", "--root", corpus["raw"],
                                "--eval_dir", corpus["eval_dir"], "--dest", manifests])
        _root, files = read_manifest(manifests)
        if len(files) != corpus["clips"]:
            raise AssertionError(f"manifest: {len(files)} clips, expected {corpus['clips']}")
        print(f"stage1: corpus {json.dumps(corpus)}, written in {write_s:.1f} s; cli manifest "
              f"{manifest_s:.2f} s", flush=True)
        fused_info = run_fused_trainer(root, manifests, ckpt) if fused else None
        pre = exp = None
        if not only_fused:
            pre = run_preprocess(root, corpus, manifests, ckpt, fused_info["best_path"])
            exp = run_experiments(root, manifests, ckpt, pre["stores"]) if experiments else None
        d2v_info = run_d2v(root, manifests, ckpt) if d2v else None
        par = run_parallel(root, manifests, ckpt) if parallel else None
    return fused_info, pre, exp, d2v_info, par


T_START = time.perf_counter()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", choices=("attention", "conv", "trainer", "fused", "preprocess",
                                      "experiments", "d2v", "parallel"),
                   help="attention: build and run phases 1-3 only; conv: build conv.cu and "
                        "run phases 1, 2 and 6, then the conv grid comparison (to time two "
                        "checkouts in one call); trainer: build nothing, run phase 8 only; "
                        "fused: build attention.cu and run phases 1, 2 and 9 (with phase 10's "
                        "corpus and manifest); preprocess: build attention.cu and run phases "
                        "1, 2, 9 and 10 (phase 10 reads phase 9's checkpoint); experiments: "
                        "build attention.cu and run phases 1, 2, 9, 10 and 11 (phase 11 "
                        "reads phase 10's stores); d2v: build attention.cu and run phases "
                        "1, 2 and 12 on phase 9's corpus and checkpoint; "
                        "parallel: build attention.cu, write phase 9's corpus and run phases "
                        "1, 2 and 13")
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.worker:  # phase 13's worker processes
        with open(args.worker) as f:
            spec = json.load(f)
        (cli_worker if spec["kind"] == "cli" else rank_worker)(spec)
        return 0
    smi = nvidia_smi_line()
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    # f32 comparisons need full-precision convolutions and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    sources = {None: SOURCES, "trainer": (), "fused": ("attention",),
               "preprocess": ("attention",), "experiments": ("attention",),
               "d2v": ("attention",), "parallel": ("attention",)}.get(args.only, (args.only,))
    t0 = time.perf_counter()
    if sources:
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(cuda_build.build, sources))
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s", flush=True)

    def result(**extra) -> str:
        return json.dumps({"ok": True, **extra, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})

    if args.only == "trainer":
        run_feature_trainer()
    elif args.only in ("fused", "preprocess", "experiments", "d2v", "parallel"):
        run_stage1_and_fused(only_fused=args.only in ("fused", "d2v", "parallel"),
                             experiments=args.only == "experiments", d2v=args.only == "d2v",
                             fused=args.only not in ("d2v", "parallel"),
                             parallel=args.only == "parallel")
    elif args.only == "conv":
        # the serving slice's encoder weights and the training slice's noisy batch
        enc_cfg = EncoderConfig(dtype="bfloat16", use_flash_attention=True)
        enc_sd = fairseq_to_torch_encoder(random_fairseq_state_dict(enc_cfg, seed=0), enc_cfg)
        _clean, noisy = training_batches()
        run_conv_phase(enc_sd, noisy.wav, noisy.wav_mask)
        run_conv_grid(enc_sd, noisy.wav, noisy.wav_mask)
    else:
        attn = run_attention_phase()
    if args.only:
        print(f"total: {time.perf_counter() - T_START:.1f} s", flush=True)
        print(smi)
        print(result(only=args.only))
        return 0
    # the fused step's attention shape: B = 64 clips of 4 s (199 frames)
    step_attn = attn[(torch.bfloat16, 199, TRAIN_B)]

    slice_info = run_slice()
    norm = run_norm_phase()
    clean, noisy = training_batches()
    conv_info = run_conv_phase(slice_info["enc_sd"], noisy.wav, noisy.wav_mask)
    train = run_training_slice(slice_info["enc_sd"], clean, noisy)
    del clean, noisy
    torch.cuda.empty_cache()
    run_feature_trainer()
    fused, pre, exp, d2v_info, par = run_stage1_and_fused()

    def entry(name, source, replaces, launches, r):
        return dict(name=name, route="cuda", source=f"{PORT_PKG}/csrc/{source}",
                    replaces=replaces, launches=launches,
                    **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})

    # the conv kernel over the whole front end: each layer once (erf GELU),
    # the sums of the layers' device ms with cold L2 and of their library ms
    erf_rows = [r for r in conv_info["rows"] if r["gelu"] == "erf"]
    front = {k: sum(r[k] for r in erf_rows)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    front["max_abs_err"] = max(r["max_abs_err"] for r in erf_rows)
    ops_bound = sum(r["bound_ms"] for r in erf_rows if r["bound_by"] == "operations")
    front["bound_by"] = "operations" if ops_bound > front["bound_ms"] / 2 else "bytes"
    kernels = [
        entry("flash_attention", "attention.cu", f"{JAX_PKG}/ops/attention.py:28",
              slice_info["launches"] + train["launches"] + fused["launches"] + pre["launches"]
              + exp["launches"] + d2v_info["launches"] + par["launches"], step_attn),
        entry("fused_layernorm", "fused_norm.cu", f"{JAX_PKG}/ops/fused_norm.py:44",
              norm["launches"]["fused_layernorm"], norm["rows"][("ln_gelu", torch.bfloat16)]),
        entry("fused_conv_ln_gelu", "conv.cu", f"{JAX_PKG}/ops/conv.py:86",
              conv_info["launches"], front),
        entry("copy_rows", "fused_norm.cu", "tools/bench_fused_norm.py:133",
              norm["launches"]["copy_rows"], norm["rows"][("copy", torch.bfloat16)]),
    ]
    print(f"total: {time.perf_counter() - T_START:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(result())
    return 0


if __name__ == "__main__":
    sys.exit(main())
