#!/usr/bin/env python3
"""Drives the PyTorch port's paths on one NVIDIA GPU and checks them: the
serving path, the fused-norm probe, the conv front end through its kernel
and the fused extract+train step.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for the f32 checks.
2. build: compiles every CUDA source of the port with nvcc (sm_90a), one
   nvcc per source, all started together, and prints the build seconds.
3. kernel vs plain: the attention kernel against its plain PyTorch version
   at the serving shapes (B=16, H=12, D=64, N in {49, 399, 1499}), bf16 and
   f32, and the fused step's (B=64, N=199, bf16), with suffix padding and
   one fully masked batch row, on contiguous operands and on the encoder's
   strided views; times the kernel in turns with torch's
   scaled_dot_product_attention (a yardstick only: the port never calls
   it) with the measures of phase 5 below, the plain version's call ms,
   and computes the bound. ``--only attention`` stops after this phase.
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
8. prints the ``nvidia-smi`` line, a ``kernels`` JSON line (all four
   kernels; the conv entry sums its seven layers' numbers), then the
   result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import dataclasses
import json
import math
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    EncoderConfig,
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    StepScalars,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval.serving import (
    EmotionPredictor,
    PredictionServer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
    torch_state_dict_to_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.emotion2vec import (
    normalize_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
    FeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    ConvFeatureExtractor,
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
    FusedBatch,
    FusedConfig,
    init_fused,
    make_fused_extract_train_step,
    precompute_clean_features,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.fused import (
    extract,
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
    """Phase 3: the serving shapes (B = 16, N 49, 399, 1499) in bf16 and
    f32, and the fused step's shape (B = 64 clips of 4 s, N = 199)."""
    results = {}
    with timing.ClockSampler(gpu=torch.cuda.current_device()) as clocks:
        cases = [(torch.bfloat16, N, 16) for N in (49, 399, 1499)]
        cases += [(torch.float32, N, 16) for N in (49, 399, 1499)]
        cases += [(torch.bfloat16, 199, TRAIN_B)]
        for dtype, N, B in cases:
            r = check_attention_kernel(N, dtype, clocks, B=B)
            results[(dtype, N, B)] = r
            print("kernel: " + json.dumps(r), flush=True)
    print(f"kernel: attention phase clocks {clocks.summary()}", flush=True)
    return results


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


T_START = time.perf_counter()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", choices=("attention", "conv"),
                   help="attention: build and run phases 1-3 only; conv: build conv.cu and "
                        "run phases 1, 2 and 6, then the conv grid comparison (to time two "
                        "checkouts in one call)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    # f32 comparisons need full-precision convolutions and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    sources = (args.only,) if args.only else SOURCES
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s", flush=True)

    def result(**extra) -> str:
        return json.dumps({"ok": True, **extra, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})

    if args.only == "conv":
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
              slice_info["launches"] + train["launches"], step_attn),
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
