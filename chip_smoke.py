#!/usr/bin/env python3
"""Drives the PyTorch port's serving path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for the f32 checks.
2. build: compiles every CUDA source of the port with nvcc (sm_90a), all
   at once, and prints the build seconds.
3. kernel vs plain: the attention kernel against its plain PyTorch version
   at the serving shapes (B=16, H=12, D=64, N in {49, 399, 1499}), bf16 and
   f32, with suffix padding and one fully masked batch row; times the
   kernel, the plain version and torch's scaled_dot_product_attention (a
   yardstick only: the port never calls it), and computes the bound.
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
5. prints a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import base64
import concurrent.futures
import json
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
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval.serving import (
    EmotionPredictor,
    PredictionServer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
    torch_state_dict_to_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
    FeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
    attention,
    cuda_build,
)

PORT_PKG = attention.__name__.split(".")[0]
SOURCES = ("attention",)  # csrc/<name>.cu
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


def attention_inputs(B, H, N, D, dtype, seed, device="cuda"):
    """q (pre-scaled), k, v and a (B, N) padding mask: suffix padding of
    random length on most rows, one unpadded row, one fully padded row."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, N, D, generator=g) for _ in range(3))
    q = q * D**-0.5
    lengths = torch.randint(max(1, N // 3), N + 1, (B,), generator=g)
    lengths[0], lengths[-1] = N, 0
    mask = torch.arange(N)[None, :] >= lengths[:, None]
    return ([x.to(device=device, dtype=dtype).contiguous() for x in (q, k, v)]
            + [mask.to(device)])


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


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_attention_kernel(N: int, dtype: torch.dtype) -> dict:
    """Kernel vs plain version at (16, 12, N, 64); returns the numbers."""
    q, k, v, mask = attention_inputs(16, 12, N, 64, dtype, seed=N)
    out = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    ref = attention.flash_attention_reference(q, k, v, mask)
    if not torch.isfinite(out).all():
        raise AssertionError(f"attention kernel: non-finite output (N={N}, {dtype})")
    rows = (~mask).any(dim=1)  # items with at least one valid key
    err = (out[rows].float() - ref[rows].float()).abs()
    atol, rtol = ATTN_TOL[dtype]
    limit = atol + rtol * ref[rows].float().abs()
    if not bool((err <= limit).all()):
        raise AssertionError(
            f"attention kernel disagrees with plain (N={N}, {dtype}): "
            f"max err {float(err.max()):.3e}, tolerance {atol} + {rtol}*|ref|"
        )
    sdpa_mask = ~mask[:, None, None, :]
    bound, bound_by = attention_bound_ms(q, mask)
    return dict(
        N=N, dtype=str(dtype).replace("torch.", ""),
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: attention.flash_attention(q, k, v, mask)),
        plain_ms=time_ms(lambda: attention.flash_attention_reference(q, k, v, mask)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, scale=1.0)),
        bound_ms=bound, bound_by=bound_by,
    )


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
    return dict(launches=launches, wav_batches=wav_batches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    # f32 comparisons need full-precision convolutions and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_build.build, SOURCES))
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)

    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for N in (49, 399, 1499):
            r = check_attention_kernel(N, dtype)
            results[(dtype, N)] = r
            print("kernel: " + json.dumps(r), flush=True)

    slice_info = run_slice()

    main_shape = results[(torch.bfloat16, 1499)]
    kernels = [dict(
        name="flash_attention",
        route="cuda",
        source=f"{PORT_PKG}/csrc/attention.cu",
        replaces=f"{PORT_PKG[: -len('_torch')]}/ops/attention.py:28",
        launches=slice_info["launches"],
        max_abs_err=main_shape["max_abs_err"],
        ms=main_shape["ms"],
        plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"],
        bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
    )]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
