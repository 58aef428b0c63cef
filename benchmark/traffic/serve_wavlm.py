"""The WavLM serving driver: the port's ``PredictionServer`` over an
``EmotionPredictor`` whose ``FeatureExtractor`` runs WavLM Large
(``EncoderConfig.arch`` "wavlm": the weighted layer sum into the DAD
head), under open-loop Poisson load from ``serve_client.py``, then the
sampled replies and one batch's features against the plain reference
(``reference/wavlm.py``).

Set-up: weights from the seed on the device in transformers' key names
(``lib/wavlm_weights.py``) and the reference SSRL layout (the program
converts both), the server, every bucket the schedule uses warmed with a
full batch, a few requests over HTTP. The window: the client's n = rate x
seconds requests, every one waited for. The predictor's counters
(``requests_served``, ``batches_run``) and a wrapper of its
``predict_wavs`` (``PadProbe``: padded and bucket samples, host seconds)
fill the counters ``serve.py`` fills, but for the FLOPs. A traced run
starts the device trace in set-up, stops it once every reply is in, and
keeps the stretch ``trace.lead_s`` into the window; its readers read the
program's own spans (``lib/wavlm_spans.py``).

Checks, after the window: ``prob_gap``, the widest gap of a sampled
reply's probabilities (``sample`` of them, the longest clip among them) to
the reference's; ``feat_gap``, the program's ``FeatureExtractor`` on the
longest sampled clip in a full batch at its bucket (the timed path at the
timed size, the batch filled with the next sampled clips): the largest
|feature - reference| over its valid frames over the reference's largest
magnitude."""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..lib import corpus, stats, wavlm_weights, weights
from ..lib.harness import PORT_PACKAGE, Context, Outcome
from ..lib.trace import Tracer
from ..reference import wavlm as reference
from .serve import CLIENT, bucket, post, sample_requests


def program_configs(ctx: Context):
    """(EncoderConfig, DADConfig) of the configuration, checked against its
    file; a program without WavLM fails here, before any set-up."""
    configs = importlib.import_module(f"{PORT_PACKAGE}.configs")
    enc, head = ctx.config["encoder"], ctx.config["head"]
    kw = dict(enc)
    kw["conv_feature_layers"] = tuple(tuple(x) for x in enc["conv_feature_layers"])
    cfg = configs.EncoderConfig(**kw)
    dad_cfg = configs.dad_preset(head["preset"], input_dim=head["input_dim"])
    got = (dad_cfg.input_dim, dad_cfg.hidden_dim, dad_cfg.num_classes, list(dad_cfg.class_names))
    want = (head["input_dim"], head["hidden_dim"], head["num_classes"], head["class_names"])
    if got != want:
        raise ValueError(f"the program's {head['preset']} head is {got}, the configuration {want}")
    return cfg, dad_cfg


class PadProbe:
    """Wraps ``EmotionPredictor.predict_wavs`` (called by the dispatcher
    thread, one call at a time) for what ``serve.py``'s ``PredictProbe``
    counts that does not depend on the model: padded and bucket samples of
    every batch, and the calls' host seconds."""

    def __init__(self, predict, ctx: Context, buckets, batch: int):
        self.predict, self.ctx, self.buckets, self.batch = predict, ctx, buckets, batch
        for k in ("pad_samples", "bucket_samples", "predict_s"):
            ctx.counters[k] = 0.0

    def __call__(self, wavs):
        c = self.ctx.counters
        t = time.monotonic()
        out = self.predict(wavs)
        c["predict_s"] += time.monotonic() - t
        lens = sorted(len(w) for w in wavs)
        for s in range(0, len(lens), self.batch):
            chunk = lens[s:s + self.batch]
            T = bucket(chunk[-1], self.buckets)
            c["bucket_samples"] += self.batch * T
            c["pad_samples"] += self.batch * T - sum(chunk)
        return out


def run(ctx: Context) -> Outcome:
    P = ctx.workload["params"]
    cfgs = program_configs(ctx)
    spec = dict(seed=ctx.seed, rate=P["rate_rps"], seconds=ctx.seconds, lengths=P["lengths"],
                connections=P["connections"], timeout_s=P["timeout_s"])
    client = subprocess.Popen([sys.executable, str(CLIENT)], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True)
    try:
        client.stdin.write(json.dumps(spec) + "\n")
        client.stdin.flush()
        return _serve(ctx, client, *cfgs)
    finally:
        if client.poll() is None:
            client.kill()
        client.wait()


def _serve(ctx: Context, client, cfg, dad_cfg) -> Outcome:
    import torch

    convert = importlib.import_module(f"{PORT_PACKAGE}.models.convert")
    extract = importlib.import_module(f"{PORT_PACKAGE}.models.extract")
    serving = importlib.import_module(f"{PORT_PACKAGE}.eval.serving")

    P, enc, head = ctx.workload["params"], ctx.config["encoder"], ctx.config["head"]
    sr = corpus.SAMPLE_RATE
    dev = torch.device(ctx.device)
    buckets = [int(s * sr) for s in P["buckets_s"]]
    B = P["max_batch"]
    sched = corpus.serve_schedule(ctx.seed, P["rate_rps"], ctx.seconds, P["lengths"])

    sd = weights.materialize(wavlm_weights.wavlm_layout(enc), corpus.torch_seed(ctx.seed, 1), dev)
    ssrl = weights.materialize(weights.ssrl_layout(head), corpus.torch_seed(ctx.seed, 2), dev)
    enc_sd = convert.hf_wavlm_to_torch_encoder(sd, cfg)
    ssrl_state = convert.torch_state_dict_to_ssrl(ssrl)
    del sd, ssrl
    extractor = extract.FeatureExtractor(cfg, enc_sd, batch_size=B, buckets=buckets, device=dev)
    predictor = serving.EmotionPredictor(dad_cfg, ssrl_state, extractor=extractor, batch_size=B,
                                         wav_transfer_dtype=P["wav_transfer_dtype"], device=dev)
    del enc_sd, ssrl_state
    for T in sorted({bucket(int(n), buckets) for n in sched["lengths"]}):
        predictor.predict_wavs([np.zeros(T, np.int16)] * B)
    tracer = Tracer() if ctx.trace else None
    if tracer is not None:  # started before the window: its start-up takes seconds
        tracer.start()
    server = serving.PredictionServer(predictor, port=0, max_batch=B,
                                      max_wait_ms=P["max_wait_ms"])
    server.start()
    try:
        base = f"http://{server.host}:{server.port}"
        warm = [corpus.serve_audio(ctx.seed)[:int(0.5 * sr * (i + 1))] for i in range(8)]
        with ThreadPoolExecutor(len(warm)) as pool:
            list(pool.map(lambda w: post(base, w), warm))
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        predictor.requests_served = 0
        predictor.batches_run = 0
        predictor.predict_wavs = PadProbe(predictor.predict_wavs, ctx, buckets, B)
        t0 = time.monotonic() + 0.25
        client.stdin.write(json.dumps({"host": server.host, "port": server.port, "t0": t0}) + "\n")
        client.stdin.flush()
        line = client.stdout.readline()
        if not line:
            raise RuntimeError("the load generator exited without its results")
        report = json.loads(line)
        if tracer is not None:  # every reply is in: the device is quiet
            tracer.stop()
            tr = ctx.workload["trace"]
            ctx.trace_data = tracer.read(t0 + tr["lead_s"], t0 + tr["lead_s"] + tr["length_s"])
        c = ctx.counters
        c["requests_served"] = predictor.requests_served
        c["batches_run"] = predictor.batches_run
        c["max_batch"] = B
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        server.shutdown()
    print(f"serve_wavlm: load generator lateness (ms) {json.dumps(report['lateness_ms'])}",
          file=sys.stderr, flush=True)
    results = report["results"]
    lat, done_ok = [], []
    for r, a in zip(results, sched["arrivals"]):
        if r is not None and r[2] == 200:
            lat.append(r[1] - (t0 + a))
            done_ok.append(r[1])
        else:
            lat.append(math.inf)
    n, ok = len(results), len(done_ok)
    e2e = {"serve_p95_ms": 1e3 * stats.percentile(lat, 95),
           "serve_rps": ok / (max(done_ok) - t0) if ok else 0.0,
           "setup_s": t0 - ctx.t_start}
    if ok < n:
        bad = [r for r in results if r is None or r[2] != 200][:3]
        print(f"serve_wavlm: {n - ok} of {n} requests failed, e.g. {bad}", file=sys.stderr,
              flush=True)

    picked = sample_requests(ctx.seed, sched["lengths"], P["sample"])
    audio = corpus.serve_audio(ctx.seed)
    clips = [audio[int(sched["offsets"][i]):int(sched["offsets"][i] + sched["lengths"][i])]
             for i in picked]
    feats = batch_features(predictor, clips[:B], buckets, dev)
    del server, predictor, extractor
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prob_gap, feat_gap = reference_gaps(ctx, picked, clips, results, feats, dev)
    lim = ctx.workload["limits"]
    checks = [("prob_gap", prob_gap, lim["prob_gap"]), ("feat_gap", feat_gap, lim["feat_gap"])]
    return Outcome(e2e, n, n - ok, checks, int(peak), t0)


def batch_features(predictor, clips, buckets, dev) -> np.ndarray:
    """The program's weighted-layer-sum features of ``clips[0]`` (the
    longest) over its valid frames, from one full batch of ``clips`` at its
    bucket through the predictor's extractor: int16 on the device, scaled
    by 1/32768 there, as the predictor's wav path does."""
    import torch

    B = predictor.batch_size
    T = bucket(len(clips[0]), buckets)
    wav = np.zeros((B, T), np.int16)
    mask = np.ones((B, T), bool)
    for row, c in enumerate(clips[:B]):
        wav[row, :len(c)] = c
        mask[row, :len(c)] = False
    with torch.no_grad():
        x = torch.from_numpy(wav).to(dev).float() / 32768.0
        feats, frame_mask = predictor.extractor.forward_batch(x, torch.from_numpy(mask).to(dev))
        return feats[0][~frame_mask[0]].cpu().numpy()


def reference_gaps(ctx: Context, picked, clips, results, feats: np.ndarray, dev):
    """(prob_gap, feat_gap): the sampled replies' widest probability gap to
    the reference (a missing reply counts as 1), and the batch features'
    largest gap over the reference's largest magnitude (inf where their
    frame counts differ)."""
    import torch

    enc, head = ctx.config["encoder"], ctx.config["head"]
    sd = weights.materialize(wavlm_weights.wavlm_layout(enc), corpus.torch_seed(ctx.seed, 1), dev)
    ssrl = weights.materialize(weights.ssrl_layout(head), corpus.torch_seed(ctx.seed, 2), dev)
    prob_gap, feat_gap = 0.0, math.inf
    for j, (i, clip) in enumerate(zip(picked, clips)):
        probs, ref_feats = reference.predict(sd, ssrl, enc, torch.from_numpy(clip).to(dev))
        r = results[i]
        if r is None or r[2] != 200:
            prob_gap = 1.0
        else:
            got = np.array([r[3][c] for c in head["class_names"]])
            prob_gap = max(prob_gap, float(np.abs(got - probs.cpu().numpy()).max()))
        if j == 0 and feats.shape == tuple(ref_feats.shape):
            want = ref_feats.cpu().numpy()
            feat_gap = float(np.abs(feats - want).max() / np.abs(want).max())
    return prob_gap, feat_gap
