"""The serving driver: the port's ``PredictionServer`` (HTTP ``POST
/predict`` with ``pcm16`` bodies, micro-batched into an
``EmotionPredictor`` over a ``FeatureExtractor``) under open-loop Poisson
load from ``serve_client.py``, then the sampled replies against the plain
reference.

Set-up: weights from the seed on the device in the fairseq and SSRL
layouts (the program converts them), the server, every bucket the
schedule uses warmed with a full batch, a few requests over HTTP. The
window: the client's n = rate x seconds requests, every one waited for.
The benchmark wraps the predictor's ``predict_wavs`` to count padding,
operations and host time and to bound the dispatcher's spans; a traced
run starts the device trace in set-up and stops it once every reply is
in, and keeps the stretch ``trace.lead_s`` into the window."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..lib import corpus, roofline, stats, weights
from ..lib.harness import PORT_PACKAGE, Context, Outcome
from ..lib.trace import Tracer
from ..reference import e2v

CLIENT = Path(__file__).with_name("serve_client.py")


def bucket(n: int, buckets) -> int:
    """Smallest bucket >= n; past the top, the next multiple of the top."""
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / buckets[-1]) * buckets[-1])


def encoder_config(enc: dict):
    import importlib

    configs = importlib.import_module(f"{PORT_PACKAGE}.configs")
    kw = dict(enc)
    kw["conv_feature_layers"] = tuple(tuple(x) for x in enc["conv_feature_layers"])
    return configs.EncoderConfig(**kw)


class PredictProbe:
    """Wraps ``EmotionPredictor.predict_wavs`` (called by the dispatcher
    thread, one call at a time): padding, FLOPs and host seconds of every
    call, its spans, and each call's host interval with the least time of
    one of its attention launches (``calls``), by which the attention
    kernels of the device trace are matched to their shapes."""

    def __init__(self, predict, ctx: Context, buckets, batch: int, t0: float):
        self.predict, self.ctx, self.buckets, self.batch = predict, ctx, buckets, batch
        self.enc, self.head = ctx.config["encoder"], ctx.config["head"]
        self.last_end = t0
        c = ctx.counters
        for k in ("pad_samples", "bucket_samples", "flops", "predict_s"):
            c[k] = 0.0
        c["calls"] = []  # (start, end, attention bound s of one launch)

    def frames(self, n: int) -> int:
        return roofline.conv_frames(n, self.enc["conv_feature_layers"])

    def __call__(self, wavs):
        c, enc = self.ctx.counters, self.enc
        t = time.monotonic()
        self.ctx.spans.add("serve.between_batches", self.last_end, t)
        out = self.predict(wavs)
        t1 = self.last_end = time.monotonic()
        self.ctx.spans.add("serve.predict_wavs", t, t1)
        lens = sorted(len(w) for w in wavs)
        heads = enc["num_heads"]
        bound = 0.0
        for s in range(0, len(lens), self.batch):
            chunk = lens[s:s + self.batch]
            T = bucket(chunk[-1], self.buckets)
            c["bucket_samples"] += self.batch * T
            c["pad_samples"] += self.batch * T - sum(chunk)
            keys = sum(self.frames(n) for n in chunk)
            bound = roofline.attention_bound_s(self.batch, heads, self.frames(T),
                                               enc["embed_dim"] // heads, keys)
        c["calls"].append((t, t1, bound))
        c["flops"] += sum(roofline.encoder_flops(enc, n)
                          + roofline.head_flops(self.head, self.frames(n)) for n in lens)
        c["predict_s"] += t1 - t
        return out


def post(base: str, pcm: np.ndarray) -> None:
    import base64

    body = json.dumps({"pcm16": base64.b64encode(pcm.astype("<i2").tobytes()).decode(),
                       "sr": corpus.SAMPLE_RATE}).encode()
    req = urllib.request.Request(base + "/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.getcode() != 200:
            raise RuntimeError(f"warm-up request failed: {r.getcode()}")
        r.read()


def run(ctx: Context) -> Outcome:
    P = ctx.workload["params"]
    spec = dict(seed=ctx.seed, rate=P["rate_rps"], seconds=ctx.seconds, lengths=P["lengths"],
                connections=P["connections"], timeout_s=P["timeout_s"])
    # the client builds its request bodies while the server sets up
    client = subprocess.Popen([sys.executable, str(CLIENT)], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True)
    try:
        client.stdin.write(json.dumps(spec) + "\n")
        client.stdin.flush()
        return _serve(ctx, client)
    finally:
        if client.poll() is None:
            client.kill()
        client.wait()


def _serve(ctx: Context, client) -> Outcome:
    import importlib

    import torch

    convert = importlib.import_module(f"{PORT_PACKAGE}.models.convert")
    extract = importlib.import_module(f"{PORT_PACKAGE}.models.extract")
    serving = importlib.import_module(f"{PORT_PACKAGE}.eval.serving")
    configs = importlib.import_module(f"{PORT_PACKAGE}.configs")

    P, enc, head = ctx.workload["params"], ctx.config["encoder"], ctx.config["head"]
    sr = corpus.SAMPLE_RATE
    dev = torch.device(ctx.device)
    cfg = encoder_config(enc)
    dad_cfg = configs.dad_preset(head["preset"])
    got = (dad_cfg.input_dim, dad_cfg.hidden_dim, dad_cfg.num_classes, list(dad_cfg.class_names))
    want = (head["input_dim"], head["hidden_dim"], head["num_classes"], head["class_names"])
    if got != want:
        raise ValueError(f"the program's {head['preset']} head is {got}, the configuration {want}")
    buckets = [int(s * sr) for s in P["buckets_s"]]
    B = P["max_batch"]
    sched = corpus.serve_schedule(ctx.seed, P["rate_rps"], ctx.seconds, P["lengths"])

    sd = weights.materialize(weights.fairseq_encoder_layout(enc), corpus.torch_seed(ctx.seed, 1), dev)
    ssrl = weights.materialize(weights.ssrl_layout(head), corpus.torch_seed(ctx.seed, 2), dev)
    enc_sd = convert.fairseq_to_torch_encoder(sd, cfg)
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
        t0 = time.monotonic() + 0.25
        probe = PredictProbe(predictor.predict_wavs, ctx, buckets, B, t0)
        predictor.predict_wavs = probe
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
    print(f"serve: load generator lateness (ms) {json.dumps(report['lateness_ms'])}",
          file=sys.stderr, flush=True)
    results = report["results"]
    arrivals = sched["arrivals"]
    lat, done_ok = [], []
    for r, a in zip(results, arrivals):
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
        print(f"serve: {n - ok} of {n} requests failed, e.g. {bad}", file=sys.stderr, flush=True)

    del server, predictor, extractor
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gap = reference_gap(ctx, sched, results, head, dev)
    checks = [("prob_gap", gap, ctx.workload["limits"]["prob_gap"])]
    return Outcome(e2e, n, n - ok, checks, int(peak), t0)


def sample_requests(seed: int, lengths: np.ndarray, k: int) -> list:
    """The longest request and k - 1 others drawn from the seed."""
    longest = int(np.argmax(lengths))
    rest = np.delete(np.arange(len(lengths)), longest)
    pick = corpus.rng_for(seed, 6).choice(rest, min(k - 1, len(rest)), replace=False)
    return [longest] + sorted(int(i) for i in pick)


def reference_gap(ctx: Context, sched, results, head: dict, dev) -> float:
    """The widest gap between a sampled reply's class probabilities and the
    plain reference's for the same clip (a missing reply counts as 1)."""
    import torch

    enc, P = ctx.config["encoder"], ctx.workload["params"]
    sd = weights.materialize(weights.fairseq_encoder_layout(enc), corpus.torch_seed(ctx.seed, 1), dev)
    ssrl = weights.materialize(weights.ssrl_layout(head), corpus.torch_seed(ctx.seed, 2), dev)
    audio = corpus.serve_audio(ctx.seed)
    gap = 0.0
    for i in sample_requests(ctx.seed, sched["lengths"], P["sample"]):
        r = results[i]
        if r is None or r[2] != 200:
            gap = max(gap, 1.0)
            continue
        o, n = int(sched["offsets"][i]), int(sched["lengths"][i])
        pcm = torch.from_numpy(audio[o:o + n].astype(np.int16)).to(dev)
        ref = e2v.predict(sd, ssrl, enc, pcm).cpu().numpy()
        got = np.array([r[3][c] for c in head["class_names"]])
        gap = max(gap, float(np.abs(got - ref).max()))
    return gap
