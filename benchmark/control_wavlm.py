"""Readings that set the limits of ``serve.wavlm-long`` (see PERF.md):

- ``--what program``: the cell's checks on each seed with a window of
  ``--seconds`` (the lower readings: the program against the reference);
- ``--what control``: the plain reference with every matmul and
  convolution operand rounded to float8 e4m3, in the program's place,
  against the float32 reference, on the cell's sampled clips;
- ``--what nobias``: the program with its relative position bias left out
  (a zero bucket table), the cell's checks;
- ``--what gate1``: the program with every layer's gate fixed at 1, the
  cell's checks.

    python benchmark/control_wavlm.py --what control --seeds 1 2 3
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

T_START = time.monotonic()
CELL = "serve.wavlm-long"


def control(ctx, dev):
    """(prob_gap, feat_gap) of the float8 reference against the float32 one
    on the cell's sampled clips (feat_gap on the longest)."""
    import numpy as np

    from benchmark.lib import corpus, wavlm_weights, weights
    from benchmark.reference import nn as rnn
    from benchmark.reference import wavlm as reference
    from benchmark.traffic.serve import sample_requests

    import torch

    P, enc, head = ctx.workload["params"], ctx.config["encoder"], ctx.config["head"]
    sched = corpus.serve_schedule(ctx.seed, P["rate_rps"], ctx.seconds, P["lengths"])
    sd = weights.materialize(wavlm_weights.wavlm_layout(enc), corpus.torch_seed(ctx.seed, 1), dev)
    ssrl = weights.materialize(weights.ssrl_layout(head), corpus.torch_seed(ctx.seed, 2), dev)
    audio = corpus.serve_audio(ctx.seed)
    prob_gap, feat_gap = 0.0, None
    for i in sample_requests(ctx.seed, sched["lengths"], P["sample"]):
        o, n = int(sched["offsets"][i]), int(sched["lengths"][i])
        pcm = torch.from_numpy(audio[o:o + n].astype(np.int16)).to(dev)
        p32, f32 = reference.predict(sd, ssrl, enc, pcm)
        p8, f8 = reference.predict(sd, ssrl, enc, pcm, rnn.fp8)
        prob_gap = max(prob_gap, float((p8 - p32).abs().max()))
        if feat_gap is None:
            feat_gap = float((f8 - f32).abs().max() / f32.abs().max())
    return {"prob_gap": prob_gap, "feat_gap": feat_gap}


def fault(what: str):
    """The program altered where the fault lives: ``nobias`` a zero bucket
    table (the bias left out), ``gate1`` every gate 1."""
    from benchmark.lib.harness import PORT_PACKAGE

    wavlm = __import__(f"{PORT_PACKAGE}.models.wavlm", fromlist=["x"])
    if what == "nobias":
        table = wavlm.position_table
        return mock.patch.object(wavlm, "position_table",
                                 lambda *a, **k: table(*a, **k).zero_())
    gate = wavlm.relative_gate
    return mock.patch.object(wavlm, "relative_gate",
                             lambda *a, **k: gate(*a, **k).fill_(1.0))


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark.lib import harness

    p = argparse.ArgumentParser()
    p.add_argument("--what", choices=("program", "control", "nobias", "gate1"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    harness.set_cache_dirs()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / f"{CELL}.json")
    config = harness.load_json(harness.BENCH_DIR / "configs" / f"{cell['config']}.json")
    import torch

    for seed in args.seeds:
        t0 = time.monotonic()
        if args.what == "control":
            ctx = harness.Context(CELL, cell, workload, config, seed, args.seconds, False,
                                  args.device, t0)
            readings = control(ctx, torch.device(args.device))
        else:
            with fault(args.what) if args.what != "program" else contextlib.nullcontext():
                r = harness.run_cell(CELL, seed, args.seconds, False, device=args.device)
            readings = {k: v["value"] for k, v in r["checks"].items()}
            readings["failed"] = r["failed"]
        print(json.dumps({"what": args.what, "seed": seed, **readings,
                          "s": time.monotonic() - t0}), flush=True)
