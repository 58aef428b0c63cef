"""Readings that set a cell's limits (see PERF.md):

- ``--what program``: the cell's check on each seed with a window of
  ``--seconds`` (the lower readings: the program against the reference);
- ``--what control``: the plain reference computed with every matmul and
  convolution operand rounded to float8 e4m3, in the program's place,
  against the float32 reference, on the same inputs (the upper readings);
- ``--what half`` (training cells): the reference fed the first half of
  each checked batch, in the program's place: the fault "half of the batch
  left out, the mean taken over the rest";
- ``--what altered`` (the DAD cell): the program with every validation
  prediction altered where it is produced (the next class), the cell's
  check on each seed with a window of ``--seconds``.

    python benchmark/control.py --workload d2v.pretrain-10s --what control --seeds 1 2 3
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.monotonic()


def control_serve(ctx, dev):
    from benchmark.lib import corpus
    from benchmark.reference import nn as rnn
    from benchmark.traffic import serve

    P, enc, head = ctx.workload["params"], ctx.config["encoder"], ctx.config["head"]
    sched = corpus.serve_schedule(ctx.seed, P["rate_rps"], ctx.seconds, P["lengths"])
    from benchmark.lib import weights
    from benchmark.reference import e2v

    sd = weights.materialize(weights.fairseq_encoder_layout(enc), corpus.torch_seed(ctx.seed, 1), dev)
    ssrl = weights.materialize(weights.ssrl_layout(head), corpus.torch_seed(ctx.seed, 2), dev)
    audio = corpus.serve_audio(ctx.seed)
    import numpy as np
    import torch

    results = {}
    for i in serve.sample_requests(ctx.seed, sched["lengths"], P["sample"]):
        o, n = int(sched["offsets"][i]), int(sched["lengths"][i])
        pcm = torch.from_numpy(audio[o:o + n].astype(np.int16)).to(dev)
        p8 = e2v.predict(sd, ssrl, enc, pcm, rnn.fp8).cpu().numpy()
        results[i] = [0.0, 0.0, 200, {c: float(p8[j]) for j, c in enumerate(head["class_names"])}]
    full = [results.get(i) for i in range(len(sched["lengths"]))]
    return {"prob_gap": serve.reference_gap(ctx, sched, full, head, dev)}


def control_d2v(ctx, dev, half: bool = False):
    import torch

    from benchmark.lib import corpus, roofline
    from benchmark.reference import nn as rnn
    from benchmark.reference.d2v import span_mask_counts
    from benchmark.traffic import d2v

    enc, dc, P = ctx.config["encoder"], ctx.config["d2v"], ctx.workload["params"]
    B, crop_n = dc["batch_size"], dc["crop_size"]
    t = roofline.conv_frames(crop_n, enc["conv_feature_layers"])
    _, n_masked = span_mask_counts(t, dc["mask_prob"], dc["mask_length"])
    sizes = corpus.d2v_lengths(ctx.seed, P["corpus"])
    raw = d2v.host_corpus(sizes, ctx.seed, dev)
    batches = corpus.crop_batches(ctx.seed, sizes, B, crop_n, dc["crop_align"])
    checked = []
    for s in range(P["check_steps"]):
        idx, starts = next(batches)
        checked.append((d2v.crop(raw, sizes, idx, starts, crop_n, dev),
                        d2v.make_draws(ctx.seed, s, B * dc["clone_batch"], t, n_masked,
                                       enc["embed_dim"], dc, dev)))
    del raw
    gen_state = torch.Generator(device=dev).manual_seed(corpus.torch_seed(ctx.seed, 2)).get_state()
    ref = d2v.reference_readings(ctx, gen_state, checked, dev)
    if half:  # the fault "half of the batch left out": the reference on the first half
        h = B // 2
        r = h * dc["clone_batch"]
        checked = [((w[:h], p[:h]), {"mask": tuple(u[:r] for u in dr["mask"]),
                                     "din": dr["din"][:r], "dtok": dr["dtok"][:r]})
                   for (w, p), dr in checked]
        low = d2v.reference_readings(ctx, gen_state, checked, dev)
    else:
        low = d2v.reference_readings(ctx, gen_state, checked, dev, rnn.fp8)
    return d2v.gaps(low, ref, d2v.counted(ref["grad1"]))


def control_dad(ctx, dev, half: bool = False):
    """The DAD cell's numbers for the float8 reference (or the reference on
    the first half of each batch) against the float32 one: three steps on
    the first batches of a seeded order of the fold's training clips, each
    at the bucket of its longest clip, and the validation predictions of
    the start weights."""
    import numpy as np
    import torch

    from benchmark.lib import corpus
    from benchmark.lib.compare import counted, loss_gap, worst_gap
    from benchmark.reference import nn as rnn
    from benchmark.reference.dad import DadReference
    from benchmark.traffic import dad

    P, dc = ctx.workload["params"], ctx.config["dad"]
    clips = corpus.feature_clips(ctx.seed, P["corpus"])
    clean, noisy = corpus.feature_corpus(ctx.seed, P["corpus"], clips, dev)
    rows = dad.subset(clips, P["fold"]["train"])
    B = dc["batch_size"]
    rng = corpus.rng_for(ctx.seed, 12)
    clean_order, noisy_order = rng.permutation(len(rows)), rng.permutation(len(rows))
    checked = []
    for s in range(P["check_steps"]):
        ci, ni = clean_order[s * B:(s + 1) * B], noisy_order[s * B:(s + 1) * B]
        t_c, t_n = (min(b for b in dc["length_buckets"] if b >= clips["sizes"][rows[i]].max())
                    for i in (ci, ni))
        t_valid = int(min(clips["sizes"][rows[ni]].max(), t_n))
        checked.append((dad.batch(clean, clips, rows, ci, t_c, dev),
                        dad.batch(noisy, clips, rows, ni, t_n, dev, labeled=False),
                        dad.make_draws(ctx.seed, s, B, t_n, t_valid, dc, dev),
                        torch.tensor(P["anchors"], device=dev)))
    ref = dad.reference_readings(ctx, checked, dev)
    low = dad.reference_readings(ctx, checked, dev, rows=B // 2) if half else \
        dad.reference_readings(ctx, checked, dev, rnn.fp8)
    keys = counted(ref["grad1"])
    out = {k: worst_gap(low[k], ref[k], keys) for k in ("grad1", "change", "ema")}
    out = {"grad_gap": out["grad1"], "change_gap": out["change"], "ema_gap": out["ema"],
           "loss_gap": loss_gap(low["losses"], ref["losses"])}
    if not half:  # the validation predictions of the start weights
        p = dad.start_weights(ctx, dev)
        val = dad.subset(clips, [P["fold"]["val"]])
        bad = 0
        for feats in (clean, noisy):
            for a in range(0, len(val), 64):
                idx = np.arange(a, min(a + 64, len(val)))
                b = dad.batch(feats, clips, val, idx, int(clips["sizes"][val[idx]].max()), dev)
                want = DadReference(dc).predict(p, "student", b["feats"], b["pad"])
                got = DadReference(dc, rnn.fp8).predict(p, "student", b["feats"], b["pad"])
                bad += int((want != got).sum())
        out["val_mismatch"] = bad / (2 * len(val))
    return out


def altered_predictions():
    """The program's DAD eval step giving the next class for every row."""
    from unittest import mock

    from benchmark.lib.harness import PORT_PACKAGE

    trainer = __import__(f"{PORT_PACKAGE}.train.dad_trainer", fromlist=["x"])
    make = trainer.make_eval_step

    def factory(head):
        fwd = make(head)

        def altered(params, feats, mask):
            preds, logits = fwd(params, feats, mask)
            return (preds + 1) % logits.shape[-1], logits
        return altered

    return mock.patch.object(trainer, "make_eval_step", factory)


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark.lib import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--what", choices=("program", "control", "half", "altered"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    harness.set_cache_dirs()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / f"{args.workload}.json")
    config = harness.load_json(harness.BENCH_DIR / "configs" / f"{cell['config']}.json")
    import torch

    for seed in args.seeds:
        t0 = time.monotonic()
        if args.what in ("program", "altered"):
            if args.what == "altered":
                with altered_predictions():
                    r = harness.run_cell(args.workload, seed, args.seconds, False,
                                         device=args.device)
            else:
                r = harness.run_cell(args.workload, seed, args.seconds, False, device=args.device)
            readings = {k: v["value"] for k, v in r["checks"].items()}
        else:
            ctx = harness.Context(args.workload, cell, workload, config, seed, args.seconds,
                                  False, args.device, t0)
            if workload["driver"] == "serve":
                readings = control_serve(ctx, torch.device(args.device))
            else:
                control = control_d2v if workload["driver"] == "d2v" else control_dad
                readings = control(ctx, torch.device(args.device), args.what == "half")
        print(json.dumps({"what": args.what, "seed": seed, **readings,
                          "s": time.monotonic() - t0}), flush=True)
