"""The d2v pretraining driver: the program's own loop,
``train/d2v_pretrain.py::run_d2v_pretrain`` with the resident corpus, as
``cli d2v-pretrain --resident on`` runs it: each step's (clip, start)
index vectors drawn by ``index_crop_batches`` and uploaded, the resident
step dispatched, its metrics staged behind it and read one step late by
the collapse guards, a history entry every ``log_every`` steps. The
checkpoint and validation intervals lie beyond the window.

The benchmark feeds the loop from outside. Its manifest names clips whose
audio the benchmark made from the seed and holds in memory, and which the
loop's ``read_mono`` reads from there. The resident step's factory is
wrapped (``Probe``) to time the window from the step calls, to trace a
stretch of it, and to end the loop at the first call after the window.

Set-up: the loop starts from a state the benchmark hands it
(``init_state``): weights made on the device from the seed, the teacher's
EMA copies of the main blocks those weights plus a seeded offset (a
teacher that lags its student), Adam's moments zero, and the step count
at ``start_step``, the end of warmup, where the learning rate is at its
peak and the EMA decay anneals. The first three steps get ``D2vDraws``
the benchmark draws (the masks' uniforms, the decoder's input keep, the
mask tokens); the probe records the generator's state before them and the
crops they were handed. Those steps are the check: after the window the
plain reference repeats them from the same start, crops, draws and
generator state. One more step warms up, then the window."""

from __future__ import annotations

import gc
import importlib
import os
import sys
import tempfile
import time
from unittest import mock

import numpy as np

from ..lib import corpus, roofline, weights
from ..lib.compare import counted, leaf_norms, loss_gap, report, worst_gap
from ..lib.harness import PORT_PACKAGE, Context, Outcome
from ..lib.trace import Tracer
from ..reference import nn as rnn
from ..reference.d2v import D2vReference, span_mask_counts


def port_configs(enc: dict, d2v: dict, seed: int):
    """The program's EncoderConfig and D2vPretrainConfig, the pretraining
    seed (crop order, crop starts, the step generator) taken from the
    run's seed."""
    configs = importlib.import_module(f"{PORT_PACKAGE}.configs")
    ekw = dict(enc, conv_feature_layers=tuple(tuple(x) for x in enc["conv_feature_layers"]))
    dkw = dict(d2v, decoder=configs.D2vDecoderConfig(**d2v["decoder"]),
               adam_betas=tuple(d2v["adam_betas"]), random_seed=corpus.torch_seed(seed, 2))
    return configs.EncoderConfig(**ekw), configs.D2vPretrainConfig(**dkw)


def host_corpus(sizes: np.ndarray, seed: int, dev) -> np.ndarray:
    """The corpus's raw audio, N(0, 1) drawn on the device from the seed
    in one call and copied to the host once: (total,) float32."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(corpus.torch_seed(seed, 3))
    return torch.randn(int(sizes.sum()), generator=gen, device=dev).cpu().numpy()


def offsets_of(sizes: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)


def crop(raw: np.ndarray, sizes: np.ndarray, idx, starts, n: int, dev):
    """The benchmark's own crop batch: each clip normalised to zero mean
    and unit variance over its own samples (eps 1e-5, in float64, as the
    d2v dataset normalises a clip before it crops), then (B, n) samples
    from its start, zero past its end, and the padding mask."""
    import torch

    offsets = offsets_of(sizes)
    wav = np.zeros((len(idx), n), np.float32)
    pad = np.ones((len(idx), n), bool)
    for r, (i, s) in enumerate(zip(np.asarray(idx).tolist(), np.asarray(starts).tolist())):
        clip = raw[offsets[i]:offsets[i] + sizes[i]].astype(np.float64)
        clip = (clip - clip.mean()) / np.sqrt(clip.var() + 1e-5)
        m = min(n, int(sizes[i]) - s)
        wav[r, :m] = clip[s:s + m]
        pad[r, :m] = False
    return torch.from_numpy(wav).to(dev), torch.from_numpy(pad).to(dev)


def make_draws(seed: int, step: int, rows: int, t: int, n_masked: int, d: int, d2v: dict, dev):
    """One step's D2vDraws fields, drawn by the benchmark: the span mask's
    start and fill uniforms, the decoder input's keep, the mask tokens."""
    import torch

    g = torch.Generator(device=dev).manual_seed(corpus.torch_seed(seed, 100 + step))
    L = d2v["mask_length"]
    u = torch.rand((rows, t - L + 1), generator=g, device=dev)
    fill = torch.rand((rows, t), generator=g, device=dev)
    keep_len = t - n_masked
    din = torch.rand((rows, keep_len, d), generator=g, device=dev) < 1.0 - d2v["decoder"]["input_dropout"]
    dtok = torch.randn((rows, n_masked, d), generator=g, device=dev)
    return {"mask": (u, fill), "din": din, "dtok": dtok}


def ema_keys(enc: dict, layout) -> list:
    """The teacher's leaves: the main blocks' (``ema_encoder_only``)."""
    blocks = {f"block_{i}" for i in range(enc["depth"])}
    return [k for k in layout if k.split(".")[0] in blocks]


def start_weights(ctx: Context, dev):
    """(params, ema): the weights from the seed, and the EMA copies of the
    main blocks' leaves: those weights plus ``ema_offset`` times an
    independent draw at each leaf's own scale."""
    enc, d2v = ctx.config["encoder"], ctx.config["d2v"]
    layout = weights.d2v_layout(enc, d2v)
    params = weights.materialize(layout, corpus.torch_seed(ctx.seed, 1), dev)
    f = ctx.workload["params"]["ema_offset"]
    keys = ema_keys(enc, layout)
    delta = weights.materialize({k: (layout[k][0], f * layout[k][1], 0.0) for k in keys},
                                corpus.torch_seed(ctx.seed, 6), dev)
    return params, {k: params[k] + delta[k] for k in keys}


def gaps(got: dict, ref: dict, keys) -> dict:
    """The compared numbers of one set of readings against the
    reference's: the first gradient's, the change's and the EMA change's
    worst leaf, and the losses' gap."""
    ek = [k for k in keys if k in ref["ema"]]
    return {"grad_gap": worst_gap(got["grad1"], ref["grad1"], keys),
            "change_gap": worst_gap(got["change"], ref["change"], keys),
            "ema_gap": worst_gap(got["ema"], ref["ema"], ek),
            "loss_gap": loss_gap(got["losses"], ref["losses"])}


class WindowClosed(Exception):
    """Raised by the wrapped step at its first call after the window: it
    ends the program's loop before that step is dispatched."""


class Probe:
    """Wraps ``make_resident_d2v_step``. The first ``check`` calls are the
    checked steps: their crops, the generator's state before them, the
    first gradient's norms (from Adam's first moment after step 1) and
    the change of the parameters and of the EMA copies after the last.
    ``warm`` calls later it opens the window (the device synchronised),
    counts every call, spans each step and the loop's host work between
    steps, traces ``trace.steps`` steps from ``trace.lead_s`` into the
    window, and raises ``WindowClosed`` at the first call after it."""

    def __init__(self, ctx: Context, dev, check: int, warm: int):
        self.ctx, self.dev, self.check, self.warm = ctx, dev, check, warm
        self.calls, self.steps, self.traced = 0, 0, 0
        self.checked, self.gen_state, self.readings = [], None, {"losses": []}
        self.t0 = self.t1 = self.t_end = self.trace_lo = None
        self.last_end = None
        self.starts = []  # each window step's call time
        self.stop_s = 0.0  # the profiler's stop inside the window
        self.tracing = False
        self.tracer = Tracer() if ctx.trace and dev.type == "cuda" else None

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def factory(self, make):
        def make_probed(model, tx):
            step = make(model, tx)

            def probed(state, corpus_, idx, starts, generator=None, draws=None, *, crop):
                self.before(idx, starts, generator)
                t = time.monotonic()
                out = step(state, corpus_, idx, starts, generator, draws, crop=crop)
                self.after(out, t)
                return out
            return probed
        return make_probed

    def before(self, idx, starts, generator) -> None:
        n = self.calls
        if n < self.check:
            self.checked.append((idx.cpu().numpy(), starts.cpu().numpy()))
            if n == 0:
                self.gen_state = generator.get_state()
            return
        if n == self.check + self.warm:  # the window opens
            if self.tracer is not None:  # its start-up takes seconds: before the window
                self.tracer.start()
            self.sync()
            self.t0 = time.monotonic()
            self.t_end = self.t0 + self.ctx.seconds
            return
        if n < self.check + self.warm:
            return
        now = time.monotonic()
        self.ctx.spans.add("d2v.loop", self.last_end, now)
        if now >= self.t_end:
            self.sync()
            self.t1 = time.monotonic()
            if self.tracing:
                self.tracer.stop()
                self.tracing = False
            raise WindowClosed
        tr = self.ctx.workload["trace"]
        if self.tracer is not None and not self.tracing and not self.traced \
                and now - self.t0 >= tr["lead_s"]:
            self.sync()
            self.trace_lo = time.monotonic()
            self.tracing = True
        elif self.tracing and self.traced == tr["steps"]:
            # after the loop's host work behind the last traced step; the
            # profiler's stop holds the host for seconds
            t = time.monotonic()
            self.tracer.stop()
            self.stop_s = time.monotonic() - t
            self.tracing = False

    def after(self, out, t_call: float) -> None:
        n = self.calls
        self.calls += 1
        state, metrics = out
        if n >= self.check + self.warm:
            self.steps += 1
            self.last_end = time.monotonic()
            self.starts.append(t_call)
            self.ctx.spans.add("d2v.step", t_call, self.last_end)
            if self.tracing:
                self.traced += 1
            return
        if n >= self.check:
            return
        self.readings["losses"].append(float(metrics["loss"]))
        if n == 0:
            b1 = self.ctx.config["d2v"]["adam_betas"][0]
            self.readings["grad1"] = leaf_norms(
                {k: v.float() / (1 - b1) for k, v in state.opt_state.mu.items()})
        if n == self.check - 1:
            params, ema = start_weights(self.ctx, self.dev)
            self.readings["change"] = leaf_norms({k: state.params[k] - params[k] for k in params})
            self.readings["ema"] = leaf_norms({k: state.ema_blocks[k] - ema[k] for k in ema})


def run(ctx: Context) -> Outcome:
    import torch

    d2v_models = importlib.import_module(f"{PORT_PACKAGE}.models.d2v_pretrain")
    resident = importlib.import_module(f"{PORT_PACKAGE}.parallel.resident")
    d2v_train = importlib.import_module(f"{PORT_PACKAGE}.train.d2v_pretrain")

    enc, d2v, P = ctx.config["encoder"], ctx.config["d2v"], ctx.workload["params"]
    dev = torch.device(ctx.device)
    cfg, pcfg = port_configs(enc, d2v, ctx.seed)
    B, crop_n, m = d2v["batch_size"], d2v["crop_size"], d2v["clone_batch"]
    t = roofline.conv_frames(crop_n, enc["conv_feature_layers"])
    _, n_masked = span_mask_counts(t, d2v["mask_prob"], d2v["mask_length"])
    rows, E, s0, check = B * m, enc["embed_dim"], P["start_step"], P["check_steps"]

    # the start state, in the program's types
    with torch.device("meta"):
        model = d2v_models.D2vPretrainModel(cfg, pcfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if want != {k: s for k, (s, _a, _b) in weights.d2v_layout(enc, d2v).items()}:
        raise ValueError("the program's d2v model has other leaves than the configuration's")
    del model
    params, ema = start_weights(ctx, dev)
    opt = d2v_models.build_d2v_optimizer(pcfg).init(params)
    start = torch.tensor(s0, dtype=torch.int32, device=dev)
    init_state = d2v_models.D2vTrainState(params=params, ema_blocks=ema,
                                          opt_state=opt._replace(count=start.clone()),
                                          step=start.clone())
    del params, ema, opt

    # the corpus: a manifest of the seed's clips, their audio in memory
    sizes = corpus.d2v_lengths(ctx.seed, P["corpus"])
    raw = host_corpus(sizes, ctx.seed, dev)
    offsets = offsets_of(sizes)
    clips = {f"clip_{i:05d}.wav": (int(o), int(n)) for i, (o, n) in enumerate(zip(offsets, sizes))}

    def read_mono(path, sample_rate):
        o, n = clips[os.path.basename(path)]
        return raw[o:o + n].copy()

    def step_draws(step: int):
        s = step - s0
        if s >= check:
            return None
        dr = make_draws(ctx.seed, s, rows, t, n_masked, E, d2v, dev)
        return d2v_models.D2vDraws(mask=dr["mask"], din=dr["din"], dtok=dr["dtok"])

    probe = Probe(ctx, dev, check, P["warm_steps"])
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        man = os.path.join(tmp, "manifest")
        os.makedirs(man)
        with open(os.path.join(man, "train.tsv"), "w") as f:
            f.write(tmp + "\n" + "".join(f"{k}\t{n}\n" for k, (_o, n) in clips.items()))
        with mock.patch.object(d2v_train, "read_mono", read_mono), \
                mock.patch.object(resident, "make_resident_d2v_step",
                                  probe.factory(resident.make_resident_d2v_step)):
            try:
                d2v_train.run_d2v_pretrain(
                    cfg, pcfg, [man], os.path.join(tmp, "run"), init_state=init_state,
                    log_every=P["log_every"], checkpoint_every=pcfg.max_steps, resident=True,
                    device=dev, step_draws=step_draws)
            except WindowClosed:
                pass
            else:  # a collapse guard ended the loop, or it ran out of steps
                print(f"d2v: the loop ended after {probe.calls} steps, before the window "
                      f"closed", file=sys.stderr, flush=True)
                failed = 1
                probe.sync()
                probe.t1 = time.monotonic()
    del init_state
    gc.collect()
    if probe.t0 is None:
        raise RuntimeError("the loop ended before the window opened")
    if probe.tracer is not None:
        if probe.tracing:
            probe.tracer.stop()
        ctx.trace_data = probe.tracer.read(probe.trace_lo if probe.traced else probe.t1)
    window = probe.t1 - probe.t0
    step_s = np.diff(probe.starts)
    if len(step_s) > 3:
        h = len(step_s) // 2
        q = [float(x) for x in np.percentile(step_s, [10, 50, 90, 100])]
        print(f"d2v: {probe.steps} steps in {window!r} s; seconds between step calls: p10, "
              f"median, p90, max {q}; mean of the first half {float(step_s[:h].mean())!r}, "
              f"of the second {float(step_s[h:].mean())!r}", file=sys.stderr, flush=True)
    c = ctx.counters
    # the per-layer rate leaves out the profiler's stop, which no untraced
    # run has
    c.update(steps=probe.steps, window_s=window - probe.stop_s, traced_steps=probe.traced,
             step_flops=roofline.d2v_step_flops(enc, d2v, B, t, t - n_masked))
    e2e = {"d2v_tokens_per_s": probe.steps * B * t / window, "setup_s": probe.t0 - ctx.t_start}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = [(crop(raw, sizes, idx, st, crop_n, dev),
                make_draws(ctx.seed, s, rows, t, n_masked, E, d2v, dev))
               for s, (idx, st) in enumerate(probe.checked)]
    del raw
    ref = reference_readings(ctx, probe.gen_state, checked, dev)
    keys = counted(ref["grad1"])
    got = probe.readings
    print(f"d2v: losses {got['losses']}, reference {ref['losses']}; {len(keys)} of "
          f"{len(ref['grad1'])} leaves counted", file=sys.stderr, flush=True)
    for what in ("grad1", "change", "ema"):
        report("d2v", what, got[what], ref[what], keys)
    checks = [(k, v, ctx.workload["limits"][k]) for k, v in gaps(got, ref, keys).items()]
    return Outcome(e2e, probe.steps, failed, checks, int(peak), probe.t0)


def reference_readings(ctx: Context, gen_state, checked, dev, q=rnn.exact) -> dict:
    """The plain reference's losses, first gradient, and change of the
    parameters and of the EMA copies after the checked steps, from the
    seed's start state and the recorded inputs."""
    import torch

    enc, d2v = ctx.config["encoder"], ctx.config["d2v"]
    ref = D2vReference(enc, d2v, q)
    params, ema = start_weights(ctx, dev)
    state = ref.init(params, ema, ctx.workload["params"]["start_step"])
    del params, ema
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    losses = []
    b1 = d2v["adam_betas"][0]
    for s, ((wav, pad), draws) in enumerate(checked):
        state, loss = ref.step(state, wav, pad, draws, gen)
        losses.append(loss)
        if s == 0:
            grad1 = leaf_norms({k: v / (1 - b1) for k, v in state.mu.items()})
    params, ema = start_weights(ctx, dev)
    return {"losses": losses, "grad1": grad1,
            "change": leaf_norms({k: state.params[k] - params[k] for k in params}),
            "ema": leaf_norms({k: state.ema[k] - ema[k] for k in ema})}
