"""The DAD feature-trainer driver: the program's own
``train/dad_trainer.py::CrossDomainTrainer.train`` at ``resident=True``,
as ``cli dad`` runs it on extracted features: per epoch the resident
steps (two index vectors uploaded a step), the epoch-end DACP update, the
metrics read once, then validation of both domains (the teacher's
disagreement on the noisy one) and the best checkpoint.

The benchmark makes the clean and noisy feature stores in memory from the
seed and hands them to the trainer. The trainer starts at ``start_epoch``
(past the warm-up epochs and the weight ramps' start, so that DACP and
ECDA run in every step) through its own resume path, from a small
``last_state.pt`` the benchmark writes under the temporary directory:
the head's weights from the seed in the reference SSRL layout, converted
by the program, the teacher those weights plus a seeded offset, Adam's
moments zero at the count of the epochs before, DACP at its initial
state, the anchors of the workload. ``Probe`` wraps the resident step's
factory and the trainer's epoch, validation and prediction calls: it
hands the first three steps of ``start_epoch`` every random number they
use, records their inputs and the state after them, records the
predictions of that epoch's validation with the parameters they came
from, opens the window at the first step of the next epoch, traces
``trace.steps`` steps of the first epoch that starts ``trace.lead_s``
into the window, and ends the run at the first step or validation after
the window. The plain reference then repeats the three steps and the
validation predictions."""

from __future__ import annotations

import gc
import importlib
import math
import sys
import tempfile
import time
from typing import Dict

import numpy as np

from ..lib import corpus, roofline, weights
from ..lib.compare import counted, leaf_norms, loss_gap, report, worst_gap
from ..lib.harness import PORT_PACKAGE, Context, Outcome
from ..lib.trace import Tracer
from ..reference import nn as rnn
from ..reference.dad import LEAVES, DadReference, epoch_scalars


def port(name: str):
    return importlib.import_module(f"{PORT_PACKAGE}.{name}")


def dad_config(ctx: Context, results_dir: str):
    """The program's DADConfig from the configuration's ``dad`` settings,
    the seed and the run's paths."""
    configs = port("configs")
    d = dict(ctx.config["dad"])
    nested = {"dacp": configs.DACPConfig, "ecda": configs.ECDAConfig,
              "augment": configs.AugmentConfig}
    for k, cls in nested.items():
        d[k] = cls(**d[k])
    d["label_dict"] = tuple(tuple(x) for x in d["label_dict"])
    d["length_buckets"] = tuple(d["length_buckets"])
    P = ctx.workload["params"]
    return configs.DADConfig(**d, clean_data_dir="clean", noisy_data_dir=P["noisy_dir_name"],
                             results_base_dir=results_dir,
                             random_seed=corpus.torch_seed(ctx.seed, 9) % (1 << 30))


def start_weights(ctx: Context, dev) -> Dict:
    """The head in the reference SSRL layout: the student from the seed, the
    teacher the student plus ``teacher_offset`` times an independent draw
    at each leaf's scale."""
    head = ctx.config["head"]
    layout = {k: v for k, v in weights.ssrl_layout(head).items() if k.startswith("student_")}
    p = weights.materialize(layout, corpus.torch_seed(ctx.seed, 10), dev)
    f = ctx.workload["params"]["teacher_offset"]
    delta = weights.materialize({k: (s, f * sc, 0.0) for k, (s, sc, _o) in layout.items()},
                                corpus.torch_seed(ctx.seed, 11), dev)
    p.update({k.replace("student_", "teacher_"): p[k] + delta[k] for k in layout})
    return p


def subset(clips: Dict[str, np.ndarray], sessions) -> np.ndarray:
    """The clips of ``sessions`` in store order (the fold's split)."""
    return np.flatnonzero(np.isin(clips["groups"], sessions))


def batch(feats: np.ndarray, clips: Dict[str, np.ndarray], rows: np.ndarray, idx, t: int,
          dev, labeled: bool = True) -> dict:
    """The benchmark's own padded batch of the subset ``rows``'s clips
    ``idx`` (-1: a padded row), ``t`` frames."""
    import torch

    offsets = np.concatenate([[0], np.cumsum(clips["sizes"])[:-1]])
    B, D = len(idx), feats.shape[1]
    x = np.zeros((B, t, D), np.float32)
    pad = np.ones((B, t), bool)
    labels = np.full(B, -1, np.int64)
    for r, i in enumerate(np.asarray(idx).tolist()):
        if i < 0:
            continue
        g = int(rows[i])
        n = min(t, int(clips["sizes"][g]))
        x[r, :n] = feats[offsets[g]:offsets[g] + n]
        pad[r, :n] = False
        if labeled:
            labels[r] = clips["labels"][g]
    valid = torch.from_numpy(np.asarray(idx) >= 0).to(dev)
    return {"feats": torch.from_numpy(x).to(dev), "pad": torch.from_numpy(pad).to(dev),
            "labels": torch.from_numpy(labels).to(dev), "valid": valid}


def make_draws(seed: int, step: int, B: int, t: int, t_valid: int, dad: dict, dev) -> dict:
    """One step's random numbers, drawn by the benchmark: the weak and
    strong noise, the channel uniforms, the temporal mask starts (uniform
    below max(1, t_valid - mask length + 1)) and both dropout keeps."""
    import torch

    g = torch.Generator(device=dev).manual_seed(corpus.torch_seed(seed, 200 + step))
    D, H, rate = dad["input_dim"], dad["hidden_dim"], dad["dropout_rate"]
    hi = max(1, t_valid - int(math.floor(t_valid * dad["augment"]["temporal_mask_ratio"])) + 1)
    return {"weak": torch.randn((B, t, D), generator=g, device=dev),
            "strong_noise": torch.randn((B, t, D), generator=g, device=dev),
            "feat_u": torch.rand(D, generator=g, device=dev),
            "start": torch.randint(0, hi, (B,), generator=g, device=dev),
            "clean_keep": torch.rand((B, H), generator=g, device=dev) < 1.0 - rate,
            "strong_keep": torch.rand((B, H), generator=g, device=dev) < 1.0 - rate}


class WindowClosed(Exception):
    """Raised at the first step or validation after the window."""


class Probe:
    """The wrappers around the trainer's step factory, epochs, validation
    and predictions (the module's docstring says what each records)."""

    def __init__(self, ctx: Context, dev, clips, train_rows, start_epoch: int, check: int):
        self.ctx, self.dev, self.clips, self.rows = ctx, dev, clips, train_rows
        self.start, self.check = start_epoch, check
        self.epoch, self.in_epoch = None, 0
        self.trainer = None
        self.checked, self.readings, self.predicted = [], {"losses": []}, []
        self.t0 = self.t1 = self.t_end = self.trace_lo = self.trace_epoch = None
        self.last_end = None
        self.steps = self.traced = 0
        self.flops = self.validate_s = self.stop_s = 0.0
        self.validations = []  # each validation's host seconds in the window
        self.tracing = False
        self.tracer = Tracer() if ctx.trace and dev.type == "cuda" else None

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def in_window(self) -> bool:
        return self.t0 is not None

    def close_if_over(self) -> None:
        if self.in_window() and time.monotonic() >= self.t_end:
            self.sync()
            self.t1 = time.monotonic()
            if self.tracing:
                self.tracer.stop()
                self.tracing = False
            raise WindowClosed

    # -- the trainer's calls ----------------------------------------------------
    def train_epoch(self, orig):
        def wrapped(epoch):
            self.epoch, self.in_epoch = epoch, 0
            return orig(epoch)
        return wrapped

    def validate(self, orig):
        def wrapped(it, domain, epoch=0):
            self.close_if_over()
            t = time.monotonic()
            with self.ctx.spans.span("dad.validate"):
                out = orig(it, domain, epoch)
            if self.in_window():
                self.validations.append(time.monotonic() - t)
                self.validate_s += self.validations[-1]
            return out
        return wrapped

    def predict_all(self, orig):
        """Records the predictions of ``start_epoch``'s validation, with the
        parameters of each role."""
        def wrapped(it, roles):
            y, preds = orig(it, roles)
            if self.epoch == self.start:
                params = {r: {k: v.detach().clone() for k, v in
                              getattr(self.trainer.state.ssrl, r).items()} for r in roles}
                self.predicted.append((it, y, preds, params))
            return y, preds
        return wrapped

    def factory(self, make):
        def make_probed(head, tx, cfg):
            step = make(head, tx, cfg)

            def probed(state, clean_c, noisy_c, clean_idx, noisy_idx, scalars, anchors,
                       generator=None, draws=None, *, t_clean, t_noisy, frame_cap=None):
                draws = self.before(clean_idx, noisy_idx, t_clean, t_noisy, anchors, draws)
                t = time.monotonic()
                out = step(state, clean_c, noisy_c, clean_idx, noisy_idx, scalars, anchors,
                           generator, draws, t_clean=t_clean, t_noisy=t_noisy,
                           frame_cap=frame_cap)
                self.after(out, t, clean_idx.shape[0], t_clean, t_noisy)
                return out
            return probed
        return make_probed

    # -- around each step -------------------------------------------------------
    def before(self, cidx, nidx, t_c, t_n, anchors, draws):
        n, first = self.in_epoch, self.in_epoch == 0
        self.in_epoch += 1
        if self.epoch == self.start and n < self.check:
            return self.checked_draws(n, cidx, nidx, t_c, t_n, anchors)
        if self.epoch == self.start + 1 and first:  # the window opens
            if self.tracer is not None:  # its start-up takes seconds: before the window
                self.tracer.start()
            self.sync()
            self.t0 = self.last_end = time.monotonic()
            self.t_end = self.t0 + self.ctx.seconds
            return draws
        if not self.in_window():
            return draws
        now = time.monotonic()
        self.ctx.spans.add("dad.loop", self.last_end, now)
        self.close_if_over()
        tr = self.ctx.workload["trace"]
        if self.tracer is not None and first and self.trace_epoch is None \
                and now - self.t0 >= tr["lead_s"]:
            self.sync()
            self.trace_lo, self.trace_epoch, self.tracing = time.monotonic(), self.epoch, True
        elif self.tracing and self.traced == tr["steps"]:
            t = time.monotonic()
            self.tracer.stop()
            self.stop_s = time.monotonic() - t
            self.tracing = False
        return draws

    def checked_draws(self, n, cidx, nidx, t_c, t_n, anchors):
        """The benchmark's draws for checked step ``n`` at its noisy batch's
        shape, in the program's types; its inputs recorded."""
        dad = port("dad")
        augment = port("dad.augment")
        ci, ni = cidx.cpu().numpy(), nidx.cpu().numpy()
        sizes = self.clips["sizes"][self.rows]
        t_valid = int(max(min(int(sizes[i]), t_n) for i in ni if i >= 0))
        dr = make_draws(self.ctx.seed, n, len(ni), t_n, t_valid, self.ctx.config["dad"], self.dev)
        self.checked.append(dict(cidx=ci, nidx=ni, t_c=t_c, t_n=t_n, draws=dr,
                                 anchors=anchors.detach().clone()))
        given = dad.StepDraws(weak=dr["weak"], strong=augment.StrongDraws(
            dr["strong_noise"], dr["feat_u"], dr["start"]),
            clean_keep=dr["clean_keep"], strong_keep=dr["strong_keep"])
        return lambda _noisy_batch: given

    def after(self, out, t_call: float, B: int, t_c: int, t_n: int) -> None:
        state, metrics, _tracking = out
        if self.in_window():
            self.steps += 1
            self.flops += roofline.dad_step_flops(self.ctx.config["head"], B, t_c, t_n)
            self.last_end = time.monotonic()
            self.ctx.spans.add("dad.step", t_call, self.last_end)
            if self.tracing:
                self.traced += 1
            return
        n = self.in_epoch - 1
        if self.epoch != self.start or n >= self.check:
            return
        self.readings["losses"].append(float(metrics["total_loss"]))
        if n == 0:
            self.readings["grad1"] = leaf_norms({k: v / (1 - 0.9)
                                                 for k, v in state.opt_state.mu.items()})
        if n == self.check - 1:
            p = start_weights(self.ctx, self.dev)
            self.readings["change"] = leaf_norms(
                {k: state.ssrl.student[k] - p[f"student_{k}"] for k in LEAVES})
            self.readings["ema"] = leaf_norms(
                {k: state.ssrl.teacher[k] - p[f"teacher_{k}"] for k in LEAVES})


def run(ctx: Context) -> Outcome:
    import torch

    dad_trainer = port("train.dad_trainer")
    store_mod = port("data.store")
    convert = port("models.convert")
    dad = port("dad")
    checkpointing = port("train.checkpointing")

    P, dc = ctx.workload["params"], ctx.config["dad"]
    dev = torch.device(ctx.device)
    clips = corpus.feature_clips(ctx.seed, P["corpus"])
    clean, noisy = corpus.feature_corpus(ctx.seed, P["corpus"], clips, dev)
    t_stores = time.monotonic()
    offsets = np.concatenate([[0], np.cumsum(clips["sizes"])[:-1]]).astype(np.int64)

    def store(feats):
        return store_mod.FeatureStore(feats=feats, sizes=clips["sizes"], offsets=offsets,
                                      labels=clips["labels"], groups=clips["groups"])

    train_rows = subset(clips, P["fold"]["train"])
    val_rows = subset(clips, [P["fold"]["val"]])
    start, B = P["start_epoch"], dc["batch_size"]
    probe = Probe(ctx, dev, clips, train_rows, start, P["check_steps"])
    failed = 0
    saved = dad_trainer.make_resident_dad_step
    dad_trainer.make_resident_dad_step = probe.factory(saved)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = dad_config(ctx, tmp)
            trainer = dad_trainer.CrossDomainTrainer(cfg, fold=P["fold"]["index"],
                                                     clean_store=store(clean),
                                                     noisy_store=store(noisy), resident=True,
                                                     device=dev)
            probe.trainer = trainer
            t_trainer = time.monotonic()
            trainer.train_epoch = probe.train_epoch(trainer.train_epoch)
            trainer.validate = probe.validate(trainer.validate)
            trainer._predict_all = probe.predict_all(trainer._predict_all)
            ssrl = convert.torch_state_dict_to_ssrl(start_weights(ctx, dev))
            n_steps = math.ceil(len(train_rows) / B)
            opt = trainer.tx.init(ssrl.student)
            state = dad.DADTrainState(
                ssrl=ssrl, opt_state=opt._replace(count=torch.full_like(opt.count, start * n_steps)),
                dacp=trainer.state.dacp)
            checkpointing.save_train_state(trainer._last_state_path, state, trainer.generator, {
                "epoch": start - 1, "best_noisy_weighted_acc": 0.0,
                "best_clean_weighted_acc": 0.0, "patience_counter": 0,
                "anchors": P["anchors"], "training_history": {}, "bias_analysis_log": []})
            del state, ssrl, opt
            try:
                trainer.train(resume=True)
            except WindowClosed:
                pass
            else:  # early stopping, or the epochs ran out
                print("dad: the trainer returned before the window closed", file=sys.stderr,
                      flush=True)
                failed = 1
                probe.sync()
                probe.t1 = time.monotonic()
            del trainer
            probe.trainer = None
            gc.collect()
    finally:
        dad_trainer.make_resident_dad_step = saved
    if probe.t0 is None:
        raise RuntimeError("the trainer returned before the window opened")
    if probe.tracer is not None:
        if probe.tracing:
            probe.tracer.stop()
        ctx.trace_data = probe.tracer.read(probe.trace_lo if probe.traced else probe.t1)
    window = probe.t1 - probe.t0
    print(f"dad: set-up {probe.t0 - ctx.t_start!r} s: stores made at {t_stores - ctx.t_start!r}, "
          f"the trainer built at {t_trainer - ctx.t_start!r}; {probe.steps} steps in "
          f"{window!r} s, {probe.validate_s!r} s validating: "
          f"{[round(v, 3) for v in probe.validations]}", file=sys.stderr, flush=True)
    c = ctx.counters
    # the per-layer rates leave out the profiler's stop, which no untraced run has
    c.update(steps=probe.steps, window_s=window - probe.stop_s, traced_steps=probe.traced,
             flops=probe.flops, validate_s=probe.validate_s)
    e2e = {"dad_clips_per_s": probe.steps * B / window, "setup_s": probe.t0 - ctx.t_start}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checked = [(batch(clean, clips, train_rows, s["cidx"], s["t_c"], dev),
                batch(noisy, clips, train_rows, s["nidx"], s["t_n"], dev, labeled=False),
                s["draws"], s["anchors"]) for s in probe.checked]
    ref = reference_readings(ctx, checked, dev)
    keys = counted(ref["grad1"])
    got = probe.readings
    print(f"dad: losses {got['losses']}, reference {ref['losses']}; {len(keys)} of "
          f"{len(ref['grad1'])} leaves counted", file=sys.stderr, flush=True)
    for what in ("grad1", "change", "ema"):
        report("dad", what, got[what], ref[what], keys)
    mism = val_mismatch(ctx, probe.predicted, clips, val_rows, (clean, noisy), dev)
    del clean, noisy
    g = {"grad_gap": worst_gap(got["grad1"], ref["grad1"], keys),
         "change_gap": worst_gap(got["change"], ref["change"], keys),
         "ema_gap": worst_gap(got["ema"], ref["ema"], keys),
         "loss_gap": loss_gap(got["losses"], ref["losses"]),
         "val_mismatch": mism}
    checks = [(k, v, ctx.workload["limits"][k]) for k, v in g.items()]
    return Outcome(e2e, probe.steps, failed, checks, int(peak), probe.t0)


def reference_readings(ctx: Context, checked, dev, q=rnn.exact, rows: int = 0) -> dict:
    """The plain reference's losses, first gradient, and change of the
    student and of the teacher over the checked steps, from the seed's
    start state; ``rows`` > 0 keeps each batch's first rows alone (the
    half-batch fault)."""
    P, dc = ctx.workload["params"], ctx.config["dad"]
    ref = DadReference(dc, q)
    p0 = start_weights(ctx, dev)
    n_train = len(subset(corpus.feature_clips(ctx.seed, P["corpus"]), P["fold"]["train"]))
    s = ref.init(p0, P["start_epoch"] * math.ceil(n_train / dc["batch_size"]))
    sc = epoch_scalars(dc, P["start_epoch"])
    losses = []
    for i, (cb, nb, draws, anchors) in enumerate(checked):
        if rows:
            cb, nb = ({k: v[:rows] for k, v in b.items()} for b in (cb, nb))
            draws = {k: v if k == "feat_u" else v[:rows] for k, v in draws.items()}
        s, loss = ref.step(s, cb, nb, draws, sc, anchors)
        losses.append(loss)
        if i == 0:
            grad1 = leaf_norms({k: v / (1 - 0.9) for k, v in s.mu.items()})
    return {"losses": losses, "grad1": grad1,
            "change": leaf_norms({k: s.params[f"student_{k}"] - p0[f"student_{k}"] for k in LEAVES}),
            "ema": leaf_norms({k: s.params[f"teacher_{k}"] - p0[f"teacher_{k}"] for k in LEAVES})}


def val_mismatch(ctx: Context, predicted, clips, val_rows, feats, dev, q=rnn.exact) -> float:
    """The share of the recorded validation rows whose prediction (or label)
    differs from the reference's, over every domain and role recorded; the
    reference predicts from the same parameters, on the benchmark's own
    batches of the validation clips in store order. 1 where nothing was
    recorded."""
    if not predicted:
        return 1.0
    ref = DadReference(ctx.config["dad"], q)
    bad = total = 0
    for it, y, preds, params in predicted:
        f = feats[0] if it.store.feats is feats[0] else feats[1]
        want_y = clips["labels"][val_rows]
        for r, pr in preds.items():
            p = {f"{r}_{k}": v for k, v in params[r].items()}
            got_ref = []
            for a in range(0, len(val_rows), 64):
                idx = np.arange(a, min(a + 64, len(val_rows)))
                t = int(clips["sizes"][val_rows[idx]].max())
                b = batch(f, clips, val_rows, idx, t, dev)
                got_ref.append(ref.predict(p, r, b["feats"], b["pad"]).cpu().numpy())
            want = np.concatenate(got_ref)
            n = min(len(want), len(pr))
            bad += int((want[:n] != pr[:n]).sum()) + abs(len(want) - len(pr))
            bad += int((want_y[:n] != y[:n]).sum()) if r == "student" else 0
            total += len(want)
    return bad / max(total, 1)
