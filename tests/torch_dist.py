"""Multi-process runs of the port on the CPU for its parallel tests: N gloo
processes (at most 4), each a rank of a ``torchrun``-like launch, run one
function and send back what it returns.

This module imports torch and the port only: the spawned processes never
import JAX. The test modules compute the JAX side in their own process and
pass plain data (numpy arrays, tensors, configs) to the ranks.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import pickle
import socket
import traceback
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    StepScalars,
    set_learning_rate,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad.train_step import (
    Optimizer,
    cosine_lr,
    epoch_end_dacp,
    init_dad_train_state,
    make_dad_train_step,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.batching import (
    Batch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.store import (
    load_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
    FeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    close_mesh,
    make_fused_extract_train_step,
    make_mesh,
    make_sharded_dad_train_step,
    place_fused,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.fused import (
    FusedConfig,
    init_fused,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train.dad_trainer import (
    CrossDomainTrainer,
)

__all__ = ["FusedConfig", "run_ranks"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(world: int = 1, rank: int = 0):
    """This process as rank ``rank`` of a ``torchrun`` launch of ``world``
    processes (world 1: a whole launch, in-process); the process group and
    the environment are taken down after."""
    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        yield
    finally:
        close_mesh()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(fn, rank: int, world: int, port: int, payload: bytes, out) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        out.put((rank, True, fn(*pickle.loads(payload))))
    except Exception:  # noqa: BLE001 (sent back to the test as text)
        out.put((rank, False, traceback.format_exc()))
    finally:
        close_mesh()


def run_ranks(fn: Callable, world: int, *args, timeout: float = 240.0) -> List[Any]:
    """``fn(*args)`` in ``world`` spawned processes with a ``torchrun``
    environment each; returns the ranks' results in rank order, or raises
    with the first failing rank's traceback."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    # plain pickle copies the tensors; multiprocessing's own would move the
    # caller's tensors into shared memory under its feet
    payload = pickle.dumps(args)
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, payload, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# what the ranks run


class GradRecorder(Optimizer):
    """An optimizer that keeps the gradients it is given and leaves the
    parameters where they are."""

    def __init__(self):
        super().__init__(None, 0.0, 0.0)
        self.grads = None

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return {k: torch.zeros_like(p) for k, p in params.items()}, state


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return np.array(x.detach().cpu().numpy())


def numpy_state(state) -> dict:
    """A DAD train state's student, teacher, Adam moments and DACP as numpy."""
    out = {f"{role}.{k}": to_numpy(v)
           for role in ("student", "teacher") for k, v in getattr(state.ssrl, role).items()}
    out.update({f"mu.{k}": to_numpy(v) for k, v in state.opt_state.mu.items()})
    out.update({f"nu.{k}": to_numpy(v) for k, v in state.opt_state.nu.items()})
    out.update({f"dacp.{k}": to_numpy(v) for k, v in state.dacp._asdict().items()})
    return out


def numpy_metrics(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items() if k != "tracking"}


def feature_steps(cfg, state, batches, epochs, draws, seed, mesh=None, tx=None):
    """The feature DAD step (data-parallel over ``mesh``, else the plain
    step) over (clean, noisy) ``batches``, one per epoch of ``epochs``, fed
    ``draws`` (one per step, or None: the generator seeded ``seed``, in the
    trainer's order). Returns [(metrics, tracking, state)] as numpy."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad.train_step import (
        draw_feature_step,
    )

    head, tx0, _ = init_dad_train_state(cfg, torch.Generator().manual_seed(0))
    tx = tx or tx0
    gen = torch.Generator().manual_seed(seed)
    step = (make_sharded_dad_train_step(head, tx, cfg, mesh) if mesh is not None
            else make_dad_train_step(head, tx, cfg))
    out = []
    for i, (epoch, (clean, noisy)) in enumerate(zip(epochs, batches)):
        state = state._replace(opt_state=set_learning_rate(state.opt_state, cosine_lr(cfg, epoch)))
        d = None if draws is None else draws[i]
        if mesh is None:
            clean, noisy = (Batch(*(None if v is None else torch.from_numpy(np.asarray(v))
                                    for v in b)) for b in (clean, noisy))
            if d is None:
                d = draw_feature_step(gen, noisy.feats, noisy.padding_mask, cfg.augment)
        state, m, tr = step(state, clean, noisy, StepScalars.for_epoch(cfg, epoch),
                            torch.zeros(cfg.num_classes), gen, d)
        state = epoch_end_dacp(state, cfg)
        rec = {k: to_numpy(v) for k, v in tr.items() if v is not None}
        out.append((numpy_metrics(m), rec, numpy_state(state)))
        if isinstance(tx, GradRecorder):
            out[-1] = out[-1] + ({k: to_numpy(v) for k, v in tx.grads.items()},)
    return out


def fused_steps(cfg: FusedConfig, enc_state, state, clean, noisy, epochs, draws, seed,
                mesh=None):
    """The fused step (over ``mesh``, else on one process) over one global
    batch pair, one step per epoch of ``epochs``, fed ``draws`` (one per
    step) or drawing from a generator seeded ``seed``."""
    encoder, head, tx, _ = init_fused(cfg, enc_state, device="cpu")
    if mesh is not None:
        encoder, state = place_fused(cfg, enc_state, state, mesh)
    step = make_fused_extract_train_step(encoder, head, tx, cfg, mesh)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i, epoch in enumerate(epochs):
        state = state._replace(opt_state=set_learning_rate(state.opt_state,
                                                           cosine_lr(cfg.dad, epoch)))
        state, m = step(state, clean, noisy, StepScalars.for_epoch(cfg.dad, epoch),
                        torch.zeros(cfg.dad.num_classes), gen, None,
                        None if draws is None else draws[i])
        state = epoch_end_dacp(state, cfg.dad)
        out.append((numpy_metrics(m), numpy_state(state)))
    return out


def extract(cfg, enc_state, clips, batch_size, mesh=None):
    ex = FeatureExtractor(cfg, enc_state, batch_size=batch_size, buckets=(1024,), device="cpu",
                          mesh=mesh)
    return [np.array(f) for f in ex.extract_clips(clips)]


def trainer_epochs(cfg, clean_dir: str, noisy_dir: str, epochs: int, mesh=None):
    """``epochs`` epochs of the feature trainer: the per-epoch metric means
    and the final state, as numpy."""
    clean = load_feature_store(clean_dir, cfg.label_map)
    noisy = load_feature_store(noisy_dir, cfg.label_map)
    t = CrossDomainTrainer(cfg, fold=0, clean_store=clean, noisy_store=noisy, prefetch_depth=0,
                           mesh=mesh, device="cpu")
    avgs = [t.train_epoch(e) for e in range(epochs)]
    return avgs, numpy_state(t.state)


def cli_run(argv, cwd: str, mesh=None):
    """``cli.main(argv)`` in ``cwd`` (the command makes its own mesh from
    its flags and leaves the process group at its end); rc and the
    training history this rank wrote, if any."""
    import glob
    import json

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
        cli,
    )

    close_mesh()  # the command joins the launch itself
    os.chdir(cwd)
    rc = cli.main(argv)
    hist = glob.glob(os.path.join(cwd, "**", "training_history.json"), recursive=True)
    history = None
    if hist:
        with open(hist[0]) as f:
            history = json.load(f)
    return dict(rc=rc, history=history,
                best=glob.glob(os.path.join(cwd, "**", "*_best.pth"), recursive=True))


def grid(world: int, tp: int, *, dp_only: bool = False):
    return make_mesh(world, tp=tp, axis_names=("dp",) if dp_only else ("dp", "tp"),
                     device="cpu")


def run_scenarios(scenarios: Sequence):
    """Each (name, tp, fn, kwargs) of ``scenarios`` on a fresh mesh of this
    launch's processes at that tp: {name: fn(mesh=mesh, **kwargs)}, or the
    traceback text where it raised."""
    import torch.distributed as dist

    results = {}
    world = int(os.environ["WORLD_SIZE"])
    for name, tp, fn, kw in scenarios:
        if os.environ.get("DBG"):
            print(f"rank {os.environ['RANK']}: {name}", flush=True)
        mesh = grid(world, tp) if tp else None  # tp 0: the case makes its own
        try:
            results[name] = fn(mesh=mesh, **kw)
        except Exception:  # noqa: BLE001 (reported by the test that reads it)
            results[name] = "FAILED\n" + traceback.format_exc()
        if dist.is_initialized():
            dist.barrier()
    return results


def mesh_facts(mesh=None):
    """What a rank sees of its grids: ranks and subgroups."""
    import torch.distributed as dist

    world = int(os.environ["WORLD_SIZE"])
    facts = {}
    for tp in sorted({1, 2} & {t for t in (1, 2) if world % t == 0}):
        m = grid(world, tp)
        facts[tp] = dict(
            dp=m.dp, tp=m.tp, rank=m.rank, dp_rank=m.dp_rank, tp_rank=m.tp_rank,
            dp_ranks=dist.get_process_group_ranks(m.dp_group),
            tp_ranks=dist.get_process_group_ranks(m.tp_group),
            backend=dist.get_backend(),
        )
    return facts
