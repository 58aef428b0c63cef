"""A dry run of every process-grid path at tiny shapes: the counterpart of
the JAX package's ``__graft_entry__.py`` ``dryrun_multichip``.

``dryrun_multichip(n)`` spawns ``n`` gloo processes on the CPU as one
``torchrun``-like launch, a (n // 2, 2) grid for an even n (else (n, 1)),
and each runs six stages at one tiny encoder config (``_DRYRUN_ENC``), each
asserting finite losses:

1. two fused extract+train steps at dp x tp;
2. the cached-clean-features fused step with NOISEX-bank injection;
3. one d2v step over the grid (tp shards qkv);
4. two resident fused steps over resident corpora;
5. two fused-trainer epochs (startup, warmup and post-warmup) and a noisy
   validation, on a synthetic EMODB-named wav corpus;
6. the d2v driver over the grid: 2 updates, its guards, a checkpoint and
   the encoder export.

Rank 0 prints a line a stage (its name, its seconds, the total), as the JAX
dry run's ``_Stage`` does, and the summary line; ``dryrun_multichip``
returns the stages and raises if any rank fails or the run outlasts
``timeout``.

    python -c "from <pkg>.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import socket
import tempfile
import time
import traceback
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

# one tiny encoder config for every stage (the JAX dry run's)
_DRYRUN_ENC = dict(
    embed_dim=16,
    depth=2,
    num_heads=2,
    prenet_depth=1,
    conv_feature_layers=((8, 4, 2), (8, 3, 2)),
    conv_pos_width=6,
    conv_pos_groups=2,
    conv_pos_depth=2,
    dtype="float32",
    use_flash_attention=False,
)


class _Stage:
    """Wall seconds a stage; rank 0 prints each as it completes."""

    def __init__(self, verbose: bool):
        self.verbose = verbose
        self.t0 = self.t_last = time.monotonic()
        self.done_stages: List[Tuple[str, float, float]] = []

    def done(self, name: str) -> None:
        now = time.monotonic()
        self.done_stages.append((name, now - self.t_last, now - self.t0))
        if self.verbose:
            print(f"[dryrun] stage '{name}' done in {now - self.t_last:.1f}s "
                  f"(total {now - self.t0:.1f}s)", flush=True)
        self.t_last = now


def _finite(x, what: str) -> float:
    v = float(x)
    assert np.isfinite(v), f"non-finite {what} {v}"
    return v


def _write_emodb_corpus(root: str) -> str:
    """20 tone clips of 700-1000 samples named as EMODB names them, and
    their manifest; returns the manifest dir."""
    from ..audio.wavio import write_wav
    from ..data.manifests import build_emodb_manifest

    wav_dir = os.path.join(root, "wav")
    os.makedirs(wav_dir)
    rng = np.random.default_rng(0)
    for si, spk in enumerate(("03", "08", "09", "10", "11", "12", "13", "14", "15", "16")):
        for j in range(2):
            c = (2 * si + j) % 4  # every adjacent speaker pair covers 4 classes
            n = int(700 + 300 * rng.random())
            t = np.arange(n) / 16000.0
            wav = 0.2 * np.sin(2 * np.pi * 200.0 * (c + 1) * t)
            write_wav(os.path.join(wav_dir, f"{spk}a{j}{'ATNL'[c]}a.wav"),
                      wav.astype(np.float32), 16000)
    manifest = os.path.join(root, "manifests")
    build_emodb_manifest(wav_dir, manifest)
    return manifest


def _dryrun_impl(n_devices: int, root: str) -> List[Tuple[str, float, float]]:
    from ..configs import D2vDecoderConfig, D2vPretrainConfig, EncoderConfig, dad_preset
    from ..dad import StepScalars, init_dad_train_state
    from ..models.d2v_pretrain import init_d2v_state, init_params
    from ..models.emotion2vec import Emotion2vecEncoder
    from ..train.d2v_pretrain import run_d2v_pretrain
    from ..train.fused_trainer import FusedCrossDomainTrainer
    from . import (
        FusedBatch,
        FusedConfig,
        init_fused,
        make_fused_extract_train_step,
        make_mesh,
        make_resident_fused_step,
        make_sharded_d2v_step,
        place_d2v_state,
        place_fused,
        precompute_clean_features,
        resident_from_flat,
    )

    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, tp=tp, device="cpu")
    stage = _Stage(verbose=mesh.is_writer)
    dp = mesh.dp
    cpu = torch.device("cpu")

    enc_cfg = EncoderConfig(**_DRYRUN_ENC)
    enc_state = init_params(Emotion2vecEncoder(enc_cfg), torch.Generator().manual_seed(0))
    dad_cfg = dad_preset("iemocap", input_dim=enc_cfg.embed_dim, hidden_dim=16,
                         batch_size=2 * dp, warmup_epochs=1, ecda_start_epoch=1, epochs=8,
                         weight_ramp_epochs=2)
    cfg = FusedConfig(encoder=enc_cfg, dad=dad_cfg, inject_snr_db=10.0)
    encoder, head, tx, state = init_fused(cfg, enc_state, torch.Generator().manual_seed(0),
                                          device=cpu)
    enc_s, state_s = place_fused(cfg, enc_state, state, mesh)
    step = make_fused_extract_train_step(enc_s, head, tx, cfg, mesh)
    rng = np.random.default_rng(0)
    B, T = 2 * dp, 256

    def batch(labeled: bool) -> FusedBatch:
        labels = rng.integers(0, 4, B) if labeled else np.full(B, -1)
        wav = (rng.normal(size=(B, T)) * 0.1).astype(np.float32)
        return FusedBatch(torch.from_numpy(wav), torch.zeros((B, T), dtype=torch.bool),
                          torch.from_numpy(labels.astype(np.int32)),
                          torch.ones(B, dtype=torch.bool))

    gen = torch.Generator().manual_seed(1)
    # post-warmup epoch: DACP, ECDA, the EMA and consistency all weigh
    scalars = StepScalars.for_epoch(dad_cfg, 4)
    anchors = torch.zeros(4)
    state2, metrics = step(state_s, batch(True), batch(False), scalars, anchors, gen)
    total = _finite(metrics["total_loss"], "fused loss")
    _state3, metrics2 = step(state2, batch(True), batch(False), scalars, anchors, gen)
    _finite(metrics2["total_loss"], "fused loss (step 2)")
    stage.done("fused extract+train step (2 steps, dp x tp)")

    # clean features cached once, NOISEX-bank injection (the bank replicated)
    cfg_c = dataclasses.replace(cfg, cache_clean_features=True, inject_noise_bank_mode="fixed",
                                inject_noise_type=2)
    _h, tx_c, state_c = init_dad_train_state(cfg_c.dad, torch.Generator().manual_seed(0))
    step_c = make_fused_extract_train_step(enc_s, head, tx_c, cfg_c, mesh)
    noise_bank = torch.from_numpy(rng.normal(size=(5, 300)).astype(np.float32))
    _e, state_cs = place_fused(cfg_c, enc_state, state_c, mesh)
    cached_clean = precompute_clean_features(encoder, cfg_c, batch(True))
    _sc, metrics_c = step_c(state_cs, cached_clean, batch(False), scalars, anchors, gen,
                            noise_bank)
    cached_loss = _finite(metrics_c["total_loss"], "cached loss")
    stage.done("cached-clean + NOISEX-bank fused step")

    # one d2v step over the grid, the same encoder config
    pcfg = D2vPretrainConfig(
        clone_batch=2, average_top_k_layers=2, mask_length=3,
        decoder=D2vDecoderConfig(decoder_dim=16, decoder_groups=2, decoder_kernel=3,
                                 decoder_layers=2),
        warmup_steps=1, max_steps=10, batch_size=B, crop_size=T)
    d2v_model, d2v_tx, d2v_state = init_d2v_state(enc_cfg, pcfg,
                                                  torch.Generator().manual_seed(3))
    d2v_step = make_sharded_d2v_step(d2v_model, d2v_tx, mesh)
    d2v_state = place_d2v_state(d2v_state, mesh)
    if tp > 1:  # tp really shards the trained params (heads and MLP hidden)
        qkv = d2v_state.params["block_0.attn.qkv.weight"]
        assert qkv.shape[0] == 3 * enc_cfg.embed_dim // tp, qkv.shape
    wav = (rng.normal(size=(B, T)) * 0.1).astype(np.float32)
    d2v_state, d2v_metrics = d2v_step(d2v_state, wav, np.zeros((B, T), bool), gen)
    d2v_loss = _finite(d2v_metrics["loss"], "d2v loss")
    stage.done("d2v sharded pretrain step")

    # two resident fused steps over resident corpora
    n_res, t_feat = 2 * B, 63  # 63: the frames of 256 samples through the conv stack
    wav_sizes = rng.integers(T // 2, T + 1, n_res)
    feat_sizes = rng.integers(t_feat // 2, t_feat + 1, n_res)
    wav_c = resident_from_flat(
        (rng.normal(size=int(wav_sizes.sum())) * 0.1).astype(np.float32), wav_sizes, cpu)
    clean_c = resident_from_flat(
        rng.normal(size=(int(feat_sizes.sum()), enc_cfg.embed_dim)).astype(np.float32),
        feat_sizes, cpu, labels=rng.integers(0, 4, n_res).astype(np.int32))
    res_step = make_resident_fused_step(enc_s, head, tx_c, cfg_c, mesh)
    idx = torch.from_numpy(rng.permutation(n_res).astype(np.int32).reshape(2, B))
    _h, _tx, state_r = init_dad_train_state(cfg_c.dad, torch.Generator().manual_seed(7))
    _e, state_r = place_fused(cfg_c, enc_state, state_r, mesh)
    for s in range(2):
        state_r, metrics_r = res_step(state_r, clean_c, wav_c, idx[s], idx[1 - s], scalars,
                                      anchors, gen, noise_bank, t_clean=t_feat, t_wav=T)
        resident_loss = _finite(metrics_r["total_loss"], f"resident loss (step {s + 1})")
    stage.done("resident fused step (2 steps)")

    # two fused-trainer epochs on a synthetic wav corpus (rank 0 writes it)
    if mesh.is_writer:
        _write_emodb_corpus(root)
    dist.barrier()
    manifest = os.path.join(root, "manifests")
    trainer_cfg = dad_preset("emodb", batch_size=max(2 * dp, 4), epochs=2, warmup_epochs=1,
                             ecda_start_epoch=1, weight_ramp_epochs=1, hidden_dim=8,
                             validation_interval=1,
                             results_base_dir=os.path.join(root, "results"))
    trainer = FusedCrossDomainTrainer(
        trainer_cfg, manifest, enc_cfg, enc_state,
        fused_cfg=FusedConfig(encoder=enc_cfg, dad=trainer_cfg, inject_snr_db=10.0),
        fold=0, prefetch_depth=0, mesh=mesh, wav_buckets=(1024,), extract_buckets=(1024,),
        extract_batch_size=dp * int(np.ceil(20 / dp)), device="cpu")
    avg_warm = trainer.train_epoch(0)
    avg = trainer.train_epoch(1)  # post-warmup: DACP, ECDA and the EMA weigh
    noisy = trainer.validate(trainer.noisy_val, "Noisy", 1)
    _finite(avg_warm["total_loss"], "trainer loss (warmup)")
    trainer_loss = _finite(avg["total_loss"], "trainer loss")
    assert 0.0 <= noisy["weighted_accuracy"] <= 100.0, noisy
    stage.done("fused trainer: startup, 2 epochs, noisy validation")

    # the d2v driver over the grid on the trainer's corpus: 2 updates, the
    # guards, a checkpoint and the encoder export (rank 0 writes)
    d2v_dir = os.path.join(root, "d2v")
    pcfg_drv = dataclasses.replace(pcfg, max_steps=2, min_sample_size=0, warmup_steps=1)
    last = run_d2v_pretrain(enc_cfg, pcfg_drv, [manifest], d2v_dir, log_every=1,
                            checkpoint_every=2, mesh=mesh, device="cpu")
    assert last.get("step") == 2, last
    driver_loss = _finite(last["loss"], "d2v driver loss")
    if mesh.is_writer:
        for name in ("encoder_params.pt", "d2v_last_state.pt"):
            assert os.path.exists(os.path.join(d2v_dir, name)), name
    stage.done("d2v driver over the grid (2 updates, guards, checkpoint, export)")

    if mesh.is_writer:
        print(f"dryrun_multichip OK: mesh=({dp}x{tp}) devices={n_devices} "
              f"loss={total:.4f} cached_loss={cached_loss:.4f} d2v_loss={d2v_loss:.4f} "
              f"resident_loss={resident_loss:.4f} trainer_loss={trainer_loss:.4f} "
              f"d2v_driver_loss={driver_loss:.4f}", flush=True)
    return stage.done_stages


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, root: str, out) -> None:
    from .mesh import close_mesh

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        out.put((rank, True, _dryrun_impl(world, root)))
    except Exception:  # noqa: BLE001 (sent to the parent as text)
        out.put((rank, False, traceback.format_exc()))
    finally:
        close_mesh()


def dryrun_multichip(n_devices: int = 4, timeout: float = 600.0) -> List[Tuple[str, float, float]]:
    """The six stages over ``n_devices`` gloo processes on the CPU (module
    docstring); returns rank 0's (stage, seconds, total seconds)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    results = {}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as root:
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, port, root, out),
                             daemon=True) for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for _ in range(n_devices):
                rank, ok, value = out.get(timeout=max(1.0, deadline - time.monotonic()))
                if not ok:
                    raise RuntimeError(f"dry run: rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
    return results[0]
