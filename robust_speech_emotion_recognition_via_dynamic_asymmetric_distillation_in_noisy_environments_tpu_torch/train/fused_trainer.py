"""The fused wav->train cross-domain trainer (``cli dad --from-wav``): the
reference's two stages (offline extraction, complete_preprocessing.ps1:
42-153, then feature-level training, train.py:635-662) in one step.

Per step: the noisy stream's raw waveforms -> noise injected on the device
(white or a NOISEX bank; ``parallel/fused.py::inject_noise``) -> the frozen
emotion2vec encoder -> the DAD teacher-student update, on the device. The
clean stream has no per-step randomness, so its features are extracted once
at startup and stream like the feature trainer's clean batches.

Everything around the step is ``CrossDomainTrainer``'s: anchor calibration,
the DACP epoch updates, validation with teacher-student disagreement, the
best checkpoint and the BEST/FINAL reports, early stopping, resume and the
analysis dumps. Validation and test run feature-level on stores extracted
at startup; the noisy ones come from a fixed seeded injection pass (the
deterministic counterpart of the reference's offline noisy trees), so
"best noisy WA" means what it means in the feature trainer.

With ``resident`` the fold's training corpus (cached clean features and the
raw wavs) is held on the device and each step gathers its batch pair there
(``parallel/resident.py``); the numbers are the streamed path's.

Over a (dp, tp) mesh (``cli dad --from-wav --dp/--tp`` under ``torchrun``)
the startup extracts over the mesh, every rank holds the whole corpus,
and each step splits the global batch over dp and the encoder over tp
(``parallel/fused.py``); rank 0 writes.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..audio import noise as noise_ops
from ..configs import DADConfig, EncoderConfig
from ..dad import StepDraws, StepScalars, set_learning_rate
from ..dad.train_step import cosine_lr
from ..data.batching import paired_epoch
from ..data.folds import corpus_fold_split
from ..data.prefetch import prefetch, tree_map
from ..data.store import FeatureStore
from ..data.wavstore import WAV_BUCKETS, PaddedWavIterator, WavStore, load_wav_store
from ..models.extract import FeatureExtractor
from ..parallel.fused import (
    CleanFeatureBatch,
    FusedBatch,
    FusedConfig,
    make_fused_extract_train_step,
    validate_injection,
)
from ..parallel.resident import (
    make_resident_fused_epoch_runner,
    make_resident_fused_step,
    materialize_chunked_metrics,
    materialize_metrics,
    paired_index_epoch,
    resident_from_store,
    resident_nbytes,
    upload_index,
)
from ..utils import dump_json, get_logger
from .dad_trainer import (
    METRIC_KEYS,
    RESIDENT_MAX_BYTES,
    CrossDomainTrainer,
    _safe_name,
    average_metrics,
    chunked,
    extract_noise_info,
)

logger = get_logger(__name__)


def injection_display_name(fused_cfg: FusedConfig) -> str:
    """The reference's noisy-tree directory name for the injection, so that
    ``extract_noise_info``, the layered results directories and the report
    fields (train.py:113-192) are those of an offline-tree run."""
    if fused_cfg.inject_snr_choices:
        # multi-SNR has its own db token (extract_noise_info's multi branch)
        # and keeps the bank mode, so two multi configs never share a dir
        db = "multi_" + "_".join(str(int(s)) for s in fused_cfg.inject_snr_choices) + "db"
    else:
        db = f"{int(fused_cfg.inject_snr_db)}db"
    if fused_cfg.inject_noise_bank_mode == "random":
        return f"fused/root2-{db}"
    if fused_cfg.inject_noise_bank_mode == "fixed":
        return f"fused/root1-{noise_ops.NOISE_TYPES[fused_cfg.inject_noise_type]}-{db}"
    return f"fused/root1-white-{db}"


def store_from_clips(feats: Sequence[np.ndarray], wavs: WavStore, dim: int) -> FeatureStore:
    """Per-clip feature arrays packed into an in-memory FeatureStore with
    the wav store's labels, groups and names. ``dim`` fixes the width when
    there are no frames at all."""
    sizes = np.asarray([len(f) for f in feats], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    flat = (np.concatenate([f for f in feats if len(f)], axis=0) if int(sizes.sum())
            else np.zeros((0, dim), np.float32))
    return FeatureStore(
        feats=flat.astype(np.float32),
        sizes=sizes,
        offsets=offsets,
        labels=wavs.labels,
        groups=wavs.groups,
        label_names=wavs.label_names,
        utt_names=wavs.utt_names,
    )


def inject_fixed(wavs: WavStore, fused_cfg: FusedConfig,
                 noise_clips: Optional[List[np.ndarray]], seed: int) -> List[np.ndarray]:
    """The fixed noisy domain that validation and test measure against:
    the offline injectors' numpy math over every clip (noise tiled from
    offset 0; add_real_noise_to_audio.py:129-160, add_noise_to_audio.py:
    14-43), each clip with its own ``default_rng((seed, i))``."""
    out = []
    for i in range(wavs.num):
        rng = np.random.default_rng((seed, i))
        clip = wavs.clip(i).astype(np.float64)
        if fused_cfg.inject_snr_choices:
            snr = float(rng.choice(fused_cfg.inject_snr_choices))
        else:
            snr = float(fused_cfg.inject_snr_db)
        if fused_cfg.inject_noise_bank_mode is None:
            noisy = noise_ops.add_white_noise_np(clip, snr, rng)
        else:
            if fused_cfg.inject_noise_bank_mode == "random":
                k = int(rng.integers(0, len(noise_clips)))
            else:
                k = fused_cfg.inject_noise_type
            seg = noise_ops.tile_noise_np(noise_clips[k], len(clip))
            noisy = noise_ops.add_real_noise_np(clip, seg, snr)
        out.append(noisy.astype(np.float32))
    return out


def prepare_fused_shared(
    cfg: DADConfig,
    manifest_dir: str,
    encoder_cfg: EncoderConfig,
    enc_params: Mapping[str, torch.Tensor],
    fused_cfg: FusedConfig,
    noise_root: Optional[str],
    val_injection_seed: int = 42,
    extract_batch_size: int = 16,
    mesh=None,
    skip_noisy: bool = False,
    extract_buckets: Optional[Sequence[int]] = None,
    device="cuda",
) -> Dict:
    """The fold-independent startup of fused training: the wav store, the
    extractor on ``device``, one clean extraction pass, the fixed noisy
    validation/test domain (injection + extraction) and the raw noise clips.
    ``run_fused_cv`` computes it once for all folds.

    ``enc_params``: the encoder's state dict in the port's layout.
    ``skip_noisy``: leave out the fixed noisy domain (``noisy_store`` None),
    for callers that rebuild it with ``refresh_noisy_domain``. ``mesh``: the
    extractor runs over it (every rank gets every clip's features)."""
    wav_store = load_wav_store(manifest_dir, cfg.label_map)
    if wav_store.labels is None:
        raise ValueError(f"{manifest_dir} has no label sidecar")

    kw = {} if extract_buckets is None else {"buckets": tuple(extract_buckets)}
    extractor = FeatureExtractor(encoder_cfg, enc_params, batch_size=extract_batch_size,
                                 device=device, mesh=mesh, **kw)
    logger.info("fused trainer: extracting clean features once")
    clean_feats = extractor.extract_clips(wav_store.clips())

    noise_clips = (noise_ops.load_noise_clips(noise_root)
                   if fused_cfg.inject_noise_bank_mode is not None else None)
    noisy_store = None
    if not skip_noisy:
        logger.info("fused trainer: building the fixed noisy val/test domain")
        noisy_wavs = inject_fixed(wav_store, fused_cfg, noise_clips, val_injection_seed)
        noisy_store = store_from_clips(extractor.extract_clips(noisy_wavs), wav_store,
                                       encoder_cfg.embed_dim)
    return {
        "wav_store": wav_store,
        "extractor": extractor,
        "clean_store": store_from_clips(clean_feats, wav_store, encoder_cfg.embed_dim),
        "noisy_store": noisy_store,
        "noise_clips": noise_clips,
    }


def refresh_noisy_domain(shared: Dict, fused_cfg: FusedConfig, noise_root: Optional[str],
                         val_injection_seed: int = 42) -> Dict:
    """Rebuilds only the injection-dependent half of a
    ``prepare_fused_shared`` dict: the fixed noisy validation/test domain
    (and the noise clips when the new injection needs a bank). The wav
    store, the extractor and the clean extraction are reused."""
    noise_clips = shared.get("noise_clips")
    if fused_cfg.inject_noise_bank_mode is not None and noise_clips is None:
        if not noise_root:
            raise ValueError("bank injection modes need noise_root")
        noise_clips = noise_ops.load_noise_clips(noise_root)
    wav_store, extractor = shared["wav_store"], shared["extractor"]
    logger.info("fused trainer: rebuilding the fixed noisy val/test domain (%s)",
                injection_display_name(fused_cfg))
    noisy_wavs = inject_fixed(wav_store, fused_cfg, noise_clips, val_injection_seed)
    out = dict(shared)
    out["noise_clips"] = noise_clips
    out["noisy_store"] = store_from_clips(extractor.extract_clips(noisy_wavs), wav_store,
                                          extractor.cfg.embed_dim)
    return out


def _normalize_fused_cfg(cfg: DADConfig, encoder_cfg: EncoderConfig,
                         fused_cfg: Optional[FusedConfig],
                         noise_root: Optional[str]) -> FusedConfig:
    fused_cfg = fused_cfg or FusedConfig(encoder=encoder_cfg, dad=cfg, inject_snr_db=10.0)
    fused_cfg = replace(fused_cfg, encoder=encoder_cfg, cache_clean_features=True)
    validate_injection(fused_cfg)
    if fused_cfg.inject_snr_db is None and not fused_cfg.inject_snr_choices:
        raise ValueError("fused training needs an injection SNR "
                         "(inject_snr_db or inject_snr_choices)")
    if fused_cfg.inject_noise_bank_mode is not None and not noise_root:
        raise ValueError("bank injection modes need --noise-root")
    return fused_cfg


class FusedCrossDomainTrainer(CrossDomainTrainer):
    """CrossDomainTrainer whose training epochs run the fused
    wav -> encoder -> DAD step instead of the feature-level step."""

    def __init__(
        self,
        cfg: DADConfig,
        manifest_dir: str,
        encoder_cfg: EncoderConfig,
        enc_params: Optional[Mapping[str, torch.Tensor]],
        fused_cfg: Optional[FusedConfig] = None,
        noise_root: Optional[str] = None,
        fold: int = 0,
        experiment_name: Optional[str] = None,
        pretrain_params: Optional[Dict[str, torch.Tensor]] = None,
        prefetch_depth: int = 2,
        mesh=None,
        val_injection_seed: int = 42,
        extract_batch_size: int = 16,
        wav_buckets: Sequence[int] = WAV_BUCKETS,
        transfer_dtype: Optional[str] = None,
        shared: Optional[Dict] = None,
        extract_buckets: Optional[Sequence[int]] = None,
        resident="auto",
        resident_max_bytes: int = RESIDENT_MAX_BYTES,
        scan_chunk: int = 0,
        device="cuda",
        step_draws: Optional[Callable[[int, int], StepDraws]] = None,
    ):
        """``enc_params``: the encoder's state dict (unused with ``shared``).

        ``transfer_dtype`` (e.g. "bfloat16"): ship the f32 wav and clean
        feature batches in this dtype and upcast on the device; halves the
        host-to-device bytes of the streamed path.

        ``shared``: a ``prepare_fused_shared`` dict, to reuse the
        fold-independent startup across folds (``run_fused_cv``).

        ``resident``: True / False / "auto": hold the fold's training corpus
        (the cached clean features, and the raw wavs of the noisy stream) on
        the device and gather each step's batches there. "auto" does so when
        the upload fits ``resident_max_bytes``. Features are stored as
        bfloat16 when the encoder is bfloat16 (lossless: its f32 features
        are bf16 values), else f32.

        ``scan_chunk > 0`` (resident only): run each epoch in chunks of that
        many steps, one index upload a chunk, both streams padded to the
        chunk-common buckets.

        ``step_draws(epoch, step)``: a test hook that gives each training
        step's injection, weak and strong draws instead of the trainer's
        generator.

        ``mesh`` (``parallel.make_mesh``): batches over dp, the encoder over
        tp, the resident corpus replicated on every rank; ``scan_chunk``
        raises and ``transfer_dtype`` is not applied (the JAX rules)."""
        if mesh is not None and scan_chunk:
            raise ValueError("scan_chunk is not supported with a mesh (per-batch dispatch "
                             "keeps dp/tp shardings simple); pass scan_chunk=0")
        if mesh is not None and transfer_dtype:
            logger.warning("transfer_dtype=%s ignored: the fused mesh step places the "
                           "batches", transfer_dtype)
            transfer_dtype = None
        fused_cfg = _normalize_fused_cfg(cfg, encoder_cfg, fused_cfg, noise_root)
        self.wav_buckets = tuple(wav_buckets)
        self.fused_transfer_dtype = transfer_dtype
        if shared is None:
            shared = prepare_fused_shared(
                cfg, manifest_dir, encoder_cfg, enc_params, fused_cfg, noise_root,
                val_injection_seed=val_injection_seed, extract_batch_size=extract_batch_size,
                mesh=mesh, extract_buckets=extract_buckets, device=device,
            )
        self.wav_store = shared["wav_store"]
        self.extractor = shared["extractor"]
        if shared["noisy_store"] is None:
            raise ValueError("shared startup lacks the fixed noisy domain (built with "
                             "skip_noisy=True): refresh_noisy_domain() it first")

        cfg = replace(cfg, clean_data_dir=manifest_dir,
                      noisy_data_dir=injection_display_name(fused_cfg))
        super().__init__(
            cfg, fold=fold, experiment_name=experiment_name,
            clean_store=shared["clean_store"], noisy_store=shared["noisy_store"],
            pretrain_params=pretrain_params, scan_chunk=0, prefetch_depth=prefetch_depth,
            mesh=mesh, device=device, step_draws=step_draws,
        )
        self.fused_cfg = replace(fused_cfg, dad=self.cfg)

        # the noisy training stream: the clean wavs, noise injected on the
        # device every step (fresh noise every epoch), with a shuffle stream
        # of its own as the feature trainer's noisy loader
        wtr, _wva, _wte = corpus_fold_split(self.cfg.corpus, fold, self.wav_store.groups)
        self.noisy_wav_train = PaddedWavIterator(
            self.wav_store.subset(wtr),
            self.cfg.batch_size,
            buckets=self.wav_buckets,
            shuffle=True,
            seed=self.cfg.random_seed + 7919,
            labeled=False,  # SSL: labels withheld (dataload_noisy.py:214)
            bucket_shuffle=self.cfg.bucket_batches,
        )

        self._noise_bank = None
        if fused_cfg.inject_noise_bank_mode is not None:
            bank = np.stack([noise_ops.tile_noise_np(c, max(self.wav_buckets))
                             for c in shared["noise_clips"]]).astype(np.float32)
            self._noise_bank = torch.from_numpy(bank).to(self.device)

        self.encoder = self.extractor.model
        self._fused_step = make_fused_extract_train_step(self.encoder, self.head, self.tx,
                                                         self.fused_cfg, self.mesh)
        self.fused_scan_chunk = scan_chunk
        self._setup_resident(resident, resident_max_bytes)

    def _setup_resident(self, resident, resident_max_bytes: int) -> None:
        """Uploads the fold's training corpus and builds the gathering step
        or runner; or leaves the streamed path (resident False, or "auto"
        over its budget)."""
        self._resident = None
        if resident is False:
            if self.fused_scan_chunk:
                logger.warning("scan_chunk=%d is inert without the resident corpus "
                               "(the fused chunks run over resident clips only)",
                               self.fused_scan_chunk)
            return
        clean_sub, wav_sub = self.clean_train.store, self.noisy_wav_train.store
        feat_dtype = "bfloat16" if self.fused_cfg.encoder.dtype == "bfloat16" else None
        est = resident_nbytes(clean_sub, feat_dtype) + resident_nbytes(wav_sub)
        if resident == "auto" and est > resident_max_bytes:
            logger.info(
                "resident corpus disabled: estimated %.1f GB > budget %.1f GB; streaming "
                "batches from the host%s", est / 1e9, resident_max_bytes / 1e9,
                (f" (scan_chunk={self.fused_scan_chunk} inert: the fused chunks run over "
                 "resident clips only)") if self.fused_scan_chunk else "",
            )
            return
        self._resident = (resident_from_store(clean_sub, self.device, dtype=feat_dtype),
                          resident_from_store(wav_sub, self.device, labeled=False))
        if self.fused_scan_chunk:
            self._resident_runner = make_resident_fused_epoch_runner(
                self.encoder, self.head, self.tx, self.fused_cfg)
        else:
            self._resident_step = make_resident_fused_step(
                self.encoder, self.head, self.tx, self.fused_cfg, self.mesh)

    # ------------------------------------------------------------------
    def _paired_fused_epoch(self, epoch: int):
        """Clean feature batches (the cached extraction) paired with noisy
        wav batches by the feature trainer's ``paired_epoch``."""
        for cb, wb in paired_epoch(self.clean_train, self.noisy_wav_train, epoch):
            yield (
                CleanFeatureBatch(feats=cb.feats, frame_mask=cb.padding_mask,
                                  labels=cb.labels, row_valid=cb.row_valid),
                FusedBatch(wav=wb.wav, wav_mask=wb.wav_mask, labels=wb.labels,
                           row_valid=wb.row_valid, ids=wb.ids),
            )

    def _fused_draws(self, epoch: int, step: int) -> Optional[StepDraws]:
        """Step ``step``'s draws from the hook, or None (the generator)."""
        if self.step_draws is None:
            return None
        return tree_map(lambda x: x.to(self.device) if isinstance(x, torch.Tensor) else x,
                        self.step_draws(epoch, step))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        scalars = StepScalars.for_epoch(cfg, epoch)
        self.state = self.state._replace(
            opt_state=set_learning_rate(self.state.opt_state, cosine_lr(cfg, epoch))
        )
        per_step: list = []
        tracked: list = []
        if self._resident is not None and self.fused_scan_chunk:
            rows = self._train_epoch_resident_scanned(epoch, scalars, tracked)
        else:
            if self._resident is not None:
                self._train_epoch_resident(epoch, scalars, per_step, tracked)
            else:
                self._train_epoch_streamed(epoch, scalars, per_step, tracked)
            rows = materialize_metrics(per_step, METRIC_KEYS)
        self._log_tracked(epoch, tracked)
        self._epoch_end_dacp(epoch)
        return average_metrics(rows, [1] * len(rows))

    def _train_epoch_streamed(self, epoch, scalars, per_step, tracked) -> None:
        # over a mesh the step takes each rank's rows of the host batches
        pairs = prefetch(self._paired_fused_epoch(epoch), depth=self.prefetch_depth,
                         to_device=self.mesh is None,
                         transfer_fp32_as=self.fused_transfer_dtype, device=self.device)
        for n, (cfb, fwb) in enumerate(pairs):
            self.state, metrics = self._fused_step(
                self.state, cfb, fwb, scalars, self.anchors, self.generator,
                self._noise_bank, self._fused_draws(epoch, n))
            per_step.append(metrics)
            if self._tracking(epoch):
                tracked.append(metrics["tracking"])

    def _train_epoch_resident(self, epoch, scalars, per_step, tracked) -> None:
        """Per step the host ships two (B,) index vectors; the batch pair is
        gathered on the device."""
        clean_c, wav_c = self._resident
        cap = self.clean_train.max_frames
        for n, ((cidx, t_c), (widx, t_w)) in enumerate(
                paired_index_epoch(self.clean_train, self.noisy_wav_train, epoch)):
            self.state, metrics = self._resident_step(
                self.state, clean_c, wav_c, upload_index(cidx, self.device),
                upload_index(widx, self.device), scalars, self.anchors, self.generator,
                self._noise_bank, self._fused_draws(epoch, n),
                t_clean=t_c, t_wav=t_w, frame_cap=cap,
            )
            per_step.append(metrics)
            if self._tracking(epoch):
                tracked.append(metrics["tracking"])

    def _train_epoch_resident_scanned(self, epoch, scalars, tracked) -> np.ndarray:
        """Chunks of ``scan_chunk`` steps, one (S, B) index upload each, both
        streams padded to the chunk-common buckets. Returns the (S, K)
        metric rows."""
        clean_c, wav_c = self._resident
        cap = self.clean_train.max_frames
        chunks, n = [], 0
        for buf in chunked(paired_index_epoch(self.clean_train, self.noisy_wav_train, epoch),
                           self.fused_scan_chunk):
            self.state, metrics = self._resident_runner(
                self.state, clean_c, wav_c,
                upload_index(np.stack([c for (c, _), _ in buf]), self.device),
                upload_index(np.stack([w for _, (w, _) in buf]), self.device),
                scalars, self.anchors, self.generator, self._noise_bank,
                lambda s, n0=n: self._fused_draws(epoch, n0 + s),
                t_clean=max(t for (_i, t), _ in buf), t_wav=max(t for _, (_i, t) in buf),
                frame_cap=cap,
            )
            chunks.append(metrics)
            if self._tracking(epoch):
                tracked.extend({k: v[s] for k, v in metrics["tracking"].items()}
                               for s in range(len(buf)))
            n += len(buf)
        return materialize_chunked_metrics(chunks, METRIC_KEYS)


def run_fused_cv(
    cfg: DADConfig,
    manifest_dir: str,
    encoder_cfg: EncoderConfig,
    enc_params: Mapping[str, torch.Tensor],
    fused_cfg: Optional[FusedConfig] = None,
    noise_root: Optional[str] = None,
    folds=None,
    experiment_name: Optional[str] = None,
    pretrain_params: Optional[Dict[str, torch.Tensor]] = None,
    prefetch_depth: int = 2,
    mesh=None,
    transfer_dtype: Optional[str] = None,
    resident="auto",
    scan_chunk: int = 0,
    device="cuda",
) -> Dict:
    """K-fold sweep of the fused trainer (``run_cv``'s counterpart). The
    fold-independent startup (wav decode, the two extraction passes, the
    fixed injection, the noise clips) runs once."""
    n_folds = {"iemocap": 5, "casia": 4, "emodb": 10}[cfg.corpus]
    folds = list(folds) if folds is not None else list(range(n_folds))
    fused_cfg = _normalize_fused_cfg(cfg, encoder_cfg, fused_cfg, noise_root)
    shared = prepare_fused_shared(cfg, manifest_dir, encoder_cfg, enc_params, fused_cfg,
                                  noise_root, mesh=mesh, device=device)
    all_results = []
    for fold in folds:
        try:
            trainer = FusedCrossDomainTrainer(
                cfg, manifest_dir, encoder_cfg, enc_params, fused_cfg=fused_cfg,
                noise_root=noise_root, fold=fold, experiment_name=experiment_name,
                pretrain_params=pretrain_params, prefetch_depth=prefetch_depth,
                transfer_dtype=transfer_dtype, shared=shared, resident=resident,
                scan_chunk=scan_chunk, mesh=mesh, device=device,
            )
            trainer.train()
            all_results.append(trainer.final_summary())
        except Exception as e:  # keep the sweep alive (train.py:786-789)
            logger.error("fold %d failed: %s", fold + 1, e, exc_info=True)
            all_results.append({"fold": fold + 1, "error": str(e)})
    ok = [r for r in all_results if "error" not in r]
    summary = {
        "noise": extract_noise_info(injection_display_name(fused_cfg))["display_name"],
        "folds": all_results,
        "mean_noisy_weighted_acc": float(np.mean([r["best_noisy_weighted_acc"] for r in ok]))
        if ok else None,
        "std_noisy_weighted_acc": float(np.std([r["best_noisy_weighted_acc"] for r in ok]))
        if ok else None,
    }
    out_dir = cfg.results_base_dir
    if experiment_name:
        out_dir = os.path.join(out_dir, _safe_name(experiment_name))
    if mesh is None or mesh.is_writer:
        dump_json(summary, os.path.join(out_dir, "final_summary_report.json"))
    return summary
