"""The feature-level DAD cross-domain trainer (the reference's train.py:44-762
and its CASIA/EMODB siblings as one class, parameterised by the corpus
preset): ``cli dad --clean --noisy``.

The per-batch work is the DAD train step (``dad/train_step.py``) on the
device. This class owns the host-side loop: noise info parsed from the
noisy directory's name, the layered results directories, anchor
calibration, the per-epoch scalars and learning rate, validation with
teacher-student disagreement, the best checkpoint (a reference-layout
``.pth``), early stopping on noisy weighted accuracy, resume, the analysis
dumps and the final test-set evaluation.

The training batches come from the host (assembled and copied ahead by
``data/prefetch.py``) or, with ``resident``, from the fold's corpora held on
the device and gathered there per step (``parallel/resident.py``); the
numbers are the same either way. Nothing in an epoch reads a value back
per step: the step metrics and the tracked samples' rows are taken once at
the epoch's end, and validation pulls its predictions once per pass.

Over a dp mesh (``parallel/mesh.py``, ``cli dad --dp N`` under ``torchrun``)
every rank assembles the same global batches on the host and the
data-parallel step (``parallel/sharded.py``) takes its rows: the history is
the single-process one at the same global batch. Every rank validates;
rank 0 alone writes checkpoints, reports and the history.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from dataclasses import replace
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..configs import DADConfig
from ..dad import (
    StepDraws,
    StepScalars,
    init_dad_train_state,
    make_dad_train_step,
    make_eval_step,
    run_anchor_calibration,
    set_learning_rate,
)
from ..dad.train_step import cosine_lr, draw_feature_step, epoch_end_dacp
from ..data.batching import PaddedBatchIterator, paired_epoch
from ..data.folds import corpus_fold_split
from ..data.prefetch import prefetch, tree_map
from ..data.store import FeatureStore, load_feature_store
from ..parallel.resident import (
    make_resident_dad_step,
    materialize_metrics,
    materialize_tracking,
    paired_index_epoch,
    resident_from_store,
    resident_nbytes,
    upload_index,
)
from ..eval.metrics import evaluate_domain
from ..eval.reports import best_detailed_results, final_test_report, save_confusion_matrices
from ..models.convert import (
    load_pretrain_head_checkpoint,
    load_torch_file,
    save_torch_file,
    ssrl_to_torch_state_dict,
    torch_state_dict_to_ssrl,
)
from ..models.heads import SSRLState, load_pretrain_into_ssrl
from ..parallel.sharded import make_sharded_dad_train_step, shard_dad_state
from ..utils import dump_json, get_logger, resolve_device
from .checkpointing import restore_train_state, save_train_state

logger = get_logger(__name__)

METRIC_KEYS = ("total_loss", "supervised_ce_loss", "consistency_loss", "ecda_loss")
RESIDENT_MAX_BYTES = 8 << 30


def extract_noise_info(noisy_path: str) -> Dict:
    """Parses root1/root2 noise trees from the noisy dir path
    (reference train.py:113-192)."""
    # fused multi-SNR runs carry their whole SNR set in the db token
    m = re.search(r"root1-([^-]+)-(multi(?:_\d+)+)db", noisy_path,
                  re.IGNORECASE)
    if m:
        noise_type, db = m.group(1), m.group(2)
        return {
            "root_type": "root1",
            "noise_type": noise_type,
            "db_value": f"{db}db",
            "display_name": f"root1-{noise_type}-{db}db",
        }
    m = re.search(r"root2-(multi(?:_\d+)+)db", noisy_path, re.IGNORECASE)
    if m:
        db = m.group(1)
        return {
            "root_type": "root2",
            "noise_type": None,
            "db_value": f"{db}db",
            "display_name": f"root2-{db}db",
        }
    m = re.search(r"root1-([^.]+)\.wav-(\d+)db", noisy_path, re.IGNORECASE)
    if not m:
        m = re.search(r"root1-([^-]+)-(\d+)db", noisy_path, re.IGNORECASE)
    if m:
        noise_type, db = m.group(1), m.group(2)
        return {
            "root_type": "root1",
            "noise_type": noise_type,
            "db_value": f"{db}db",
            "display_name": f"root1-{noise_type}-{db}db",
        }
    m = re.search(r"root2-(\d+)db", noisy_path, re.IGNORECASE)
    if m:
        db = m.group(1)
        return {
            "root_type": "root2",
            "noise_type": None,
            "db_value": f"{db}db",
            "display_name": f"root2-{db}db",
        }
    for pattern in (r"(\d+)db", r"(-?\d+)_?db"):
        m = re.search(pattern, noisy_path, re.IGNORECASE)
        if m:
            db = m.group(1)
            return {
                "root_type": "unknown",
                "noise_type": "unknown",
                "db_value": f"{db}db",
                "display_name": f"unknown-{db}db",
            }
    return {
        "root_type": "unknown",
        "noise_type": "unknown",
        "db_value": "unknown_db",
        "display_name": "unknown-unknown-unknown_db",
    }


def _safe_name(name: str) -> str:
    return re.sub(r'[\\/*?:"<>|]', "", name)


def average_metrics(rows: np.ndarray) -> Dict[str, float]:
    """The epoch's mean of each metric from its (S, K) per-step rows of
    METRIC_KEYS: the JAX package's host sums, in step order."""
    totals = dict.fromkeys(METRIC_KEYS, 0.0)
    for row in rows:
        for k, v in zip(METRIC_KEYS, row):
            totals[k] += float(v)
    return {k: v / len(rows) for k, v in totals.items()} if len(rows) else {}


class CrossDomainTrainer:
    def __init__(
        self,
        cfg: DADConfig,
        fold: int = 0,
        experiment_name: Optional[str] = None,
        clean_store: Optional[FeatureStore] = None,
        noisy_store: Optional[FeatureStore] = None,
        pretrain_params: Optional[Dict[str, torch.Tensor]] = None,
        prefetch_depth: int = 2,
        transfer_dtype: Optional[str] = None,
        mesh=None,
        resident=False,
        resident_max_bytes: int = RESIDENT_MAX_BYTES,
        device="cuda",
        step_draws: Optional[Callable[[int, int], StepDraws]] = None,
    ):
        """``prefetch_depth > 0`` assembles and copies batch N+1 on a worker
        thread while step N runs (``data/prefetch.py``); 0 disables.

        ``transfer_dtype`` (e.g. "bfloat16"): ship float32 features to the
        device in this dtype and upcast there; halves the host-to-device
        bytes and rounds the inputs (opt-in).

        ``pretrain_params``: a ``PretrainHead`` state dict loaded into the
        student and the teacher (else ``cfg.pretrained_weight``'s file).

        ``resident``: True / False / "auto": hold the fold's training
        stores (clean and noisy) on the device and gather each batch there
        from its indices (``parallel/resident.py``) instead of shipping the
        batches. "auto" does so when they fit ``resident_max_bytes``. The
        history is the streamed path's.

        ``device``: "cuda" (default; raises without a GPU) or "cpu".

        ``step_draws(epoch, step)``: a test hook that gives each training
        step's weak/strong draws instead of the trainer's generator.

        ``mesh`` (``parallel.make_mesh``, dp only): every training batch split
        over dp, the losses over the whole batch; the device is the mesh's.
        ``batch_size`` must divide by dp; ``resident=True`` raises (the dp
        step streams; "auto" streams); ``transfer_dtype`` is not applied.
        """
        if mesh is not None:
            if resident is True:
                raise ValueError("resident=True is not supported with a mesh in the "
                                 "feature-mode trainer (the fused trainer supports "
                                 "mesh+resident)")
            if cfg.batch_size % mesh.dp:
                raise ValueError(f"batch_size={cfg.batch_size} must divide by dp={mesh.dp}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.fold = fold
        self._resident_mode = resident
        self._resident_max_bytes = resident_max_bytes
        self.prefetch_depth = prefetch_depth
        self.transfer_dtype = transfer_dtype
        self.step_draws = step_draws
        self.experiment_name = experiment_name
        self.noise_info = extract_noise_info(cfg.noisy_data_dir)
        self.results_dir = self._setup_results_directory()
        self.num_classes = cfg.num_classes
        self.class_names = list(cfg.class_names)

        self.best_noisy_weighted_acc = 0.0
        self.best_clean_weighted_acc = 0.0
        self.best_results = {"epoch": 0}
        self.training_history = defaultdict(list)
        self.patience_counter = 0
        self.bias_analysis_log = []
        self.tracked_sample_indices: Optional[set] = None

        self._setup_data(clean_store, noisy_store)
        self._setup_model(pretrain_params)
        self._setup_anchors()
        self._setup_training()

    # ------------------------------------------------------------------
    @property
    def is_writer(self) -> bool:
        """Rank 0 of a mesh, or the only process."""
        return self.mesh is None or self.mesh.is_writer

    def _setup_results_directory(self) -> str:
        base = self.cfg.results_base_dir
        if self.experiment_name:
            base = os.path.join(base, _safe_name(self.experiment_name))
        info = self.noise_info
        if info["root_type"] == "root1":
            d = os.path.join(
                base, "root1", info["noise_type"], info["db_value"],
                f"fold_{self.fold + 1}",
            )
        elif info["root_type"] == "root2":
            d = os.path.join(base, "root2", info["db_value"], f"fold_{self.fold + 1}")
        else:
            d = os.path.join(base, "unknown", f"fold_{self.fold + 1}")
        if self.is_writer:
            for sub in ("models", "plots", "reports"):
                os.makedirs(os.path.join(d, sub), exist_ok=True)
        return d

    def _setup_data(self, clean_store, noisy_store):
        cfg = self.cfg
        if clean_store is None:
            clean_store = load_feature_store(cfg.clean_data_dir, cfg.label_map)
        if noisy_store is None:
            noisy_store = load_feature_store(cfg.noisy_data_dir, cfg.label_map)
        if not (clean_store.validate() and noisy_store.validate()):
            raise ValueError("feature store failed validation (see the log)")
        if clean_store.dim != cfg.input_dim:
            logger.info("adjusting input_dim %d -> %d (from feature store)",
                        cfg.input_dim, clean_store.dim)
            self.cfg = cfg = replace(cfg, input_dim=clean_store.dim)
        self.clean_store, self.noisy_store = clean_store, noisy_store

        ctr, cva, cte = corpus_fold_split(cfg.corpus, self.fold, clean_store.groups)
        ntr, nva, nte = corpus_fold_split(cfg.corpus, self.fold, noisy_store.groups)

        def it(store, idx, shuffle, bs=None, labeled=True, seed_offset=0):
            sub = store.subset(idx)
            if not labeled:
                sub.labels = None  # SSL: labels withheld (dataload_noisy.py:214)
            return PaddedBatchIterator(
                sub,
                bs or cfg.batch_size,
                cfg.length_buckets,
                shuffle=shuffle,
                seed=cfg.random_seed + seed_offset,
                # opt-in bucket-homogeneous batches; shuffled (train)
                # iterators only, eval order is untouched
                bucket_shuffle=shuffle and cfg.bucket_batches,
            )

        self.clean_train = it(clean_store, ctr, True)
        self.clean_val = it(clean_store, cva, False)
        self.clean_test = it(clean_store, cte, False)
        # a shuffle stream of its own: the clean and noisy stores list the
        # same utterances in the same order, so a shared (seed, epoch)
        # permutation would pair every clean batch with its own noisy twin;
        # the reference's two DataLoaders shuffle independently
        # (train.py:479-483), making the clean/noisy pairing random
        self.noisy_train = it(noisy_store, ntr, True, labeled=False,
                              seed_offset=7919)
        self.noisy_val = it(noisy_store, nva, False)
        self.noisy_test = it(noisy_store, nte, False)
        # calibration batches at batch_size*2 (train.py:324-325): clean TRAIN
        # + noisy VAL, a preserved reference quirk
        self.calib_clean = it(clean_store, ctr, False, bs=cfg.batch_size * 2)
        self.calib_noisy = it(noisy_store, nva, False, bs=cfg.batch_size * 2)

        n_noisy_train = len(ntr)
        if n_noisy_train > cfg.num_tracked_samples:
            rng = np.random.default_rng(cfg.random_seed)
            self.tracked_sample_indices = set(
                rng.choice(n_noisy_train, cfg.num_tracked_samples, replace=False)
                .tolist()
            )

    def _setup_model(self, pretrain_params):
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(cfg.random_seed)
        self.head, self.tx, self.state = init_dad_train_state(cfg, gen, device=self.device)
        if pretrain_params is None and cfg.pretrained_weight:
            pretrain_params = load_pretrain_head_checkpoint(cfg.pretrained_weight)
        if pretrain_params is not None:
            ssrl = load_pretrain_into_ssrl(self.state.ssrl, pretrain_params)
            self.state = self.state._replace(ssrl=ssrl)
            logger.info("loaded pretrained head weights into student + teacher")

    def _setup_anchors(self):
        cfg = self.cfg
        if cfg.dacp.use_dacp and cfg.dacp.anchor_calibration_enabled:
            anchors = run_anchor_calibration(
                self.head, self.state.ssrl.student, self.calib_clean,
                self.calib_noisy, cfg, prefetch_depth=self.prefetch_depth,
            )
            logger.info("calibrated anchors: %s", np.round(anchors, 4).tolist())
        else:
            anchors = np.zeros(cfg.num_classes, np.float32)
        self.anchors = torch.as_tensor(anchors, device=self.device)

    def _setup_training(self):
        if self.mesh is None:
            self.train_step = make_dad_train_step(self.head, self.tx, self.cfg)
        else:
            self.train_step = make_sharded_dad_train_step(self.head, self.tx, self.cfg,
                                                          self.mesh)
            self.state = shard_dad_state(self.state, self.mesh)
        self.eval_step = make_eval_step(self.head)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.random_seed + 1)
        self._setup_feature_resident()

    def _setup_feature_resident(self) -> None:
        """Uploads the fold's clean and noisy training stores and builds the
        gathering step; or leaves the streamed path (resident
        False, or "auto" over its budget)."""
        self._resident = None
        if self._resident_mode is False or self.mesh is not None:
            return
        clean_sub, noisy_sub = self.clean_train.store, self.noisy_train.store
        est = resident_nbytes(clean_sub) + resident_nbytes(noisy_sub)
        if self._resident_mode == "auto" and est > self._resident_max_bytes:
            logger.info("resident corpus disabled: estimated %.1f GB > budget %.1f GB; "
                        "streaming batches from the host", est / 1e9,
                        self._resident_max_bytes / 1e9)
            return
        self._resident = (resident_from_store(clean_sub, self.device),
                          resident_from_store(noisy_sub, self.device))
        self._resident_step = make_resident_dad_step(self.head, self.tx, self.cfg)

    # ------------------------------------------------------------------
    def is_warmup(self, epoch: int) -> bool:
        return epoch < self.cfg.warmup_epochs

    def _tracking(self, epoch: int) -> bool:
        return bool(self.tracked_sample_indices) and not self.is_warmup(epoch)

    def _draws(self, epoch: int, step: int, feats: torch.Tensor,
               padding_mask: torch.Tensor) -> StepDraws:
        """Step ``step``'s weak/strong draws at the shape of its own noisy
        batch: from the hook where one is set, else from the generator (over
        a mesh the data-parallel step draws them: None)."""
        if self.step_draws is None:
            if self.mesh is not None:
                return None
            return draw_feature_step(self.generator, feats, padding_mask, self.cfg.augment)
        return tree_map(lambda x: x.to(self.device) if isinstance(x, torch.Tensor) else x,
                        self.step_draws(epoch, step))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        scalars = StepScalars.for_epoch(cfg, epoch)
        self.state = self.state._replace(
            opt_state=set_learning_rate(self.state.opt_state, cosine_lr(cfg, epoch))
        )
        steps: list = []  # metrics per step
        tracked: list = []
        if self._resident is not None:
            self._run_epoch_resident(epoch, scalars, steps, tracked)
        else:
            self._run_epoch_streamed(epoch, scalars, steps, tracked)
        self._log_tracked(epoch, tracked)
        self._epoch_end_dacp(epoch)
        return average_metrics(materialize_metrics(steps, METRIC_KEYS))

    def _run_epoch_streamed(self, epoch, scalars, steps, tracked) -> None:
        n = 0
        # over a mesh the step takes each rank's rows of the host batches
        pairs = prefetch(
            paired_epoch(self.clean_train, self.noisy_train, epoch),
            depth=self.prefetch_depth, to_device=self.mesh is None,
            transfer_fp32_as=self.transfer_dtype if self.mesh is None else None,
            device=self.device,
        )
        for clean_b, noisy_b in pairs:
            draws = self._draws(epoch, n, noisy_b.feats, noisy_b.padding_mask)
            self.state, metrics, tracking = self.train_step(
                self.state, clean_b, noisy_b, scalars, self.anchors, self.generator, draws
            )
            steps.append(metrics)
            n += 1
            if self._tracking(epoch):
                tracked.append(tracking)

    def _run_epoch_resident(self, epoch, scalars, steps, tracked) -> None:
        """Per step the host ships two (B,) index vectors; the batches are
        gathered on the device at their own buckets."""
        clean_c, noisy_c = self._resident
        cap = self.clean_train.max_frames
        for n, ((cidx, t_c), (nidx, t_n)) in enumerate(
                paired_index_epoch(self.clean_train, self.noisy_train, epoch)):
            self.state, metrics, tracking = self._resident_step(
                self.state, clean_c, noisy_c, upload_index(cidx, self.device),
                upload_index(nidx, self.device), scalars, self.anchors, self.generator,
                lambda b, n=n: self._draws(epoch, n, b.feats, b.padding_mask),
                t_clean=t_c, t_noisy=t_n, frame_cap=cap,
            )
            steps.append(metrics)
            if self._tracking(epoch):
                tracked.append(tracking)

    def _log_tracked(self, epoch: int, tracked: list) -> None:
        """The tracked samples' rows of this epoch's steps, in step and row
        order, taken from the device in one pass."""
        for host in materialize_tracking(tracked):
            for i, sid in enumerate(host["ids"]):
                if int(sid) in self.tracked_sample_indices:
                    self.bias_analysis_log.append(
                        {
                            "epoch": epoch,
                            "sample_id": int(sid),
                            "pseudo_label": int(host["pseudo_label"][i]),
                            "certainty_score": float(host["certainty_score"][i]),
                            "is_masked_in": bool(host["is_masked_in"][i]),
                        }
                    )

    def _epoch_end_dacp(self, epoch: int) -> None:
        """Post-epoch DACP quality update and its analysis history."""
        cfg = self.cfg
        if self.is_warmup(epoch):
            return
        self.state = epoch_end_dacp(self.state, cfg)
        self.training_history["dacp_ema_thresholds"].append(
            self.state.dacp.ema_thresholds.cpu().tolist()
        )
        quality = self.state.dacp.quality.cpu().numpy()
        self.training_history["dacp_class_quality"].append(quality.tolist())
        attn = np.exp(
            cfg.ecda.class_attention_lambda * (quality.mean() - quality)
        )
        self.training_history["ecda_class_attention"].append(attn.tolist())

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _predict_all(self, it: PaddedBatchIterator, roles):
        """(y_true, {role: y_pred}) over the labelled valid rows of ``it``,
        each role's params on the same transferred batches."""
        preds = {r: [] for r in roles}
        labels, valid = [], []
        for b in prefetch(it, depth=self.prefetch_depth, to_device=True, device=self.device):
            for r in roles:
                p, _ = self.eval_step(getattr(self.state.ssrl, r), b.feats, b.padding_mask)
                preds[r].append(p)
            labels.append(b.labels)
            valid.append(b.row_valid)
        if not labels:
            empty = np.zeros(0, np.int64)
            return empty, {r: empty for r in roles}
        y = torch.cat(labels).cpu().numpy()
        keep = torch.cat(valid).cpu().numpy() & (y >= 0)
        return (y[keep].astype(np.int64),
                {r: torch.cat(preds[r]).cpu().numpy()[keep].astype(np.int64) for r in roles})

    def validate(self, it: PaddedBatchIterator, domain: str, epoch: int = 0) -> Dict:
        teacher = "noisy" in domain.lower() and not self.is_warmup(epoch)
        y_true, preds = self._predict_all(it, ("student", "teacher") if teacher else ("student",))
        if teacher:
            rate = float(np.mean(preds["student"] != preds["teacher"]))
            self.training_history[f"disagreement_rate_{domain.lower()}"].append(rate)
        return evaluate_domain(y_true, preds["student"], self.num_classes)

    # ------------------------------------------------------------------
    @property
    def best_path(self) -> str:
        return os.path.join(self.results_dir, "models",
                            f"{self.cfg.corpus}_cross_domain_best.pth")

    def save_checkpoint(self, epoch, clean_results, noisy_results, is_best):
        if not is_best:
            return
        self.best_results.update(
            {"epoch": epoch, "clean_results": clean_results, "noisy_results": noisy_results}
        )
        if not self.is_writer:
            return
        # reference-layout torch checkpoint, loadable by the reference's
        # inference/analysis scripts and by the JAX package
        save_torch_file(ssrl_to_torch_state_dict(self.state.ssrl), self.best_path)
        best_detailed_results(
            self.results_dir, self.noise_info, self.fold, epoch,
            clean_results, noisy_results, self.class_names, is_best=True,
        )
        save_confusion_matrices(
            self.results_dir, clean_results, noisy_results, epoch,
            self.class_names, self.noise_info["display_name"], is_best=True,
        )
        logger.info("best checkpoint saved at epoch %d", epoch + 1)

    def check_early_stopping(self, noisy_results, is_best) -> bool:
        if not self.cfg.early_stopping:
            return False
        if is_best:
            self.patience_counter = 0
            return False
        self.patience_counter += 1
        return self.patience_counter >= self.cfg.patience

    # ------------------------------------------------------------------
    # full-state checkpoint/resume (the reference has none)
    @property
    def _last_state_path(self) -> str:
        return os.path.join(self.results_dir, "models", "last_state.pt")

    def save_resume_checkpoint(self, epoch: int) -> None:
        if not self.is_writer:
            return
        save_train_state(
            self._last_state_path,
            self.state,
            self.generator,
            metadata={
                "epoch": epoch,
                "best_noisy_weighted_acc": self.best_noisy_weighted_acc,
                "best_clean_weighted_acc": self.best_clean_weighted_acc,
                "patience_counter": self.patience_counter,
                "anchors": self.anchors.cpu().tolist(),
                # analysis artifacts, so a resumed run writes the COMPLETE
                # training_history.json / confirmation_bias_log.json
                "training_history": self.training_history,
                "bias_analysis_log": self.bias_analysis_log,
            },
        )

    def try_resume(self) -> int:
        """Restores the full train state and the generator if a resume
        checkpoint exists; returns the epoch to continue from (0 if fresh)."""
        if not os.path.exists(self._last_state_path):
            return 0
        self.state, meta = restore_train_state(self._last_state_path, self.state,
                                               self.generator)
        start = 0
        if meta:
            self.best_noisy_weighted_acc = meta["best_noisy_weighted_acc"]
            self.best_clean_weighted_acc = meta["best_clean_weighted_acc"]
            self.patience_counter = meta["patience_counter"]
            self.anchors = torch.tensor(meta["anchors"], dtype=torch.float32,
                                        device=self.device)
            # a defaultdict again: a series that starts after the resume
            # point (the DACP history of a run resumed in warmup) appends
            self.training_history = defaultdict(list, meta["training_history"])
            self.bias_analysis_log = meta["bias_analysis_log"]
            start = int(meta["epoch"]) + 1
        logger.info("resumed from %s at epoch %d", self._last_state_path, start)
        return start

    def train(self, resume: bool = False, checkpoint_interval: int = 25) -> Dict:
        cfg = self.cfg
        logger.info(
            "starting %s cross-domain training fold %d (%s) on %s",
            cfg.corpus, self.fold + 1, self.noise_info["display_name"], self.device,
        )
        start_epoch = self.try_resume() if resume else 0
        for epoch in range(start_epoch, cfg.epochs):
            avg = self.train_epoch(epoch)
            for k, v in avg.items():
                self.training_history[k].append(v)
            if checkpoint_interval and (epoch + 1) % checkpoint_interval == 0:
                self.save_resume_checkpoint(epoch)

            should_validate = (epoch + 1) % cfg.validation_interval == 0 or not self.is_warmup(epoch)
            if not should_validate:
                continue
            clean_results = self.validate(self.clean_val, "Clean", epoch)
            noisy_results = self.validate(self.noisy_val, "Noisy", epoch)
            is_best = (
                noisy_results["weighted_accuracy"]
                > self.best_noisy_weighted_acc + cfg.min_delta
            )
            if is_best:
                self.best_noisy_weighted_acc = noisy_results["weighted_accuracy"]
                self.best_clean_weighted_acc = clean_results["weighted_accuracy"]
            self.save_checkpoint(epoch, clean_results, noisy_results, is_best)
            logger.info(
                "epoch %d/%d | total %.4f ce %.4f kd %.4f ecda %.4f | noisy WA %.2f%%%s",
                epoch + 1, cfg.epochs, avg.get("total_loss", 0),
                avg.get("supervised_ce_loss", 0), avg.get("consistency_loss", 0),
                avg.get("ecda_loss", 0), noisy_results["weighted_accuracy"],
                " *best*" if is_best else "",
            )
            if self.check_early_stopping(noisy_results, is_best):
                logger.info("early stopping triggered")
                break

        self._save_analysis_data()
        final = self._evaluate_on_test_set()
        out = {
            "best_noisy_weighted_acc": self.best_noisy_weighted_acc,
            "results_dir": self.results_dir,
        }
        if final is not None:
            # best-checkpoint test metrics (None when no best was ever saved)
            out["clean_test"], out["noisy_test"] = final
        return out

    def _save_analysis_data(self):
        if not self.is_writer:
            return
        dump_json(
            dict(self.training_history),
            os.path.join(self.results_dir, "reports", "training_history.json"),
        )
        if self.bias_analysis_log:
            dump_json(
                self.bias_analysis_log,
                os.path.join(self.results_dir, "reports", "confirmation_bias_log.json"),
            )

    def final_summary(self) -> Dict:
        return {
            "fold": self.fold + 1,
            "noise": self.noise_info["display_name"],
            "best_noisy_weighted_acc": self.best_noisy_weighted_acc,
            "best_clean_weighted_acc": self.best_clean_weighted_acc,
            "results_dir": self.results_dir,
        }

    def _evaluate_on_test_set(self):
        if self.mesh is not None:
            torch.distributed.barrier()  # rank 0's best checkpoint is on disk
        if not os.path.exists(self.best_path):
            # reference train.py:704-707: warn and skip; evaluating
            # last-epoch weights would masquerade as a best-model result
            logger.warning("no best checkpoint at %s; skipping test-set "
                           "evaluation", self.best_path)
            return None
        best = torch_state_dict_to_ssrl(load_torch_file(self.best_path))
        self.state = self.state._replace(ssrl=SSRLState(
            *({k: v.to(self.device) for k, v in params.items()} for params in best)))
        clean_test = self.validate(self.clean_test, "Clean_Test")
        noisy_test = self.validate(self.noisy_test, "Noisy_Test")
        logger.info(
            "final test | clean WA %.2f%% | noisy WA %.2f%%",
            clean_test["weighted_accuracy"], noisy_test["weighted_accuracy"],
        )
        if not self.is_writer:
            return clean_test, noisy_test
        best_detailed_results(
            self.results_dir, self.noise_info, self.fold, 999,
            clean_test, noisy_test, self.class_names, is_best=False,
        )
        save_confusion_matrices(
            self.results_dir, clean_test, noisy_test, 999, self.class_names,
            self.noise_info["display_name"],
        )
        final_test_report(
            self.results_dir, self.noise_info, self.fold,
            clean_test, noisy_test, self.best_noisy_weighted_acc,
        )
        return clean_test, noisy_test


def run_cv(
    cfg: DADConfig,
    folds: Optional[Iterable[int]] = None,
    experiment_name: Optional[str] = None,
    clean_store: Optional[FeatureStore] = None,
    noisy_store: Optional[FeatureStore] = None,
    pretrain_params: Optional[Dict[str, torch.Tensor]] = None,
    prefetch_depth: int = 2,
    transfer_dtype: Optional[str] = None,
    mesh=None,
    resident=False,
    resident_max_bytes: int = RESIDENT_MAX_BYTES,
    device="cuda",
) -> Dict:
    """Full K-fold cross-validation sweep with an aggregate summary report.

    The reference's ``main()`` runs one fold at a time with a try/except
    keeping the sweep alive (train.py:765-789); this function runs all folds,
    keeps the sweep alive across a failed fold the same way, and writes the
    ``final_summary_report.json`` the reference left commented out
    (train.py:797-800).
    """
    n_folds = {"iemocap": 5, "casia": 4, "emodb": 10}[cfg.corpus]
    folds = list(folds) if folds is not None else list(range(n_folds))
    all_results = []
    for fold in folds:
        try:
            trainer = CrossDomainTrainer(
                cfg,
                fold=fold,
                experiment_name=experiment_name,
                clean_store=clean_store,
                noisy_store=noisy_store,
                pretrain_params=pretrain_params,
                prefetch_depth=prefetch_depth,
                transfer_dtype=transfer_dtype,
                mesh=mesh,
                resident=resident,
                resident_max_bytes=resident_max_bytes,
                device=device,
            )
            trainer.train()
            all_results.append(trainer.final_summary())
        except Exception as e:  # keep the sweep alive (train.py:786-789)
            logger.error("fold %d failed: %s", fold + 1, e, exc_info=True)
            all_results.append({"fold": fold + 1, "error": str(e)})
    ok = [r for r in all_results if "error" not in r]
    summary = {
        "noise": extract_noise_info(cfg.noisy_data_dir)["display_name"],
        "folds": all_results,
        "mean_noisy_weighted_acc": float(
            np.mean([r["best_noisy_weighted_acc"] for r in ok])
        )
        if ok
        else None,
        "std_noisy_weighted_acc": float(
            np.std([r["best_noisy_weighted_acc"] for r in ok])
        )
        if ok
        else None,
    }
    out_dir = cfg.results_base_dir
    if experiment_name:
        out_dir = os.path.join(out_dir, _safe_name(experiment_name))
    if mesh is None or mesh.is_writer:
        dump_json(summary, os.path.join(out_dir, "final_summary_report.json"))
    return summary
