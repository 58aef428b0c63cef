"""Supervised pretrain stage: speaker-isolated K-fold CV with early stopping
(``cli pretrain``).

The reference's train_with_early_stopping (train_for_clean.py:62-391): a
``PretrainHead`` trained with cross-entropy over bucketed batches, the
per-epoch learning-rate schedulers and early stopping on the host, the best
checkpoint per fold in the reference's ``pre_net``/``post_net`` layout (the
file the DAD stage loads, readable by both packages) and the same
summary/report JSONs.

The optimizer is Adam with coupled L2 weight decay (the decay added into
the gradient before the moments: torch ``Adam(weight_decay=...)``, not
AdamW), as the JAX package's ``add_decayed_weights -> scale_by_adam``
chain. It is the DAD step's functional ``Optimizer``, which rounds in
optax's order: ``torch.optim.Adam`` rounds its bias corrections in another
order, and after a few epochs its weights part from the JAX package's by
more than float32 summation order explains. The scheduler's learning rate
replaces the optimizer state's after every epoch. An epoch reads its
losses and correct counts back once, at its end.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..configs import PretrainConfig
from ..dad.train_step import Optimizer, apply_updates, set_learning_rate
from ..data.batching import PaddedBatchIterator
from ..data.folds import corpus_fold_split
from ..data.prefetch import prefetch
from ..data.store import FeatureStore, load_feature_store
from ..eval.metrics import accuracy, balanced_accuracy, classification_report_text, f1_scores
from ..models.convert import save_pretrain_head_checkpoint
from ..models.heads import PretrainHead, init_pretrain_head
from ..utils import dump_json, get_logger, resolve_device
from .early_stopping import EarlyStopper
from .schedules import make_lr_scheduler

logger = get_logger(__name__)

HISTORY_KEYS = ("train_loss", "train_acc", "val_loss", "val_acc", "val_weighted_acc",
                "val_f1", "epochs", "lr")


def build_pretrain_optimizer(cfg: PretrainConfig) -> Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with coupled L2 weight decay, no
    clipping."""
    return Optimizer(None, cfg.weight_decay, cfg.learning_rate)


def pretrain_loss(logits: torch.Tensor, labels: torch.Tensor, row_valid: torch.Tensor):
    """CE over the valid rows (filler rows weigh nothing), the predictions
    and the count of correct valid rows."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(torch.clamp(labels.long(), 0, C - 1), C).to(logp.dtype)
    per_row = -torch.sum(onehot * logp, dim=-1)
    w = row_valid.to(logp.dtype)
    loss = torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)
    preds = torch.argmax(logits, dim=-1)
    correct = torch.sum((preds == labels) & row_valid)
    return loss, preds, correct


def make_pretrain_steps(head: PretrainHead, tx: Optimizer):
    """(train_step, eval_step) over a ``PretrainHead`` state dict."""

    def loss_fn(params, batch):
        logits = functional_call(head, params, (batch.feats, batch.padding_mask))
        return pretrain_loss(logits, batch.labels, batch.row_valid)

    def train_step(params, opt_state, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, _preds, correct = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss.detach(), correct

    @torch.no_grad()
    def eval_step(params, batch):
        loss, preds, _correct = loss_fn(params, batch)
        return loss, preds

    return train_step, eval_step


def _run_eval(eval_step, params, it: PaddedBatchIterator, device):
    """(mean batch loss, y_true, y_pred) over the valid rows, read back once."""
    losses, preds, labels, valid = [], [], [], []
    for batch in prefetch(it, depth=2, to_device=True, device=device):
        loss, p = eval_step(params, batch)
        losses.append(loss)
        preds.append(p)
        labels.append(batch.labels)
        valid.append(batch.row_valid)
    if not losses:
        return 0.0, np.zeros(0, np.int64), np.zeros(0, np.int64)
    keep = torch.cat(valid).cpu().numpy()
    y_true = torch.cat(labels).cpu().numpy()[keep].astype(np.int64)
    y_pred = torch.cat(preds).cpu().numpy()[keep].astype(np.int64)
    return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64))), y_true, y_pred


def pretrain_fold(
    cfg: PretrainConfig,
    store: FeatureStore,
    fold: int,
    seed: Optional[int] = None,
    device="cuda",
    init_params: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict:
    """Trains one fold; returns {params, best_epoch, history, test}.
    ``fold`` is 0-based. ``params`` is the best epoch's ``PretrainHead``
    state dict, on ``device``.

    The head is drawn from a ``torch.Generator`` seeded ``seed + fold``;
    ``init_params`` (a ``PretrainHead`` state dict) starts from given
    weights instead, a test hook."""
    seed = cfg.random_seed if seed is None else seed
    dev = resolve_device(device)
    num_classes = cfg.num_classes

    tr_idx, va_idx, te_idx = corpus_fold_split(cfg.corpus, fold, store.groups)
    its = {
        name: PaddedBatchIterator(store.subset(idx), cfg.batch_size, cfg.length_buckets,
                                  shuffle=(name == "train"), seed=seed)
        for name, idx in (("train", tr_idx), ("val", va_idx), ("test", te_idx))
    }

    gen = torch.Generator(device=dev).manual_seed(seed + fold)
    head, params = init_pretrain_head(gen, cfg.input_dim, cfg.hidden_dim, num_classes,
                                      device=dev)
    if init_params is not None:
        params = {k: init_params[k].to(device=dev, dtype=torch.float32) for k in params}
    tx = build_pretrain_optimizer(cfg)
    opt_state = tx.init(params)
    train_step, eval_step = make_pretrain_steps(head, tx)

    scheduler = make_lr_scheduler(cfg)
    per_epoch_schedule = cfg.lr_scheduler_type in ("CosineAnnealingWarmRestarts", "StepLR")
    stopper = EarlyStopper(cfg.early_stopping_patience, cfg.early_stopping_min_delta,
                           cfg.early_stopping_mode)
    history = {k: [] for k in HISTORY_KEYS}
    best_metric = float("-inf") if cfg.early_stopping_mode == "max" else float("inf")
    best_params = params
    best_epoch = 0
    metric_key = cfg.early_stopping_metric

    for epoch in range(cfg.max_epochs):
        t0 = time.time()
        its["train"].set_epoch(epoch)
        losses, corrects, valid = [], [], []
        for batch in prefetch(its["train"], depth=2, to_device=True, device=dev):
            params, opt_state, loss, correct = train_step(params, opt_state, batch)
            losses.append(loss)
            corrects.append(correct)
            valid.append(batch.row_valid.sum())
        # the JAX package's host sums: each step's f32 loss added in step
        # order in double precision
        train_loss = (sum(float(x) for x in torch.stack(losses).cpu().numpy()) / len(losses)
                      if losses else 0.0)
        train_acc = (int(torch.stack(corrects).sum()) / max(int(torch.stack(valid).sum()), 1)
                     if losses else 0.0)

        val_loss, y_true, y_pred = _run_eval(eval_step, params, its["val"], dev)
        val_acc = accuracy(y_true, y_pred)
        val_wacc = balanced_accuracy(y_true, y_pred, num_classes)
        val_f1 = f1_scores(y_true, y_pred, num_classes)["macro"]

        lr = scheduler.step(epoch + 1, None if per_epoch_schedule else val_loss)
        opt_state = set_learning_rate(opt_state, lr)

        for key, value in zip(HISTORY_KEYS, (train_loss, train_acc, val_loss, val_acc,
                                             val_wacc, val_f1, epoch + 1, lr)):
            history[key].append(value)

        current = {"val_loss": val_loss, "val_acc": val_acc,
                   "val_weighted_acc": val_wacc, "val_f1": val_f1}[metric_key]
        better = (current > best_metric if cfg.early_stopping_mode == "max"
                  else current < best_metric)
        if better:
            best_metric = current
            best_epoch = epoch + 1
            # every step returns new tensors: nothing aliases later epochs
            best_params = params

        logger.info(
            "fold %d epoch %3d/%d train_loss %.4f train_acc %.4f %s %.4f "
            "(best %.4f @%d) lr %.2e %.1fs",
            fold + 1, epoch + 1, cfg.max_epochs, train_loss, train_acc,
            metric_key, current, best_metric, best_epoch, lr, time.time() - t0,
        )
        if stopper(current, epoch + 1):
            logger.info("early stopping at epoch %d", epoch + 1)
            break

    # test with the best params
    _loss, y_true, y_pred = _run_eval(eval_step, best_params, its["test"], dev)
    return {
        "params": best_params,
        "best_epoch": best_epoch,
        "history": history,
        "test": {
            "y_true": y_true,
            "y_pred": y_pred,
            "accuracy": accuracy(y_true, y_pred),
            "weighted_accuracy": balanced_accuracy(y_true, y_pred, num_classes),
            "f1_macro": f1_scores(y_true, y_pred, num_classes)["macro"],
        },
    }


def train_with_early_stopping(
    cfg: PretrainConfig,
    store: Optional[FeatureStore] = None,
    folds: Optional[Tuple[int, ...]] = None,
    device="cuda",
) -> Dict:
    """The K-fold CV loop (train_for_clean.py:62-391): per-fold training,
    the best checkpoint per fold (``best_model_fold_N.ckpt``, the
    reference's layout), the classification reports and the aggregate
    summary JSONs."""
    if store is None:
        store = load_feature_store(cfg.feat_path, cfg.label_map)
    if not store.validate():
        raise ValueError("feature store failed integrity validation")
    if store.dim != cfg.input_dim:
        logger.info("adjusting input_dim %d -> %d (from feature store)",
                    cfg.input_dim, store.dim)
        cfg = replace(cfg, input_dim=store.dim)

    folds = tuple(folds) if folds is not None else tuple(range(cfg.n_folds))
    save_dir = cfg.save_dir
    os.makedirs(save_dir, exist_ok=True)

    fold_results, fold_weighted, fold_f1 = [], [], []
    training_history = {}
    for fold in folds:
        logger.info("=" * 30 + f" FOLD {fold + 1}/{cfg.n_folds} " + "=" * 30)
        out = pretrain_fold(cfg, store, fold, device=device)
        training_history[f"fold_{fold + 1}"] = out["history"]
        save_pretrain_head_checkpoint(
            out["params"], os.path.join(save_dir, f"best_model_fold_{fold + 1}.ckpt"))

        test = out["test"]
        fold_results.append(test["accuracy"])
        fold_weighted.append(test["weighted_accuracy"])
        fold_f1.append(test["f1_macro"])
        report = classification_report_text(test["y_true"], test["y_pred"], cfg.class_names)
        with open(os.path.join(save_dir, f"test_classification_report_fold_{fold + 1}.txt"),
                  "w") as f:
            f.write(f"Fold {fold + 1} Test Results:\n")
            f.write(f"Test Accuracy: {test['accuracy']:.4f}\n")
            f.write(f"Test Weighted Accuracy: {test['weighted_accuracy']:.4f}\n")
            f.write(f"Test Macro F1-score: {test['f1_macro']:.4f}\n\n")
            f.write("Test Classification Report:\n")
            f.write(report)
        logger.info("fold %d test acc %.4f w-acc %.4f f1 %.4f", fold + 1,
                    test["accuracy"], test["weighted_accuracy"], test["f1_macro"])

    summary = {
        "mean_test_accuracy": float(np.mean(fold_results)),
        "std_test_accuracy": float(np.std(fold_results)),
        "mean_test_weighted_accuracy": float(np.mean(fold_weighted)),
        "std_test_weighted_accuracy": float(np.std(fold_weighted)),
        "mean_test_f1": float(np.mean(fold_f1)),
        "std_test_f1": float(np.std(fold_f1)),
        "fold_test_accuracies": fold_results,
        "fold_test_weighted_accuracies": fold_weighted,
        "fold_test_f1_scores": fold_f1,
        # 1-based fold numbers, as the checkpoint names
        "best_fold_accuracy": folds[int(np.argmax(fold_results))] + 1,
        "best_test_accuracy": float(np.max(fold_results)),
        "worst_fold_accuracy": folds[int(np.argmin(fold_results))] + 1,
        "worst_test_accuracy": float(np.min(fold_results)),
    }
    dump_json(summary, os.path.join(save_dir, "test_results.json"))
    dump_json(training_history, os.path.join(save_dir, "training_history.json"))
    plot_training_history(training_history, save_dir, cfg.corpus)
    return summary


def plot_training_history(training_history, save_dir, dataset_name="iemocap"):
    """Per-fold loss/accuracy curves (train_for_clean.py:475-513); skipped
    without matplotlib."""
    from ..analysis.common import get_pyplot

    plt = get_pyplot()
    if plt is None:
        logger.warning("matplotlib is not installed: training-history plots skipped")
        return
    for fold_key, history in training_history.items():
        epochs = history["epochs"]
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
        ax1.plot(epochs, history["train_loss"], marker="o", label="Train Loss")
        ax1.plot(epochs, history["val_loss"], marker="o", label="Validation Loss")
        ax1.set_xlabel("Epochs")
        ax1.set_ylabel("Loss")
        ax1.legend()
        ax1.grid(True)
        ax2.plot(epochs, history["train_acc"], marker="o", label="Train Accuracy")
        ax2.plot(epochs, history["val_acc"], marker="o", label="Validation Accuracy")
        ax2.set_xlabel("Epochs")
        ax2.set_ylabel("Accuracy")
        ax2.legend()
        ax2.grid(True)
        fig.suptitle(f"{dataset_name.upper()} Training History - {fold_key}")
        fig.savefig(os.path.join(save_dir, f"training_history_{fold_key}.png"), dpi=150,
                    bbox_inches="tight")
        plt.close(fig)
