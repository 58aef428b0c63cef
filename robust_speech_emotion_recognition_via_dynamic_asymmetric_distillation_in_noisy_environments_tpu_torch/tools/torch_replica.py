"""Reference-faithful PyTorch replica of both training stages: the yardstick
of the accuracy-parity protocol (``tools/run_parity.py``).

The reference repo publishes no numbers and its full stack (fairseq/timm)
is not installed, so the "reference numbers" come from a faithful torch
re-implementation of the two trainable stages, run head-to-head against
the port on the same corpora. It is the replica of the original repo, not
a second port of the trainer: it keeps the reference's global seeding,
``DataLoader`` collator, EMA teacher, DACP and ECDA.

Faithfulness contract (all semantics re-derived from the reference, cited):
- Pretrain stage  = IEMOCAP/pretrain-and-processed-IEMOCAP/train_for_clean.py
  :33-60 (EarlyStopper), :155-200 (Adam + CE + ReduceLROnPlateau),
  :393-449 (train/validate epochs), model.py:4-21 (BaseModel).
- DAD stage       = IEMOCAP/DAD-train-IEMOCAP/train.py :317-357 (anchor
  calibration), :377-395 (warmup/ramps), :397-471 (train_step),
  :473-520 (epoch loop + epoch-end DACP update), :638-662 (validation
  cadence + early stop), model.py:67-265 (SSRLModel incl. EMA teacher),
  utils.py:317-375 (DataAugmentation), :379-507 (DACPManager),
  :510-652 (ECDALoss).

Data plumbing (feature store, fold splits, metrics) is the port's, so the
comparison isolates the *training math*, not IO: both sides consume the
same ``FeatureStore`` subsets from ``data.folds.corpus_fold_split``.

``device`` (``pretrain_fold_torch``, ``dad_train_fold_torch``; default
"cuda", which raises without a GPU): the models are built there, every
batch is moved there, and every draw of the training math (init, dropout,
augmentation) comes from that device's generator, seeded by the
reference's ``torch.manual_seed``. The loaders shuffle on the host, as
the reference's do. On the CPU the results are bit-equal to the JAX
system's ``tools/torch_replica.py``.

This is a verification asset, not on any production path.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.data import DataLoader, Dataset

from ..configs import DADConfig, PretrainConfig
from ..data.folds import corpus_fold_split
from ..data.store import FeatureStore
from ..eval.metrics import evaluate_domain
from ..utils import resolve_device


# ---------------------------------------------------------------------------
# data: FeatureStore subset -> torch DataLoader with the reference collator
# (right-pad to batch max, bool padding_mask True=pad — data.py:143-170)
# ---------------------------------------------------------------------------
class _StoreDataset(Dataset):
    def __init__(self, store: FeatureStore, with_labels: bool = True):
        self.store = store
        self.with_labels = with_labels and store.labels is not None

    def __len__(self):
        return len(self.store.sizes)

    def __getitem__(self, i):
        feats = torch.from_numpy(np.ascontiguousarray(self.store.clip(i)))
        label = int(self.store.labels[i]) if self.with_labels else -1
        return {"id": i, "feats": feats, "target": label}


def _collate(samples):
    feats = [s["feats"] for s in samples]
    sizes = [f.shape[0] for f in feats]
    t_max = max(sizes)
    out = feats[0].new_zeros(len(feats), t_max, feats[0].shape[-1])
    pad = torch.zeros(len(feats), t_max, dtype=torch.bool)
    for i, (f, sz) in enumerate(zip(feats, sizes)):
        out[i, :sz] = f
        pad[i, sz:] = True
    return {
        "id": torch.tensor([s["id"] for s in samples], dtype=torch.long),
        "net_input": {"feats": out, "padding_mask": pad},
        "labels": torch.tensor([s["target"] for s in samples], dtype=torch.long),
    }


def make_loader(
    store: FeatureStore,
    batch_size: int,
    shuffle: bool,
    seed: int = 0,
    with_labels: bool = True,
) -> DataLoader:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return DataLoader(
        _StoreDataset(store, with_labels),
        batch_size=batch_size,
        shuffle=shuffle,
        collate_fn=_collate,
        generator=gen if shuffle else None,
        num_workers=0,
        drop_last=False,
    )


def _batches(loader: DataLoader, device: torch.device):
    """The loader's batches with their tensors on ``device``."""
    for b in loader:
        yield {
            "id": b["id"],
            "net_input": {k: v.to(device) for k, v in b["net_input"].items()},
            "labels": b["labels"].to(device),
        }


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
class PretrainBaseModel(nn.Module):
    """Linear d->h, ReLU, masked mean-pool, Linear h->C
    (reference pretrain model.py:4-21; keys pre_net/post_net)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_classes: int):
        super().__init__()
        self.pre_net = nn.Linear(input_dim, hidden_dim)
        self.post_net = nn.Linear(hidden_dim, num_classes)
        self.activate = nn.ReLU()

    def forward(self, x, padding_mask):
        x = self.activate(self.pre_net(x))
        keep = (~padding_mask).float().unsqueeze(-1)
        x = (x * keep).sum(dim=1) / keep.sum(dim=1).clamp(min=1.0)
        return self.post_net(x)


class _Encoder(nn.Module):
    """pre_net + ReLU + masked mean-pool (DAD model.py:6-41)."""

    def __init__(self, input_dim, hidden_dim):
        super().__init__()
        self.pre_net = nn.Linear(input_dim, hidden_dim)

    def forward(self, x, padding_mask):
        x = F.relu(self.pre_net(x))
        keep = (~padding_mask).float().unsqueeze(-1)
        return (x * keep).sum(dim=1) / keep.sum(dim=1).clamp(min=1.0)


class _Classifier(nn.Module):
    """Dropout + Linear (DAD model.py:44-64; key fc_layer)."""

    def __init__(self, hidden_dim, num_classes, dropout):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.fc_layer = nn.Linear(hidden_dim, num_classes)

    def forward(self, x):
        return self.fc_layer(self.dropout(x))


class TorchSSRL(nn.Module):
    """Student + EMA teacher pair (DAD model.py:67-265)."""

    def __init__(self, cfg: DADConfig):
        super().__init__()
        self.student_encoder = _Encoder(cfg.input_dim, cfg.hidden_dim)
        self.student_classifier = _Classifier(
            cfg.hidden_dim, cfg.num_classes, cfg.dropout_rate
        )
        self.teacher_encoder = _Encoder(cfg.input_dim, cfg.hidden_dim)
        self.teacher_classifier = _Classifier(cfg.hidden_dim, cfg.num_classes, 0.0)
        self.ema_momentum = cfg.ema_momentum

    def load_pretrain(self, sd: Dict[str, torch.Tensor]):
        """pre_net.* -> student_encoder, post_net.* -> fc_layer
        (DAD model.py:143-198), then teacher := student (:200-209)."""
        enc = {k: v for k, v in sd.items() if k.startswith("pre_net")}
        cls = {
            k.replace("post_net", "fc_layer"): v
            for k, v in sd.items()
            if k.startswith("post_net")
        }
        self.student_encoder.load_state_dict(enc, strict=False)
        self.student_classifier.load_state_dict(cls, strict=False)
        self.init_teacher()

    def init_teacher(self):
        for t, s in zip(self.teacher_encoder.parameters(), self.student_encoder.parameters()):
            t.data.copy_(s.data)
            t.requires_grad = False
        for t, s in zip(self.teacher_classifier.parameters(), self.student_classifier.parameters()):
            t.data.copy_(s.data)
            t.requires_grad = False

    @torch.no_grad()
    def update_teacher_ema(self):
        m = self.ema_momentum
        for t, s in zip(self.teacher_encoder.parameters(), self.student_encoder.parameters()):
            t.data.mul_(m).add_(s.data, alpha=1.0 - m)
        for t, s in zip(self.teacher_classifier.parameters(), self.student_classifier.parameters()):
            t.data.mul_(m).add_(s.data, alpha=1.0 - m)

    @torch.no_grad()
    def predict(self, feats, padding_mask, use_teacher=False):
        self.eval()
        if use_teacher:
            return self.teacher_classifier(self.teacher_encoder(feats, padding_mask))
        return self.student_classifier(self.student_encoder(feats, padding_mask))


# ---------------------------------------------------------------------------
# DAD algorithm kernels
# ---------------------------------------------------------------------------
class TorchAugmenter:
    """Weak/strong feature-space augmentation (utils.py:317-375): weak =
    +N(0, weak_std^2); strong = +N(0, strong_std^2) then one per-batch
    feature-channel dropout mask then per-sample contiguous temporal mask."""

    def __init__(self, cfg: DADConfig):
        a = cfg.augment
        self.weak_std = a.weak_noise_std
        self.strong_std = a.strong_noise_std
        self.drop = a.feature_dropout_rate
        self.tmask = a.temporal_mask_ratio

    def weak(self, x):
        return x + torch.randn_like(x) * self.weak_std

    def strong(self, x):
        out = x + torch.randn_like(x) * self.strong_std
        if self.drop > 0:
            chan = (torch.rand(out.shape[-1], device=out.device) > self.drop).float()
            out = out * chan
        if self.tmask > 0 and out.dim() == 3:
            b, t = out.shape[0], out.shape[1]
            mlen = int(t * self.tmask)
            if mlen > 0:
                out = out.clone()
                for i in range(b):
                    s = torch.randint(0, max(1, t - mlen + 1), (1,),
                                      device=out.device).item()
                    out[i, s : s + mlen] = 0
        return out


class TorchDACP:
    """Dynamic Adaptive Confidence Pruning state machine (utils.py:379-507)."""

    def __init__(self, cfg: DADConfig, total_epochs: int, device=None):
        self.cfg = cfg.dacp
        self.num_classes = cfg.num_classes
        self.total_epochs = total_epochs
        self.quality = torch.full((cfg.num_classes,), 0.5, device=device)
        self.ema_thresholds = torch.full((cfg.num_classes,), 0.5, device=device)
        self.epoch_scores: List[List[float]] = [[] for _ in range(cfg.num_classes)]

    def certainty(self, probs):
        """s = p_max * (1 - H(p)/log2 C) (utils.py:400-428)."""
        max_p, preds = probs.max(dim=1)
        if self.cfg.use_entropy_in_score:
            ent = -(probs * torch.log2(probs + 1e-8)).sum(dim=1)
            scores = max_p * (1.0 - ent / np.log2(probs.shape[1]))
        else:
            scores = max_p
        return scores, preds

    def epoch_update(self):
        """EMA of per-class epoch-mean scores (utils.py:430-447)."""
        cur = torch.tensor(
            [
                float(np.mean(s)) if s else float(self.quality[i])
                for i, s in enumerate(self.epoch_scores)
            ],
            device=self.quality.device,
        )
        b = self.cfg.quality_smoothing_beta
        self.quality = b * self.quality + (1 - b) * cur
        self.epoch_scores = [[] for _ in range(self.num_classes)]

    def calculate_mask(self, probs, epoch, anchors):
        """Stages 1+3+4 (utils.py:449-507). Mutates ema_thresholds per batch
        and buffers scores for the epoch-end quality update."""
        c = self.cfg
        scores, preds = self.certainty(probs)
        delta = self.quality - self.quality.mean()
        w_ce = torch.sigmoid(c.sensitivity_k * delta)
        gamma = c.quantile_start + (c.quantile_end - c.quantile_start) * (
            epoch / self.total_epochs
        )
        thr = torch.zeros(self.num_classes, device=scores.device)
        for k in range(self.num_classes):
            sel = scores[preds == k]
            thr[k] = (
                torch.quantile(sel, gamma) if sel.numel() > 0 else self.ema_thresholds[k]
            )
        dyn = thr + c.calibration_strength_lambda * (w_ce - 0.5)
        floored = torch.max(dyn, anchors)
        a = c.threshold_smoothing_alpha
        self.ema_thresholds = a * self.ema_thresholds + (1 - a) * floored
        mask = scores >= self.ema_thresholds[preds]
        for k in range(self.num_classes):
            self.epoch_scores[k].extend(scores[preds == k].detach().cpu().numpy())
        return mask, scores, w_ce


class TorchECDA(nn.Module):
    """Class-aware attention-weighted multi-kernel MMD + compactness +
    repulsion (utils.py:510-652)."""

    def __init__(self, cfg: DADConfig):
        super().__init__()
        self.cfg = cfg.ecda
        self.num_classes = cfg.num_classes
        self.fixed_thr = cfg.dacp.fixed_confidence_threshold

    def _kernel_terms(self, src, tgt, w_s, w_t):
        n_s, n_t = src.shape[0], tgt.shape[0]
        both = torch.cat([src, tgt], dim=0)
        d2 = ((both.unsqueeze(0) - both.unsqueeze(1)) ** 2).sum(-1)
        n = n_s + n_t
        bw = (d2.detach().sum() / (n * n - n) if n > 1
              else torch.tensor(1.0, device=d2.device))
        bw = bw / self.cfg.kernel_mul ** (self.cfg.kernel_num // 2)
        kmat = sum(
            torch.exp(-d2 / (bw * self.cfg.kernel_mul**i + 1e-8))
            for i in range(self.cfg.kernel_num)
        )
        kss, ktt, kst = kmat[:n_s, :n_s], kmat[n_s:, n_s:], kmat[:n_s, n_s:]
        wss, wtt, wst = (
            torch.outer(w_s, w_s),
            torch.outer(w_t, w_t),
            torch.outer(w_s, w_t),
        )
        return (
            (kss * wss).sum() / (wss.sum() + 1e-8),
            (ktt * wtt).sum() / (wtt.sum() + 1e-8),
            (kst * wst).sum() / (wst.sum() + 1e-8),
        )

    def forward(self, clean_emb, noisy_emb, clean_labels, noisy_labels, mask, scores, w_ce):
        c = self.cfg
        dev = clean_emb.device
        total = torch.tensor(0.0, device=dev)
        if mask.dtype != torch.bool:
            mask = mask > self.fixed_thr
        if not c.use_class_aware_mmd:
            tgt = noisy_emb[mask]
            if clean_emb.shape[0] >= 2 and tgt.shape[0] >= 2:
                ss, tt, st = self._kernel_terms(
                    clean_emb, tgt, torch.ones(clean_emb.shape[0], device=dev),
                    torch.ones(tgt.shape[0], device=dev)
                )
                total = ss + tt - 2 * st
            return total
        cents, _valid = [], []
        for k in range(self.num_classes):
            sel = noisy_emb[(noisy_labels == k) & mask]
            if sel.shape[0] > 0:
                cents.append(sel.mean(dim=0))
        repulsion = torch.tensor(0.0, device=dev)
        if len(cents) > 1:
            repulsion = -torch.pdist(torch.stack(cents), p=2).mean()
        attn = torch.exp(c.class_attention_lambda * (w_ce.mean() - w_ce))
        for k in range(self.num_classes):
            src = clean_emb[clean_labels == k]
            sel_mask = (noisy_labels == k) & mask
            tgt = noisy_emb[sel_mask]
            if src.shape[0] < 2 or tgt.shape[0] < 2:
                continue
            ss, tt, st = self._kernel_terms(
                src, tgt, torch.ones(src.shape[0], device=dev), scores[sel_mask]
            )
            mmd = ss + tt - 2 * st
            cent = tgt.mean(dim=0)
            compact = ((tgt - cent) ** 2).sum(dim=1).mean()
            total = total + attn[k] * (
                mmd + c.compactness_weight_gamma * compact + c.repulsion_weight_delta * repulsion
            )
        return total


# ---------------------------------------------------------------------------
# stage 1: supervised pretrain (train_for_clean.py:62-391)
# ---------------------------------------------------------------------------
def pretrain_fold_torch(
    cfg: PretrainConfig,
    store: FeatureStore,
    fold: int,
    seed: Optional[int] = None,
    device="cuda",
) -> Dict:
    dev = resolve_device(device)
    seed = cfg.random_seed if seed is None else seed
    torch.manual_seed(seed)
    tr, va, te = corpus_fold_split(cfg.corpus, fold, store.groups)
    train_loader = make_loader(store.subset(tr), cfg.batch_size, True, seed)
    val_loader = make_loader(store.subset(va), cfg.batch_size, False)
    test_loader = make_loader(store.subset(te), cfg.batch_size, False)

    with dev:  # the init draws from the device's generator
        model = PretrainBaseModel(store.dim, cfg.hidden_dim, cfg.num_classes)
    opt = torch.optim.Adam(
        model.parameters(), lr=cfg.learning_rate, weight_decay=cfg.weight_decay
    )
    crit = nn.CrossEntropyLoss()
    # honor the configured scheduler (pretrain config.py LR_SCHEDULER_TYPE);
    # the JAX side routes the same way in train/schedules.py
    if cfg.lr_scheduler_type == "CosineAnnealingWarmRestarts":
        sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
            opt, T_0=cfg.cosine_t_0, T_mult=cfg.cosine_t_mult,
            eta_min=cfg.cosine_eta_min,
        )
        plateau = False
    elif cfg.lr_scheduler_type == "StepLR":
        # same knob mapping as train/schedules.py:102-103
        sched = torch.optim.lr_scheduler.StepLR(
            opt, step_size=cfg.lr_scheduler_patience, gamma=cfg.lr_scheduler_factor
        )
        plateau = False
    else:
        sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
            opt,
            mode="min",
            factor=cfg.lr_scheduler_factor,
            patience=cfg.lr_scheduler_patience,
            min_lr=cfg.lr_scheduler_min_lr,
        )
        plateau = True

    def run_eval(loader):
        model.eval()
        y_true, y_pred, loss_sum = [], [], 0.0
        with torch.no_grad():
            for b in _batches(loader, dev):
                logits = model(b["net_input"]["feats"], b["net_input"]["padding_mask"])
                loss_sum += float(crit(logits, b["labels"]))
                y_pred.extend(logits.argmax(1).tolist())
                y_true.extend(b["labels"].tolist())
        res = evaluate_domain(np.array(y_true), np.array(y_pred), cfg.num_classes)
        res["loss"] = loss_sum / max(len(loader), 1)
        return res

    # best-state snapshot uses plain > (train_for_clean.py:186-236); the
    # EarlyStopper tracks its own best with min_delta (:33-60). Reference
    # metrics are 0-1 scale; evaluate_domain returns percent, so min_delta
    # scales by 100.
    best_metric, best_state = float("-inf"), None
    es_best, patience = float("-inf"), 0
    min_delta = cfg.early_stopping_min_delta * 100
    for _epoch in range(cfg.max_epochs):
        model.train()
        for b in _batches(train_loader, dev):
            opt.zero_grad()
            loss = crit(
                model(b["net_input"]["feats"], b["net_input"]["padding_mask"]),
                b["labels"],
            )
            loss.backward()
            opt.step()
        val = run_eval(val_loader)
        if plateau:
            sched.step(val["loss"])
        else:
            sched.step()
        cur = val["weighted_accuracy"]
        if cur > best_metric:
            best_metric, best_state = cur, copy.deepcopy(model.state_dict())
        if cur > es_best + min_delta:
            es_best, patience = cur, 0
        else:
            patience += 1
            if patience >= cfg.early_stopping_patience:
                break
    if best_state is not None:
        model.load_state_dict(best_state)
    test = run_eval(test_loader)
    return {"state_dict": model.state_dict(), "val_weighted_acc": best_metric, "test": test}


# ---------------------------------------------------------------------------
# stage 2: DAD cross-domain training (train.py:317-762)
# ---------------------------------------------------------------------------
def dad_train_fold_torch(
    cfg: DADConfig,
    clean_store: FeatureStore,
    noisy_store: FeatureStore,
    fold: int,
    pretrain_sd: Optional[Dict[str, torch.Tensor]] = None,
    seed: Optional[int] = None,
    device="cuda",
) -> Dict:
    dev = resolve_device(device)
    seed = cfg.random_seed if seed is None else seed
    torch.manual_seed(seed)
    np.random.seed(seed)

    ctr, cva, cte = corpus_fold_split(cfg.corpus, fold, clean_store.groups)
    ntr, nva, nte = corpus_fold_split(cfg.corpus, fold, noisy_store.groups)
    clean_train = make_loader(clean_store.subset(ctr), cfg.batch_size, True, seed)
    clean_val = make_loader(clean_store.subset(cva), cfg.batch_size, False)
    clean_test = make_loader(clean_store.subset(cte), cfg.batch_size, False)
    noisy_train = make_loader(
        noisy_store.subset(ntr), cfg.batch_size, True, seed + 1, with_labels=False
    )
    noisy_val = make_loader(noisy_store.subset(nva), cfg.batch_size, False)
    noisy_test = make_loader(noisy_store.subset(nte), cfg.batch_size, False)
    calib_clean = make_loader(clean_store.subset(ctr), cfg.batch_size * 2, False)
    calib_noisy = make_loader(noisy_store.subset(nva), cfg.batch_size * 2, False)

    with dev:  # the init draws from the device's generator
        model = TorchSSRL(cfg)
    if pretrain_sd is not None:
        model.load_pretrain(pretrain_sd)
    else:
        model.init_teacher()

    dacp = TorchDACP(cfg, cfg.epochs, device=dev)
    ecda = TorchECDA(cfg)
    aug = TorchAugmenter(cfg)

    # anchor calibration (train.py:317-357): clean TRAIN + noisy VAL at 2x bs
    anchors = torch.zeros(cfg.num_classes, device=dev)
    if cfg.dacp.use_dacp and cfg.dacp.anchor_calibration_enabled:
        per = {"clean": [[] for _ in range(cfg.num_classes)], "noisy": [[] for _ in range(cfg.num_classes)]}
        with torch.no_grad():
            for name, loader in (("clean", calib_clean), ("noisy", calib_noisy)):
                for b in _batches(loader, dev):
                    probs = F.softmax(
                        model.predict(b["net_input"]["feats"], b["net_input"]["padding_mask"]),
                        dim=1,
                    )
                    scores, _ = dacp.certainty(probs)
                    for i, lab in enumerate(b["labels"].tolist()):
                        per[name][lab].append(float(scores[i]))
        mu_c = torch.tensor([np.mean(s) if s else 0.0 for s in per["clean"]],
                            dtype=torch.float32, device=dev)
        mu_n = torch.tensor([np.mean(s) if s else 0.0 for s in per["noisy"]],
                            dtype=torch.float32, device=dev)
        sd_c = torch.tensor([np.std(s) if s else 0.0 for s in per["clean"]],
                            dtype=torch.float32, device=dev)
        anchors = torch.clamp(mu_c - cfg.dacp.anchor_std_k * sd_c, min=0) * (
            mu_n / (mu_c + 1e-8)
        )

    opt = torch.optim.Adam(
        model.parameters(), lr=cfg.learning_rate, weight_decay=cfg.weight_decay
    )
    sched = (
        torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=cfg.epochs)
        if cfg.lr_scheduler == "cosine"
        else None
    )
    ce = nn.CrossEntropyLoss(
        label_smoothing=cfg.label_smoothing_factor if cfg.use_label_smoothing else 0.0
    )
    kl = nn.KLDivLoss(reduction="none")

    def validate(loader):
        y_true, y_pred = [], []
        for b in _batches(loader, dev):
            logits = model.predict(b["net_input"]["feats"], b["net_input"]["padding_mask"])
            y_pred.extend(logits.argmax(1).tolist())
            y_true.extend(b["labels"].tolist())
        return evaluate_domain(np.array(y_true), np.array(y_pred), cfg.num_classes)

    def is_warmup(epoch):
        return epoch < cfg.warmup_epochs

    best_noisy_wa, best_clean_wa, best_state, patience = 0.0, 0.0, None, 0
    for epoch in range(cfg.epochs):
        # loss-weight schedule (train.py:380-395)
        if is_warmup(epoch):
            w_ecda, w_cons = 0.0, 0.0
        else:
            if cfg.progressive_training:
                p = min(1.0, (epoch - cfg.warmup_epochs) / cfg.weight_ramp_epochs)
                w_cons = cfg.initial_consistency_weight + (
                    cfg.final_consistency_weight - cfg.initial_consistency_weight
                ) * p
            else:
                w_cons = cfg.weight_consistency
            if epoch >= cfg.ecda_start_epoch:
                w_ecda = cfg.weight_ecda * min(
                    1.0, (epoch - cfg.ecda_start_epoch) / cfg.weight_ramp_epochs
                )
            else:
                w_ecda = 0.0

        model.train()
        for clean_b, noisy_b in zip(_batches(clean_train, dev), _batches(noisy_train, dev)):
            opt.zero_grad()
            feats, pad, labels = (
                clean_b["net_input"]["feats"],
                clean_b["net_input"]["padding_mask"],
                clean_b["labels"],
            )
            clean_emb = model.student_encoder(feats, pad)
            loss = ce(model.student_classifier(clean_emb), labels)
            if not is_warmup(epoch):
                nf, npad = noisy_b["net_input"]["feats"], noisy_b["net_input"]["padding_mask"]
                weak, strong = aug.weak(nf), aug.strong(nf)
                with torch.no_grad():
                    tprobs = F.softmax(
                        model.teacher_classifier(model.teacher_encoder(weak, npad)), dim=1
                    )
                if cfg.dacp.use_dacp:
                    mask, scores, w_ce_cls = dacp.calculate_mask(tprobs, epoch, anchors)
                else:
                    scores, _ = tprobs.max(dim=1)
                    mask = scores >= cfg.dacp.fixed_confidence_threshold
                    w_ce_cls = torch.ones(cfg.num_classes, device=dev)
                strong_emb = model.student_encoder(strong, npad)
                slogp = F.log_softmax(model.student_classifier(strong_emb), dim=1)
                if mask.sum() > 1:
                    per_sample = kl(slogp, tprobs).sum(dim=1)
                    cons = (per_sample * mask).sum() / (mask.sum() + 1e-8)
                    loss = loss + w_cons * cons
                    if cfg.ecda.use_ecda and w_ecda > 0:
                        pseudo = tprobs.argmax(dim=1)
                        loss = loss + w_ecda * ecda(
                            clean_emb, strong_emb, labels, pseudo, mask, scores, w_ce_cls
                        )
            loss.backward()
            if cfg.gradient_clipping:
                torch.nn.utils.clip_grad_norm_(model.parameters(), cfg.max_grad_norm)
            opt.step()
            if not is_warmup(epoch):
                model.update_teacher_ema()
        if not is_warmup(epoch):
            dacp.epoch_update()
        if sched:
            sched.step()

        # validation cadence quirk (train.py:642): every epoch post-warmup
        should_validate = (epoch + 1) % cfg.validation_interval == 0 or not is_warmup(epoch)
        if not should_validate:
            continue
        noisy_res = validate(noisy_val)
        clean_res = validate(clean_val)
        is_best = noisy_res["weighted_accuracy"] > best_noisy_wa + cfg.min_delta
        if is_best:
            best_noisy_wa = noisy_res["weighted_accuracy"]
            best_clean_wa = clean_res["weighted_accuracy"]
            best_state = copy.deepcopy(model.state_dict())
            patience = 0
        elif cfg.early_stopping:
            patience += 1
            if patience >= cfg.patience:
                break

    if best_state is not None:
        model.load_state_dict(best_state)
    return {
        "best_noisy_weighted_acc": best_noisy_wa,
        "best_clean_weighted_acc": best_clean_wa,
        "clean_test": validate(clean_test),
        "noisy_test": validate(noisy_test),
    }
