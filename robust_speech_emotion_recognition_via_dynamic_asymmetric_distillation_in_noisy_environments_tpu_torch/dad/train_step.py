"""The DAD train step: the reference's per-batch loop body as one function
over a state tuple.

    state = (ssrl: student/teacher head params, opt_state, dacp)
    (state', metrics, tracking) = step(state, clean, noisy, scalars,
                                       anchors, generator)

Epoch-level scalars (warmup flag, consistency/ECDA weights, the DACP
quantile level gamma_e) are computed on the host once per epoch; the
learning rate lives in the optimizer state. Nothing in a step reads a
value back to the host.

The optimizer reproduces the JAX package's optax chain term for term:
global-norm clip, then L2 weight decay added into the gradient, then Adam
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected), then the learning rate. Its
state is optax's (count, mu, nu) plus the injected learning rate, so a JAX
state carries over one to one (``models/convert.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..configs import DADConfig
from ..models.heads import DADHead, SSRLState, ema_update, init_ssrl
from .augment import StrongDraws, strong_augment, weak_augment
from .dacp import DACPState, dacp_epoch_update, dacp_mask, fixed_threshold_mask, init_dacp
from .ecda import ecda_loss

Params = Dict[str, torch.Tensor]


class Batch(NamedTuple):
    """A feature-level batch (the data layer's ``Batch``)."""

    feats: torch.Tensor  # (B, T, D) float32
    padding_mask: torch.Tensor  # (B, T) bool, True = padded frame
    labels: torch.Tensor  # (B,) int, -1 where absent
    ids: Optional[torch.Tensor]  # (B,) clip indices, or None
    row_valid: torch.Tensor  # (B,) bool, False = padded row


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32, Adam's step count
    mu: Params
    nu: Params
    learning_rate: torch.Tensor  # () float32, set per epoch


class DADTrainState(NamedTuple):
    ssrl: SSRLState
    opt_state: AdamState
    dacp: DACPState


class StepScalars(NamedTuple):
    """Per-epoch host-side scalars (the reference's update_loss_weights)."""

    warmup: bool  # epoch < warmup_epochs
    w_consistency: float
    w_ecda: float
    gamma_e: float  # DACP quantile level for this epoch

    @staticmethod
    def for_epoch(cfg: DADConfig, epoch: int) -> "StepScalars":
        warmup = epoch < cfg.warmup_epochs
        w_cons = w_ecda = 0.0
        if not warmup:
            if cfg.progressive_training:
                progress = min(1.0, (epoch - cfg.warmup_epochs) / cfg.weight_ramp_epochs)
                w_cons = (cfg.initial_consistency_weight
                          + (cfg.final_consistency_weight - cfg.initial_consistency_weight)
                          * progress)
            else:
                w_cons = cfg.weight_consistency
            if epoch >= cfg.ecda_start_epoch:
                ecda_progress = min(1.0, (epoch - cfg.ecda_start_epoch) / cfg.weight_ramp_epochs)
                w_ecda = cfg.weight_ecda * ecda_progress
        gamma = cfg.dacp.quantile_start + (
            cfg.dacp.quantile_end - cfg.dacp.quantile_start) * (epoch / cfg.epochs)
        return StepScalars(warmup, float(w_cons), float(w_ecda), float(gamma))


def cosine_lr(cfg: DADConfig, epoch: int) -> float:
    """torch CosineAnnealingLR(T_max=epochs) stepped once per epoch."""
    if cfg.lr_scheduler != "cosine":
        return cfg.learning_rate
    return 0.5 * cfg.learning_rate * (1.0 + math.cos(math.pi * epoch / cfg.epochs))


class Optimizer:
    """clip_by_global_norm -> add_decayed_weights -> scale_by_adam ->
    scale_by_learning_rate, as functions of (grads, state, params)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # torch Adam's defaults, as the JAX chain's

    def __init__(self, max_grad_norm: Optional[float], weight_decay: float,
                 learning_rate: float):
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.learning_rate = learning_rate

    def init(self, params: Params) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            learning_rate=torch.tensor(self.learning_rate, dtype=torch.float32, device=device),
        )

    def update(self, grads: Params, state: AdamState, params: Params
               ) -> Tuple[Params, AdamState]:
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            keep = norm < self.max_grad_norm
            grads = {k: torch.where(keep, g, g / norm * self.max_grad_norm)
                     for k, g in grads.items()}
        grads = {k: g + self.weight_decay * params[k] for k, g in grads.items()}
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g * g + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        updates = {k: -state.learning_rate * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps))
                   for k in grads}
        return updates, AdamState(count, mu, nu, state.learning_rate)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}


def build_optimizer(cfg: DADConfig) -> Optimizer:
    """torch Adam(lr, weight_decay) semantics: clip first, then L2 decay
    into the gradient, then the Adam moments."""
    return Optimizer(cfg.max_grad_norm if cfg.gradient_clipping else None,
                     cfg.weight_decay, cfg.learning_rate)


def set_learning_rate(opt_state: AdamState, lr: float) -> AdamState:
    """Per-epoch learning-rate update."""
    return opt_state._replace(learning_rate=torch.full_like(opt_state.learning_rate, lr))


def init_dad_train_state(
    cfg: DADConfig, generator: Optional[torch.Generator] = None, device=None
) -> Tuple[DADHead, Optimizer, DADTrainState]:
    head, ssrl = init_ssrl(generator, cfg.input_dim, cfg.hidden_dim,
                           cfg.num_classes, cfg.dropout_rate, device=device)
    tx = build_optimizer(cfg)
    return head, tx, DADTrainState(ssrl=ssrl, opt_state=tx.init(ssrl.student),
                                   dacp=init_dacp(cfg.num_classes, device=device))


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor, row_valid: torch.Tensor,
                smoothing: float) -> torch.Tensor:
    """torch CrossEntropyLoss(label_smoothing=eps) over valid rows."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(torch.clamp(labels.long(), 0, C - 1), C).to(logits.dtype)
    per_row = -torch.sum((onehot * (1.0 - smoothing) + smoothing / C) * logp, dim=-1)
    w = row_valid.to(logits.dtype)
    return torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)


class StepDraws(NamedTuple):
    """A step's random numbers given ready-made (the tests feed the JAX
    draws here); a field left None is drawn from the step's generator."""

    inject: Optional[torch.Tensor] = None  # (B, T) standard normal (fused step)
    weak: Optional[torch.Tensor] = None  # (B, T', D) standard normal
    strong: Optional[StrongDraws] = None


def dad_losses(
    head: DADHead,
    cfg: DADConfig,
    student: Params,
    teacher: Params,
    dacp_state: DACPState,
    clean_feats: torch.Tensor, clean_fmask: torch.Tensor,
    clean_labels: torch.Tensor, clean_valid: torch.Tensor,
    noisy_feats: torch.Tensor, noisy_fmask: torch.Tensor,
    noisy_valid: torch.Tensor, noisy_ids: Optional[torch.Tensor],
    scalars: StepScalars,
    anchors: torch.Tensor,
    generator: Optional[torch.Generator],
    draws: StepDraws,
):
    """The loss body that the feature-level and the fused step share.
    Returns (total, new_dacp, metrics, tracking); gradients reach only
    ``student``."""
    smoothing = cfg.label_smoothing_factor if cfg.use_label_smoothing else 0.0
    train = dict(deterministic=False, generator=generator)

    # supervised CE on the clean stream
    clean_logits, clean_emb = functional_call(head, student, (clean_feats, clean_fmask), train)
    ce = smoothed_ce(clean_logits, clean_labels, clean_valid, smoothing)

    # weak/strong views of the same noisy features
    weak = weak_augment(generator, noisy_feats, cfg.augment, noise=draws.weak)
    strong = strong_augment(generator, noisy_feats, cfg.augment,
                            padding_mask=noisy_fmask, draws=draws.strong)

    # teacher: no graph, no dropout
    with torch.no_grad():
        teacher_logits, _ = functional_call(head, teacher, (weak, noisy_fmask))
        teacher_probs = torch.softmax(teacher_logits, dim=-1)

    if cfg.dacp.use_dacp:
        new_dacp, mask, scores, wce = dacp_mask(
            dacp_state, teacher_probs, noisy_valid, scalars.gamma_e, anchors, cfg.dacp)
    else:
        mask, scores, wce = fixed_threshold_mask(
            teacher_probs, noisy_valid, cfg.dacp.fixed_confidence_threshold)
        new_dacp = dacp_state

    student_logits, strong_emb = functional_call(head, student, (strong, noisy_fmask), train)
    mask_f = mask.to(torch.float32)
    count = mask_f.sum()
    preds = teacher_probs.argmax(dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=clean_feats.device)

    # warmup: only CE contributes and the DACP state stays where it was
    consistency = ecda = zero
    if scalars.warmup:
        new_dacp = dacp_state
    else:
        student_logp = torch.log_softmax(student_logits, dim=-1)
        kl = torch.sum(teacher_probs * (torch.log(teacher_probs + 1e-12) - student_logp), dim=-1)
        consistency = torch.where(count > 1, torch.sum(kl * mask_f) / (count + 1e-8), zero)
        if cfg.ecda.use_ecda and scalars.w_ecda > 0:
            ecda = ecda_loss(clean_emb, strong_emb, clean_labels, preds, mask, scores, wce,
                             clean_valid, noisy_valid, cfg.ecda)
            ecda = torch.where(count > 1, ecda, zero)

    total = ce + scalars.w_consistency * consistency + scalars.w_ecda * ecda
    metrics = {
        "total_loss": total,
        "supervised_ce_loss": ce,
        "consistency_loss": consistency,
        "ecda_loss": ecda,
        "high_confidence_count": count,
    }
    tracking = {
        "ids": noisy_ids,
        "pseudo_label": preds,
        "certainty_score": scores,
        "is_masked_in": mask,
    }
    return total, new_dacp, metrics, tracking


def student_update(state: DADTrainState, total: torch.Tensor, student: Params,
                   new_dacp: DACPState, scalars: StepScalars, tx: Optimizer,
                   cfg: DADConfig) -> DADTrainState:
    """Backward to the student, the optimizer step, then the teacher EMA
    (post-warmup only)."""
    grads = dict(zip(student, torch.autograd.grad(total, list(student.values()))))
    params = {k: v.detach() for k, v in student.items()}
    updates, new_opt = tx.update(grads, state.opt_state, params)
    new_student = apply_updates(params, updates)
    teacher = state.ssrl.teacher
    if not scalars.warmup:
        teacher = ema_update(SSRLState(new_student, teacher), cfg.ema_momentum).teacher
    return DADTrainState(SSRLState(new_student, teacher), new_opt, new_dacp)


def make_dad_train_step(head: DADHead, tx: Optimizer, cfg: DADConfig):
    """Returns step(state, clean, noisy, scalars, anchors, generator,
    draws=None) -> (state', metrics, tracking) over feature batches."""

    def step(state: DADTrainState, clean: Batch, noisy: Batch, scalars: StepScalars,
             anchors: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[StepDraws] = None):
        student = {k: v.detach().requires_grad_(True) for k, v in state.ssrl.student.items()}
        total, new_dacp, metrics, tracking = dad_losses(
            head, cfg, student, state.ssrl.teacher, state.dacp,
            clean.feats, clean.padding_mask, clean.labels, clean.row_valid,
            noisy.feats, noisy.padding_mask, noisy.row_valid, noisy.ids,
            scalars, anchors, generator, draws or StepDraws(),
        )
        new_state = student_update(state, total, student, new_dacp, scalars, tx, cfg)
        return new_state, {k: v.detach() for k, v in metrics.items()}, tracking

    return step


def epoch_end_dacp(state: DADTrainState, cfg: DADConfig) -> DADTrainState:
    """Epoch-boundary DACP quality update."""
    return state._replace(dacp=dacp_epoch_update(state.dacp, cfg.dacp))


def make_eval_step(head: DADHead) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Eval forward: returns (preds, logits) for a batch using either
    student or teacher params (a ``DADHead`` state dict)."""

    @torch.no_grad()
    def fwd(params: Params, feats: torch.Tensor, padding_mask: torch.Tensor):
        logits, _ = functional_call(head, params, (feats, padding_mask))
        return torch.argmax(logits, dim=-1), logits

    return fwd
