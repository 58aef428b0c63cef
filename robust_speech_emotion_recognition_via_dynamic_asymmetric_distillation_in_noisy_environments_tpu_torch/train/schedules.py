"""Host-side per-epoch learning-rate schedulers.

Reproduces the torch schedulers the pretrain stage selects between
(train_for_clean.py:157-173): ReduceLROnPlateau, CosineAnnealingWarmRestarts
and StepLR. LR is injected into the optax chain per epoch
(optax.inject_hyperparams), so these are pure python state machines.
"""

from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, base_lr: float):
        self.lr = base_lr

    def step(self, epoch: int, val_loss: float | None = None) -> float:
        raise NotImplementedError


class ReduceLROnPlateau(LRScheduler):
    """torch semantics: factor decay after `patience` epochs without
    improvement (mode=min on val loss)."""

    def __init__(self, base_lr, factor=0.7, patience=8, min_lr=1e-6, threshold=1e-4):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, epoch, val_loss=None):
        if val_loss is None:
            return self.lr
        if val_loss < self.best * (1 - self.threshold):
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, base_lr, t_0=10, t_mult=2, eta_min=1e-6):
        super().__init__(base_lr)
        self.base_lr = base_lr
        self.t_0 = t_0
        self.t_mult = t_mult
        self.eta_min = eta_min

    def step(self, epoch, val_loss=None):
        t_cur, t_i = epoch, self.t_0
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.t_mult
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)
        ) / 2
        return self.lr


class StepLR(LRScheduler):
    def __init__(self, base_lr, step_size=8, gamma=0.7):
        super().__init__(base_lr)
        self.base_lr = base_lr
        self.step_size = step_size
        self.gamma = gamma

    def step(self, epoch, val_loss=None):
        self.lr = self.base_lr * (self.gamma ** (epoch // self.step_size))
        return self.lr


class CosineAnnealingLR(LRScheduler):
    """torch CosineAnnealingLR(T_max) — the DAD stage scheduler."""

    def __init__(self, base_lr, t_max, eta_min=0.0):
        super().__init__(base_lr)
        self.base_lr = base_lr
        self.t_max = t_max
        self.eta_min = eta_min

    def step(self, epoch, val_loss=None):
        self.lr = self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.t_max)
        )
        return self.lr


def make_lr_scheduler(cfg) -> LRScheduler:
    """Builds the pretrain scheduler from a PretrainConfig."""
    if cfg.lr_scheduler_type == "CosineAnnealingWarmRestarts":
        return CosineAnnealingWarmRestarts(
            cfg.learning_rate, cfg.cosine_t_0, cfg.cosine_t_mult, cfg.cosine_eta_min
        )
    if cfg.lr_scheduler_type == "StepLR":
        return StepLR(cfg.learning_rate, cfg.lr_scheduler_patience, cfg.lr_scheduler_factor)
    return ReduceLROnPlateau(
        cfg.learning_rate,
        cfg.lr_scheduler_factor,
        cfg.lr_scheduler_patience,
        cfg.lr_scheduler_min_lr,
    )
