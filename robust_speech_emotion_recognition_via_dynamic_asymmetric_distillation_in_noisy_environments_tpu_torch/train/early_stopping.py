"""Early stopping (reference pretrain train_for_clean.py:33-60)."""

from __future__ import annotations


class EarlyStopper:
    def __init__(self, patience: int = 20, min_delta: float = 0.001, mode: str = "max"):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.counter = 0
        self.best_score = float("-inf") if mode == "max" else float("inf")
        self.best_epoch = 0
        self.early_stop = False

    def _is_better(self, score: float) -> bool:
        if self.mode == "max":
            return score > self.best_score + self.min_delta
        return score < self.best_score - self.min_delta

    def __call__(self, score: float, epoch: int) -> bool:
        if self._is_better(score):
            self.best_score = score
            self.counter = 0
            self.best_epoch = epoch
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop
