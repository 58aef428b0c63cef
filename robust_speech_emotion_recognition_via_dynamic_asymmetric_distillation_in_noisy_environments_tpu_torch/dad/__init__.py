from .augment import StrongDraws, strong_augment, weak_augment
from .dacp import (
    DACPState,
    certainty_scores,
    dacp_epoch_update,
    dacp_mask,
    fixed_threshold_mask,
    init_dacp,
)
from .ecda import ecda_loss
from .train_step import (
    AdamState,
    Batch,
    DADTrainState,
    StepDraws,
    StepScalars,
    build_optimizer,
    cosine_lr,
    epoch_end_dacp,
    init_dad_train_state,
    make_dad_train_step,
    make_eval_step,
    set_learning_rate,
    smoothed_ce,
)
from .calibrate import run_anchor_calibration

__all__ = [
    "weak_augment",
    "strong_augment",
    "StrongDraws",
    "DACPState",
    "init_dacp",
    "certainty_scores",
    "dacp_mask",
    "fixed_threshold_mask",
    "dacp_epoch_update",
    "ecda_loss",
    "AdamState",
    "Batch",
    "DADTrainState",
    "StepDraws",
    "StepScalars",
    "build_optimizer",
    "cosine_lr",
    "epoch_end_dacp",
    "init_dad_train_state",
    "make_dad_train_step",
    "make_eval_step",
    "set_learning_rate",
    "smoothed_ce",
    "run_anchor_calibration",
]
