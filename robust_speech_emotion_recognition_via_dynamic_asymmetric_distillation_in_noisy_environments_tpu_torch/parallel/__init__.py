from .fused import (
    CleanFeatureBatch,
    FusedBatch,
    FusedConfig,
    init_fused,
    make_fused_extract_train_step,
    precompute_clean_features,
)

__all__ = [
    "CleanFeatureBatch",
    "FusedBatch",
    "FusedConfig",
    "init_fused",
    "make_fused_extract_train_step",
    "precompute_clean_features",
]
