from .attention import flash_attention, flash_attention_reference
from .conv import fused_conv_ln_gelu, fused_conv_ln_gelu_reference, pallas_conv_stack
from .d2v_update import fused_update
from .fused_norm import copy_rows, fused_layernorm, fused_layernorm_reference
from .masked import masked_mean_pool, masked_quantile, masked_softmax_stats
from .mmd import pairwise_sq_dists, weighted_mmd_terms

__all__ = [
    "copy_rows",
    "flash_attention",
    "flash_attention_reference",
    "fused_conv_ln_gelu",
    "fused_conv_ln_gelu_reference",
    "fused_layernorm",
    "fused_layernorm_reference",
    "fused_update",
    "masked_mean_pool",
    "masked_quantile",
    "masked_softmax_stats",
    "pairwise_sq_dists",
    "pallas_conv_stack",
    "weighted_mmd_terms",
]
