from .attention import flash_attention, flash_attention_reference
from .masked import masked_mean_pool

__all__ = ["flash_attention", "flash_attention_reference", "masked_mean_pool"]
