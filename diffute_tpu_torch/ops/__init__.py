from diffute_tpu_torch.ops.attention import dense_attention, dot_product_attention
from diffute_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from diffute_tpu_torch.ops.interpolate import nearest_resize_2d

__all__ = ["dense_attention", "dot_product_attention", "flash_attention",
           "flash_attention_reference", "nearest_resize_2d"]
