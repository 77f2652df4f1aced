"""Attention compute op with the flash kernel behind one gate.

Counterpart of ``diffute_tpu/ops/attention.py``.  Layout
``(batch, seq, heads, head_dim)`` at the public functions, as in the JAX
package.  Self-attention with at least 1024 keys goes to the CUDA flash
kernels when ``use_flash`` is set: the UNet's (head_dim 64) and, with
``VAEConfig.use_flash_attention``, the VAE mid-block's (head_dim 512, or
256 at ``small_config``).
Everything else (the 577-token cross-attention, the deep blocks'
256/64-token self-attention, the TrOCR ViT, an unflagged VAE mid-block)
goes to :func:`dense_attention`, the port of what XLA compiled for
``_xla_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffute_tpu_torch.ops.flash_attention import flash_attention

FLASH_MIN_KV = 1024


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """fp32 logits, softmax, cast to ``v.dtype``, product (``_xla_attention``).
    ``mask``: booleans broadcast against the (B, H, S, T) logits; a logit
    where it is False becomes -1e30 before the softmax, as the JAX TrOCR
    decoder applies its causal and key masks."""
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", weights, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          use_flash: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, H, D) / (B, T, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash and k.shape[1] >= FLASH_MIN_KV:
        return flash_attention(q, k, v, scale=scale)
    return dense_attention(q, k, v, scale)
