"""Transformer blocks for the UNet (self + cross attention, GEGLU FFN).

Counterpart of ``diffute_tpu/models/attention.py``: the slice of diffusers'
Transformer2DModel that SD2-inpainting runs, with diffusers' submodule
names.  Every attention goes through
:func:`diffute_tpu_torch.ops.dot_product_attention`, so the flash kernel
takes the long self-attentions behind one flag.  Cross-attention K/V over
the fixed conditioning can be projected once (``cross_kv``) and passed to
every denoising step.  With ``use_int8`` every linear layer of a transformer
block is a :class:`~diffute_tpu_torch.models.layers.QuantLinear` (the
GroupNorm and LayerNorms stay float).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffute_tpu_torch.models.layers import linear
from diffute_tpu_torch.ops import dot_product_attention

KV = Tuple[torch.Tensor, torch.Tensor]  # each (B, T, heads, head_dim)


class Attention(nn.Module):
    """Multi-head attention with separate q/k/v projections."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None, use_flash: bool = False,
                 out_bias: bool = True, qkv_bias: bool = False,
                 use_int8: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim, self.use_flash = (num_heads, head_dim,
                                                         use_flash)
        kv_dim = context_dim or query_dim
        self.to_q = linear(query_dim, inner, qkv_bias, use_int8)
        self.to_k = linear(kv_dim, inner, qkv_bias, use_int8)
        self.to_v = linear(kv_dim, inner, qkv_bias, use_int8)
        self.to_out = nn.ModuleList([linear(inner, query_dim, out_bias,
                                            use_int8), nn.Identity()])

    def kv(self, context: torch.Tensor) -> KV:
        """Project context -> (k, v), each (B, T, H, D)."""
        b, t, _ = context.shape
        k = self.to_k(context).view(b, t, self.num_heads, self.head_dim)
        v = self.to_v(context).view(b, t, self.num_heads, self.head_dim)
        return k, v

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                kv: Optional[KV] = None) -> torch.Tensor:
        if kv is None:
            kv = self.kv(x if context is None else context)
        k, v = kv
        b, s, _ = x.shape
        q = self.to_q(x).view(b, s, self.num_heads, self.head_dim)
        out = dot_product_attention(q, k, v, use_flash=self.use_flash)
        return self.to_out[0](out.reshape(b, s, self.num_heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int, use_int8: bool = False):
        super().__init__()
        self.proj = linear(dim, inner_dim * 2, use_int8=use_int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU, as SD's GEGLU


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, use_int8: bool = False):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, use_int8),
                                  nn.Identity(),
                                  linear(dim * mult, dim, use_int8=use_int8)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, use_flash: bool = False,
                 use_int8: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim, use_flash=use_flash,
                               use_int8=use_int8)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim,
                               context_dim=context_dim, use_flash=use_flash,
                               use_int8=use_int8)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, use_int8=use_int8)

    def cross_kv(self, context: torch.Tensor) -> KV:
        return self.attn2.kv(context)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                cross_kv: Optional[KV] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, kv=cross_kv)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks -> proj_out + residual,
    over NCHW feature maps.

    The residual sum inherits the tokens' permuted (channels-last) memory
    layout unless ``contiguous_out`` is set; the fused GroupNorm kernels of
    the next resnet take NCHW-contiguous memory, and the sum is the pass that
    can write it at no extra cost."""

    def __init__(self, num_heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, groups: int = 32,
                 use_linear_projection: bool = True, use_flash: bool = False,
                 use_int8: bool = False, contiguous_out: bool = False):
        super().__init__()
        c = num_heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.contiguous_out = contiguous_out
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        if use_linear_projection:
            self.proj_in = linear(c, c, use_int8=use_int8)
            self.proj_out = linear(c, c, use_int8=use_int8)
        else:
            self.proj_in, self.proj_out = nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, num_heads, head_dim, context_dim,
                                  use_flash=use_flash, use_int8=use_int8)
            for _ in range(depth))

    def cross_kv(self, context: torch.Tensor) -> Tuple[KV, ...]:
        return tuple(blk.cross_kv(context) for blk in self.transformer_blocks)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                cross_kv: Optional[Tuple[KV, ...]] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if not self.use_linear_projection:
            x = self.proj_in(x)
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.use_linear_projection:
            x = self.proj_in(x)
        for i, blk in enumerate(self.transformer_blocks):
            x = blk(x, context,
                    cross_kv=cross_kv[i] if cross_kv is not None else None)
        if self.use_linear_projection:
            x = self.proj_out(x)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.use_linear_projection:
            x = self.proj_out(x)
        # the first operand's layout decides the sum's
        return residual + x if self.contiguous_out else x + residual
