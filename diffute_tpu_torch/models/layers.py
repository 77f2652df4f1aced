"""Shared building blocks for the VAE and UNet (PyTorch, NCHW).

Counterpart of ``diffute_tpu/models/layers.py``.  Submodule names are
diffusers' (norm1/conv1/time_emb_proj/...), so a diffusers state_dict loads
by name.  The opt-in kernels sit behind three switches that leave the
state_dict keys as they are: ``fused_gn`` (GroupNorm+SiLU in one kernel),
``fused_conv`` (GroupNorm+SiLU+conv3x3 in one kernel, which takes precedence)
and :class:`QuantLinear` (int8 weights) in the transformer blocks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffute_tpu_torch.ops.conv_fused import (
    gn_silu_conv3x3,
    pack_conv3x3_weight,
)
from diffute_tpu_torch.ops.groupnorm import group_norm_silu
from diffute_tpu_torch.ops.quant import pack_w8_weight, quant_matmul


class QuantLinear(nn.Module):
    """Linear layer over int8 weights with one scale per output feature
    (``QuantDense``).  Serving only: no gradient reaches the weights.

    Buffers: ``weight_q`` (out_features, in_features) int8, the axes of
    ``nn.Linear.weight`` (the JAX layer's ``kernel_q`` is its transpose), and
    ``weight_scale`` (out_features,), one per row of ``weight_q``, fp32 until
    the module is cast (a bf16 model multiplies by the bf16-rounded scale, as
    the JAX pipeline's cast of ``kernel_scale`` does).  ``bias``
    (out_features,) is an ordinary parameter.  The product is rounded to x's
    dtype before the bias is added, as in the JAX layer; on the card both
    happen in the kernel's epilogue, one launch.  The bf16 kernel's repacked
    copy of ``weight_q`` is made once and kept (not in the state_dict); the
    fp32 kernel reads ``weight_q`` as it is, so an fp32 model keeps no
    copy."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self._packed = None  # (weight identity, pack_w8_weight(weight_q))

    def _packed_weight(self, dtype: torch.dtype) -> Optional[torch.Tensor]:
        """``weight_q`` in the bf16 kernel's layout for x of ``dtype``,
        repacked when the buffer was replaced or written since (not per
        call); None off the card and for the fp32 kernel."""
        q = self.weight_q
        if q.device.type != "cuda" or dtype != torch.bfloat16:
            return None
        key = (q.data_ptr(), q._version)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_w8_weight(q))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_matmul(x, self.weight_q, self.weight_scale, self.bias,
                            packed=self._packed_weight(x.dtype))


def linear(in_features: int, out_features: int, bias: bool = True,
           use_int8: bool = False) -> nn.Module:
    """``nn.Linear`` or, with ``use_int8``, :class:`QuantLinear`."""
    cls = QuantLinear if use_int8 else nn.Linear
    return cls(in_features, out_features, bias=bias)


class GroupNormSiLU(nn.GroupNorm):
    """GroupNorm fused with SiLU in one kernel
    (:func:`~diffute_tpu_torch.ops.groupnorm.group_norm_silu`).  Parameters
    and state_dict keys are ``nn.GroupNorm``'s (``weight``, ``bias``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings (SD convention), fp32 (N, dim)."""
    timesteps = torch.atleast_1d(torch.as_tensor(timesteps))
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP over the sinusoidal embedding."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class Block(nn.Module):
    """A diffusers down/mid/up block as parameter containers: ``resnets``,
    optional ``attentions`` and an optional one-element resampler list named
    ``sampler_name`` (downsamplers / upsamplers).  The forward lives in the
    model that owns the blocks."""

    def __init__(self, resnets, attentions=None, sampler_name=None,
                 sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class ResnetBlock2D(nn.Module):
    """GroupNorm -> SiLU -> Conv x2 with optional time-embedding injection.

    ``fused_gn`` runs each GroupNorm+SiLU as one kernel; ``fused_conv`` runs
    each GroupNorm+SiLU+conv3x3 half as one kernel and takes precedence.
    Either way ``norm1`` / ``conv1`` / ``norm2`` / ``conv2`` hold the same
    parameters under the same keys."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5, fused_gn: bool = False,
                 fused_conv: bool = False):
        super().__init__()
        norm = GroupNormSiLU if fused_gn and not fused_conv else nn.GroupNorm
        self.fused_gn, self.fused_conv = fused_gn, fused_conv
        self.norm1 = norm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = norm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)
        self._packed = {}  # conv name -> (weight identity, repacked weight)

    def _packed_weight(self, name: str, conv: nn.Conv2d, dtype: torch.dtype
                       ) -> Optional[torch.Tensor]:
        """The conv's weight in the bf16 kernel's layout for x of ``dtype``,
        repacked when the weight was replaced or written since (not per
        call); None off the card and for the fp32 kernel, which reads the
        weight as it is (an fp32 model keeps no packed copy)."""
        w = conv.weight
        if w.device.type != "cuda" or dtype != torch.bfloat16:
            return None
        key = (w.data_ptr(), w._version, w.dtype)
        cached = self._packed.get(name)
        if cached is None or cached[0] != key:
            cached = self._packed[name] = (key, pack_conv3x3_weight(w))
        return cached[1]

    def _half(self, name: str, norm: nn.GroupNorm, conv: nn.Conv2d,
              x: torch.Tensor) -> torch.Tensor:
        """One GroupNorm -> SiLU -> conv3x3 half of the block."""
        if self.fused_conv:
            return gn_silu_conv3x3(x, norm.weight, norm.bias, conv.weight,
                                   conv.bias, norm.num_groups, norm.eps,
                                   packed=self._packed_weight(name, conv,
                                                              x.dtype))
        h = norm(x)  # GroupNormSiLU applies the SiLU itself
        return conv(h if self.fused_gn else F.silu(h))

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self._half("conv1", self.norm1, self.conv1, x)
        if self.time_emb_proj is not None:
            if temb is None:
                raise ValueError("this block takes a time embedding")
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self._half("conv2", self.norm2, self.conv2, h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with asymmetric (0,1) padding (SD convention)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest x2 upsample + 3x3 conv (SD convention)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
