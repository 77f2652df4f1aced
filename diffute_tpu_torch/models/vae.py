"""AutoencoderKL (SD2 VAE) in PyTorch, NCHW.

Counterpart of ``diffute_tpu/models/vae.py`` with diffusers' module tree
(encoder.down_blocks.i.resnets.j, encoder.mid_block.attentions.0.group_norm,
decoder.up_blocks.i.upsamplers.0, quant_conv, ...).  The mid-block's
single-head attention (head_dim 512) takes the dense path: the flash kernel
takes head_dim 64 only.  Sampling and the 0.18215 scale are the caller's.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from diffute_tpu_torch.config import VAEConfig
from diffute_tpu_torch.models.attention import Attention
from diffute_tpu_torch.models.layers import (
    Block,
    Downsample2D,
    ResnetBlock2D,
    Upsample2D,
)


class MidBlockAttention(Attention):
    """Single-head attention with its own GroupNorm, over NCHW maps."""

    def __init__(self, channels: int, groups: int):
        super().__init__(channels, num_heads=1, head_dim=channels,
                         qkv_bias=True)
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hidden = super().forward(hidden)
        return x + hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    """resnet -> single-head attention -> resnet (VAE mid block)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, groups=groups, eps=1e-6)
            for _ in range(2))
        self.attentions = nn.ModuleList([MidBlockAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        chs = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        blocks, x_ch = [], chs[0]
        for i, ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(x_ch, ch, groups=g, eps=1e-6))
                x_ch = ch
            blocks.append(Block(
                resnets, None, "downsamplers",
                Downsample2D(ch, ch) if i < len(chs) - 1 else None))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = self.mid_block(x)
        return self.conv_out(nn.functional.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        rev = tuple(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g)
        blocks, x_ch = [], rev[0]
        for i, ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(x_ch, ch, groups=g, eps=1e-6))
                x_ch = ch
            blocks.append(Block(
                resnets, None, "upsamplers",
                Upsample2D(ch, ch) if i < len(rev) - 1 else None))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(nn.functional.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """KL autoencoder with diagonal-Gaussian latent."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        lat = config.latent_channels
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B,3,H,W) in [-1,1] -> (mean, logvar), each (B,4,H/8,W/8)."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B,4,h,w) (already divided by scaling_factor) -> (B,3,H,W)."""
        return self.decoder(self.post_quant_conv(z))


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample() with the standard normal given."""
    return mean + torch.exp(0.5 * logvar) * noise
