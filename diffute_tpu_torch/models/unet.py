"""UNet2DCondition (SD2-inpainting topology) in PyTorch, NCHW.

Counterpart of ``diffute_tpu/models/unet.py`` with diffusers'
UNet2DConditionModel module tree (down_blocks.i.resnets.j, mid_block,
up_blocks.u.attentions.j, ...), so its state_dict keys are diffusers' keys.
The forward is split like the JAX module's: :meth:`time_embed`,
:meth:`cross_attention_kv` (projected once per edit), :meth:`encode` and
:meth:`decode`; ``forward`` composes them.  With ``config.remat`` every
resnet and transformer block is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX module wraps them in ``nn.remat``;
the forward's values do not change.  Three opt-in kernels sit behind
``config``: ``use_fused_conv`` (every resnet half is one GN+SiLU+conv3x3
kernel), ``use_fused_groupnorm`` (``conv_norm_out`` and, without the fused
conv, the resnets' norms are one GN+SiLU kernel) and ``use_int8_weights``
(the transformers' linear layers read int8 weights); the time-embedding
layers and the convolutions stay float.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffute_tpu_torch.config import UNetConfig
from diffute_tpu_torch.models.attention import Transformer2D
from diffute_tpu_torch.models.layers import (
    Block,
    Downsample2D,
    GroupNormSiLU,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    timestep_embedding,
)


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        n_blocks = len(cfg.block_out_channels)
        temb_ch = ch0 * 4
        groups = cfg.norm_num_groups

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, temb_ch, groups=groups, eps=1e-5,
                                 fused_gn=cfg.use_fused_groupnorm,
                                 fused_conv=cfg.use_fused_conv)

        def attn(i):
            heads = cfg.num_attention_heads[i]
            ch = cfg.block_out_channels[i]
            return Transformer2D(heads, ch // heads, cfg.cross_attention_dim,
                                 groups=groups,
                                 use_linear_projection=cfg.use_linear_projection,
                                 use_flash=cfg.use_flash_attention,
                                 use_int8=cfg.use_int8_weights,
                                 contiguous_out=(cfg.use_fused_groupnorm
                                                 or cfg.use_fused_conv))

        self.time_embedding = TimestepEmbedding(ch0, temb_ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)

        skip_ch = [ch0]
        x_ch = ch0
        down = []
        for i, ch in enumerate(cfg.block_out_channels):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(resnet(x_ch, ch))
                x_ch = ch
                if cfg.down_block_has_attn[i]:
                    attns.append(attn(i))
                skip_ch.append(ch)
            sampler = Downsample2D(ch, ch) if i < n_blocks - 1 else None
            if sampler is not None:
                skip_ch.append(ch)
            down.append(Block(resnets, attns, "downsamplers", sampler))
        self.down_blocks = nn.ModuleList(down)

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = Block([resnet(mid_ch, mid_ch), resnet(mid_ch, mid_ch)],
                               [attn(n_blocks - 1)])

        up = []
        for u, i in enumerate(reversed(range(n_blocks))):
            ch = cfg.block_out_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(resnet(x_ch + skip_ch.pop(), ch))
                x_ch = ch
                if cfg.up_block_has_attn[u]:
                    attns.append(attn(i))
            sampler = Upsample2D(ch, ch) if u < n_blocks - 1 else None
            up.append(Block(resnets, attns, "upsamplers", sampler))
        self.up_blocks = nn.ModuleList(up)

        norm_out = GroupNormSiLU if cfg.use_fused_groupnorm else nn.GroupNorm
        self.conv_norm_out = norm_out(groups, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    # ------------------------------------------------------------------

    def _block(self, module: nn.Module, *args, **kwargs) -> torch.Tensor:
        """Call a resnet or transformer block, rematerialised when training
        with ``config.remat``."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False, **kwargs)
        return module(*args, **kwargs)

    def _attns(self, blocks):
        for blk in blocks:
            yield from getattr(blk, "attentions", ())

    def time_embed(self, timesteps: torch.Tensor, batch: int) -> torch.Tensor:
        cfg = self.config
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   flip_sin_to_cos=cfg.flip_sin_to_cos,
                                   freq_shift=cfg.freq_shift)
        t_emb = t_emb.to(self.conv_in.weight.dtype)
        if t_emb.shape[0] == 1 and batch > 1:
            t_emb = t_emb.expand(batch, -1)
        return self.time_embedding(t_emb)

    def cross_attention_kv(self, encoder_hidden_states: torch.Tensor):
        """Every cross-attention layer's (k, v) over the conditioning, in
        forward order (down, mid, up)."""
        return tuple(
            a.cross_kv(encoder_hidden_states)
            for a in (*self._attns(self.down_blocks),
                      *self.mid_block.attentions,
                      *self._attns(self.up_blocks)))

    @property
    def _n_down_attns(self) -> int:
        return sum(1 for _ in self._attns(self.down_blocks))

    def encode(self, sample: torch.Tensor, temb: torch.Tensor,
               encoder_hidden_states: torch.Tensor, cross_kv=None
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """conv_in + down path -> (bottom features, skip stack)."""
        x = self.conv_in(sample)
        skips = [x]
        ai = 0
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = self._block(res, x, temb)
                if attns is not None:
                    x = self._block(attns[j], x, encoder_hidden_states,
                                    cross_kv=cross_kv[ai] if cross_kv else None)
                    ai += 1
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)
        return x, skips

    def decode(self, x: torch.Tensor, skips: List[torch.Tensor],
               temb: torch.Tensor, encoder_hidden_states: torch.Tensor,
               cross_kv=None) -> torch.Tensor:
        """mid block + up path + output head."""
        skips = list(skips)
        ai = self._n_down_attns

        def kv(idx):
            return cross_kv[idx] if cross_kv else None

        mid = self.mid_block
        x = self._block(mid.resnets[0], x, temb)
        x = self._block(mid.attentions[0], x, encoder_hidden_states,
                        cross_kv=kv(ai))
        ai += 1
        x = self._block(mid.resnets[1], x, temb)
        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = self._block(res, torch.cat([x, skips.pop()], dim=1), temb)
                if attns is not None:
                    x = self._block(attns[j], x, encoder_hidden_states,
                                    cross_kv=kv(ai))
                    ai += 1
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        x = self.conv_norm_out(x)  # GroupNormSiLU applies the SiLU itself
        if not self.config.use_fused_groupnorm:
            x = F.silu(x)
        return self.conv_out(x)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                cross_kv: Optional[tuple] = None) -> torch.Tensor:
        """sample (B, 9, H, W), timesteps () or (B,), context (B, T, C)
        -> (B, 4, H, W)."""
        temb = self.time_embed(timesteps, sample.shape[0])
        x, skips = self.encode(sample, temb, encoder_hidden_states, cross_kv)
        return self.decode(x, skips, temb, encoder_hidden_states, cross_kv)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
