"""TrOCR-large glyph encoder (ViT-large) in PyTorch.

Counterpart of ``diffute_tpu/models/trocr.py`` with transformers' ViTModel
module tree (embeddings.patch_embeddings.projection, encoder.layer.i.
attention.attention.query, ...), so its state_dict keys are the HF keys.
Pre-LN ViT: 16x16 patch conv -> CLS + 576 patches -> layers -> LayerNorm,
output (B, 577, hidden).  Its attention is 577 tokens, so the gate sends it
to the dense path whatever ``use_flash_attention`` says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from diffute_tpu_torch.config import TrOCRConfig
from diffute_tpu_torch.ops import dot_product_attention


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size,
                                    cfg.patch_size, stride=cfg.patch_size)


class ViTEmbeddings(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embeddings.projection(pixel_values)  # (B, H, h, w)
        x = x.flatten(2).transpose(1, 2)                     # (B, 576, H)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings


class ViTSelfAttention(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.use_flash = cfg.use_flash_attention
        self.query = nn.Linear(h, h, bias=cfg.qkv_bias)
        self.key = nn.Linear(h, h, bias=cfg.qkv_bias)
        self.value = nn.Linear(h, h, bias=cfg.qkv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        shape = (b, s, self.num_heads, h // self.num_heads)
        out = dot_product_attention(self.query(x).view(shape),
                                    self.key(x).view(shape),
                                    self.value(x).view(shape),
                                    use_flash=self.use_flash)
        return out.reshape(b, s, h)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class ViTAttention(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        self.attention = ViTSelfAttention(cfg)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output.dense(self.attention(x))


class ViTLayer(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layernorm_before = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.attention = ViTAttention(cfg)
        self.layernorm_after = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class _Layers(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class TrOCREncoder(nn.Module):
    def __init__(self, config: TrOCRConfig = TrOCRConfig()):
        super().__init__()
        self.config = config
        self.embeddings = ViTEmbeddings(config)
        self.encoder = _Layers(config)
        self.layernorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, 3, 384, 384) in [-1, 1] -> (B, 577, hidden)."""
        x = self.embeddings(pixel_values)
        for layer in self.encoder.layer:
            x = layer(x)
        return self.layernorm(x)
