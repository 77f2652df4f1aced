"""Seeded random parameter initialization, made on the target device.

Counterpart of ``diffute_tpu/utils/params.py``.  Each model is built on the
``meta`` device (no memory) to enumerate its parameter names and shapes;
every tensor is then drawn on ``device`` from an explicit
``torch.Generator``, with the JAX package's initializers: LeCun-normal conv
and dense weights, zero biases, unit norm scales, N(0, 0.02) position
embeddings, zero CLS token.  The result is a dict of state_dicts with the
diffusers / transformers keys, loadable with ``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from diffute_tpu_torch.config import DiffUTEConfig
from diffute_tpu_torch.models import AutoencoderKL, TrOCREncoder, UNet2DCondition
from diffute_tpu_torch.models.layers import QuantLinear
from diffute_tpu_torch.ops.quant import convert_linear_weights_to_int8
from diffute_tpu_torch.utils.device import resolve_device


def _init_state_dict(module: nn.Module, gen: torch.Generator,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, p in module.named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "position_embeddings":
            t.normal_(0.0, 0.02, generator=gen)
        elif leaf == "weight" and p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
            t.normal_(0.0, fan_in ** -0.5, generator=gen)
        elif leaf == "weight":
            t.fill_(1.0)  # GroupNorm / LayerNorm scale
        else:
            t.zero_()     # biases, cls_token
        out[name] = t
    return out


def build_meta(cls, config) -> nn.Module:
    """Construct ``cls(config)`` on the meta device: shapes, no storage."""
    with torch.device("meta"):
        return cls(config)


def load_module(cls, config, state_dict: Dict[str, torch.Tensor], device,
                dtype: torch.dtype) -> nn.Module:
    """``cls(config)`` holding ``state_dict`` (strict) on ``device`` in
    ``dtype``, frozen and in eval mode.

    A model with int8 layers (``use_int8_weights``) takes a float state_dict
    too: the layers' weights are quantised here, once, unless the dict
    already holds quantised entries.  Floating tensors, the int8 layers'
    scales among them, are then cast to ``dtype``."""
    module = build_meta(cls, config)
    quant = [name for name, m in module.named_modules()
             if isinstance(m, QuantLinear)]
    if quant and not any(k.endswith(".weight_q") for k in state_dict):
        state_dict = convert_linear_weights_to_int8(state_dict, quant)
    module.load_state_dict(state_dict, strict=True, assign=True)
    module = module.to(device=device, dtype=dtype).eval()
    module.requires_grad_(False)
    return module


def init_pipeline_params(config: DiffUTEConfig, seed: int = 0,
                         device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Random-init fp32 state_dicts for the three models on ``device`` (the
    card unless the caller asks for the CPU).  The UNet's dict is float
    whatever ``use_int8_weights`` says: the pipeline quantises at load."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    config = dataclasses.replace(config, unet=dataclasses.replace(
        config.unet, use_int8_weights=False))
    return {
        "vae": _init_state_dict(build_meta(AutoencoderKL, config.vae), gen, device),
        "unet": _init_state_dict(build_meta(UNet2DCondition, config.unet), gen,
                                 device),
        "trocr": _init_state_dict(build_meta(TrOCREncoder, config.trocr), gen,
                                  device),
    }
