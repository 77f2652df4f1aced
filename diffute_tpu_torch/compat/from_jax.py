"""Weight bridge: a JAX-package param tree -> the port's state_dicts.

The JAX package's Flax trees (nested dicts of arrays, as
``diffute_tpu.utils.init_pipeline_params`` or its checkpoint loaders return
them) become PyTorch state_dicts with diffusers / transformers keys:

- conv kernels HWIO -> OIHW, dense kernels (I, O) -> (O, I);
- norm ``scale`` -> ``weight``;
- an int8 layer's ``kernel_q`` (I, O) int8 -> ``weight_q`` (O, I) int8 and
  ``kernel_scale`` (O,) -> ``weight_scale``
  (:class:`~diffute_tpu_torch.models.layers.QuantLinear`);
- the flattened Flax module names -> dotted diffusers names (transformers
  names for the TrOCR encoder and decoder).

The key rewrites re-implement ``diffute_tpu.compat.hf_import``'s export
grammar here, because the port does not import the JAX package.

Training needs nothing more: gradients and updated parameters have the
parameters' tree, so the same functions map them (the tests read the JAX
trainer's gradients and new weights through ``unet_state_dict``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _iter_paths(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _iter_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(leaf: str, value: np.ndarray):
    value = np.asarray(value)
    if leaf == "kernel":
        if value.ndim == 4:  # HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.transpose(1, 0)
    if leaf == "scale":
        return "weight", value
    if leaf == "kernel_q":
        return "weight_q", value.transpose(1, 0)
    if leaf == "kernel_scale":
        return "weight_scale", value
    return leaf, value


_DIFFUSERS = [
    (r"\b(down_blocks|up_blocks)_(\d+)_(resnets|attentions|downsamplers|upsamplers)_(\d+)\b",
     r"\1.\2.\3.\4"),
    (r"\bmid_block_(resnets|attentions)_(\d+)\b", r"mid_block.\1.\2"),
    (r"\bmid_block\.attn_group_norm\b", "mid_block.attentions.0.group_norm"),
    (r"\bmid_block\.(resnets|attentions)_(\d+)\b", r"mid_block.\1.\2"),
    (r"\btransformer_blocks_(\d+)\b", r"transformer_blocks.\1"),
    (r"\bto_out_0\b", "to_out.0"),
    (r"\bff\.net_0\.proj\b", "ff.net.0.proj"),
    (r"\bff\.net_2\b", "ff.net.2"),
]

_VIT = [
    (r"^cls_token$", "embeddings.cls_token"),
    (r"^position_embeddings$", "embeddings.position_embeddings"),
    (r"^patch_embeddings\.", "embeddings.patch_embeddings.projection."),
    (r"^layer_(\d+)\.attention\.(query|key|value)\.",
     r"encoder.layer.\1.attention.attention.\2."),
    (r"^layer_(\d+)\.attention\.output_dense\.",
     r"encoder.layer.\1.attention.output.dense."),
    (r"^layer_(\d+)\.intermediate_dense\.", r"encoder.layer.\1.intermediate.dense."),
    (r"^layer_(\d+)\.output_dense\.", r"encoder.layer.\1.output.dense."),
    (r"^layer_(\d+)\.(layernorm_before|layernorm_after)\.", r"encoder.layer.\1.\2."),
]


_DECODER = [
    (r"^(embed_tokens|embed_positions)$", r"\1.weight"),
    (r"^layers_(\d+)\.", r"layers.\1."),
]


def _convert(params: Mapping, rewrites) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, value in _iter_paths(params):
        leaf, arr = _leaf(path[-1], value)
        name = ".".join(path[:-1] + (leaf,))
        for pat, repl in rewrites:
            name = re.sub(pat, repl, name)
        # a copy; int8 weights keep their type
        out[name] = torch.tensor(arr, dtype=torch.int8 if arr.dtype == np.int8
                                 else torch.float32)
    return out


def unet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX UNet2DCondition params -> diffusers UNet2DConditionModel keys."""
    return _convert(params, _DIFFUSERS)


def vae_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> diffusers AutoencoderKL keys."""
    return _convert(params, _DIFFUSERS)


def trocr_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX TrOCREncoder params -> transformers ViTModel keys."""
    return _convert(params, _VIT)


def trocr_decoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX TrOCRDecoder params -> the port's TrOCRDecoder keys (HF
    TrOCRForCausalLM's ``model.decoder.*`` without the prefix)."""
    return _convert(params, _DECODER)


def pipeline_state_dicts(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"vae", "unet", "trocr"} JAX trees -> the same keys as state_dicts."""
    return {"vae": vae_state_dict(params["vae"]),
            "unet": unet_state_dict(params["unet"]),
            "trocr": trocr_state_dict(params["trocr"])}
