"""diffusers / transformers checkpoint files: safetensors IO, config.json
and the loading rules of older key names.

Counterpart of the parts of ``diffute_tpu/compat/hf_import.py`` and
``diffute_tpu/train/checkpoint.py`` that a PyTorch model needs.  The port's
modules carry diffusers' (UNet, VAE) and transformers' (ViT) parameter names
already, so a modern state_dict loads with ``load_state_dict(strict=True)``
and exports as it is; only two rewrites need code, and their grammar is
kept here (the port does not import the JAX package):

- :func:`import_vae_state_dict`: the legacy AttentionBlock names of the VAE
  mid-block (``query``, ``key``, ``value``, ``proj_attn``, ``norm``) become
  ``to_q``, ``to_k``, ``to_v``, ``to_out.0``, ``group_norm``, and
  projections stored as ``(C, C, 1, 1)`` convolutions are squeezed to
  ``(C, C)`` linear weights;
- :func:`import_trocr_state_dict`: a VisionEncoderDecoder checkpoint's
  ``encoder.`` prefix is stripped, and the pooler and the text decoder's
  weights are dropped;
- :func:`import_trocr_decoder_state_dict` / :func:`export_trocr_decoder_
  state_dict`: the text decoder under HF ``TrOCRForCausalLM``'s
  ``model.decoder.`` prefix (``decoder.model.decoder.`` in a
  VisionEncoderDecoder checkpoint), its ``output_projection`` dropped on
  import as tied to ``embed_tokens``.

Files are safetensors in fp32 with the JAX package's file names; each is
written under a temporary name and renamed once complete.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Mapping

import torch

UNET_FILE = "diffusion_pytorch_model.safetensors"
VAE_FILE = "diffusion_pytorch_model.safetensors"
TROCR_FILE = "model.safetensors"
DECODER_PREFIX = "model.decoder."  # HF TrOCRForCausalLM's decoder


# ---------------------------------------------------------------------------
# safetensors IO
# ---------------------------------------------------------------------------


def load_safetensors(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return load_file(path, device=str(device))


_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
           torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
           torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
           torch.bool: "BOOL"}
_CHUNK = 64 << 20


def save_safetensors(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``state_dict`` (any device) to ``path`` atomically, in the
    safetensors format: an 8-byte little-endian header length, the JSON
    header (padded with spaces to 8 bytes), then each tensor's bytes.

    The bytes go straight from each tensor's memory to an unbuffered file,
    64 MiB a ``write``, and the interpreter lock is released for every one
    of them: a checkpoint written on a background thread leaves the step
    loop's thread free to launch work, and no second host copy is made."""
    tensors = {k: v.detach().cpu().contiguous()
               for k, v in sorted(state_dict.items())}
    header, offset = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb", buffering=0) as f:
        _write_all(f, struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            if t.numel():
                _write_all(f, t.reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)


def _write_all(f, data) -> None:
    view = memoryview(data).cast("B")
    pos = 0
    while pos < len(view):
        pos += f.write(view[pos:pos + _CHUNK])


def save_component(directory: str, filename: str,
                   state_dict: Mapping[str, torch.Tensor],
                   config: dict = None) -> None:
    """``directory/filename`` (floating tensors in fp32, the export dtype)
    and ``directory/config.json``."""
    os.makedirs(directory, exist_ok=True)
    save_safetensors({k: v.float() if v.is_floating_point() else v
                      for k, v in state_dict.items()},
                     os.path.join(directory, filename))
    if config is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(config, f, indent=2)


# ---------------------------------------------------------------------------
# config.json
# ---------------------------------------------------------------------------


def diffusers_unet_config_json(config) -> dict:
    """UNetConfig -> diffusers UNet2DConditionModel config dict."""
    down = ["CrossAttnDownBlock2D" if a else "DownBlock2D"
            for a in config.down_block_has_attn]
    up = ["CrossAttnUpBlock2D" if a else "UpBlock2D"
          for a in config.up_block_has_attn]
    return {
        "_class_name": "UNet2DConditionModel",
        "sample_size": config.sample_size,
        "in_channels": config.in_channels,
        "out_channels": config.out_channels,
        "block_out_channels": list(config.block_out_channels),
        "layers_per_block": config.layers_per_block,
        "down_block_types": down,
        "up_block_types": up,
        "attention_head_dim": list(config.num_attention_heads),
        "cross_attention_dim": config.cross_attention_dim,
        "norm_num_groups": config.norm_num_groups,
        "use_linear_projection": config.use_linear_projection,
        "act_fn": "silu",
    }


def vit_config_json(config) -> dict:
    """TrOCRConfig -> transformers ViTModel config dict."""
    return {
        "model_type": "vit",
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "intermediate_size": config.intermediate_size,
        "image_size": config.image_size,
        "patch_size": config.patch_size,
        "num_channels": config.num_channels,
        "layer_norm_eps": config.layer_norm_eps,
        "qkv_bias": config.qkv_bias,
    }


def diffusers_vae_config_json(config) -> dict:
    """VAEConfig -> diffusers AutoencoderKL config dict."""
    return {
        "_class_name": "AutoencoderKL",
        "sample_size": config.sample_size,
        "in_channels": config.in_channels,
        "out_channels": config.out_channels,
        "block_out_channels": list(config.block_out_channels),
        "layers_per_block": config.layers_per_block,
        "latent_channels": config.latent_channels,
        "norm_num_groups": config.norm_num_groups,
        "scaling_factor": config.scaling_factor,
        "down_block_types": ["DownEncoderBlock2D"] * len(config.block_out_channels),
        "up_block_types": ["UpDecoderBlock2D"] * len(config.block_out_channels),
        "act_fn": "silu",
    }


# ---------------------------------------------------------------------------
# loading rules
# ---------------------------------------------------------------------------

_VAE_LEGACY = [
    (re.compile(r"\bmid_block\.attentions\.0\.norm\."),
     "mid_block.attentions.0.group_norm."),
    (re.compile(r"\bmid_block\.attentions\.0\.query\."),
     "mid_block.attentions.0.to_q."),
    (re.compile(r"\bmid_block\.attentions\.0\.key\."),
     "mid_block.attentions.0.to_k."),
    (re.compile(r"\bmid_block\.attentions\.0\.value\."),
     "mid_block.attentions.0.to_v."),
    (re.compile(r"\bmid_block\.attentions\.0\.proj_attn\."),
     "mid_block.attentions.0.to_out.0."),
]

_VIT_KEY = re.compile(
    r"^(embeddings\.(cls_token|position_embeddings)$"
    r"|embeddings\.patch_embeddings\.projection\."
    r"|encoder\.layer\.\d+\.(attention\.attention\.(query|key|value)"
    r"|attention\.output\.dense|intermediate\.dense|output\.dense"
    r"|layernorm_before|layernorm_after)\."
    r"|layernorm\.)")


def _f32(value) -> torch.Tensor:
    t = torch.as_tensor(value)
    return t.float() if t.is_floating_point() else t


def import_unet_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """diffusers UNet2DConditionModel state_dict -> the port's (the same
    keys, floating tensors as fp32)."""
    return {k: _f32(v) for k, v in state_dict.items()}


def import_vae_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """diffusers AutoencoderKL state_dict, modern or legacy names -> the
    port's keys, fp32."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        for pat, repl in _VAE_LEGACY:
            key = pat.sub(repl, key)
        value = _f32(value)
        if (".mid_block.attentions.0.to_" in key and value.ndim == 4
                and value.shape[2:] == (1, 1)):
            value = value[:, :, 0, 0]
        out[key] = value
    return out


def import_trocr_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """transformers ViTModel (or VisionEncoderDecoderModel, ``encoder.``
    prefixed) state_dict -> the port's TrOCREncoder keys, fp32.  The
    pooler and the decoder's weights are dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key.startswith(("encoder.encoder.", "encoder.embeddings.",
                           "encoder.layernorm.")):
            key = key[len("encoder."):]
        if _VIT_KEY.match(key):
            out[key] = _f32(value)
    return out


def import_trocr_decoder_state_dict(state_dict: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """HF TrOCRForCausalLM (or VisionEncoderDecoderModel) state_dict -> the
    port's TrOCRDecoder keys, fp32; the tied ``output_projection`` is
    dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        for prefix in ("decoder." + DECODER_PREFIX, DECODER_PREFIX, "decoder."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key.startswith("output_projection"):
            continue
        out[key] = _f32(value)
    return out


def export_trocr_decoder_state_dict(state_dict: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """The port's TrOCRDecoder state_dict -> HF TrOCRForCausalLM keys
    (``model.decoder.``-prefixed), the layout the JAX package writes."""
    return {DECODER_PREFIX + k: v for k, v in state_dict.items()}
