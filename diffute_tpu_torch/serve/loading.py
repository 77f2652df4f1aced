"""Model weights from a diffusers-layout checkpoint directory.

Counterpart of ``diffute_tpu/serve/loading.py``.  The directory holds
``unet/`` (or ``unet_ema/``, preferred) and ``vae/`` with
``diffusion_pytorch_model.safetensors``, and optionally ``trocr/`` with
``model.safetensors`` in transformers naming and the OCR verifier's
``trocr_decoder/``: what the trainers export.  Of the three models, only
those the directory lacks are random-initialized, each from seed 0.  The
result is the ``{"vae", "unet", "trocr"}`` state_dicts that
``DiffUTEPipeline`` and ``UNetTrainer`` take, with ``"trocr_decoder"``
where the directory has one.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from diffute_tpu_torch.compat.diffusers import (
    TROCR_FILE,
    UNET_FILE,
    VAE_FILE,
    diffusers_unet_config_json,
    diffusers_vae_config_json,
    import_trocr_decoder_state_dict,
    import_trocr_state_dict,
    import_unet_state_dict,
    import_vae_state_dict,
    load_safetensors,
    vit_config_json,
)
from diffute_tpu_torch.config import DiffUTEConfig, small_config, tiny_test_config
from diffute_tpu_torch.utils.device import resolve_device
from diffute_tpu_torch.utils.params import init_pipeline_params


def _find(path: str, sub: str, name: str) -> Optional[str]:
    p = os.path.join(path, sub, name)
    return p if os.path.exists(p) else None


def resolve_diffusers_layout(path: str) -> Dict[str, Optional[str]]:
    """Component -> the weight file :func:`load_diffusers_layout` reads
    (None when it would be random-initialized).  A bare ``vae/`` directory
    without its safetensors file resolves to None."""
    return {
        "unet": (_find(path, "unet_ema", UNET_FILE)
                 or _find(path, "unet", UNET_FILE)),
        "vae": _find(path, "vae", VAE_FILE),
        "trocr": _find(path, "trocr", TROCR_FILE),
    }


def load_diffusers_layout(path: str, config: DiffUTEConfig, device="cuda",
                          components=("vae", "unet", "trocr", "trocr_decoder")
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """fp32 state_dicts on ``device`` (the card unless the caller asks for
    the CPU) for the ``components`` asked for, read from the directory
    ``path`` (which must exist).  The OCR verifier's decoder
    (``trocr_decoder/model.safetensors``, HF ``TrOCRForCausalLM`` layout)
    is returned only when the directory has it: its configuration is not
    part of ``config``."""
    device = resolve_device(device)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path!r}")
    importers = {"unet": import_unet_state_dict, "vae": import_vae_state_dict,
                 "trocr": import_trocr_state_dict,
                 "trocr_decoder": import_trocr_decoder_state_dict}
    files = {**resolve_diffusers_layout(path),
             "trocr_decoder": _find(path, "trocr_decoder", TROCR_FILE)}
    params = {}
    for name in components:
        if files[name]:
            params[name] = {k: v.to(device) for k, v in importers[name](
                load_safetensors(files[name])).items()}
        elif name != "trocr_decoder":
            params.update(init_pipeline_params(config, 0, device, (name,)))
    return params


SCALES = {"full": DiffUTEConfig, "small": small_config,
          "tiny": tiny_test_config}


def layout_scale(path: str) -> Optional[str]:
    """The model scale ("full", "small" or "tiny") whose configs the
    directory's ``config.json`` files equal; None when it has none or no
    scale matches them."""
    expected = {"unet": lambda c: diffusers_unet_config_json(c.unet),
                "unet_ema": lambda c: diffusers_unet_config_json(c.unet),
                "vae": lambda c: diffusers_vae_config_json(c.vae),
                "trocr": lambda c: vit_config_json(c.trocr)}
    found = {}
    for sub in expected:
        p = os.path.join(path, sub, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                found[sub] = json.load(f)
    for name, make in SCALES.items() if found else ():
        cfg = make()
        if all(cfg_json == expected[sub](cfg) for sub, cfg_json in found.items()):
            return name
    return None
