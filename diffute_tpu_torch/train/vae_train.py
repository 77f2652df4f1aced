"""Stage-1 trainer: the VAE's reconstruction fine-tune on document images.

Counterpart of ``diffute_tpu/train/vae_train.py`` on one card: uint8 pixels
normalised on the device, encode -> sample -> decode, pixel MSE in fp32
against the input (no KL term, as the reference's stage 1), gradient
accumulation, clip, AdamW and EMA.  With ``mixed_precision="bf16"`` the VAE
module holds a bf16 copy of the fp32 master weights, as ``UNetTrainer``
does.  The posterior's standard normal is the step's one draw: given as an
argument, or drawn from the trainer's generator.  The trained VAE feeds
stage 2 through its ``vae/`` export.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from diffute_tpu_torch.config import DiffUTEConfig
from diffute_tpu_torch.models import AutoencoderKL
from diffute_tpu_torch.models.vae import sample_latent
from diffute_tpu_torch.train.state import Trainer
from diffute_tpu_torch.utils.device import configure_cuda_numerics, resolve_device
from diffute_tpu_torch.utils.images import device_to_unit_range

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


class VAETrainer(Trainer):
    """Holds the trainable VAE and its train state on ``device``: the card
    by default (raises without one), the CPU only when asked.

    ``vae_params`` is a state_dict with diffusers keys.  ``config.vae.dtype``
    is ignored: the compute dtype follows ``config.train.mixed_precision``.
    The batch is ``{"pixel_values": (B, R, R, 3) uint8}`` (or float in
    [-1, 1]); with ``gradient_accumulation_steps > 1`` (accum, B, R, R, 3).
    A draw is the posterior's normal, (B, latent_channels, R/8, R/8) in the
    compute dtype.
    """

    def __init__(self, config: DiffUTEConfig, vae_params: Dict[str, torch.Tensor],
                 device="cuda", total_steps: Optional[int] = None):
        tc = config.train
        if tc.mixed_precision not in ("no", "bf16"):
            raise ValueError(f"mixed_precision must be no|bf16, got "
                             f"{tc.mixed_precision!r}")
        self.bf16 = tc.mixed_precision == "bf16"
        self.dtype = torch.bfloat16 if self.bf16 else torch.float32
        config = self.config = dataclasses.replace(
            config, vae=dataclasses.replace(config.vae, dtype=self.dtype))
        self.device = resolve_device(device)
        configure_cuda_numerics(self.device, config.vae)
        self.vae = self._init_trained(AutoencoderKL, config.vae, vae_params,
                                      total_steps)

    def draw(self, batch: int) -> torch.Tensor:
        """The posterior's standard normal from the trainer's generator."""
        cfg = self.config
        r = cfg.edit.resolution // cfg.vae.scale_factor
        return torch.randn((batch, cfg.vae.latent_channels, r, r),
                           generator=self.generator, device=self.device,
                           dtype=self.dtype)

    def loss_fn(self, micro: Batch, noise: torch.Tensor) -> torch.Tensor:
        """The fp32 pixel MSE of one micro-batch's reconstruction."""
        x = torch.as_tensor(micro["pixel_values"]).to(self.device)
        pixels = device_to_unit_range(x, self.dtype).permute(0, 3, 1, 2)
        z = sample_latent(*self.vae.encode(pixels), noise.to(self.dtype))
        recon = self.vae.decode(z)
        return torch.mean((recon.float() - pixels.float()) ** 2)
