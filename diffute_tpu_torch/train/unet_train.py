"""Stage-2 trainer: the SD2-inpainting UNet with TrOCR glyph conditioning.

Counterpart of ``diffute_tpu/train/unet_train.py`` on one card:

  glyph -> TrOCR encode (frozen)
  pixels / masked -> VAE encode, sample, x scaling_factor (frozen)
  mask -> nearest-downsample to latent resolution
  t ~ U[0, T); noisy = add_noise(latents, eps, t); target = eps | velocity
  pred = unet(concat 9ch, t, ctx); loss = MSE in fp32
  grad accumulation -> clip -> AdamW -> EMA

Numerics follow the JAX step.  The frozen models are stored and run in the
compute dtype without grad.  With ``mixed_precision="bf16"`` the UNet module
holds a bf16 copy of the fp32 master weights, refreshed after every
optimizer step; its bf16 gradients are added to fp32 gradient buffers on
the masters (the JAX step's cast transposes to exactly that), and the
optimizer updates the masters.  There is no ``torch.autocast``: GroupNorm
and softmax run in bf16 as in the JAX modules.  Tensors are NCHW inside;
batches arrive in the JAX layout and are permuted once.  The state is
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from diffute_tpu_torch.config import DiffUTEConfig
from diffute_tpu_torch.diffusion import add_noise, make_schedule, training_target
from diffute_tpu_torch.models import AutoencoderKL, TrOCREncoder, UNet2DCondition
from diffute_tpu_torch.models.vae import sample_latent
from diffute_tpu_torch.ops import nearest_resize_2d
from diffute_tpu_torch.text import trocr_normalize
from diffute_tpu_torch.train.state import Trainer
from diffute_tpu_torch.utils.device import configure_cuda_numerics, resolve_device
from diffute_tpu_torch.utils.images import device_to_unit_range
from diffute_tpu_torch.utils.params import load_module

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


@dataclasses.dataclass
class TrainDraws:
    """The five random draws of one loss evaluation, in the order the JAX
    ``loss_fn`` splits its key: the VAE sample's normal for the pixels and
    for the masked image, the noise, the timesteps and the noise offset.
    Normals are (B, 4, r, r) in the compute dtype (the offset (B, 4, 1, 1),
    or None when ``noise_offset`` is 0); timesteps are int64 (B,)."""

    vae_noise: torch.Tensor
    masked_noise: torch.Tensor
    noise: torch.Tensor
    timesteps: torch.Tensor
    offset_noise: Optional[torch.Tensor] = None

    @classmethod
    def sample(cls, gen: torch.Generator, batch: int, channels: int, r: int,
               num_train_timesteps: int, dtype: torch.dtype,
               with_offset: bool) -> "TrainDraws":
        def normal(*shape):
            return torch.randn(shape, generator=gen, device=gen.device,
                               dtype=dtype)

        return cls(normal(batch, channels, r, r), normal(batch, channels, r, r),
                   normal(batch, channels, r, r),
                   torch.randint(0, num_train_timesteps, (batch,),
                                 generator=gen, device=gen.device),
                   normal(batch, channels, 1, 1) if with_offset else None)


class UNetTrainer(Trainer):
    """Holds the trainable UNet, the frozen VAE and TrOCR encoder and the
    train state on ``device``: the card by default (raises without one),
    the CPU only when asked.

    ``unet_params`` and ``frozen_params`` (``{"vae", "trocr"}``) are
    state_dicts with diffusers / transformers keys.  ``config.unet.dtype``
    is ignored: the compute dtype follows ``config.train.mixed_precision``.
    """

    def __init__(self, config: DiffUTEConfig,
                 unet_params: Dict[str, torch.Tensor],
                 frozen_params: Dict[str, Dict[str, torch.Tensor]],
                 device="cuda", total_steps: Optional[int] = None):
        tc = config.train
        if tc.mixed_precision not in ("no", "bf16"):
            raise ValueError(f"mixed_precision must be no|bf16, got "
                             f"{tc.mixed_precision!r}")
        self.bf16 = tc.mixed_precision == "bf16"
        dtype = self.dtype = torch.bfloat16 if self.bf16 else torch.float32
        config = self.config = dataclasses.replace(
            config,
            vae=dataclasses.replace(config.vae, dtype=dtype),
            unet=dataclasses.replace(config.unet, dtype=dtype),
            trocr=dataclasses.replace(config.trocr, dtype=dtype))
        self.device = resolve_device(device)
        configure_cuda_numerics(self.device, config.unet, config.vae)

        self.vae = load_module(AutoencoderKL, config.vae, frozen_params["vae"],
                               self.device, dtype)
        self.trocr = load_module(TrOCREncoder, config.trocr,
                                 frozen_params["trocr"], self.device, dtype)
        self.unet = self._init_trained(UNet2DCondition, config.unet,
                                       unet_params, total_steps)
        self.schedule = make_schedule(config.scheduler, device=self.device)

    # ------------------------------------------------------------------

    def draw(self, batch: int) -> TrainDraws:
        """One loss evaluation's draws from the trainer's own generator."""
        cfg = self.config
        r = cfg.edit.resolution // cfg.vae.scale_factor
        return TrainDraws.sample(self.generator, batch, cfg.vae.latent_channels,
                                 r, cfg.scheduler.num_train_timesteps,
                                 self.dtype, bool(cfg.train.noise_offset))

    def loss_fn(self, micro: Batch, draws: TrainDraws) -> torch.Tensor:
        """The fp32 MSE of one micro-batch.

        ``micro``: pixel_values / masked_images (B, R, R, 3) uint8 (or float
        in [-1, 1]), masks (B, R, R) uint8 {0, 1}, glyph_pixels
        (B, S, S, 3) uint8, as numpy arrays or tensors."""
        cfg, dtype = self.config, self.dtype
        sf = cfg.vae.scaling_factor

        def dev(x):
            return torch.as_tensor(x).to(self.device)

        with torch.no_grad():
            pixels = device_to_unit_range(dev(micro["pixel_values"]), dtype)
            masked = device_to_unit_range(dev(micro["masked_images"]), dtype)
            glyphs = trocr_normalize(dev(micro["glyph_pixels"])).to(dtype)
            ctx = self.trocr(glyphs.permute(0, 3, 1, 2))
            latents = sample_latent(*self.vae.encode(pixels.permute(0, 3, 1, 2)),
                                    draws.vae_noise) * sf
            masked_latents = sample_latent(
                *self.vae.encode(masked.permute(0, 3, 1, 2)),
                draws.masked_noise) * sf
            r = latents.shape[-1]
            # torch F.interpolate 'nearest' index rule (ops/interpolate.py)
            mask_lat = nearest_resize_2d(dev(micro["masks"]).to(dtype), r, r)[:, None]
            noise = draws.noise
            if cfg.train.noise_offset:
                noise = noise + cfg.train.noise_offset * draws.offset_noise
            t = draws.timesteps
            noisy = add_noise(self.schedule, latents, noise, t)
            target = training_target(self.schedule, latents, noise, t)
            x_in = torch.cat([noisy, mask_lat, masked_latents], dim=1).to(dtype)
        pred = self.unet(x_in, t, ctx)
        return torch.mean((pred.float() - target.float()) ** 2)
