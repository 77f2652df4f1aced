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
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from diffute_tpu_torch.config import DiffUTEConfig
from diffute_tpu_torch.diffusion import add_noise, make_schedule, training_target
from diffute_tpu_torch.models import AutoencoderKL, TrOCREncoder, UNet2DCondition
from diffute_tpu_torch.models.ema import EmaState
from diffute_tpu_torch.models.vae import sample_latent
from diffute_tpu_torch.ops import nearest_resize_2d
from diffute_tpu_torch.text import trocr_normalize
from diffute_tpu_torch.train.optim import build_optimizer
from diffute_tpu_torch.train.state import TrainState
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


class UNetTrainer:
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
        configure_cuda_numerics(self.device, config.unet)

        self.vae = load_module(AutoencoderKL, config.vae, frozen_params["vae"],
                               self.device, dtype)
        self.trocr = load_module(TrOCREncoder, config.trocr,
                                 frozen_params["trocr"], self.device, dtype)
        # fp32 masters: copies, so the caller's tensors stay as they were
        names = list(unet_params)
        masters = [unet_params[n].detach().to(self.device, torch.float32,
                                              copy=True) for n in names]
        self.unet = load_module(UNet2DCondition, config.unet,
                                dict(zip(names, masters)), self.device, dtype)
        self.unet.requires_grad_(True)
        self._compute_params = [self.unet.get_parameter(n) for n in names]
        if not self.bf16:
            masters = self._compute_params  # the module's own fp32 weights

        total = total_steps or tc.max_train_steps or 10_000
        tbs = tc.train_batch_size * tc.gradient_accumulation_steps
        self.state = TrainState(
            names=names, params=masters,
            opt=build_optimizer(masters, tc.optimizer, total, tbs),
            ema=EmaState(masters) if tc.use_ema else None)
        self.schedule = make_schedule(config.scheduler, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(tc.seed)

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

    def accumulate_grads(self, batch: Batch,
                         draws: Union[None, TrainDraws, Sequence[TrainDraws]]
                         = None) -> torch.Tensor:
        """Mean loss of the batch's micro-batches, with the mean of their
        gradients left in the masters' ``.grad`` (fp32).

        With ``gradient_accumulation_steps > 1`` every array of ``batch``
        has leading dims (accum, micro) and ``draws`` is one
        :class:`TrainDraws` per micro-batch; None draws them from the
        trainer's generator."""
        accum = self.config.train.gradient_accumulation_steps
        micros = ([{k: v[i] for k, v in batch.items()} for i in range(accum)]
                  if accum > 1 else [batch])
        if draws is None:
            draws = [self.draw(len(m["masks"])) for m in micros]
        elif isinstance(draws, TrainDraws):
            draws = [draws]
        if len(draws) != len(micros):
            raise ValueError(f"{len(draws)} draws for {len(micros)} micro-batches")
        masters = self.state.params
        for p in masters:
            p.grad = None
        loss_sum = torch.zeros((), device=self.device)
        for micro, d in zip(micros, draws):
            loss = self.loss_fn(micro, d)
            loss.backward()
            loss_sum += loss.detach()
            if self.bf16:  # bf16 grads of the compute copy -> fp32 buffers
                for m, c in zip(masters, self._compute_params):
                    g = c.grad.float()
                    m.grad = g if m.grad is None else m.grad.add_(g)
                    c.grad = None
        if accum > 1:
            torch._foreach_div_([p.grad for p in masters], accum)
        return loss_sum / accum

    def apply_grads(self) -> torch.Tensor:
        """Clip, AdamW and EMA on the accumulated gradients; returns the
        pre-clip global gradient norm."""
        state = self.state
        grad_norm = state.opt.step()
        for p in state.params:
            p.grad = None
        if self.bf16:
            with torch.no_grad():
                torch._foreach_copy_(self._compute_params, state.params)
        if state.ema is not None:
            state.ema.update(state.params, self.config.train.ema_decay)
        state.step += 1
        return grad_norm

    def step(self, batch: Batch,
             draws: Union[None, torch.Generator, TrainDraws,
                          Sequence[TrainDraws]] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimizer step.  ``draws``: None (the trainer's generator), a
        ``torch.Generator`` on the trainer's device, or the draws themselves.
        Returns 0-d tensors ``{"loss", "grad_norm"}``; reading them is the
        step's only host synchronisation."""
        if isinstance(draws, torch.Generator):
            self.generator, draws = draws, None
        loss = self.accumulate_grads(batch, draws)
        return {"loss": loss, "grad_norm": self.apply_grads()}
