"""DiffUTEPipeline: one-region text editing on a CUDA card (or the CPU).

Counterpart of ``diffute_tpu/pipeline/edit.py`` with the same public API
(uint8 HWC numpy in and out) and the same stage split:

host:    box validation, mask raster, crop window, glyph raster, 512^2 and
         384^2 resizes, paste-back (numpy / PIL / native hostops);
device:  ``_device_prep``   TrOCR encode, mask downsample, VAE encode + sample
         ``_device_loop``   the DDIM steps over the 9-channel UNet, a Python
                            loop, with the cross-attention K/V projected once
         ``_device_decode`` VAE decode -> uint8.

Only the default ``EditConfig`` path is ported: DDIM, no classifier-free
guidance, no masked-latent blend, ``encoder_reuse_interval=1``; the others
raise.  Noise is drawn from ``torch.Generator(device).manual_seed(seed)``;
``_device_prep`` takes the two noise tensors as arguments so tests can feed
the JAX package's draws.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diffute_tpu_torch.config import DiffUTEConfig, EditConfig
from diffute_tpu_torch.diffusion import ddim_step, ddim_timesteps, make_schedule
from diffute_tpu_torch.io import hostops
from diffute_tpu_torch.models import AutoencoderKL, TrOCREncoder, UNet2DCondition
from diffute_tpu_torch.models.vae import sample_latent
from diffute_tpu_torch.ops import nearest_resize_2d
from diffute_tpu_torch.pipeline.crop import infer_crop_params, paste_back
from diffute_tpu_torch.pipeline.regions import generate_mask, make_masked_image
from diffute_tpu_torch.text import (
    render_glyph,
    trocr_normalize,
    trocr_preprocess_host,
)
from diffute_tpu_torch.utils.device import (
    configure_cuda_numerics,
    resolve_device,
)
from diffute_tpu_torch.utils.params import load_module


def normalize_image(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> fp32 [-1,1] (albumentations Normalize(0.5, 0.5))."""
    return (x_uint8.float() / 255.0 - 0.5) / 0.5


def _validate_box(box, image_hw) -> Tuple[int, int, int, int]:
    """Clip the region box to the image; reject degenerate boxes."""
    h, w = image_hw
    if len(box) != 4:
        raise ValueError(f"box must be (x1, y1, x2, y2); got {box!r}")
    x1, y1, x2, y2 = (int(v) for v in box)
    if x1 > x2:
        x1, x2 = x2, x1
    if y1 > y2:
        y1, y2 = y2, y1
    x1, x2 = max(0, x1), min(w, x2)
    y1, y2 = max(0, y1), min(h, y2)
    if x2 - x1 < 1 or y2 - y1 < 1:
        raise ValueError(
            f"box {box!r} has no area inside the {w}x{h} image after clipping")
    return x1, y1, x2, y2


def _check_ported(ec: EditConfig) -> None:
    for bad, what in ((ec.sampler != "ddim", f"sampler {ec.sampler!r}"),
                      (ec.guidance_scale > 1.0, "classifier-free guidance"),
                      (ec.masked_latent_blend, "masked-latent blend"),
                      (ec.encoder_reuse_interval != 1, "encoder reuse")):
        if bad:
            raise NotImplementedError(
                f"{what} is not yet ported to the PyTorch pipeline "
                "(ROADMAP.md queue 1)")


class DiffUTEPipeline:
    """Holds the three frozen models on ``device``: the card by default
    (raises without one), the CPU only when asked (``device="cpu"``).

    ``params`` is ``{"vae", "unet", "trocr"}`` -> state_dict with diffusers /
    transformers keys (``utils.init_pipeline_params`` or
    ``compat.pipeline_state_dicts``); each model is stored in its config's
    dtype.
    """

    def __init__(self, config: DiffUTEConfig,
                 params: Dict[str, Dict[str, torch.Tensor]], device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        configure_cuda_numerics(self.device, config.unet)
        self.vae = load_module(AutoencoderKL, config.vae, params["vae"],
                               self.device, config.vae.dtype)
        self.unet = load_module(UNet2DCondition, config.unet, params["unet"],
                                self.device, config.unet.dtype)
        self.trocr = load_module(TrOCREncoder, config.trocr, params["trocr"],
                                 self.device, config.trocr.dtype)
        self.schedule = make_schedule(config.scheduler, device=self.device)

    # ------------------------------------------------------------------
    # Device stages
    # ------------------------------------------------------------------

    def _device_prep(self, mask_u8: torch.Tensor, masked_u8: torch.Tensor,
                     glyph_u8: torch.Tensor, init_noise: torch.Tensor,
                     latent_noise: torch.Tensor):
        """mask (B,R,R) u8, masked (B,R,R,3) u8, glyph (B,384,384,3) u8,
        init_noise / latent_noise (B,4,R/8,R/8) fp32 ->
        (ctx, mask_lat, masked_latents, latents)."""
        cfg = self.config
        r = mask_u8.shape[1] // cfg.vae.scale_factor
        glyph = trocr_normalize(glyph_u8).permute(0, 3, 1, 2)
        ctx = self.trocr(glyph.to(cfg.trocr.dtype))
        # torch F.interpolate 'nearest' index rule (ops/interpolate.py)
        mask_lat = nearest_resize_2d(mask_u8.float(), r, r)[:, None]
        masked = normalize_image(masked_u8).permute(0, 3, 1, 2)
        mean, logvar = self.vae.encode(masked.to(cfg.vae.dtype))
        masked_latents = sample_latent(mean.float(), logvar.float(),
                                       latent_noise) * cfg.vae.scaling_factor
        return ctx, mask_lat, masked_latents, init_noise.float()

    def _device_loop(self, num_steps: int, ctx, mask_lat, masked_latents,
                     latents, return_trajectory: bool = False):
        """The DDIM loop.  Returns the final fp32 latents (B,4,r,r), and with
        ``return_trajectory`` also the latents after every step
        (num_steps, B, 4, r, r)."""
        dtype = self.config.unet.dtype
        ts = ddim_timesteps(self.schedule, num_steps)
        prevs = [int(t) for t in ts[1:]] + [-1]
        ts_dev = torch.as_tensor(ts, device=latents.device)
        ctx = ctx.to(dtype)
        # loop-invariant: project the cross-attention K/V once per edit
        ctx_kv = self.unet.cross_attention_kv(ctx)
        cond = torch.cat([mask_lat, masked_latents], dim=1)
        traj: List[torch.Tensor] = []
        for j, (t, prev_t) in enumerate(zip(ts, prevs)):
            temb = self.unet.time_embed(ts_dev[j], latents.shape[0])
            x_in = torch.cat([latents, cond], dim=1).to(dtype)
            bottom, skips = self.unet.encode(x_in, temb, ctx, ctx_kv)
            eps = self.unet.decode(bottom, skips, temb, ctx, ctx_kv).float()
            latents = ddim_step(self.schedule, eps, int(t), prev_t, latents)
            if return_trajectory:
                traj.append(latents)
        if return_trajectory:
            return latents, torch.stack(traj)
        return latents

    def _device_decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B,4,r,r) latents -> (B,R,R,3) uint8."""
        z = latents / self.config.vae.scaling_factor
        image = self.vae.decode(z.to(self.config.vae.dtype)).float()
        image = (image / 2 + 0.5) * 255.0
        image = torch.clamp(torch.round(image), 0, 255).to(torch.uint8)
        return image.permute(0, 2, 3, 1)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def edit(self, image: np.ndarray, box: Tuple[int, int, int, int],
             text: str, num_inference_steps: Optional[int] = None,
             seed: Optional[int] = None,
             edit_config: Optional[EditConfig] = None,
             rng: Optional[np.random.Generator] = None,
             return_crop: bool = False):
        """Edit one text region.  Returns (edited uint8 image, mask*255), and
        with ``return_crop`` the pre-paste crop artifacts as a third item."""
        ec = edit_config or self.config.edit
        _check_ported(ec)
        steps = num_inference_steps or ec.num_inference_steps
        seed = ec.seed if seed is None else seed

        image = np.asarray(image, dtype=np.uint8)
        box = _validate_box(box, image.shape[:2])
        region, mask = self._prepare_region(image, box, text, ec.resolution, rng)
        edited = self._run_device([region], steps, seed)[0]
        result = paste_back(image, edited, region["x_s"], region["y_s"],
                            region["crop_scale"], region["location"])
        if return_crop:
            return result, mask * 255, {"edited_crop": edited,
                                        "source_crop": region["crop512"],
                                        "crop_mask": region["mask512"]}
        return result, mask * 255

    # ------------------------------------------------------------------
    # Host helpers
    # ------------------------------------------------------------------

    def _prepare_region(self, image, box, text, res, rng):
        # the raw box, as the reference's text_editing uses it (no +10%)
        h, w = image.shape[:2]
        location = np.int32(box)
        mask = generate_mask((h, w), location)
        masked = make_masked_image(image, mask)
        x_s, y_s, crop_scale = infer_crop_params((h, w), location, rng)
        window = (slice(y_s, y_s + crop_scale), slice(x_s, x_s + crop_scale))
        region = {
            "crop512": hostops.resize_bilinear_u8(image[window], res, res),
            "mask512": hostops.resize_bilinear_u8(mask[window], res, res),
            "masked512": hostops.resize_bilinear_u8(masked[window], res, res),
            "glyph": render_glyph(text, self.config.glyph),
            "x_s": x_s, "y_s": y_s, "crop_scale": crop_scale,
            "location": location,
        }
        return region, mask

    def _run_device(self, regions, steps: int, seed: int) -> np.ndarray:
        glyph384 = trocr_preprocess_host([r["glyph"] for r in regions],
                                         self.config.trocr)
        dev = self.device
        mask = torch.from_numpy(np.stack([r["mask512"] for r in regions])).to(dev)
        masked = torch.from_numpy(np.stack([r["masked512"] for r in regions])).to(dev)
        glyph = torch.from_numpy(glyph384).to(dev)
        r = mask.shape[1] // self.config.vae.scale_factor
        shape = (len(regions), self.config.vae.latent_channels, r, r)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        init_noise = torch.randn(shape, generator=gen, device=dev)
        latent_noise = torch.randn(shape, generator=gen, device=dev)
        with torch.inference_mode():
            prepped = self._device_prep(mask, masked, glyph, init_noise,
                                        latent_noise)
            latents = self._device_loop(steps, *prepped)
            out = self._device_decode(latents)
        return out.cpu().numpy()


def text_editing(pipe: DiffUTEPipeline, text: str, instance_image: np.ndarray,
                 slider_step: int, x0: int, y0: int, x1: int, y1: int):
    """Signature-compatible wrapper of the reference's
    ``text_editing(text, instance_image, slider_step, x0, y0, x1, y1)
    -> (PIL.Image, mask*255)``."""
    from PIL import Image

    out, mask = pipe.edit(instance_image, (x0, y0, x1, y1), text,
                          num_inference_steps=int(slider_step))
    return Image.fromarray(out).convert("RGB"), mask
