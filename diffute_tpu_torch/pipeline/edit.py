"""DiffUTEPipeline: text editing on a CUDA card (or the CPU).

Counterpart of ``diffute_tpu/pipeline/edit.py`` with the same public API
(uint8 HWC numpy in and out; ``edit``, ``edit_multi``, ``edit_batch``,
``edit_stream``, ``edit_profiled``; one card, so no ``mesh``) and the same
stage split:

host:    box validation, mask raster, crop window, glyph raster, 512^2 and
         384^2 resizes, paste-back (numpy / PIL / native hostops);
device:  ``_device_prep``   TrOCR encode, mask downsample, VAE encode + sample
         ``_device_loop``   the sampler steps over the 9-channel UNet, a
                            Python loop, with the cross-attention K/V
                            projected once
         ``_device_decode`` VAE decode -> uint8.

Every ``EditConfig`` of the JAX ``edit()`` runs: the DDIM, DDPM and
DPM-Solver++(2M) samplers, classifier-free guidance (``guidance_scale > 1``:
the [cond; uncond] pair as one batch-2B UNet pass, the null context being
the TrOCR encoding of the empty glyph), the masked-latent blend, and encoder
reuse (``encoder_reuse_interval = k``: one full UNet pass, then k - 1
decoder-only passes over its encoder features; a remainder of full steps).
All noise is drawn from ``torch.Generator(device).manual_seed(seed)`` in
``_draw_noise`` and enters the stages as arguments, so tests can feed the JAX
package's draws.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from diffute_tpu_torch.config import DiffUTEConfig, EditConfig
from diffute_tpu_torch.diffusion import (
    add_noise,
    ddim_step,
    ddim_timesteps,
    ddpm_step,
    ddpm_timesteps,
    dpmpp_2m_step,
    make_schedule,
)
from diffute_tpu_torch.io import hostops
from diffute_tpu_torch.models import AutoencoderKL, TrOCREncoder, UNet2DCondition
from diffute_tpu_torch.models.vae import sample_latent
from diffute_tpu_torch.ops import flash_attention, nearest_resize_2d
from diffute_tpu_torch.ops.conv_fused import gn_silu_conv3x3
from diffute_tpu_torch.ops.quant import quant_matmul
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
                     latent_noise: torch.Tensor,
                     null_glyph_u8: Optional[torch.Tensor] = None,
                     crop_u8: Optional[torch.Tensor] = None,
                     crop_noise: Optional[torch.Tensor] = None):
        """mask (B,R,R) u8, masked (B,R,R,3) u8, glyph (B,384,384,3) u8,
        init_noise / latent_noise (B,4,R/8,R/8) fp32; for guidance the empty
        glyph (1,384,384,3) u8; for the blend the crop (B,R,R,3) u8 and its
        latent noise ->
        (ctx, mask_lat, masked_latents, latents, null_ctx, crop_latents),
        the last two ``None`` without their inputs."""
        cfg = self.config
        sf = cfg.vae.scaling_factor
        r = mask_u8.shape[1] // cfg.vae.scale_factor

        def encode_glyph(g):
            g = trocr_normalize(g).permute(0, 3, 1, 2)
            return self.trocr(g.to(cfg.trocr.dtype))

        def encode_image(img_u8, noise):
            img = normalize_image(img_u8).permute(0, 3, 1, 2)
            mean, logvar = self.vae.encode(img.to(cfg.vae.dtype))
            return sample_latent(mean.float(), logvar.float(), noise) * sf

        ctx = encode_glyph(glyph_u8)
        null_ctx = None
        if null_glyph_u8 is not None:
            null_ctx = encode_glyph(null_glyph_u8).expand_as(ctx)
        # torch F.interpolate 'nearest' index rule (ops/interpolate.py)
        mask_lat = nearest_resize_2d(mask_u8.float(), r, r)[:, None]
        masked_latents = encode_image(masked_u8, latent_noise)
        crop_latents = (encode_image(crop_u8, crop_noise)
                        if crop_u8 is not None else None)
        return (ctx, mask_lat, masked_latents, init_noise.float(), null_ctx,
                crop_latents)

    def _device_loop(self, num_steps: int, ctx, mask_lat, masked_latents,
                     latents, null_ctx=None, crop_latents=None, *,
                     sampler: str = "ddim", guidance_scale: float = 1.0,
                     blend: bool = False, reuse_interval: int = 1,
                     step_noise: Optional[torch.Tensor] = None,
                     blend_noise: Optional[torch.Tensor] = None,
                     return_trajectory: bool = False):
        """The denoising loop.  ``step_noise`` (num_steps, B, 4, r, r) feeds
        DDPM's ancestral steps, ``blend_noise`` (B, 4, r, r) re-noises the
        crop latents for the blend.  Returns the final fp32 latents
        (B,4,r,r), and with ``return_trajectory`` also the latents after
        every step (num_steps, B, 4, r, r)."""
        if sampler not in ("ddim", "ddpm", "dpmpp"):
            raise ValueError(f"unknown sampler {sampler!r}")
        dtype = self.config.unet.dtype
        use_cfg = guidance_scale > 1.0
        if use_cfg and null_ctx is None:
            raise ValueError("guidance needs the null context")
        if blend and (crop_latents is None or blend_noise is None):
            raise ValueError("the blend needs crop latents and blend noise")
        if sampler == "ddpm" and step_noise is None:
            raise ValueError("the DDPM sampler needs per-step noise")
        ts = (ddpm_timesteps if sampler == "ddpm" else ddim_timesteps)(
            self.schedule, num_steps)
        ts = [int(t) for t in ts]
        prevs = ts[1:] + [-1]
        ts_dev = torch.as_tensor(ts, device=latents.device)

        # loop-invariant: project the cross-attention K/V once per edit; with
        # guidance the [cond; uncond] pair runs as one batch-2B pass
        ctx = ctx.to(dtype)
        kv = self.unet.cross_attention_kv(ctx)
        cond = torch.cat([mask_lat, masked_latents], dim=1)
        if use_cfg:
            null_ctx = null_ctx.to(dtype)
            null_kv = self.unet.cross_attention_kv(null_ctx)
            ctx = torch.cat([ctx, null_ctx], dim=0)
            kv = tuple(tuple(tuple(torch.cat([a, b], dim=0)
                                   for a, b in zip(blk, null_blk))
                             for blk, null_blk in zip(layer, null_layer))
                       for layer, null_layer in zip(kv, null_kv))
            cond = torch.cat([cond, cond], dim=0)

        def predict(latents, j, cache):
            """-> (eps, encoder features); ``cache=None`` forces a full
            forward, otherwise only the decoder runs over the cached
            features."""
            n = latents.shape[0] * (2 if use_cfg else 1)
            temb = self.unet.time_embed(ts_dev[j], n)
            if cache is None:
                x = torch.cat([latents, latents], 0) if use_cfg else latents
                x_in = torch.cat([x, cond], dim=1).to(dtype)
                cache = self.unet.encode(x_in, temb, ctx, kv)
            eps = self.unet.decode(*cache, temb, ctx, kv).float()
            if use_cfg:
                eps_c, eps_u = eps.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            return eps, cache

        k = max(1, reuse_interval)
        n_grouped = num_steps - num_steps % k  # the remainder: full steps
        prev_x0, t_last = torch.zeros_like(latents), -1  # DPM-Solver++ carry
        cache = None
        traj: List[torch.Tensor] = []
        for j, (t, prev_t) in enumerate(zip(ts, prevs)):
            reuse = j < n_grouped and j % k > 0
            eps, cache = predict(latents, j, cache if reuse else None)
            if sampler == "ddpm":
                latents = ddpm_step(self.schedule, eps, t, latents,
                                    step_noise[j], num_steps)
            elif sampler == "dpmpp":
                latents, prev_x0 = dpmpp_2m_step(
                    self.schedule, eps, t, prev_t, t_last, latents, prev_x0)
                t_last = t
            else:
                latents = ddim_step(self.schedule, eps, t, prev_t, latents)
            if blend:
                noised = (add_noise(self.schedule, crop_latents, blend_noise,
                                    ts_dev[j + 1])
                          if prev_t >= 0 else crop_latents)
                latents = mask_lat * latents + (1.0 - mask_lat) * noised
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
        ec, steps, seed = self._resolve(num_inference_steps, seed, edit_config)
        image = np.asarray(image, dtype=np.uint8)
        box = _validate_box(box, image.shape[:2])
        region, mask = self._prepare_region(image, box, text, ec.resolution, rng)
        edited = self._run_device([region], steps, ec, seed)[0]
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

    def _draw_noise(self, shape, steps: int, ec: EditConfig, seed: int):
        """Every draw of one device pass, fp32 on the device: (init, latent,
        crop, blend, per-step) noise of ``shape`` (B, 4, r, r), the last
        with a leading ``steps`` axis; ``None`` where the mode does not use
        it.  One generator per pass, never shared between edits in flight;
        the first two draws are the default path's, the others follow."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def noise(*lead):
            return torch.randn((*lead, *shape), generator=gen,
                               device=self.device)

        blend = ec.masked_latent_blend
        return (noise(), noise(), noise() if blend else None,
                noise() if blend else None,
                noise(steps) if ec.sampler == "ddpm" else None)

    def _enqueue(self, regions, steps: int, ec: EditConfig, seed: int,
                 stream=None, stage=None):
        """Queue one device pass over ``regions`` (upload, prep, loop,
        decode, copy of the uint8 crops to the host) and return without
        waiting for it: a handle for :meth:`_fetch`.

        ``stream`` (CUDA only): run the pass on this side stream instead of
        the current one.  Every tensor of the pass, the noise generator
        included, is created and consumed inside the stream's context, so
        the caching allocator keeps its memory on that stream and nothing
        crosses to another; the weights were loaded on the current stream,
        which the side stream waits for first.  ``stage`` (edit_profiled):
        a context-manager factory wrapped around each of the four stages
        ``host_prep``, ``prep``, ``loop``, ``decode``."""
        cfg, dev = self.config, self.device
        use_cfg, blend = ec.guidance_scale > 1.0, ec.masked_latent_blend
        stage = stage or (lambda name: contextlib.nullcontext())
        on_side = contextlib.nullcontext()
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
            on_side = torch.cuda.stream(stream)

        def on_device(key):
            return torch.from_numpy(np.stack([r[key] for r in regions])).to(dev)

        def glyphs(images):
            return torch.from_numpy(
                trocr_preprocess_host(images, cfg.trocr)).to(dev)

        with on_side, torch.inference_mode():
            with stage("host_prep"):
                mask = on_device("mask512")
                r = mask.shape[1] // cfg.vae.scale_factor
                (init_noise, latent_noise, crop_noise, blend_noise,
                 step_noise) = self._draw_noise(
                    (len(regions), cfg.vae.latent_channels, r, r), steps, ec,
                    seed)
                masked = on_device("masked512")
                glyph = glyphs([r["glyph"] for r in regions])
                null_glyph = (glyphs([render_glyph("", cfg.glyph)])
                              if use_cfg else None)
                crop = on_device("crop512") if blend else None
            with stage("prep"):
                prepped = self._device_prep(
                    mask, masked, glyph, init_noise, latent_noise,
                    null_glyph_u8=null_glyph, crop_u8=crop,
                    crop_noise=crop_noise)
            with stage("loop"):
                latents = self._device_loop(
                    steps, *prepped, sampler=ec.sampler,
                    guidance_scale=ec.guidance_scale, blend=blend,
                    reuse_interval=ec.encoder_reuse_interval,
                    step_noise=step_noise, blend_noise=blend_noise)
            with stage("decode"):
                out, done = self._device_decode(latents), None
                if dev.type == "cuda":
                    # pinned, so the copy is queued and the host does not wait
                    out = torch.empty(out.shape, dtype=out.dtype,
                                      pin_memory=True).copy_(out,
                                                             non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
        return out, done

    @staticmethod
    def _fetch(pending) -> np.ndarray:
        """Wait for one queued pass (its own event, not the device) and
        return its (B, R, R, 3) uint8 crops."""
        out, done = pending
        if done is not None:
            done.synchronize()
        return out.numpy()

    def _run_device(self, regions, steps: int, ec: EditConfig,
                    seed: int) -> np.ndarray:
        return self._fetch(self._enqueue(regions, steps, ec, seed))

    def _resolve(self, num_inference_steps, seed, edit_config):
        ec = edit_config or self.config.edit
        return (ec, num_inference_steps or ec.num_inference_steps,
                ec.seed if seed is None else seed)

    # ------------------------------------------------------------------
    # The other serving modes
    # ------------------------------------------------------------------

    def edit_multi(self, image: np.ndarray, regions,
                   num_inference_steps: Optional[int] = None,
                   seed: Optional[int] = None,
                   edit_config: Optional[EditConfig] = None,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Edit several (disjoint) text regions of one image, given as
        ``(box, text)`` pairs, in one batched device pass; the crops are
        pasted back in order onto the running result."""
        ec, steps, seed = self._resolve(num_inference_steps, seed, edit_config)
        image = np.asarray(image, dtype=np.uint8)
        prepped = [self._prepare_region(
                       image, _validate_box(box, image.shape[:2]), text,
                       ec.resolution, rng)[0]
                   for box, text in regions]
        edited = self._run_device(prepped, steps, ec, seed)
        result = image
        for r, e in zip(prepped, edited):
            result = paste_back(result, e, r["x_s"], r["y_s"],
                                r["crop_scale"], r["location"])
        return result

    def edit_batch(self, items, num_inference_steps: Optional[int] = None,
                   seed: Optional[int] = None,
                   edit_config: Optional[EditConfig] = None,
                   rng: Optional[np.random.Generator] = None
                   ) -> List[np.ndarray]:
        """Independent edits ``(image, box, text)``, one region each, through
        one device pass.  Returns the edited images in order."""
        ec, steps, seed = self._resolve(num_inference_steps, seed, edit_config)
        images, prepped = [], []
        for image, box, text in items:
            image = np.asarray(image, dtype=np.uint8)
            images.append(image)
            prepped.append(self._prepare_region(
                image, _validate_box(box, image.shape[:2]), text,
                ec.resolution, rng)[0])
        edited = self._run_device(prepped, steps, ec, seed)
        return [paste_back(img, e, r["x_s"], r["y_s"], r["crop_scale"],
                           r["location"])
                for img, e, r in zip(images, edited, prepped)]

    def edit_stream(self, items, num_inference_steps: Optional[int] = None,
                    seed: Optional[int] = None,
                    edit_config: Optional[EditConfig] = None,
                    rng: Optional[np.random.Generator] = None,
                    depth: int = 2) -> Iterator[np.ndarray]:
        """Serve a stream of independent edits ``(image, box, text)`` with at
        most ``depth`` of them in flight; yields the edited images in
        submission order.  Every edit uses the same ``seed``, so each output
        is bit-identical to a sequential :meth:`edit` of the same item, and
        ``depth=1`` is strictly sequential.

        On a card, "in flight" is a pool of ``depth`` CUDA streams: an
        edit's upload, prep, loop, decode and copy to pinned host memory are
        queued on its stream, and finishing it waits on its own event only,
        so the host prep and paste-back of one edit overlap the device work
        of the other.  The host thread still queues every launch itself (no
        threads are added): what ``depth=2`` can hide is the fixed cost
        around the loop, not the loop.  On the CPU the passes run in turn."""
        ec, steps, seed = self._resolve(num_inference_steps, seed, edit_config)
        depth = max(1, depth)
        streams = ([torch.cuda.Stream(self.device) for _ in range(depth)]
                   if self.device.type == "cuda" else [None])

        def submit(i, item):
            image, box, text = item
            image = np.asarray(image, dtype=np.uint8)
            region, _ = self._prepare_region(
                image, _validate_box(box, image.shape[:2]), text,
                ec.resolution, rng)
            # round-robin: the stream's previous edit was fetched already
            return image, region, self._enqueue(
                [region], steps, ec, seed, stream=streams[i % len(streams)])

        def finish(entry):
            image, region, pending = entry
            return paste_back(image, self._fetch(pending)[0], region["x_s"],
                              region["y_s"], region["crop_scale"],
                              region["location"])

        inflight = collections.deque()
        for i, item in enumerate(items):
            inflight.append(submit(i, item))
            if len(inflight) >= depth:  # at most `depth` in flight
                yield finish(inflight.popleft())
        while inflight:
            yield finish(inflight.popleft())

    def edit_profiled(self, image: np.ndarray, box: Tuple[int, int, int, int],
                      text: str, num_inference_steps: Optional[int] = None,
                      seed: Optional[int] = None,
                      edit_config: Optional[EditConfig] = None,
                      rng: Optional[np.random.Generator] = None):
        """:meth:`edit` with a per-stage attribution: returns ``(edited,
        mask*255, stats)``.  ``stats`` has the seconds of ``host_prep_s``
        (region prep, glyph raster, upload, noise), ``prep_s``, ``loop_s``,
        ``decode_s`` (with the copy to the host) and ``paste_s``, each device
        stage closed by a device synchronisation that the chained
        :meth:`edit` does not pay: use them to attribute latency, and
        un-instrumented ``edit()`` timings for throughput.

        ``stats["flops"]`` is ``{"prep", "loop", "decode", "total"}``, counted
        in a second, untimed pass over the same inputs:
        ``torch.utils.flop_counter`` for the library's matrix products and
        convolutions plus the hand-written kernels' own counts from their
        shapes; ``None`` where that cannot be had."""
        ec, steps, seed = self._resolve(num_inference_steps, seed, edit_config)
        dev = self.device
        stats: Dict[str, object] = {}
        last = [time.perf_counter()]

        @contextlib.contextmanager
        def timed(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stats[f"{name}_s"], last[0] = now - last[0], now

        image = np.asarray(image, dtype=np.uint8)
        box = _validate_box(box, image.shape[:2])
        region, mask = self._prepare_region(image, box, text, ec.resolution,
                                            rng)
        edited = self._fetch(self._enqueue([region], steps, ec, seed,
                                           stage=timed))[0]
        last[0] = time.perf_counter()
        result = paste_back(image, edited, region["x_s"], region["y_s"],
                            region["crop_scale"], region["location"])
        stats["paste_s"] = time.perf_counter() - last[0]
        stats["flops"] = self._stage_flops([region], steps, ec, seed)
        return result, mask * 255, stats

    def _stage_flops(self, regions, steps, ec, seed
                     ) -> Optional[Dict[str, float]]:
        """FLOPs per device stage of one pass, counted while it runs once
        more; ``None`` when this torch has no flop counter."""
        try:
            from torch.utils.flop_counter import FlopCounterMode
        except ImportError:
            return None
        flops: Dict[str, float] = {}

        @contextlib.contextmanager
        def counted(name):
            before = _kernel_flops()
            with FlopCounterMode(display=False) as counter:
                yield
            flops[name] = float(counter.get_total_flops()
                                + _kernel_flops() - before)

        self._fetch(self._enqueue(regions, steps, ec, seed, stage=counted))
        flops.pop("host_prep")
        flops["total"] = sum(flops.values())
        return flops


def _kernel_flops() -> int:
    """Matrix-product FLOPs the hand-written kernels have launched so far
    (they are invisible to ``torch.utils.flop_counter``)."""
    return (flash_attention.flops + gn_silu_conv3x3.flops
            + quant_matmul.flops)


def text_editing(pipe: DiffUTEPipeline, text: str, instance_image: np.ndarray,
                 slider_step: int, x0: int, y0: int, x1: int, y1: int):
    """Signature-compatible wrapper of the reference's
    ``text_editing(text, instance_image, slider_step, x0, y0, x1, y1)
    -> (PIL.Image, mask*255)``."""
    from PIL import Image

    out, mask = pipe.edit(instance_image, (x0, y0, x1, y1), text,
                          num_inference_steps=int(slider_step))
    return Image.fromarray(out).convert("RGB"), mask
