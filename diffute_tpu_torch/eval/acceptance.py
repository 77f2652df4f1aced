"""Weight-day acceptance: one command that certifies imported weights.

Counterpart of ``diffute_tpu/eval/acceptance.py``, with its stages, pins,
bundle files and exit code:

  1. layout      the diffusers-layout directory resolves real weight files
                 for all three models (a bare subdirectory, which the
                 loader would random-initialize, fails here);
  2. param_pins  the loaded state_dicts hold the pinned SD2-inpainting
                 counts (UNet 865,925,124 / VAE 83,653,863 at
                 --model_scale full);
  3. goldens     per-module forwards (TrOCR context, VAE encode / decode,
                 UNet eps) against saved arrays;
  4. latents     the composed edit's latents after every step against a
                 saved trajectory;
  5. image       the final uint8 edit: SSIM >= --ssim_threshold (0.99) and
                 its largest LSB difference.

Stages 3-5 compare with a reference bundle (``.npy`` arrays and a
``manifest.json``); ``--make_reference`` writes one from this stack.  The
arrays keep the JAX package's NHWC layouts, so a bundle written by either
stack loads in the other.  The models run in the config's own dtype (fp32)
with dense attention: the purpose is fp32 parity with a reference stack.
Noise comes from the pipeline's ``_draw_noise`` (a ``torch.Generator``), so
stage 4 against another stack's bundle needs that stack's draws.

  python -m diffute_tpu_torch.eval.acceptance --pretrained <dir> \\
      [--reference_outputs <bundle>] [--out report.json]
  python -m diffute_tpu_torch.eval.acceptance --pretrained <dir> \\
      --make_reference <bundle>

Exit code 0 if and only if every stage that was not skipped passes.  Runs
on the card unless ``--device cpu`` is given; without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

# pins for --model_scale full (SD2-inpainting + SD2 VAE)
PARAM_PINS = {"full": {"unet": 865_925_124, "vae": 83_653_863}}

GOLDEN_FILES = {
    "trocr_ctx": "golden_trocr_ctx.npy",
    "vae_mean": "golden_vae_mean.npy",
    "vae_logvar": "golden_vae_logvar.npy",
    "vae_dec": "golden_vae_dec.npy",
    "unet_eps": "golden_unet_eps.npy",
}
LATENTS_FILE = "latents_steps.npy"
IMAGE_FILE = "edited_uint8.npy"
MANIFEST_FILE = "manifest.json"
_ARG_KEYS = ("steps", "sampler", "seed", "scene_seed", "text")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pretrained", required=True,
                   help="diffusers-layout dir (vae/ unet/ [trocr/])")
    p.add_argument("--reference_outputs", default=None,
                   help="bundle dir with golden arrays (see module doc)")
    p.add_argument("--make_reference", default=None,
                   help="write a bundle from this stack")
    p.add_argument("--model_scale", default="full",
                   choices=["full", "small", "tiny"])
    p.add_argument("--steps", type=int, default=10,
                   help="denoise steps for the latent-parity stage")
    p.add_argument("--sampler", default="ddim", choices=["ddim", "ddpm"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene_seed", type=int, default=11)
    p.add_argument("--text", default="Hi")
    p.add_argument("--ssim_threshold", type=float, default=0.99)
    p.add_argument("--out", default=None, help="report JSON path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def _config(scale):
    from diffute_tpu_torch.serve.loading import SCALES

    return SCALES[scale]()


def _scene(cfg, scene_seed, text):
    """Deterministic inputs (the res^2 crop triple and the glyph),
    reproducible from the manifest on either stack."""
    from diffute_tpu_torch.pipeline.regions import (generate_mask,
                                                    make_masked_image)
    from diffute_tpu_torch.text import render_glyph, trocr_preprocess_host

    res = cfg.edit.resolution
    rng = np.random.RandomState(scene_seed)
    image = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    q = max(1, res // 4)
    box = np.int32([q, q, 3 * q, 2 * q])
    mask = generate_mask((res, res), box)
    masked = make_masked_image(image, mask)
    glyph = trocr_preprocess_host([render_glyph(text, cfg.glyph)], cfg.trocr)
    return image, mask, masked, glyph


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().movedim(-3, -1).cpu().numpy()


def _compute_outputs(cfg, params, args, device) -> Dict[str, np.ndarray]:
    """Module goldens, the composed edit's trajectory and its final image
    from this stack, in the bundle's (NHWC) layouts."""
    from diffute_tpu_torch.config import EditConfig
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.pipeline.edit import normalize_image
    from diffute_tpu_torch.text import trocr_normalize

    pipe = DiffUTEPipeline(cfg, params, device)
    _, mask, masked, glyph = _scene(cfg, args.scene_seed, args.text)
    out: Dict[str, np.ndarray] = {}

    def on_device(a):
        return torch.from_numpy(a).to(device)

    with torch.inference_mode():
        # per-module goldens on deterministic inputs
        g = trocr_normalize(on_device(glyph)).permute(0, 3, 1, 2)
        ctx = pipe.trocr(g.to(cfg.trocr.dtype))
        out["trocr_ctx"] = ctx.float().cpu().numpy()
        x = normalize_image(on_device(masked[None])).permute(0, 3, 1, 2)
        mean, logvar = pipe.vae.encode(x.to(cfg.vae.dtype))
        out["vae_mean"], out["vae_logvar"] = _nhwc(mean), _nhwc(logvar)
        out["vae_dec"] = _nhwc(pipe.vae.decode(mean))
        h, w = mean.shape[2:]
        x9 = np.random.RandomState(args.scene_seed + 1).randn(
            1, h, w, cfg.unet.in_channels).astype(np.float32)
        t = torch.tensor([517 % cfg.scheduler.num_train_timesteps],
                         device=device)
        eps = pipe.unet(on_device(x9).permute(0, 3, 1, 2).to(cfg.unet.dtype),
                        t, ctx.to(cfg.unet.dtype))
        out["unet_eps"] = _nhwc(eps)

        # the composed edit: the staged programs edit() chains, the loop
        # keeping every step's latents
        r = cfg.edit.resolution // cfg.vae.scale_factor
        ec = EditConfig(sampler=args.sampler)
        init, latent, _, _, step_noise = pipe._draw_noise(
            (1, cfg.vae.latent_channels, r, r), args.steps, ec, args.seed)
        prepped = pipe._device_prep(on_device(mask[None]),
                                    on_device(masked[None]),
                                    on_device(glyph), init, latent)
        latents, traj = pipe._device_loop(args.steps, *prepped,
                                          sampler=args.sampler,
                                          step_noise=step_noise,
                                          return_trajectory=True)
        out["latents_steps"] = _nhwc(traj)
        out["edited_uint8"] = pipe._device_decode(latents).cpu().numpy()
    return out


def _count(state_dict) -> int:
    return sum(int(v.numel()) for v in state_dict.values())


def run_acceptance(args) -> dict:
    from diffute_tpu_torch.eval import ssim
    from diffute_tpu_torch.serve.loading import (load_diffusers_layout,
                                                 resolve_diffusers_layout)
    from diffute_tpu_torch.utils import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"acceptance: {e}")
    report = {"pretrained": args.pretrained, "model_scale": args.model_scale,
              "stages": {}}
    stages = report["stages"]

    def stage(name, status, **details):
        stages[name] = {"status": status, **details}
        print(f"[{status:>7}] {name}"
              + (f" — {details}" if details else ""), flush=True)

    # 1. the weight files the loader will read, not just subdirectories:
    # the loader random-initializes a component whose file is absent, and
    # the pins count topology, so a bare export must fail here
    cfg = _config(args.model_scale)
    sources = resolve_diffusers_layout(args.pretrained)
    missing = [k for k, v in sources.items() if not v]
    if missing:
        stage("layout", "fail", missing_weight_files=missing,
              resolved=sources)
        return report
    params = load_diffusers_layout(args.pretrained, cfg, device,
                                   components=("vae", "unet", "trocr"))
    stage("layout", "pass", resolved=sources)

    # 2. param pins
    counts = {k: _count(params[k]) for k in ("unet", "vae", "trocr")}
    pins = PARAM_PINS.get(args.model_scale)
    if pins:
        ok = all(counts[k] == v for k, v in pins.items())
        stage("param_pins", "pass" if ok else "fail",
              counts=counts, expected=pins)
        if not ok:
            return report
    else:
        stage("param_pins", "skipped", counts=counts,
              note="pins exist only for --model_scale full")

    def arg_key(a):
        return tuple(getattr(a, k) for k in _ARG_KEYS)

    computed = None  # (arg key, outputs), reused when the manifest matches
    if args.make_reference:
        out = _compute_outputs(cfg, params, args, device)
        computed = (arg_key(args), out)
        os.makedirs(args.make_reference, exist_ok=True)
        for key, fname in {**GOLDEN_FILES, "latents_steps": LATENTS_FILE,
                           "edited_uint8": IMAGE_FILE}.items():
            np.save(os.path.join(args.make_reference, fname), out[key])
        with open(os.path.join(args.make_reference, MANIFEST_FILE), "w") as f:
            json.dump({"model_scale": args.model_scale,
                       **{k: getattr(args, k) for k in _ARG_KEYS}},
                      f, indent=2)
        stage("make_reference", "pass", path=args.make_reference)
        if not args.reference_outputs:
            return report
        # both flags: write ours, then compare with the one given

    if not args.reference_outputs:
        for name in ("goldens", "latents", "image"):
            stage(name, "skipped", note="no --reference_outputs bundle")
        return report

    bundle = args.reference_outputs
    man_path = os.path.join(bundle, MANIFEST_FILE)
    if os.path.exists(man_path):
        with open(man_path) as f:
            man = json.load(f)
        if man.get("model_scale", args.model_scale) != args.model_scale:
            stage("manifest", "fail", bundle_scale=man["model_scale"],
                  run_scale=args.model_scale,
                  note="re-run with --model_scale matching the bundle")
            return report
        for k in _ARG_KEYS:
            if k in man:
                setattr(args, k, man[k])
    # a bundle with no comparable arrays fails before the models run
    if not any(os.path.exists(os.path.join(bundle, f))
               for f in (*GOLDEN_FILES.values(), LATENTS_FILE, IMAGE_FILE)):
        stage("bundle", "fail",
              note="--reference_outputs contains no comparable arrays "
                   "(expected the make_reference file set)")
        return report
    if computed is not None and computed[0] == arg_key(args):
        out = computed[1]
    else:
        out = _compute_outputs(cfg, params, args, device)

    # 3. per-module goldens (fp32 cross-stack tolerance).  A bundle with
    # some of the five files fails; with none, the stage is skipped and
    # the vacuity guard below refuses to accept.
    ok, details, compared = True, {}, 0
    for key, fname in GOLDEN_FILES.items():
        path = os.path.join(bundle, fname)
        if not os.path.exists(path):
            details[key] = "absent"
            continue
        compared += 1
        ref = np.load(path)
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(out[key] - ref).max())
        details[key] = {"max_err": err, "scale": scale}
        ok &= err <= 2e-3 * scale
    if compared == 0:
        stage("goldens", "skipped", note="no golden arrays in bundle")
    elif compared < len(GOLDEN_FILES):
        stage("goldens", "fail", **details)
    else:
        stage("goldens", "pass" if ok else "fail", **details)

    # 4. per-step latent parity
    lat_path = os.path.join(bundle, LATENTS_FILE)
    if os.path.exists(lat_path):
        ref = np.load(lat_path)
        per_step, ok = [], True
        for i in range(min(len(ref), len(out["latents_steps"]))):
            scale = max(1.0, float(np.abs(ref[i]).max()))
            err = float(np.abs(out["latents_steps"][i] - ref[i]).max())
            per_step.append(err)
            ok &= err <= 5e-3 * scale
        ok &= len(ref) == len(out["latents_steps"])
        stage("latents", "pass" if ok else "fail",
              steps=len(per_step), max_err_per_step=per_step)
    else:
        stage("latents", "skipped", note=f"{LATENTS_FILE} absent")

    # 5. final image SSIM + LSB
    img_path = os.path.join(bundle, IMAGE_FILE)
    if os.path.exists(img_path):
        ref = np.load(img_path)
        got = out["edited_uint8"]
        s = float(ssim(ref[0], got[0]))
        lsb = int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())
        stage("image", "pass" if s >= args.ssim_threshold else "fail",
              ssim=s, threshold=args.ssim_threshold, max_lsb=lsb)
    else:
        stage("image", "skipped", note=f"{IMAGE_FILE} absent")

    # vacuity guard: with a bundle given, at least one comparison must
    # have run for "accepted" to mean anything
    if all(stages[s]["status"] == "skipped"
           for s in ("goldens", "latents", "image")):
        stage("bundle", "fail",
              note="--reference_outputs contains no comparable arrays "
                   "(expected the make_reference file set)")
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    report = run_acceptance(args)
    failed = [k for k, v in report["stages"].items()
              if v["status"] == "fail"]
    report["accepted"] = not failed
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
