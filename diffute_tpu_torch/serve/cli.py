"""Command-line edit: one image in, one edited image out (PyTorch port).

Example:
  python -m diffute_tpu_torch.serve.cli --image in.png --box 40,50,200,90 \\
      --text "NEW TEXT" --steps 50 --out edited.png

The flags are ``diffute_tpu.serve.cli``'s, plus ``--device`` (default
``cuda``: without a card the command exits non-zero unless ``--device cpu``
is given) and the UNet's opt-in kernels: ``--fused-gn``, ``--fused-conv``,
``--int8``, ``--reuse K`` and ``--res {512,768,1024}`` (``bench.py``'s
serving flags) and ``--pipeline-fwd`` (its A/B switch).  On the card the
models run in bf16 with the flash kernel, on the CPU in fp32.  The weights
come from ``--checkpoint`` (a diffusers-layout directory: a trainer's
checkpoint, ``unet_ema/`` preferred; components it lacks are random-init
from seed 0), else they are random-init from ``--seed``.  The model scale
is ``--scale`` (``--tiny``), else the one the checkpoint's ``config.json``
files match, else full.

  python -m diffute_tpu_torch.serve.cli --checkpoint out/checkpoint-1000 \\
      --image in.png --box 40,50,200,90 --text "NEW TEXT"

  python -m diffute_tpu_torch.serve.cli --image in.png --box 40,50,200,90 \\
      --text "NEW TEXT" --sampler dpmpp --steps 20 --guidance_scale 3 \\
      --blend --reuse 2 --fused-conv --fused-gn --int8
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--box", required=True, help="x1,y1,x2,y2")
    p.add_argument("--text", required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", default="ddim", choices=["ddim", "ddpm", "dpmpp"])
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--blend", action="store_true")
    p.add_argument("--reuse", type=int, default=1, metavar="K",
                   help="run the UNet's encoder every K-th step")
    p.add_argument("--fused-gn", action="store_true",
                   help="GroupNorm+SiLU as one kernel")
    p.add_argument("--fused-conv", action="store_true",
                   help="GroupNorm+SiLU+conv3x3 as one kernel")
    p.add_argument("--int8", action="store_true",
                   help="serve the UNet's transformer weights int8")
    p.add_argument("--res", type=int, default=None, choices=[512, 768, 1024],
                   help="edit resolution (default: the scale's own)")
    p.add_argument("--pipeline-fwd", action="store_true",
                   help="route the flash forward through the deferred-"
                   "softmax kernel (an A/B switch; off by default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="edited.png")
    p.add_argument("--mask-out", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="diffusers-layout directory (random init without)")
    p.add_argument("--scale", default=None, choices=["full", "small", "tiny"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    from PIL import Image

    from diffute_tpu_torch.config import (DiffUTEConfig, card_serving_config,
                                          small_config, tiny_test_config)
    from diffute_tpu_torch.ops.flash_attention import set_pipeline_fwd
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.serve.loading import (layout_scale,
                                                 load_diffusers_layout)
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"cli: {e}")
    scale = (args.scale or ("tiny" if args.tiny else None)
             or (args.checkpoint and layout_scale(args.checkpoint)) or "full")
    config = {"full": DiffUTEConfig, "small": small_config,
              "tiny": tiny_test_config}[scale]()
    config = dataclasses.replace(
        config,
        unet=dataclasses.replace(config.unet,
                                 use_fused_groupnorm=args.fused_gn,
                                 use_fused_conv=args.fused_conv,
                                 use_int8_weights=args.int8),
        edit=dataclasses.replace(config.edit, sampler=args.sampler,
                                 guidance_scale=args.guidance_scale,
                                 masked_latent_blend=args.blend,
                                 encoder_reuse_interval=args.reuse,
                                 **({"resolution": args.res} if args.res
                                    else {})))
    if device.type == "cuda":
        # the card's main path: bf16 with the flash kernel
        config = card_serving_config(config)
    set_pipeline_fwd(args.pipeline_fwd)
    params = (load_diffusers_layout(args.checkpoint, config, device)
              if args.checkpoint else
              init_pipeline_params(config, args.seed, device))
    pipe = DiffUTEPipeline(config, params, device)
    del params

    img = np.asarray(Image.open(args.image).convert("RGB"))
    box = tuple(int(v) for v in args.box.split(","))
    out, mask = pipe.edit(img, box, args.text, num_inference_steps=args.steps,
                          seed=args.seed)
    Image.fromarray(out).save(args.out)
    if args.mask_out:
        Image.fromarray(mask.astype(np.uint8)).save(args.mask_out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
