"""Evaluation CLI: edit fidelity and OCR round trip over a set of scenes.

Counterpart of ``diffute_tpu/eval/run.py``, with its flags, report fields
and names.  Every example is edited through ``DiffUTEPipeline.edit``, then

  - background fidelity: SSIM / PSNR between the edited and the source
    image with the box neutralised, the mean |delta| inside the box, and
    the same SSIM / PSNR on the pre-paste crop (``return_crop=True``), where
    the model's reconstruction of the window shows;
  - OCR round trip: the verifier (TrOCR encoder + causal decoder) reads the
    edited region.  With a tokenizer (``--tokenizer char`` or a transformers
    tokenizer directory) the decoded string is compared with the requested
    text; always, the read ids are compared with the verifier's reading of
    the target text's glyph render (``ocr_id_match``).

  python -m diffute_tpu_torch.eval.run --synthetic 8 --steps 20 --out report.json
  python -m diffute_tpu_torch.eval.run --manifest docs.csv \\
      --pretrained <diffusers-layout dir> --tokenizer char --out report.json
  python -m diffute_tpu_torch.eval.run --tiny --synthetic 2 --steps 2 --device cpu

On the card the pipeline runs as the serving entry points run it
(``card_serving_config``: bf16, the UNet's self-attention through the flash
kernel); the verifier stays in fp32.  Without a card it exits non-zero
unless ``--device cpu`` is given.  Writes one JSON report and prints it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Iterator, Tuple

import numpy as np

# the salt of --randomize's generator (the JAX package folds the same
# constant into its key)
RANDOMIZE_SALT = 0xAB1A7E


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--manifest", default=None,
                   help="CSV with image_path/ocr_path columns")
    p.add_argument("--synthetic", type=int, default=0,
                   help="evaluate on N procedural synthetic scenes instead")
    p.add_argument("--pretrained", default=None,
                   help="diffusers-layout dir (vae/ unet/ trocr/ "
                        "[trocr_decoder/])")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer dir for string-level OCR comparison "
                        "(needs transformers), or 'char' for the built-in "
                        "printable-ASCII vocabulary of train/run_ocr.py")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_examples", type=int, default=16)
    p.add_argument("--out", default=None, help="report JSON path")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-init models (machinery smoke)")
    p.add_argument("--model_scale", default="full", choices=["full", "small"],
                   help="small = config.small_config scale (matches "
                        "trainer --model_scale small)")
    p.add_argument("--randomize", default=None,
                   help="comma list of components (unet,vae) to re-init "
                        "randomly after --pretrained loading: the ablation "
                        "baseline that keeps the verifier and the other "
                        "components")
    p.add_argument("--ocr_max_len", type=int, default=16)
    p.add_argument("--reuse", type=int, default=1,
                   help="encoder reuse interval; 1 = exact sampling")
    p.add_argument("--sampler", default=None,
                   choices=["ddim", "ddpm", "dpmpp"],
                   help="override the config's sampler")
    p.add_argument("--cross_text", action="store_true",
                   help="edit each region to a different word of the "
                        "synthetic vocabulary instead of regenerating the "
                        "one in the scene")
    p.add_argument("--cross_text_novel", action="store_true",
                   help="like --cross_text, the target a novel random 3-10 "
                        "character string, deterministic per example")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def _iter_synthetic(n: int, seed: int, image_hw=(384, 512)
                    ) -> Iterator[Tuple[np.ndarray, tuple, str]]:
    """Raw (image, box, text) scenes: SyntheticSceneDataset's recipe before
    the crop, the text at full size, width-capped so the box fits one
    inference crop window."""
    from diffute_tpu_torch.config import GlyphConfig
    from diffute_tpu_torch.io import hostops
    from diffute_tpu_torch.io.dataset import SyntheticSceneDataset
    from diffute_tpu_torch.text import render_glyph

    words = SyntheticSceneDataset._WORDS
    h, w = image_hw
    gcfg = GlyphConfig()
    for k in range(n):
        rng = np.random.default_rng((seed, k))
        image = np.full((h, w, 3), int(rng.integers(180, 255)), np.uint8)
        text = words[int(rng.integers(len(words)))]
        glyph = render_glyph(text, gcfg)
        gh, gw = glyph.shape[:2]
        scale = min(1.0, (min(h, w) - 24) / gw)
        gw2, gh2 = max(16, int(gw * scale)), max(16, int(gh * scale))
        glyph_s = hostops.resize_bilinear_u8(glyph, gh2, gw2)
        y = int(rng.integers(0, h - gh2))
        x = int(rng.integers(0, w - gw2))
        image[y : y + gh2, x : x + gw2] = np.minimum(
            image[y : y + gh2, x : x + gw2], glyph_s)
        yield image, (x, y, x + gw2, y + gh2), text


def _iter_manifest(manifest: str, seed: int, score_threshold: float
                   ) -> Iterator[Tuple[np.ndarray, tuple, str]]:
    from diffute_tpu_torch.io.dataset import read_manifest
    from diffute_tpu_torch.io.storage import open_blob, read_image

    cols = read_manifest(manifest)
    for k, (image_path, ocr_path) in enumerate(zip(cols["image_path"],
                                                   cols["ocr_path"])):
        rng = np.random.default_rng((seed, k))
        image = read_image(image_path)
        with open_blob(ocr_path) as f:
            ocr = json.loads(f.read())
        regions = [r for r in ocr["document"]
                   if r.get("score", 1.0) > score_threshold]
        if not regions:
            continue
        region = regions[int(rng.integers(len(regions)))]
        quad = np.asarray(region["box"], dtype=np.float32)
        box = (int(quad[:, 0].min()), int(quad[:, 1].min()),
               int(quad[:, 0].max()), int(quad[:, 1].max()))
        yield image, box, region["text"]


def _background_metrics(original: np.ndarray, edited: np.ndarray,
                        mask_full: np.ndarray) -> dict:
    """SSIM / PSNR with the box neutralised (both images keep the
    original's pixels there), plus the in-box mean |delta|.  Paste-back
    writes only the box, so the first two are 1.0 / inf unless it breaks:
    a regression guard; :func:`_window_metrics` is the discriminative one."""
    from diffute_tpu_torch.eval import psnr, ssim

    keep = mask_full == 0
    edited_bg = np.where(keep[..., None], edited, original)
    inside = np.abs(edited.astype(np.int32)
                    - original.astype(np.int32))[mask_full > 0]
    return {
        "ssim_background": float(ssim(original, edited_bg)),
        "psnr_background": float(psnr(original, edited_bg)),
        "region_mean_abs_delta": float(inside.mean()) if inside.size else 0.0,
    }


def _window_metrics(crop_info: dict) -> dict:
    """The crop window outside the box on the pre-paste output: how
    faithfully the model reconstructs the background it regenerates
    (seams, colour shifts, the VAE round trip)."""
    from diffute_tpu_torch.eval import psnr, ssim

    edited = np.asarray(crop_info["edited_crop"])
    source = np.asarray(crop_info["source_crop"])
    keep = np.asarray(crop_info["crop_mask"]) == 0
    edited_bg = np.where(keep[..., None], edited, source)
    return {
        "ssim_window_background": float(ssim(source, edited_bg)),
        "psnr_window_background": float(psnr(source, edited_bg)),
    }


def _id_match(a: np.ndarray, b: np.ndarray, eos_id: int) -> float:
    """Fraction of positions, up to the first EOS in either, that agree.
    Two reads that are both EOS at position 0 score 0: the verifier read
    nothing from either image, which is no evidence of agreement."""
    a, b = np.asarray(a), np.asarray(b)
    if len(a) and len(b) and a[0] == eos_id and b[0] == eos_id:
        return 0.0
    stop = len(a)
    for i, (x, y) in enumerate(zip(a, b)):
        if x == eos_id or y == eos_id:
            stop = i + 1
            break
    if stop == 0:
        return 1.0
    return float((a[:stop] == b[:stop]).mean())


def _load_tokenizer(name):
    if name is None:
        return None
    if name == "char":
        from diffute_tpu_torch.text import CharTokenizer

        return CharTokenizer()
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise SystemExit(f"eval: --tokenizer {name!r} needs the transformers "
                         f"package, which is not installed ({e}); use "
                         f"--tokenizer char or no tokenizer") from None
    return AutoTokenizer.from_pretrained(name)


def build_models(args):
    """(pipeline, verifier, config) for the requested scale and weights."""
    from diffute_tpu_torch.config import (DiffUTEConfig, card_serving_config,
                                          small_config, tiny_test_config)
    from diffute_tpu_torch.eval import OCRVerifier
    from diffute_tpu_torch.models.trocr_decoder import (TrOCRDecoderConfig,
                                                        small_decoder_config)
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device
    from diffute_tpu_torch.utils.params import init_trocr_decoder_params

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"eval: {e}")
    if args.tiny:
        config = tiny_test_config()
        dcfg = TrOCRDecoderConfig(
            vocab_size=64, hidden_size=config.trocr.hidden_size,
            decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=32,
            max_position_embeddings=64)
    elif args.model_scale == "small":
        config, dcfg = small_config(), small_decoder_config()
    else:
        config, dcfg = DiffUTEConfig(), TrOCRDecoderConfig()  # trocr-large

    if args.pretrained:
        from diffute_tpu_torch.serve.loading import load_diffusers_layout

        params = load_diffusers_layout(args.pretrained, config, device)
    else:
        params = init_pipeline_params(config, seed=args.seed, device=device)

    if args.randomize:
        # the ablation baseline: the named components re-initialized from
        # generators disjoint from any training init, the rest kept
        salts = {"unet": 0, "vae": 1}
        for name in args.randomize.split(","):
            name = name.strip()
            if name not in salts:
                raise ValueError(f"--randomize supports unet,vae; got {name!r}")
            seed = int(np.random.SeedSequence(
                [args.seed, RANDOMIZE_SALT, salts[name]]).generate_state(1)[0])
            params.update(init_pipeline_params(config, seed, device, (name,)))

    dec_params = params.get("trocr_decoder")
    if dec_params is None:
        dec_params = init_trocr_decoder_params(dcfg, seed=args.seed + 1,
                                               device=device)
    # the card's serving path for the edits; the verifier in the configs'
    # own dtype (fp32)
    pipe_config = card_serving_config(config) if device.type == "cuda" else config
    pipe = DiffUTEPipeline(pipe_config, {k: params[k]
                                         for k in ("vae", "unet", "trocr")},
                           device)
    verifier = OCRVerifier(config.trocr, dcfg, params["trocr"], dec_params,
                           tokenizer=_load_tokenizer(args.tokenizer),
                           max_len=args.ocr_max_len, device=device)
    return pipe, verifier, config


def _target_text(args, i: int, text: str) -> str:
    from diffute_tpu_torch.io.dataset import SyntheticSceneDataset

    if args.cross_text_novel:
        # a novel string: the diverse training stream's charset and lengths
        # on a disjoint generator, so no checkpoint has seen it
        rng = np.random.default_rng((args.seed, 7777, i))
        charset = SyntheticSceneDataset._CHARSET
        while True:
            n = int(rng.integers(3, 11))
            idx = rng.integers(len(charset), size=n)
            target = "".join(charset[int(c)] for c in idx)
            if target != text:
                return target
    if args.cross_text:
        # another word of the synthetic vocabulary
        words = SyntheticSceneDataset._WORDS
        base = words.index(text) if text in words else i
        target = words[(base + 1 + i) % len(words)]
        if target == text:
            target = words[(base + 2 + i) % len(words)]
        return target
    return text


def run_eval(args) -> dict:
    from diffute_tpu_torch.config import TrainConfig
    from diffute_tpu_torch.text import render_glyph

    pipe, verifier, config = build_models(args)
    eos_id = verifier.decoder.config.eos_token_id

    if args.manifest:
        examples = _iter_manifest(args.manifest, args.seed,
                                  TrainConfig().ocr_score_threshold)
    else:
        examples = _iter_synthetic(max(1, args.synthetic or 4), args.seed)

    edit_cfg = pipe.config.edit
    if args.reuse > 1 or args.sampler:
        edit_cfg = dataclasses.replace(
            edit_cfg, encoder_reuse_interval=args.reuse,
            sampler=args.sampler or edit_cfg.sampler)

    def norm(s):
        return "".join(s.split()).lower()

    rows = []
    for i, (image, box, text) in enumerate(examples):
        if i >= args.max_examples:
            break
        target = _target_text(args, i, text)
        edited, mask255, crop_info = pipe.edit(
            image, box, target, num_inference_steps=args.steps,
            seed=args.seed, edit_config=edit_cfg, return_crop=True)
        row = _background_metrics(image, edited, mask255)
        row.update(_window_metrics(crop_info))
        x1, y1, x2, y2 = box
        region = edited[y1:y2, x1:x2]
        ids_region = verifier.read([region])[0]
        if verifier.tokenizer is not None:
            decoded = verifier.read_text([region])[0]
            row["ocr_text"] = decoded
            row["ocr_text_match"] = bool(norm(decoded) == norm(target))
        # the target text's glyph render as the verifier reads it
        ids_glyph = verifier.read([render_glyph(target, config.glyph)])[0]
        row["ocr_id_match"] = _id_match(ids_region, ids_glyph, eos_id)
        row["text"] = text
        if args.cross_text or args.cross_text_novel:
            row["target_text"] = target
        row["box"] = list(map(int, box))
        rows.append(row)

    if not rows:
        raise ValueError("no evaluable examples (empty manifest or all "
                         "regions below the OCR score threshold)")

    def mean(key):
        return float(np.mean([r[key] for r in rows]))

    report = {
        "num_examples": len(rows),
        "steps": args.steps,
        "encoder_reuse_interval": args.reuse,
        "sampler": edit_cfg.sampler,
        "cross_text": bool(args.cross_text or args.cross_text_novel),
        "cross_text_mode": ("novel" if args.cross_text_novel
                            else "vocab" if args.cross_text else None),
        "ssim_background_mean": mean("ssim_background"),
        "psnr_background_mean": mean("psnr_background"),
        "ssim_window_background_mean": mean("ssim_window_background"),
        "psnr_window_background_mean": mean("psnr_window_background"),
        "region_mean_abs_delta_mean": mean("region_mean_abs_delta"),
        "ocr_id_match_mean": mean("ocr_id_match"),
        "ocr_mode": ("tokenizer" if verifier.tokenizer is not None
                     else "glyph_id_fallback"),
        "examples": rows,
    }
    if verifier.tokenizer is not None:
        report["ocr_text_match_rate"] = mean("ocr_text_match")
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    report = run_eval(args)
    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    return report


if __name__ == "__main__":
    main()
