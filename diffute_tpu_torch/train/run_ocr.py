"""OCR verifier training entry point: the char-level TrOCR on glyph renders.

  python -m diffute_tpu_torch.train.run_ocr --model_scale small \\
      --max_train_steps 3000 --output_dir diffute-ocr
  python -m diffute_tpu_torch.train.run_ocr --smoke --device cpu

Flag names, defaults and semantics are ``diffute_tpu.train.run_ocr``'s
(batch 64, lr 3e-4 with 100 warmup steps, targets of 16 ids); only the
small scale trains (``config.small_config()``'s encoder and
``small_decoder_config()``), the full scale being the pretrained TrOCR.
``--smoke`` runs the tiny config at batch 2 for 2 steps (or
``--max_train_steps``).  The data is ``SyntheticGlyphOCRDataset``; the
encoder and decoder are random-init from ``--seed`` and ``--seed + 1``.
Every checkpoint holds the trainer's whole state and exports ``trocr/``
(ViT layout) and ``trocr_decoder/`` (HF ``TrOCRForCausalLM`` layout,
``"tokenizer": "char"`` in its ``config.json``): point stage-2 training
and eval (``--pretrained <checkpoint> --tokenizer char``) at it.  Runs on
the card unless ``--device cpu`` is given; without a card it exits
non-zero.  ``--steps_per_call`` above 1 is not ported and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

from diffute_tpu_torch.train import loop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--output_dir", "--output-dir", default="diffute-ocr")
    p.add_argument("--train_batch_size", type=int, default=64)
    p.add_argument("--max_train_steps", "--max-train-steps", type=int,
                   default=None, help="default 3000 (--smoke: 2)")
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--lr_scheduler", default="constant_with_warmup")
    p.add_argument("--lr_warmup_steps", type=int, default=100)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--max_len", type=int, default=16,
                   help="target sequence length (chars + EOS)")
    p.add_argument("--checkpointing_steps", type=int, default=1000)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report_to", default="tensorboard",
                   choices=["none", "tensorboard", "wandb", "comet_ml", "all"])
    p.add_argument("--logging_dir", default="logs")
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="only 1: several steps per call are not ported")
    p.add_argument("--model_scale", default="small", choices=["small"],
                   help="only the small (char-level) scale trains from "
                        "scratch; the full scale is the pretrained TrOCR")
    p.add_argument("--smoke", action="store_true",
                   help="tiny config, batch 2, 2 steps (or --max_train_steps)")
    return p.parse_args(argv)


def export_ocr_layout(path: str, config, dcfg, params) -> None:
    """``trocr/`` (ViT layout, ``vit_config_json``) and ``trocr_decoder/``
    (``model.safetensors`` in HF layout and the JAX package's
    ``config.json`` fields) under ``path``; ``params`` is ``{"encoder":
    sd, "decoder": sd}``."""
    from diffute_tpu_torch.compat.diffusers import (
        TROCR_FILE, export_trocr_decoder_state_dict, save_component,
        vit_config_json)
    from diffute_tpu_torch.models.trocr_decoder import decoder_config_json
    from diffute_tpu_torch.train.checkpoint import export_diffusers_layout

    export_diffusers_layout(path, trocr_params=params["encoder"],
                            trocr_config=vit_config_json(config.trocr))
    save_component(os.path.join(path, "trocr_decoder"), TROCR_FILE,
                   export_trocr_decoder_state_dict(params["decoder"]),
                   decoder_config_json(dcfg, tokenizer="char"))


def prepare(argv: Optional[Sequence[str]] = None
            ) -> Optional[loop.TrainingRun]:
    """Parse, build (or restore) the trainer and its loader; None when the
    checkpoint to resume from already satisfies the step budget."""
    args = parse_args(argv)
    loop.check_ported(args)

    from diffute_tpu_torch.config import (OptimizerConfig, TrainConfig,
                                          small_config, tiny_test_config)
    from diffute_tpu_torch.io.dataset import (SyntheticGlyphOCRDataset,
                                              make_ocr_batch)
    from diffute_tpu_torch.models.trocr_decoder import (TrOCRDecoderConfig,
                                                        small_decoder_config)
    from diffute_tpu_torch.text.char_tokenizer import VOCAB_SIZE
    from diffute_tpu_torch.train.ocr_train import OCRTrainer, split_params
    from diffute_tpu_torch.utils import resolve_device
    from diffute_tpu_torch.utils.params import (init_pipeline_params,
                                                init_trocr_decoder_params)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"run_ocr: {e}")

    max_steps = args.max_train_steps or (2 if args.smoke else 3000)
    train_cfg = TrainConfig(
        train_batch_size=args.train_batch_size,
        max_train_steps=max_steps,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint,
        seed=args.seed,
        output_dir=args.output_dir,
        logging_dir=args.logging_dir,
        dataloader_num_workers=args.dataloader_num_workers,
        report_to=args.report_to,
        optimizer=OptimizerConfig(
            name="adamw",
            learning_rate=args.learning_rate,
            lr_scheduler=args.lr_scheduler,
            lr_warmup_steps=args.lr_warmup_steps,
            max_grad_norm=args.max_grad_norm,
        ),
    )
    if args.smoke:
        config = dataclasses.replace(tiny_test_config(), train=train_cfg)
        dcfg = TrOCRDecoderConfig(
            vocab_size=VOCAB_SIZE, hidden_size=config.trocr.hidden_size,
            decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=32,
            max_position_embeddings=64)
        batch_size = 2
    else:
        config = dataclasses.replace(small_config(), train=train_cfg)
        dcfg = small_decoder_config()
        batch_size = args.train_batch_size
    if loop.satisfied(args, max_steps):
        return None

    dataset = SyntheticGlyphOCRDataset(config, seed=args.seed,
                                       max_len=args.max_len)
    params = {
        "encoder": init_pipeline_params(config, seed=args.seed, device=device,
                                        components=("trocr",))["trocr"],
        "decoder": init_trocr_decoder_params(dcfg, seed=args.seed + 1,
                                             device=device)}
    trainer = OCRTrainer(config, dcfg, params, device=device,
                         total_steps=max_steps)
    del params  # the trainer holds its own copy

    def export(path, host):
        export_ocr_layout(path, config, dcfg, split_params(host["params"]))

    # the synthetic stream is sampled with replacement: the loader's seed
    # takes the resume step
    return loop.start(args, trainer, dataset, batch_size,
                      lambda ex: make_ocr_batch(ex, config), max_steps,
                      False, 1, export)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train; returns one ``{"step", "loss", "grad_norm", "token_accuracy",
    "seconds", "max_memory_allocated"}`` per optimizer step (none when the
    checkpoint to resume from already satisfies the budget)."""
    run = prepare(argv)
    return run.train() if run is not None else []


if __name__ == "__main__":
    main()
