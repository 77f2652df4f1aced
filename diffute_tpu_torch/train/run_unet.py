"""Stage-2 training entry point (the reference's ``train_diffute_v1.py``).

  python -m diffute_tpu_torch.train.run_unet --manifest doc_select.csv \\
      --pretrained <stage-1 checkpoint dir> --output_dir out \\
      --model_scale full --train_batch_size 4 --mixed_precision bf16 \\
      --gradient_checkpointing [--resume_from_checkpoint latest]
  python -m diffute_tpu_torch.train.run_unet --smoke --device cpu

Flag names and semantics are ``diffute_tpu.train.run_unet``'s: the data is
a manifest (``image_path`` / ``ocr_path`` CSV) or the procedural
``SyntheticSceneDataset``; ``--pretrained`` loads a diffusers-layout
directory (only the components it lacks are random-initialized, from seed
0), else the models are random-init from ``--seed``.  Every checkpoint
holds the trainer's whole state and exports ``unet/``, ``unet_ema/`` (with
``--use_ema``), ``vae/`` and ``trocr/`` (``train.loop``).  Runs on the card
unless ``--device cpu`` is given; without a card it exits non-zero.  On the
card the flash-attention kernels are on at both precisions (bf16 kernels
with ``--mixed_precision bf16``, the fp32 ones with ``no``).
``--report_to`` defaults to ``tensorboard``, as in the JAX package.  Not
yet ported, each raising with its ROADMAP item: ``--optimizer
adafactor|adamw8bit``, ``--steps_per_call`` above 1.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence

from diffute_tpu_torch.train import loop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    loop.add_common_args(p, output_dir="diffute-unet", checkpointing_steps=1000)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="low-memory Adam: first moment stored in bf16")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--prediction_type", default=None,
                   choices=[None, "epsilon", "v_prediction"])
    p.add_argument("--noise_offset", type=float, default=0.0)
    p.add_argument("--synthetic_vocab", default="fixed",
                   choices=["fixed", "mixed", "random"])
    return p.parse_args(argv)


def prepare(argv: Optional[Sequence[str]] = None
            ) -> Optional[loop.TrainingRun]:
    """Parse, build (or restore) the trainer and its loader; None when the
    checkpoint to resume from already satisfies the step budget."""
    args = parse_args(argv)
    loop.check_ported(args)

    from diffute_tpu_torch.compat.diffusers import (diffusers_unet_config_json,
                                                    diffusers_vae_config_json,
                                                    vit_config_json)
    from diffute_tpu_torch.config import (DiffUTEConfig, OptimizerConfig,
                                          TrainConfig, small_config,
                                          tiny_test_config)
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              UNetManifestDataset,
                                              make_unet_batch)
    from diffute_tpu_torch.train.checkpoint import export_diffusers_layout
    from diffute_tpu_torch.train.unet_train import UNetTrainer
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"run_unet: {e}")
    on_card = device.type == "cuda"

    accum = args.gradient_accumulation_steps
    train_cfg = TrainConfig(
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=accum,
        num_train_epochs=args.num_train_epochs,
        mixed_precision=args.mixed_precision,
        gradient_checkpointing=args.gradient_checkpointing,
        use_ema=args.use_ema,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint,
        seed=args.seed,
        output_dir=args.output_dir,
        logging_dir=args.logging_dir,
        noise_offset=args.noise_offset,
        prediction_type=args.prediction_type,
        dataloader_num_workers=args.dataloader_num_workers,
        report_to=args.report_to,
        optimizer=OptimizerConfig(
            name=args.optimizer,
            learning_rate=args.learning_rate,
            lr_scheduler=args.lr_scheduler,
            lr_warmup_steps=args.lr_warmup_steps,
            max_grad_norm=args.max_grad_norm,
            scale_lr=args.scale_lr,
            low_memory_adam=args.use_8bit_adam,
        ),
    )
    if args.smoke:
        base, batch_size = tiny_test_config(), 2
    else:
        base = small_config() if args.model_scale == "small" else DiffUTEConfig()
        batch_size = args.train_batch_size
    config = dataclasses.replace(
        base, train=train_cfg,
        unet=dataclasses.replace(
            base.unet, remat=args.gradient_checkpointing,
            # on the card the flash kernels take both precisions; on the
            # CPU the config's own setting stands (the plain version)
            use_flash_attention=on_card or base.unet.use_flash_attention))
    if args.prediction_type:
        config = dataclasses.replace(
            config, scheduler=dataclasses.replace(
                config.scheduler, prediction_type=args.prediction_type))

    if args.manifest:
        dataset = UNetManifestDataset(args.manifest, config, seed=args.seed)
    else:
        dataset = SyntheticSceneDataset(config, seed=args.seed,
                                        vocab=args.synthetic_vocab)
    max_steps, epoch_mode, steps_per_epoch = loop.step_budget(
        args, len(dataset), batch_size * accum, default=10_000)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, max_train_steps=max_steps))
    if loop.satisfied(args, max_steps):
        return None

    if args.pretrained:
        from diffute_tpu_torch.serve.loading import load_diffusers_layout

        params = load_diffusers_layout(args.pretrained, config, device)
    else:
        params = init_pipeline_params(config, seed=args.seed, device=device)
    trainer = UNetTrainer(config, params["unet"],
                          {"vae": params["vae"], "trocr": params["trocr"]},
                          device=device, total_steps=max_steps)
    del params  # the trainer holds its own copies

    def collate(examples):
        b = make_unet_batch(examples, config)
        if accum > 1:
            b = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in b.items()}
        return b

    # the frozen models go into every checkpoint, in fp32 (the compute
    # dtype's values), so each one is a self-contained pipeline directory;
    # they never change, so their host copy is made once
    frozen = {name: {k: v.detach().float().cpu() for k, v in
                     getattr(trainer, name).state_dict().items()}
              for name in ("vae", "trocr")}

    def export(path, host):
        export_diffusers_layout(
            path, unet_params=host["params"],
            unet_ema_params=host["ema"]["params"] if host["ema"] else None,
            unet_config=diffusers_unet_config_json(config.unet),
            vae_params=frozen["vae"],
            vae_config=diffusers_vae_config_json(config.vae),
            trocr_params=frozen["trocr"],
            trocr_config=vit_config_json(config.trocr))

    return loop.start(args, trainer, dataset, batch_size * accum, collate,
                      max_steps, epoch_mode, steps_per_epoch, export)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train; returns one ``{"step", "loss", "grad_norm", "seconds",
    "max_memory_allocated"}`` per optimizer step (none when the checkpoint
    to resume from already satisfies the budget)."""
    run = prepare(argv)
    return run.train() if run is not None else []


if __name__ == "__main__":
    main()
