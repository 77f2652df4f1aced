"""Stage-1 training entry point (the reference's ``train_vae.py``): the VAE
fine-tuned on document crops.

  python -m diffute_tpu_torch.train.run_vae --manifest pages.csv \\
      --output_dir diffdoc-vae-512 --train_batch_size 4 \\
      --mixed_precision bf16 --gradient_checkpointing \\
      [--pretrained <diffusers-layout dir>] [--resume_from_checkpoint latest]
  python -m diffute_tpu_torch.train.run_vae --smoke --device cpu

Flag names and semantics are ``diffute_tpu.train.run_vae``'s: the data is
a manifest (a CSV with a ``path`` column; random 512^2 crops) or the
procedural ``SyntheticSceneDataset``; ``--pretrained`` takes the VAE from a
diffusers-layout directory, else it is random-init from ``--seed``.  The
step budget is ``--max_train_steps``, else the epochs over the manifest,
else 350,000.  Every checkpoint holds the trainer's whole state and exports
``vae/``, which stage 2 loads with ``run_unet --pretrained <checkpoint>``.
Runs on the card unless ``--device cpu`` is given; without a card it exits
non-zero.  Not yet ported, each raising with its ROADMAP item:
``--optimizer adafactor|adamw8bit``, ``--steps_per_call`` above 1.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence

from diffute_tpu_torch.train import loop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    loop.add_common_args(p, output_dir="diffdoc-vae-512",
                         checkpointing_steps=500)
    return p.parse_args(argv)


def prepare(argv: Optional[Sequence[str]] = None
            ) -> Optional[loop.TrainingRun]:
    """Parse, build (or restore) the trainer and its loader; None when the
    checkpoint to resume from already satisfies the step budget."""
    args = parse_args(argv)
    loop.check_ported(args)

    from diffute_tpu_torch.compat.diffusers import diffusers_vae_config_json
    from diffute_tpu_torch.config import (DiffUTEConfig, OptimizerConfig,
                                          TrainConfig, small_config,
                                          tiny_test_config)
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              VAEManifestDataset,
                                              make_vae_batch)
    from diffute_tpu_torch.train.checkpoint import export_diffusers_layout
    from diffute_tpu_torch.train.vae_train import VAETrainer
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"run_vae: {e}")

    train_cfg = TrainConfig(
        train_batch_size=args.train_batch_size,
        num_train_epochs=args.num_train_epochs,
        mixed_precision=args.mixed_precision,
        gradient_checkpointing=args.gradient_checkpointing,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint,
        seed=args.seed,
        output_dir=args.output_dir,
        logging_dir=args.logging_dir,
        dataloader_num_workers=args.dataloader_num_workers,
        report_to=args.report_to,
        optimizer=OptimizerConfig(
            name=args.optimizer,
            learning_rate=args.learning_rate,
            lr_scheduler=args.lr_scheduler,
            lr_warmup_steps=args.lr_warmup_steps,
            max_grad_norm=args.max_grad_norm,
            scale_lr=args.scale_lr,
        ),
    )
    if args.smoke:
        base, batch_size = tiny_test_config(), 2
    else:
        base = small_config() if args.model_scale == "small" else DiffUTEConfig()
        batch_size = args.train_batch_size
    config = dataclasses.replace(
        base, train=train_cfg,
        vae=dataclasses.replace(base.vae, remat=args.gradient_checkpointing))

    if args.manifest:
        dataset = VAEManifestDataset(args.manifest, config, seed=args.seed)
    else:
        dataset = SyntheticSceneDataset(config, seed=args.seed)
    max_steps, epoch_mode, steps_per_epoch = loop.step_budget(
        args, len(dataset), batch_size, default=350_000)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, max_train_steps=max_steps))
    if loop.satisfied(args, max_steps):
        return None

    if args.pretrained:
        from diffute_tpu_torch.serve.loading import load_diffusers_layout

        vae_params = load_diffusers_layout(args.pretrained, config, device,
                                           components=("vae",))["vae"]
    else:
        vae_params = init_pipeline_params(config, seed=args.seed, device=device,
                                          components=("vae",))["vae"]
    trainer = VAETrainer(config, vae_params, device=device,
                         total_steps=max_steps)
    del vae_params  # the trainer holds its own copy

    def export(path, host):
        export_diffusers_layout(path, vae_params=host["params"],
                                vae_config=diffusers_vae_config_json(config.vae))

    return loop.start(args, trainer, dataset, batch_size, make_vae_batch,
                      max_steps, epoch_mode, steps_per_epoch, export)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train; returns one ``{"step", "loss", "grad_norm", "seconds",
    "max_memory_allocated"}`` per optimizer step (none when the checkpoint
    to resume from already satisfies the budget)."""
    run = prepare(argv)
    return run.train() if run is not None else []


if __name__ == "__main__":
    main()
