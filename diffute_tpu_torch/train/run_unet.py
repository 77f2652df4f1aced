"""Stage-2 training entry point (the reference's ``train_diffute_v1.py``).

  python -m diffute_tpu_torch.train.run_unet --model_scale full \\
      --train_batch_size 4 --mixed_precision bf16 --gradient_checkpointing \\
      --max_train_steps 3
  python -m diffute_tpu_torch.train.run_unet --smoke --device cpu

Flag names are ``diffute_tpu.train.run_unet``'s.  The models are random-init
from ``--seed`` and the data is the procedural ``SyntheticSceneDataset``.
Runs on the card unless ``--device cpu`` is given; without a card it exits
non-zero.  On the card ``--mixed_precision bf16`` turns the flash-attention
kernels on (they take bf16 only).  Not yet ported, each raising with its
ROADMAP item: ``--manifest``, ``--pretrained``, ``--resume_from_checkpoint``
(and checkpoint saving: nothing is written), ``--report_to tensorboard``,
``--optimizer adafactor|adamw8bit``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--manifest", default=None)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_train_steps", "--max-train-steps", type=int,
                   default=None)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adafactor", "adamw8bit"])
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="low-memory Adam: first moment stored in bf16")
    p.add_argument("--mixed_precision", default="no", choices=["no", "bf16"])
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--resume_from_checkpoint", "--resume-from-checkpoint",
                   default=None)
    p.add_argument("--prediction_type", default=None,
                   choices=[None, "epsilon", "v_prediction"])
    p.add_argument("--noise_offset", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report_to", default="none",
                   choices=["none", "tensorboard"])
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--smoke", action="store_true",
                   help="tiny config + synthetic data, 2 steps")
    p.add_argument("--synthetic_vocab", default="fixed",
                   choices=["fixed", "mixed", "random"])
    p.add_argument("--model_scale", default="full", choices=["full", "small"])
    return p.parse_args(argv)


def _check_ported(args: argparse.Namespace) -> None:
    for bad, what, item in (
            (args.manifest, "--manifest", "manifest datasets and io/storage.py"),
            (args.pretrained, "--pretrained", "the safetensors loader"),
            (args.resume_from_checkpoint, "--resume_from_checkpoint",
             "train/checkpoint.py"),
            (args.report_to == "tensorboard", "--report_to tensorboard",
             "utils/metrics.py")):
        if bad:
            raise NotImplementedError(
                f"{what} is not yet ported to the PyTorch port "
                f"(ROADMAP.md queue 1: {item})")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train; returns one ``{"step", "loss", "grad_norm", "seconds",
    "max_memory_allocated"}`` per optimizer step."""
    args = parse_args(argv)
    _check_ported(args)

    import torch

    from diffute_tpu_torch.config import (DiffUTEConfig, OptimizerConfig,
                                          TrainConfig, small_config,
                                          tiny_test_config)
    from diffute_tpu_torch.io.dataset import (PrefetchLoader,
                                              SyntheticSceneDataset,
                                              make_unet_batch)
    from diffute_tpu_torch.train.unet_train import UNetTrainer
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"run_unet: {e}")
    on_card = device.type == "cuda"

    accum = args.gradient_accumulation_steps
    max_steps = 2 if args.smoke else (args.max_train_steps or 10_000)
    train_cfg = TrainConfig(
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=accum,
        max_train_steps=max_steps,
        mixed_precision=args.mixed_precision,
        gradient_checkpointing=args.gradient_checkpointing,
        use_ema=args.use_ema,
        seed=args.seed,
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
            # the flash kernels take bf16 only; on the CPU the config's own
            # setting stands (the plain version takes any dtype)
            use_flash_attention=(args.mixed_precision == "bf16" if on_card
                                 else base.unet.use_flash_attention)))
    if args.prediction_type:
        config = dataclasses.replace(
            config, scheduler=dataclasses.replace(
                config.scheduler, prediction_type=args.prediction_type))

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

    dataset = SyntheticSceneDataset(config, seed=args.seed,
                                    vocab=args.synthetic_vocab)
    loader = PrefetchLoader(dataset, batch_size * accum, collate,
                            num_threads=max(1, args.dataloader_num_workers),
                            seed=args.seed)

    history: List[Dict[str, float]] = []
    t_prev = time.perf_counter()
    for batch in loader:
        if trainer.state.step >= max_steps:
            break
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        metrics = trainer.step(batch)
        # reading the metrics waits for the step's device work
        rec = {"step": trainer.state.step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        now = time.perf_counter()
        rec["seconds"], t_prev = now - t_prev, now
        rec["max_memory_allocated"] = (
            torch.cuda.max_memory_allocated(device) if on_card else 0)
        history.append(rec)
        print(f"step {rec['step']}: loss {rec['loss']:.4f} grad_norm "
              f"{rec['grad_norm']:.4f} steps/s {1.0 / rec['seconds']:.3f}",
              flush=True)
    if history:
        print(f"done at step {trainer.state.step}; final loss "
              f"{history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
