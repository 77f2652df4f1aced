"""What the training entry points share: their common flags, the step
budget, the early exit, resume, and the loop that logs, checkpoints and
exports.

``run_vae`` (stage 1), ``run_unet`` (stage 2) and ``run_ocr`` (the OCR
verifier) follow the JAX package's entry points (``diffute_tpu/train/
run_vae.py``, ``run_unet.py``, ``run_ocr.py``), whose loops are the same
apart from the trainer, the flags and the export; here the loop is written
once.  A run is built by the entry point's ``prepare(argv)`` (None
when the newest checkpoint already satisfies the step budget) and driven by
:meth:`TrainingRun.train`.

- Step budget: ``--max_train_steps``, else ``--num_train_epochs`` over the
  manifest (when it fills a batch), else the entry point's default;
  ``--smoke`` takes 2 steps unless ``--max_train_steps`` says otherwise.
- Resume: ``--resume_from_checkpoint latest|<dir>`` restores the trainer's
  whole state.  The loader's seed takes the resume step (epoch mode: its
  epoch), as in the JAX package, so a resumed run draws fresh batches; the
  restored generator continues the noise stream where the saved run
  stopped, so no draw is replayed.
- Checkpoints: at every ``--checkpointing_steps`` boundary and at the end,
  written off the loop by ``AsyncCheckpointManager`` with the
  diffusers-layout export beside the state.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

from diffute_tpu_torch.train.checkpoint import (AsyncCheckpointManager,
                                                checkpoint_step,
                                                resolve_resume,
                                                restore_checkpoint)
from diffute_tpu_torch.utils.metrics import MetricWriter


def add_common_args(p: argparse.ArgumentParser, output_dir: str,
                    checkpointing_steps: int) -> None:
    """The flags both entry points take, with the JAX package's names."""
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--manifest", default=None)
    p.add_argument("--pretrained", default=None,
                   help="diffusers-layout directory (a checkpoint's export)")
    p.add_argument("--output_dir", "--output-dir", default=output_dir)
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--max_train_steps", "--max-train-steps", type=int,
                   default=None, help="overrides --num_train_epochs when set")
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adafactor", "adamw8bit"])
    p.add_argument("--mixed_precision", default="no", choices=["no", "bf16"])
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--checkpointing_steps", type=int,
                   default=checkpointing_steps)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", "--resume-from-checkpoint",
                   default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report_to", default="tensorboard",
                   choices=["none", "tensorboard", "wandb", "comet_ml", "all"])
    p.add_argument("--logging_dir", default="logs")
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="only 1: several steps per call are not ported")
    p.add_argument("--smoke", action="store_true",
                   help="tiny config, batch 2, 2 steps (or --max_train_steps)")
    p.add_argument("--model_scale", default="full", choices=["full", "small"])


def check_ported(args: argparse.Namespace) -> None:
    if args.steps_per_call > 1:
        raise NotImplementedError(
            "--steps_per_call > 1 is not yet ported to the PyTorch port "
            "(ROADMAP.md queue 1 item 10: steps_per_call, left out on "
            "purpose)")


def step_budget(args: argparse.Namespace, n_examples: int, batch: int,
                default: int):
    """(max_steps, epoch_mode, steps_per_epoch) for a dataset of
    ``n_examples`` read ``batch`` examples a step."""
    from diffute_tpu_torch.io.dataset import PrefetchLoader

    epoch_mode = PrefetchLoader.resolve_shuffle(n_examples, batch) == "epoch"
    steps_per_epoch = max(1, n_examples // batch)
    if args.smoke:
        max_steps = args.max_train_steps or 2
    elif args.max_train_steps:
        max_steps = args.max_train_steps
    elif epoch_mode:
        max_steps = args.num_train_epochs * steps_per_epoch
    else:
        max_steps = default
    return max_steps, epoch_mode, steps_per_epoch


def satisfied(args: argparse.Namespace, max_steps: int) -> bool:
    """True (and says so) when the checkpoint to resume from is already at
    or beyond ``max_steps``: decided from its directory name alone, before
    any weights are built."""
    resume = resolve_resume(args.output_dir, args.resume_from_checkpoint)
    if resume and checkpoint_step(resume) >= max_steps:
        print(f"done at step {checkpoint_step(resume)}; nothing to train "
              f"(resumed at or beyond max_train_steps; checkpoint {resume} "
              f"not validated)")
        return True
    return False


@dataclasses.dataclass
class TrainingRun:
    """A prepared run: the trainer (restored when resuming), its loader,
    the checkpoint manager and the metric writer."""

    trainer: object
    loader: object
    max_steps: int
    checkpointing_steps: int
    manager: AsyncCheckpointManager
    export_fn: Callable
    writer: object = None
    start_step: int = 0
    restored_from: Optional[str] = None
    restore_seconds: float = 0.0

    def save(self) -> str:
        t0 = time.perf_counter()
        path = self.manager.save(self.trainer.state.step,
                                 self.trainer.state_dict(), self.export_fn)
        print(f"saved {path} ({time.perf_counter() - t0:.3f} s in the loop)",
              flush=True)
        return path

    def train(self) -> List[Dict[str, float]]:
        """Step to ``max_steps``; returns one ``{"step", "loss",
        "grad_norm", (the trainer's other metrics), "seconds",
        "max_memory_allocated"}`` per optimizer step ("seconds": the step's
        own, from the end of the previous step or save to the metrics'
        read)."""
        import torch

        from diffute_tpu_torch.utils.profiling import StepTimer

        trainer = self.trainer
        on_card = trainer.device.type == "cuda"
        timer = StepTimer()
        history: List[Dict[str, float]] = []
        step = last_saved = self.start_step
        t_prev = time.perf_counter()
        for batch in self.loader:
            if step >= self.max_steps:
                break
            if on_card:
                torch.cuda.reset_peak_memory_stats(trainer.device)
            metrics = trainer.step(batch)
            # reading the metrics waits for the step's device work
            rec = {"step": trainer.state.step,
                   **{k: float(v) for k, v in metrics.items()}}
            now = time.perf_counter()
            rec["seconds"] = now - t_prev
            rec["max_memory_allocated"] = (
                torch.cuda.max_memory_allocated(trainer.device) if on_card
                else 0)
            history.append(rec)
            timer.tick()
            step = rec["step"]
            rate = 1.0 / timer.mean if timer.mean else 0.0
            more = {k: rec[k] for k in metrics if k != "loss"}
            print(f"step {step}: loss {rec['loss']:.4f} "
                  + "".join(f"{k} {v:.4f} " for k, v in more.items())
                  + f"steps/s {1.0 / rec['seconds']:.3f}", flush=True)
            self.writer.log(step, {"train_loss": rec["loss"], **more,
                                   "steps_per_sec": rate})
            if step % self.checkpointing_steps == 0 or step >= self.max_steps:
                last_saved = step
                self.save()
            t_prev = time.perf_counter()
        if step > last_saved:
            # the loader ran out before a boundary: never exit without
            # saving the last state
            self.save()
        self.manager.wait()  # the last checkpoint durable before exit
        self.writer.close()
        if history:
            print(f"done at step {step}; final loss {history[-1]['loss']:.4f}")
        else:
            print(f"done at step {step}; nothing to train "
                  f"(resumed at or beyond max_train_steps)")
        return history


def start(args: argparse.Namespace, trainer, dataset, batch_size: int,
          collate, max_steps: int, epoch_mode: bool, steps_per_epoch: int,
          export_fn: Callable) -> TrainingRun:
    """Restore (``--resume_from_checkpoint``), then build the loader, the
    checkpoint manager and the metric writer around ``trainer``."""
    import math

    from diffute_tpu_torch.io.dataset import PrefetchLoader

    run = TrainingRun(trainer=trainer, loader=None, max_steps=max_steps,
                      checkpointing_steps=args.checkpointing_steps,
                      manager=AsyncCheckpointManager(
                          args.output_dir, args.checkpoints_total_limit),
                      export_fn=export_fn)
    resume = resolve_resume(args.output_dir, args.resume_from_checkpoint)
    if resume:
        t0 = time.perf_counter()
        trainer.load_state_dict(restore_checkpoint(resume))
        run.restore_seconds = time.perf_counter() - t0
        run.start_step, run.restored_from = trainer.state.step, resume
        print(f"resumed from {resume} at step {run.start_step}")
    start_step = run.start_step
    run.loader = PrefetchLoader(
        dataset, batch_size, collate,
        num_threads=max(1, args.dataloader_num_workers),
        seed=args.seed if epoch_mode else args.seed + start_step,
        num_epochs=math.ceil(max_steps / steps_per_epoch) if epoch_mode else None,
        start_epoch=start_step // steps_per_epoch if epoch_mode else 0)
    run.writer = MetricWriter(os.path.join(args.output_dir, args.logging_dir),
                              report_to=args.report_to, config=vars(args))
    return run
