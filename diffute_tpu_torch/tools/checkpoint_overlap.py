"""What a checkpoint costs the training loop: the steps taken while the
background thread writes it, beside the steps taken with it idle.

  python -m diffute_tpu_torch.tools.checkpoint_overlap [--stage 1|2]
      [--rounds 2] [--idle 4] [--out DIR]

Builds the entry point's full-width trainer (``--stage 1``: ``run_vae``,
the SD2 VAE; ``--stage 2``: ``run_unet``; batch 4, 512^2, bf16, gradient
checkpointing, random weights and synthetic scenes from seed 0), then, in
turns, ``--rounds`` times: ``--idle`` steps with no checkpoint in flight,
then a save with each file writer and the steps taken until its thread is
done (and one more).  The writers are the port's ``save_safetensors``
(``stream``) and ``safetensors.torch.save_file`` (``library``), swapped in
for the whole save (state and export).  Every step ends when its loss is
read on the host, as in the loop.  Prints one JSON object with the card's
name and power limit and writes it under ``--out`` (default
``runs/checkpoint_overlap/``, git-ignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch


def library_writer(state_dict, path):
    from safetensors.torch import save_file

    tmp = f"{path}.tmp.{os.getpid()}"
    save_file({k: v.detach().cpu().contiguous() for k, v in state_dict.items()},
              tmp)
    os.replace(tmp, path)


def use_writer(writer) -> None:
    from diffute_tpu_torch.compat import diffusers
    from diffute_tpu_torch.train import checkpoint

    diffusers.save_safetensors = writer
    checkpoint.save_safetensors = writer


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--stage", type=int, default=1, choices=[1, 2])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--idle", type=int, default=4)
    p.add_argument("--out", default="runs/checkpoint_overlap")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("checkpoint_overlap: no CUDA device")
    from diffute_tpu_torch.compat.diffusers import save_safetensors
    from diffute_tpu_torch.train import run_unet, run_vae

    writers = {"stream": save_safetensors, "library": library_writer}
    root = tempfile.mkdtemp(prefix="diffute_ckpt_overlap_")
    entry = run_vae if args.stage == 1 else run_unet
    run = entry.prepare([
        "--model_scale", "full", "--train_batch_size", "4",
        "--mixed_precision", "bf16", "--gradient_checkpointing",
        "--max_train_steps", "100000", "--output_dir", root,
        "--checkpoints_total_limit", "1", "--report_to", "none",
        "--dataloader_num_workers", "4", "--seed", "0"])
    trainer, manager = run.trainer, run.manager
    batches = iter(run.loader)

    def step() -> float:
        t0 = time.perf_counter()
        float(trainer.step(next(batches))["loss"])
        return time.perf_counter() - t0

    for _ in range(3):  # warm-up: the first steps build and tune
        step()
    rounds = []
    try:
        for r in range(args.rounds):
            rec = {"idle_step_seconds": [step() for _ in range(args.idle)]}
            for name, writer in (sorted(writers.items()) if r % 2
                                 else writers.items()):
                use_writer(writer)
                t0 = time.perf_counter()
                manager.save(trainer.state.step, trainer.state_dict(),
                             run.export_fn)
                in_loop = time.perf_counter() - t0
                busy, t_busy = [], time.perf_counter()
                while manager._thread.is_alive():
                    busy.append(step())
                busy_wall = time.perf_counter() - t_busy
                manager.wait()
                rec[name] = dict(in_loop_seconds=in_loop,
                                 busy_step_seconds=busy,
                                 busy_wall_seconds=busy_wall,
                                 after_step_seconds=step(),
                                 **manager.times)
            rounds.append(rec)
    finally:
        batches.close()  # stops the loader's threads
        use_writer(save_safetensors)
        shutil.rmtree(root, ignore_errors=True)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    import safetensors

    result = {"gpu": gpu, "stage": args.stage,
              "safetensors": safetensors.__version__, "rounds": rounds}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"stage{args.stage}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
