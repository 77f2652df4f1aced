"""Optimizer and LR schedules of the trainers.

Counterpart of ``diffute_tpu/train/optim.py``, which builds them from optax.
The six schedules of diffusers' ``get_scheduler`` family are plain Python
functions of the step.  :class:`AdamW` computes what
``optax.chain(clip_by_global_norm, adamw)`` computes, over ``torch._foreach``
ops: the clip is ``g * max_norm / norm`` when ``norm >= max_norm`` (no
``+1e-6`` as in ``clip_grad_norm_``), the bias corrections use ``count + 1``,
the schedule is read at the pre-increment count, and the update is
``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.  ``adafactor`` and
``adamw8bit`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence

import torch

from diffute_tpu_torch.config import OptimizerConfig

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def build_lr_schedule(config: OptimizerConfig, total_steps: int) -> Schedule:
    lr, warmup, name = (config.learning_rate, config.lr_warmup_steps,
                        config.lr_scheduler)
    warm = _linear(0.0, lr, warmup)
    if name == "constant":
        return lambda count: lr
    if name == "constant_with_warmup":
        return _join(warm, lambda count: lr, warmup)
    if name in ("linear", "polynomial"):  # polynomial has power 1.0
        return _join(warm, _linear(lr, 0.0, max(1, total_steps - warmup)), warmup)
    if name == "cosine":
        decay_steps = max(warmup + 1, total_steps) - warmup

        def cosine(count):
            count = min(count, decay_steps)
            return lr * 0.5 * (1 + math.cos(math.pi * count / decay_steps))

        return _join(warm, cosine, warmup)
    if name == "cosine_with_restarts":
        # diffusers get_cosine_with_hard_restarts_schedule_with_warmup: the
        # LR falls to 0 at each cycle boundary and snaps back to full lr
        cycles = max(1, config.lr_num_cycles)
        decay_span = max(1, total_steps - warmup)

        def restarts(count):
            if count < warmup:
                return lr * count / max(1.0, warmup)
            progress = (count - warmup) / decay_span
            if progress >= 1.0:
                return 0.0
            return lr * 0.5 * (1.0 + math.cos(math.pi * ((cycles * progress) % 1.0)))

        return restarts
    raise ValueError(f"Unknown lr_scheduler: {name}")


class AdamW:
    """Global-norm clip + AdamW over a list of fp32 parameters.

    :meth:`step` reads each parameter's ``.grad``, scales the gradients in
    place when the clip triggers, updates the moments and the parameters in
    place, and returns the pre-clip global gradient norm (a 0-d tensor; no
    host synchronisation)."""

    def __init__(self, params: Sequence[torch.Tensor], config: OptimizerConfig,
                 schedule: Schedule):
        self.params: List[torch.Tensor] = list(params)
        self.config, self.schedule = config, schedule
        self.count = 0
        mu_dtype = torch.bfloat16 if config.low_memory_adam else torch.float32
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        cfg = self.config
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        params = self.params
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                             cfg.max_grad_norm / norm)
        torch._foreach_mul_(grads, factor)

        lr = self.schedule(self.count)
        self.count += 1
        # optax computes 1 - decay**count in fp32
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** self.count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** self.count)

        if cfg.low_memory_adam:
            # optax's numbers for a bf16 first moment: the decay is applied
            # in bf16 (beta1 itself rounded to bf16), the gradient term is
            # added in fp32, the update reads that fp32 value, and the
            # moment is rounded to bf16 when stored
            decay = torch.tensor(b1, dtype=torch.bfloat16, device=norm.device)
            mu = [m.float() for m in torch._foreach_mul(self.mu, decay)]
        else:
            mu = self.mu
            torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)

        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.adam_epsilon)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, params, alpha=cfg.adam_weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        if cfg.low_memory_adam:
            torch._foreach_copy_(self.mu, mu)
        return norm


def build_optimizer(params: Sequence[torch.Tensor], config: OptimizerConfig,
                    total_steps: int, total_batch_size: int = 1) -> AdamW:
    if config.scale_lr:
        # reference --scale_lr: lr *= grad_accum * batch * world
        config = dataclasses.replace(
            config, learning_rate=config.learning_rate * total_batch_size)
    if config.name in ("adafactor", "adamw8bit"):
        raise NotImplementedError(
            f"optimizer {config.name!r} is not yet ported to the PyTorch "
            f"port (ROADMAP.md queue 1: {config.name})")
    if config.name != "adamw":
        raise ValueError(f"Unknown optimizer: {config.name}")
    return AdamW(params, config, build_lr_schedule(config, total_steps))
