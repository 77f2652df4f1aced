"""Noise schedule tables and the DDIM sampler step (PyTorch).

Counterpart of ``diffute_tpu/diffusion/schedules.py`` for the port's
default path: ``make_schedule``, ``ddim_timesteps``, ``_predict_x0_eps``
and ``ddim_step`` (eta = 0).  The denoising loop is a Python loop, so
timesteps are Python ints and each coefficient is one fp32 table entry.
DDPM and DPM-Solver++ are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from diffute_tpu_torch.config import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed noise-schedule tables (all shape [num_train_timesteps])."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    variance_type: str
    set_alpha_to_one: bool
    steps_offset: int

    @property
    def final_alpha_cumprod(self) -> torch.Tensor:
        """DDIM boundary: alpha_bar for the step "before" t=0."""
        if self.set_alpha_to_one:
            return torch.ones((), dtype=self.alphas_cumprod.dtype,
                              device=self.alphas_cumprod.device)
        return self.alphas_cumprod[0]


def _beta_table(config: SchedulerConfig) -> np.ndarray:
    T = config.num_train_timesteps
    if config.beta_schedule == "linear":
        return np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
    if config.beta_schedule == "scaled_linear":
        return np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5, T,
                           dtype=np.float64) ** 2
    if config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(T, dtype=np.float64)
        return np.minimum(1.0 - alpha_bar((ts + 1) / T) / alpha_bar(ts / T), 0.999)
    raise ValueError(f"Unknown beta_schedule: {config.beta_schedule}")


def make_schedule(config: SchedulerConfig, dtype=torch.float32,
                  device="cpu") -> DiffusionSchedule:
    betas = _beta_table(config)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)

    def t(a):
        return torch.from_numpy(a).to(dtype=dtype, device=device)

    return DiffusionSchedule(
        betas=t(betas), alphas=t(alphas), alphas_cumprod=t(alphas_cumprod),
        num_train_timesteps=config.num_train_timesteps,
        prediction_type=config.prediction_type,
        clip_sample=config.clip_sample,
        variance_type=config.variance_type,
        set_alpha_to_one=config.set_alpha_to_one,
        steps_offset=config.steps_offset,
    )


def ddim_timesteps(schedule: DiffusionSchedule,
                   num_inference_steps: int) -> np.ndarray:
    """Descending timesteps for DDIM ("leading" spacing + steps_offset)."""
    T = schedule.num_train_timesteps
    if num_inference_steps > T:
        raise ValueError(f"num_inference_steps {num_inference_steps} > {T}")
    step_ratio = T // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
    ts = ts + schedule.steps_offset
    return np.clip(ts, 0, T - 1).astype(np.int32).copy()


def _predict_x0_eps(schedule: DiffusionSchedule, model_output: torch.Tensor,
                    t: int, sample: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_x0, pred_epsilon) under the configured prediction type."""
    alpha_prod_t = schedule.alphas_cumprod[t]
    beta_prod_t = 1.0 - alpha_prod_t
    if schedule.prediction_type == "epsilon":
        pred_x0 = (sample - torch.sqrt(beta_prod_t) * model_output) \
            / torch.sqrt(alpha_prod_t)
        pred_eps = model_output
    elif schedule.prediction_type == "v_prediction":
        pred_x0 = torch.sqrt(alpha_prod_t) * sample \
            - torch.sqrt(beta_prod_t) * model_output
        pred_eps = torch.sqrt(alpha_prod_t) * model_output \
            + torch.sqrt(beta_prod_t) * sample
    else:
        raise ValueError(f"Unknown prediction type {schedule.prediction_type}")
    if schedule.clip_sample:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
    return pred_x0, pred_eps


def ddim_step(schedule: DiffusionSchedule, model_output: torch.Tensor, t: int,
              prev_t: int, sample: torch.Tensor) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM reverse step x_t -> x_prev_t.

    ``prev_t`` is the next timestep of the descending sequence, -1 on the
    final step (alpha_bar_prev is then ``final_alpha_cumprod``)."""
    alpha_prod_prev = (schedule.alphas_cumprod[prev_t] if prev_t >= 0
                       else schedule.final_alpha_cumprod)
    pred_x0, pred_eps = _predict_x0_eps(schedule, model_output, t, sample)
    dir_xt = torch.sqrt(torch.clamp(1.0 - alpha_prod_prev, min=0.0)) * pred_eps
    return torch.sqrt(alpha_prod_prev) * pred_x0 + dir_xt
