"""Noise schedule tables, training targets and sampler steps (PyTorch).

Counterpart of ``diffute_tpu/diffusion/schedules.py``.  The training
functions (``add_noise``, ``get_velocity``, ``training_target``) take
per-sample timestep tensors.  The sampler steps (``ddim_step`` with eta = 0,
``ddpm_step``, ``dpmpp_2m_step``) are called from a Python loop, so their
timesteps are Python ints and each coefficient is one fp32 table entry;
``edit()`` runs DDIM only so far.
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


def _gather(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients, broadcast to an ``ndim``-rank tensor.
    ``t`` is an integer tensor, scalar or per-batch (B,)."""
    coef = table[t]
    return coef.reshape(coef.shape + (1,) * (ndim - coef.dim()))


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor,
              noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward process q(x_t | x_0)."""
    a = _gather(torch.sqrt(schedule.alphas_cumprod), t, x0.dim())
    s = _gather(torch.sqrt(1.0 - schedule.alphas_cumprod), t, x0.dim())
    return a * x0 + s * noise


def get_velocity(schedule: DiffusionSchedule, x0: torch.Tensor,
                 noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """v-prediction target."""
    a = _gather(torch.sqrt(schedule.alphas_cumprod), t, x0.dim())
    s = _gather(torch.sqrt(1.0 - schedule.alphas_cumprod), t, x0.dim())
    return a * noise - s * x0


def training_target(schedule: DiffusionSchedule, x0: torch.Tensor,
                    noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """epsilon / v target selection."""
    if schedule.prediction_type == "epsilon":
        return noise
    if schedule.prediction_type == "v_prediction":
        return get_velocity(schedule, x0, noise, t)
    raise ValueError(f"Unknown prediction type {schedule.prediction_type}")


def init_noise_sigma(schedule: DiffusionSchedule, sampler: str = "ddpm") -> float:
    """Initial latent scale: 1.0 for DDPM, DDIM and DPM-Solver++."""
    del schedule, sampler
    return 1.0


def scale_model_input(x: torch.Tensor, t) -> torch.Tensor:
    """Identity for these samplers; kept for API parity."""
    del t
    return x


def _leading_timesteps(schedule: DiffusionSchedule,
                       num_inference_steps: int) -> np.ndarray:
    T = schedule.num_train_timesteps
    if num_inference_steps > T:
        raise ValueError(f"num_inference_steps {num_inference_steps} > {T}")
    step_ratio = T // num_inference_steps
    return (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]


def ddpm_timesteps(schedule: DiffusionSchedule,
                   num_inference_steps: int) -> np.ndarray:
    """Descending timesteps for DDPM ancestral sampling ("leading" spacing)."""
    return _leading_timesteps(schedule, num_inference_steps).astype(
        np.int32).copy()


def ddim_timesteps(schedule: DiffusionSchedule,
                   num_inference_steps: int) -> np.ndarray:
    """Descending timesteps for DDIM ("leading" spacing + steps_offset)."""
    ts = _leading_timesteps(schedule, num_inference_steps) + schedule.steps_offset
    return np.clip(ts, 0, schedule.num_train_timesteps - 1).astype(
        np.int32).copy()


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


def ddpm_step(schedule: DiffusionSchedule, model_output: torch.Tensor, t: int,
              sample: torch.Tensor, noise: torch.Tensor,
              num_inference_steps: int) -> torch.Tensor:
    """One ancestral DDPM reverse step x_t -> x_{t-k}.  ``noise`` is the
    ancestral standard normal; it is applied only when the previous
    timestep is >= 0."""
    prev_t = t - schedule.num_train_timesteps // num_inference_steps
    alpha_prod_t = schedule.alphas_cumprod[t]
    alpha_prod_prev = (schedule.alphas_cumprod[prev_t] if prev_t >= 0
                       else torch.ones_like(alpha_prod_t))
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_prev = 1.0 - alpha_prod_prev
    current_alpha = alpha_prod_t / alpha_prod_prev
    current_beta = 1.0 - current_alpha

    pred_x0, _ = _predict_x0_eps(schedule, model_output, t, sample)
    coef_x0 = torch.sqrt(alpha_prod_prev) * current_beta / beta_prod_t
    coef_xt = torch.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
    prev_mean = coef_x0 * pred_x0 + coef_xt * sample
    if prev_t < 0:
        return prev_mean
    if schedule.variance_type == "fixed_small":
        variance = (beta_prod_prev / beta_prod_t * current_beta).clamp(min=1e-20)
    elif schedule.variance_type == "fixed_large":
        variance = current_beta.clamp(min=1e-20)
    else:
        raise ValueError(f"Unsupported variance_type {schedule.variance_type}")
    return prev_mean + torch.sqrt(variance) * noise


def _alpha_sigma_lambda(schedule: DiffusionSchedule, t: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(alpha_t, sigma_t, lambda_t) in DPM-Solver's half-log-SNR notation:
    alpha = sqrt(alpha_bar), sigma = sqrt(1 - alpha_bar),
    lambda = log(alpha / sigma)."""
    ac = schedule.alphas_cumprod[t]
    lam = 0.5 * (torch.log(ac) - torch.log1p(-ac))
    return torch.sqrt(ac), torch.sqrt(1.0 - ac), lam


def dpmpp_2m_step(schedule: DiffusionSchedule, model_output: torch.Tensor,
                  t: int, prev_t: int, t_last: int, sample: torch.Tensor,
                  prev_x0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) multistep update x_t -> x_{prev_t}.

    ``t_last`` is the previous solver step's timestep (-1 on the first step:
    first-order update), ``prev_x0`` that step's x0 prediction, ``prev_t``
    the next timestep of the descending sequence (-1 on the final step: the
    boundary is ``final_alpha_cumprod`` and the update drops to first
    order).  Returns ``(prev_sample, pred_x0)``."""
    _, sigma_t, lam_t = _alpha_sigma_lambda(schedule, t)
    ac_s = (schedule.alphas_cumprod[prev_t] if prev_t >= 0
            else schedule.final_alpha_cumprod)
    alpha_s, sigma_s = torch.sqrt(ac_s), torch.sqrt(1.0 - ac_s)
    # +inf at the set_alpha_to_one boundary; expm1(-inf) = -1 and sigma_s = 0
    # there, so the update degenerates to pred_x0 without NaNs
    lam_s = 0.5 * (torch.log(ac_s) - torch.log1p(-ac_s))
    pred_x0, _ = _predict_x0_eps(schedule, model_output, t, sample)
    h = lam_s - lam_t
    d = pred_x0
    if t_last >= 0 and prev_t >= 0:  # second-order correction
        _, _, lam_l = _alpha_sigma_lambda(schedule, t_last)
        r = (lam_t - lam_l) / h
        d = (1.0 + 1.0 / (2.0 * r)) * pred_x0 - 1.0 / (2.0 * r) * prev_x0
    x = (sigma_s / sigma_t) * sample - alpha_s * torch.expm1(-h) * d
    return x, pred_x0
