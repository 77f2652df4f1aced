from diffute_tpu_torch.diffusion.schedules import (
    DiffusionSchedule,
    add_noise,
    ddim_step,
    ddim_timesteps,
    ddpm_step,
    ddpm_timesteps,
    dpmpp_2m_step,
    get_velocity,
    init_noise_sigma,
    make_schedule,
    scale_model_input,
    training_target,
)

__all__ = ["DiffusionSchedule", "add_noise", "ddim_step", "ddim_timesteps",
           "ddpm_step", "ddpm_timesteps", "dpmpp_2m_step", "get_velocity",
           "init_noise_sigma", "make_schedule", "scale_model_input",
           "training_target"]
