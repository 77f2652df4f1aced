from diffute_tpu_torch.diffusion.schedules import (
    DiffusionSchedule,
    ddim_step,
    ddim_timesteps,
    make_schedule,
)

__all__ = ["DiffusionSchedule", "ddim_step", "ddim_timesteps", "make_schedule"]
