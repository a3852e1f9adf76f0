from .ddim import ddim_inverse_step, ddim_step, ddim_transfer
from .ddpm import ddpm_step
from .schedules import (
    DiffusionSchedule,
    add_noise,
    inversion_timesteps,
    make_schedule,
    sampling_timesteps,
)

__all__ = [
    "DiffusionSchedule", "add_noise", "ddim_inverse_step", "ddim_step", "ddim_transfer",
    "ddpm_step", "inversion_timesteps", "make_schedule", "sampling_timesteps",
]
