"""DDIM forward and inverse steps (counterpart of
``anyv2v_tpu/schedulers/ddim.py``), fp32 whatever the latent dtype."""

from __future__ import annotations

import torch

from .schedules import DiffusionSchedule, to_x0_and_eps


def ddim_transfer(schedule: DiffusionSchedule, sample: torch.Tensor,
                  model_output: torch.Tensor, t_alpha: int, t_to: int) -> torch.Tensor:
    """x0 and eps from ``sample`` at alpha_bar(t_alpha), recomposed at
    alpha_bar(t_to): ``sqrt(a_to) * x0 + sqrt(1 - a_to) * eps``."""
    x0, eps = to_x0_and_eps(schedule, sample, model_output, t_alpha)
    a_to = schedule.alpha_bar(t_to)
    return (torch.sqrt(a_to) * x0 + torch.sqrt(1.0 - a_to) * eps).to(sample.dtype)


def ddim_step(schedule: DiffusionSchedule, sample: torch.Tensor,
              model_output: torch.Tensor, timestep: int, prev_timestep: int) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM sampling step x_t -> x_{t_prev}."""
    return ddim_transfer(schedule, sample, model_output, timestep, prev_timestep)


def ddim_inverse_step(schedule: DiffusionSchedule, sample: torch.Tensor,
                      model_output: torch.Tensor, timestep: int,
                      num_inference_steps: int) -> torch.Tensor:
    """One DDIM inversion step onto the ascending grid value ``timestep``:
    x0 is extracted at the source level ``timestep - n_train // n_steps``."""
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    t_src = min(int(timestep) - step_ratio, schedule.num_train_timesteps - 1)
    return ddim_transfer(schedule, sample, model_output, t_src, timestep)
