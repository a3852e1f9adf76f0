"""DDPM ancestral sampling step (counterpart of
``anyv2v_tpu/schedulers/ddpm.py``), fp32 whatever the latent dtype: the SEINE
edit's default sampler."""

from __future__ import annotations

import torch

from .schedules import DiffusionSchedule, to_x0_and_eps


def ddpm_step(schedule: DiffusionSchedule, sample: torch.Tensor, model_output: torch.Tensor,
              timestep: int, prev_timestep: int, noise: torch.Tensor,
              variance_type: str = "fixed_small") -> torch.Tensor:
    """One ancestral step x_t -> x_{t_prev} on a strided grid (the alpha
    ratio between grid neighbours, as diffusers). ``noise`` is standard
    normal of ``sample``'s shape; the final step (``prev_timestep < 0``) adds
    none. Returns ``sample``'s dtype."""
    x0, _ = to_x0_and_eps(schedule, sample, model_output, timestep)
    x = sample.float()

    a_t = schedule.alpha_bar(timestep)
    a_prev = schedule.alpha_bar(prev_timestep)
    beta_prod_t = 1.0 - a_t
    beta_prod_t_prev = 1.0 - a_prev
    current_alpha_t = a_t / a_prev
    current_beta_t = 1.0 - current_alpha_t

    # posterior mean coefficients (DDPM eq. 7)
    pred_x0_coeff = torch.sqrt(a_prev) * current_beta_t / beta_prod_t
    current_sample_coeff = torch.sqrt(current_alpha_t) * beta_prod_t_prev / beta_prod_t
    mean = pred_x0_coeff * x0 + current_sample_coeff * x

    variance = beta_prod_t_prev / beta_prod_t * current_beta_t
    if variance_type == "fixed_small":
        variance = torch.clamp(variance, min=1e-20)
    elif variance_type == "fixed_small_log":
        variance = torch.exp(0.5 * torch.log(torch.clamp(variance, min=1e-20))) ** 2
    elif variance_type == "fixed_large":
        variance = current_beta_t
    else:
        raise ValueError(f"unsupported variance_type: {variance_type}")

    if int(prev_timestep) < 0:
        return mean.to(sample.dtype)
    return (mean + torch.sqrt(variance) * noise.float()).to(sample.dtype)
