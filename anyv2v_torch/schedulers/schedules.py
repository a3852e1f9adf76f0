"""Diffusion noise schedules and timestep grids
(counterpart of ``anyv2v_tpu/schedulers/schedules.py``).

The betas are built in float64 numpy exactly as the JAX package builds them;
the schedule then holds ``alphas_cumprod`` as an fp32 tensor on its device,
and all stepping arithmetic is fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


def linear_betas(num_train_timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)


def scaled_linear_betas(num_train_timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    """The Stable-Diffusion-family schedule: linear in sqrt(beta)."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                       dtype=np.float64) ** 2


def squaredcos_cap_v2_betas(num_train_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """The Glide cosine schedule: beta_t = 1 - alpha_bar(t+1) / alpha_bar(t),
    capped at ``max_beta`` (the reference's ``betas_for_alpha_bar``,
    ``consisti2v/ddim_inverse_scheduler.py:49``)."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array([min(1.0 - alpha_bar((i + 1) / num_train_timesteps)
                         / alpha_bar(i / num_train_timesteps), max_beta)
                     for i in range(num_train_timesteps)], dtype=np.float64)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the final alphas_cumprod is exactly 0
    (arXiv:2305.08891)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, at = alphas_bar_sqrt[0].copy(), alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - at) * a0 / (a0 - at)
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = np.concatenate([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


_BETAS = {"linear": linear_betas, "scaled_linear": scaled_linear_betas}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    alphas_cumprod: torch.Tensor          # [num_train] fp32 on the schedule's device
    num_train_timesteps: int
    prediction_type: str
    timestep_spacing: str
    steps_offset: int
    set_alpha_to_one: bool
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    thresholding: bool = False            # stored, not applied (as the JAX package)

    def alpha_bar(self, t: int) -> torch.Tensor:
        """0-dim fp32 alphas_cumprod[t]; t < 0 maps to the final alpha."""
        t = int(t)
        if t >= 0:
            return self.alphas_cumprod[min(t, self.num_train_timesteps - 1)]
        if self.set_alpha_to_one:
            return torch.ones((), dtype=torch.float32, device=self.alphas_cumprod.device)
        return self.alphas_cumprod[0]


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    prediction_type: str = "epsilon",
    timestep_spacing: str = "leading",
    steps_offset: int = 1,
    clip_sample: bool = False,
    clip_sample_range: float = 1.0,
    thresholding: bool = False,
    rescale_betas_zero_snr: bool = False,
    set_alpha_to_one: bool = False,
    trained_betas=None,
    device="cpu",
) -> DiffusionSchedule:
    """Schedule with the diffusers semantics the JAX package implements
    (defaults: the SD-family scaled_linear, leading spacing, offset 1).
    ``trained_betas`` overrides ``beta_schedule``; ``clip_sample`` clips the
    predicted x0 to ``clip_sample_range`` in :func:`to_x0_and_eps`."""
    if trained_betas is not None:
        betas = np.asarray(trained_betas, dtype=np.float64)
    elif beta_schedule == "squaredcos_cap_v2":
        betas = squaredcos_cap_v2_betas(num_train_timesteps)
    elif beta_schedule in _BETAS:
        betas = _BETAS[beta_schedule](num_train_timesteps, beta_start, beta_end)
    else:
        raise ValueError(f"unknown beta_schedule: {beta_schedule}")
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    return DiffusionSchedule(
        alphas_cumprod=torch.from_numpy(alphas_cumprod).to(device),
        num_train_timesteps=num_train_timesteps, prediction_type=prediction_type,
        timestep_spacing=timestep_spacing, steps_offset=steps_offset,
        set_alpha_to_one=set_alpha_to_one, clip_sample=clip_sample,
        clip_sample_range=clip_sample_range, thresholding=thresholding)


def sampling_timesteps(schedule: DiffusionSchedule, num_inference_steps: int) -> np.ndarray:
    """Descending integer timesteps for sampling (DDIMScheduler.set_timesteps)."""
    n_train = schedule.num_train_timesteps
    if num_inference_steps > n_train:
        raise ValueError(f"num_inference_steps {num_inference_steps} > {n_train}")
    spacing = schedule.timestep_spacing
    if spacing == "linspace":
        ts = np.linspace(0, n_train - 1, num_inference_steps).round()[::-1].astype(np.int64)
    elif spacing == "leading":
        step_ratio = n_train // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts += schedule.steps_offset
    elif spacing == "trailing":
        ts = np.round(np.arange(n_train, 0, -n_train / num_inference_steps)).astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing: {spacing}")
    return ts.copy()


def inversion_timesteps(schedule: DiffusionSchedule, num_inference_steps: int) -> np.ndarray:
    """Ascending integer timesteps for DDIM inversion
    (DDIMInverseScheduler.set_timesteps)."""
    n_train = schedule.num_train_timesteps
    spacing = schedule.timestep_spacing
    if spacing == "linspace":
        ts = np.linspace(0, n_train - 1, num_inference_steps).round().astype(np.int64)
    elif spacing == "leading":
        step_ratio = n_train // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
        ts += schedule.steps_offset
    elif spacing == "trailing":
        ts = np.round(np.arange(n_train, 0, -n_train / num_inference_steps))[::-1].astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing: {spacing}")
    return ts.copy()


def to_x0_and_eps(schedule: DiffusionSchedule, sample: torch.Tensor,
                  model_output: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_x0, pred_eps) from a model output under the prediction type, fp32."""
    x = sample.float()
    out = model_output.float()
    a_t = schedule.alpha_bar(t)
    sqrt_a, sqrt_1ma = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    p = schedule.prediction_type
    if p == "epsilon":
        x0, eps = (x - sqrt_1ma * out) / sqrt_a, out
    elif p == "sample":
        x0, eps = out, (x - sqrt_a * out) / sqrt_1ma
    elif p == "v_prediction":
        x0, eps = sqrt_a * x - sqrt_1ma * out, sqrt_a * out + sqrt_1ma * x
    else:
        raise ValueError(f"unknown prediction_type: {p}")
    if schedule.clip_sample:
        r = schedule.clip_sample_range
        x0 = torch.clamp(x0, -r, r)
        eps = (x - sqrt_a * x0) / sqrt_1ma   # eps of the clipped x0, as the JAX package
    return x0, eps


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: int) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) sample (diffusers ``add_noise``), in
    fp32, returned in ``x0``'s dtype."""
    a_t = schedule.alpha_bar(t)
    return (torch.sqrt(a_t) * x0.float() + torch.sqrt(1.0 - a_t) * noise.float()).to(x0.dtype)
