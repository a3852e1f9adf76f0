"""Euler-family schedulers of the first-frame editors (counterpart of
``anyv2v_tpu/schedulers/euler.py``):

- Euler-Ancestral (discrete, eps-prediction, "linspace" grid):
  InstructPix2Pix and MagicBrush;
- EDM Euler (log-spaced sigma 0.002-120, v-prediction, sigma_data 1):
  CosXL;
- Euler-Discrete ("leading" grid, deterministic): InstantStyle's SDXL.

The grids are host numpy, made once per run as in the JAX package. Every
per-step scalar (a sigma, a timestep, an Euler factor) is a Python float
computed here in numpy fp32 in the JAX package's order of operations, so a
step copies nothing from host memory and the tensor arithmetic sees the same
fp32 scalars as the JAX step. Latents step in fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .schedules import DiffusionSchedule

_F = np.float32


def _sigmas_full(schedule: DiffusionSchedule) -> np.ndarray:
    abar = schedule.alphas_cumprod.detach().cpu().numpy().astype(np.float64)
    return np.sqrt((1.0 - abar) / abar)


# ---------------------------------------------------------------------------
# Euler-Ancestral (InstructPix2Pix) and Euler-Discrete (InstantStyle) grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EulerAncestralGrid:
    """diffusers ``EulerAncestralDiscreteScheduler.set_timesteps`` grid (also
    ``EulerDiscreteScheduler``'s)."""

    sigmas: np.ndarray      # [n_steps + 1] fp32, descending, last element 0
    timesteps: np.ndarray   # [n_steps] fp32 (fractional under linspace)

    @property
    def init_noise_sigma(self) -> float:
        return float(np.sqrt(self.sigmas.max() ** 2 + 1.0))


def euler_ancestral_grid(schedule: DiffusionSchedule, num_steps: int) -> EulerAncestralGrid:
    T = schedule.num_train_timesteps
    timesteps = np.linspace(0, T - 1, num_steps, dtype=np.float64)[::-1].copy()
    sigmas = np.interp(timesteps, np.arange(T), _sigmas_full(schedule))
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return EulerAncestralGrid(sigmas=sigmas, timesteps=timesteps.astype(np.float32))


def euler_discrete_grid(schedule: DiffusionSchedule, num_steps: int, spacing: str = "leading",
                        steps_offset: int = 1) -> EulerAncestralGrid:
    """diffusers ``EulerDiscreteScheduler.set_timesteps``, the SDXL default:
    "leading" spacing with steps_offset 1."""
    T = schedule.num_train_timesteps
    if spacing == "leading":
        ratio = T // num_steps
        timesteps = (np.arange(num_steps) * ratio).round()[::-1].astype(np.float64)
        timesteps += steps_offset
    else:
        timesteps = np.linspace(0, T - 1, num_steps, dtype=np.float64)[::-1].copy()
    sigmas = np.interp(timesteps, np.arange(T), _sigmas_full(schedule))
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return EulerAncestralGrid(sigmas=sigmas, timesteps=timesteps.astype(np.float32))


def sigma_to_t(schedule: DiffusionSchedule, sigmas) -> np.ndarray:
    """The (fractional) train timesteps of ``sigmas`` by interpolation in log
    sigma, what diffusers' Euler schedulers feed the UNet: the JAX package's
    ``pipelines/image_edit.py::_sigma_to_t`` per element, in its fp32
    arithmetic. Made once per grid, on the host."""
    abar = schedule.alphas_cumprod.detach().cpu().numpy().astype(_F)
    log_s = np.log(np.maximum(np.sqrt((_F(1.0) - abar) / abar), _F(1e-20)))
    target = np.log(np.maximum(np.asarray(sigmas, _F), _F(1e-20)))
    idx = np.clip(np.searchsorted(log_s, target), 1, log_s.shape[0] - 1)
    lo, hi = log_s[idx - 1], log_s[idx]
    w = np.clip((target - lo) / np.maximum(hi - lo, _F(1e-20)), _F(0.0), _F(1.0))
    return ((idx - 1).astype(_F) + w).astype(_F)


def euler_scale_model_input(sample: torch.Tensor, sigma: float) -> torch.Tensor:
    """latent / sqrt(sigma^2 + 1) (diffusers ``scale_model_input``)."""
    s = _F(sigma)
    return (sample / float(np.sqrt(s * s + _F(1.0)))).to(sample.dtype)


def euler_ancestral_step(sample: torch.Tensor, model_output: torch.Tensor, sigma_from: float,
                         sigma_to: float, noise: torch.Tensor) -> torch.Tensor:
    """diffusers ``EulerAncestralDiscreteScheduler.step`` (epsilon)."""
    sf, st = _F(sigma_from), _F(sigma_to)
    sigma_up = np.sqrt(st * st * (sf * sf - st * st) / np.maximum(sf * sf, _F(1e-20)))
    sigma_down = np.sqrt(np.maximum(st * st - sigma_up * sigma_up, _F(0.0)))
    x = sample.float()
    pred_x0 = x - float(sf) * model_output.float()
    derivative = (x - pred_x0) / float(np.maximum(sf, _F(1e-20)))
    return x + derivative * float(sigma_down - sf) + noise.float() * float(sigma_up)


def euler_discrete_step(sample: torch.Tensor, model_output: torch.Tensor, sigma_from: float,
                        sigma_to: float) -> torch.Tensor:
    """Deterministic Euler step (diffusers ``EulerDiscreteScheduler.step``)."""
    sf, st = _F(sigma_from), _F(sigma_to)
    x = sample.float()
    pred_x0 = x - float(sf) * model_output.float()
    derivative = (x - pred_x0) / float(np.maximum(sf, _F(1e-20)))
    return x + derivative * float(st - sf)


# ---------------------------------------------------------------------------
# EDM Euler (CosXL)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EDMGrid:
    """CosXL's patched grid: log-spaced sigmas from sigma_max down to
    sigma_min, plus a terminal 0."""

    sigmas: np.ndarray      # [n_steps + 1] fp32, descending, last element 0
    sigma_data: float = 1.0

    @property
    def init_noise_sigma(self) -> float:
        """sqrt(sigma_max^2 + 1) (diffusers ``EDMEulerScheduler``)."""
        return float((self.sigmas.max() ** 2 + 1.0) ** 0.5)

    @staticmethod
    def timestep(sigma: float) -> float:
        """``precondition_noise``: t = 0.25 * ln(sigma), negative below 1."""
        return float(_F(0.25) * np.log(_F(sigma)))


def edm_grid(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 120.0,
             sigma_data: float = 1.0) -> EDMGrid:
    sigmas = np.exp(np.linspace(np.log(sigma_min), np.log(sigma_max), num_steps))[::-1]
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return EDMGrid(sigmas=sigmas, sigma_data=sigma_data)


def edm_scale_model_input(sample: torch.Tensor, sigma: float,
                          sigma_data: float = 1.0) -> torch.Tensor:
    """``precondition_inputs``: c_in = 1 / sqrt(sigma^2 + sigma_data^2)."""
    s, d = _F(sigma), _F(sigma_data)
    return (sample / float(np.sqrt(s * s + d * d))).to(sample.dtype)


def edm_step_v(sample: torch.Tensor, model_output: torch.Tensor, sigma_from: float,
               sigma_to: float, sigma_data: float = 1.0) -> torch.Tensor:
    """diffusers ``EDMEulerScheduler.step`` with v-prediction: denoised =
    c_skip x + c_out F(x), then an Euler step."""
    sf, st, d = _F(sigma_from), _F(sigma_to), _F(sigma_data)
    s2 = sf * sf + d * d
    c_skip = d * d / s2
    c_out = -sf * d / np.sqrt(s2)
    x = sample.float()
    denoised = float(c_skip) * x + float(c_out) * model_output.float()
    derivative = (x - denoised) / float(np.maximum(sf, _F(1e-20)))
    return x + derivative * float(st - sf)
