"""DDIM as diffusers defines it (``DDIMScheduler`` / ``DDIMInverseScheduler``,
eta 0, epsilon prediction), the PnP injection schedule of AnyV2V, and the
noising that makes a cached trajectory, in float32 on the host's or the
device's tensors. ``cfg`` is the configuration file's ``scheduler`` object."""

from __future__ import annotations

import numpy as np
import torch


def alphas_cumprod(cfg: dict) -> np.ndarray:
    """float32 cumulative alphas of the beta schedule (built in float64)."""
    n, b0, b1 = cfg["num_train_timesteps"], cfg["beta_start"], cfg["beta_end"]
    if cfg["beta_schedule"] == "scaled_linear":
        betas = np.linspace(b0 ** 0.5, b1 ** 0.5, n, dtype=np.float64) ** 2
    elif cfg["beta_schedule"] == "linear":
        betas = np.linspace(b0, b1, n, dtype=np.float64)
    else:
        raise ValueError(f"beta_schedule {cfg['beta_schedule']!r}")
    return np.cumprod(1.0 - betas).astype(np.float32)


def sampling_timesteps(cfg: dict, steps: int) -> np.ndarray:
    """Descending "leading" timesteps plus the offset."""
    if cfg["timestep_spacing"] != "leading":
        raise ValueError("only the leading spacing is configured")
    ratio = cfg["num_train_timesteps"] // steps
    return (np.arange(steps) * ratio)[::-1].astype(np.int64) + cfg["steps_offset"]


def inversion_timesteps(cfg: dict, steps: int) -> np.ndarray:
    return sampling_timesteps(cfg, steps)[::-1].copy()


def alpha_bar(cfg: dict, t: int) -> float:
    """alphas_cumprod[t]; before the grid (t < 0) the final alpha, which is
    alphas_cumprod[0] unless ``set_alpha_to_one``."""
    ac = alphas_cumprod(cfg)
    if t >= 0:
        return float(ac[min(t, len(ac) - 1)])
    return 1.0 if cfg["set_alpha_to_one"] else float(ac[0])


def transfer(cfg: dict, x: torch.Tensor, eps: torch.Tensor, t_from: int, t_to: int):
    """x0 and eps from ``x`` at alpha_bar(t_from), recomposed at t_to."""
    a, a_to = (torch.tensor(alpha_bar(cfg, t), dtype=torch.float32, device=x.device)
               for t in (t_from, t_to))
    x0 = (x - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)
    return torch.sqrt(a_to) * x0 + torch.sqrt(1.0 - a_to) * eps


def ddim_step(cfg: dict, x, eps, t: int, t_prev: int):
    return transfer(cfg, x, eps, t, t_prev)


def ddim_inverse_step(cfg: dict, x, eps, t: int, steps: int):
    """Onto the ascending grid value ``t`` from ``t - n_train // steps``."""
    n = cfg["num_train_timesteps"]
    return transfer(cfg, x, eps, min(t - n // steps, n - 1), t)


def add_noise(cfg: dict, x0, noise, t: int):
    a = torch.tensor(alpha_bar(cfg, t), dtype=torch.float32, device=x0.device)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def injection_mask(ts: np.ndarray, threshold: float, steps: int) -> np.ndarray:
    """PnP injects on the first ``int(steps * threshold)`` steps of the full
    grid, and at t = 1000."""
    m = np.zeros(len(ts), bool)
    m[:int(steps * threshold)] = True
    return m | (np.asarray(ts) == 1000)


def edit_plan(cfg: dict, steps: int, t_idx: int, thresholds) -> list:
    """The edit's steps from ``t_idx`` on: ``(t, t_prev, flags)`` where
    ``flags`` is the (conv, spatial, temporal) injection, or None once every
    injection has ended (the source row is then dropped from the batch)."""
    ts = sampling_timesteps(cfg, steps)
    masks = np.stack([injection_mask(ts, thr, steps) for thr in thresholds])[:, t_idx:]
    ts = ts[t_idx:]
    on = np.nonzero(masks.any(axis=0))[0]
    k_inj = int(on[-1]) + 1 if len(on) else 0
    ratio = cfg["num_train_timesteps"] // steps
    return [(int(t), int(t) - ratio,
             tuple(bool(m) for m in masks[:, i]) if i < k_inj else None)
            for i, t in enumerate(ts)]
