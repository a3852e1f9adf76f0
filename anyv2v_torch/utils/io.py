"""The two-phase latent cache with numpy alone (the same files as
``anyv2v_tpu/utils/io.py``, which also needs PIL): ``ddim_trajectory.npz``,
``meta.json`` and one ``ddim_latents_{t}.npy`` per inversion timestep, latents
channels-last ``[1, F, h, w, C]`` fp32."""

from __future__ import annotations

import json
import os
import re
from typing import Tuple

import numpy as np

_LATENT_RE = re.compile(r"ddim_latents_(\d+)\.npy$")


def save_ddim_trajectory(out_dir: str, trajectory: np.ndarray, timesteps: np.ndarray) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "ddim_trajectory.npz"),
             trajectory=trajectory.astype(np.float32),
             timesteps=np.asarray(timesteps, np.int64))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"layout": "BFHWC", "n_steps": int(len(timesteps))}, f)
    for i, t in enumerate(timesteps):
        np.save(os.path.join(out_dir, f"ddim_latents_{int(t)}.npy"), trajectory[i])


def load_ddim_trajectory(cache_dir: str, per_step_files: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (trajectory ``[n, 1, F, h, w, C]``, ascending timesteps ``[n]``),
    from the consolidated file, or from the ``ddim_latents_{t}.npy`` files
    when there is none or ``per_step_files`` is set."""
    consolidated = os.path.join(cache_dir, "ddim_trajectory.npz")
    if os.path.exists(consolidated) and not per_step_files:
        data = np.load(consolidated)
        return data["trajectory"], data["timesteps"]
    entries = sorted((int(m.group(1)), name) for name in os.listdir(cache_dir)
                     if (m := _LATENT_RE.search(name)))
    if not entries:
        raise FileNotFoundError(f"no ddim latents found in {cache_dir}")
    ts = np.array([t for t, _ in entries], np.int64)
    traj = np.stack([np.load(os.path.join(cache_dir, n)) for _, n in entries])
    return traj, ts
