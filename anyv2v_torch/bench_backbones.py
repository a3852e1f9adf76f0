"""The benchmark of :mod:`anyv2v_torch.bench` for ConsistI2V and SEINE
(counterpart of the repository's ``scripts/bench_backbones.py``).

    python -m anyv2v_torch.bench_backbones [consisti2v] [seine]

The same protocol and workload at the shipped configurations' step counts
(500-step inversion + 50-step PnP edit at 16 frames, 512^2, seeded random
bf16 UNet and VAE, inputs from ``np.random.RandomState(0)``): ConsistI2V's
edit at cfg_txt 35 / cfg_img 1 (a 3-row CFG batch), SEINE's a DDPM edit at
cfg 4 (noise seeded 7). Projected from warm short scans unless
``BENCH_FULL=1``. Prints one JSON line per backbone (argv picks a subset;
default both) with the keys of :mod:`anyv2v_torch.bench`, and writes no
file.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .bench import (EDIT_MEASURE, EDIT_STEPS, INV_MEASURE, INV_STEPS, WARM_STEPS, log, record,
                    scan, step_counts, vae_times)


def _inputs(pipe, frames: int, size: int, text_tokens: int):
    dim = pipe.unet.config.cross_attention_dim
    rng = np.random.RandomState(0)
    frames01 = rng.rand(frames, size, size, 3).astype(np.float32)
    text = torch.from_numpy(rng.randn(1, text_tokens, dim).astype(np.float32) * 0.02)
    return frames01, text


def bench_consisti2v(device="cuda", arch: str = "consisti2v", frames: int = 16, size: int = 512,
                     full: bool = False, inv_steps: int = INV_MEASURE,
                     edit_steps: int = EDIT_MEASURE, warm_steps: int = WARM_STEPS) -> dict:
    """The workload on ConsistI2V, with seeded random bf16 UNet and VAE;
    frame 0 of the clip is its conditioning frame. Returns its JSON record."""
    from .utils.model_zoo import build_consisti2v_pipeline

    log(f"building pipeline arch={arch}")
    pipe = build_consisti2v_pipeline(arch, device=device, seed=0, dtype=torch.bfloat16,
                                     components=("unet", "vae"))
    frames01, text = _inputs(pipe, frames, size, 77)
    latents, t_enc, t_dec = vae_times(lambda: pipe.encode_video(frames01), pipe.decode_latents)
    n_inv, n_edit = step_counts(full, inv_steps, edit_steps)
    (traj, inv_ts), t_inv = scan(
        "consisti2v invert", lambda n: pipe.invert(latents, text, num_inversion_steps=n),
        n_inv, INV_STEPS, warm_steps)
    ff = latents[:, :1]
    _, t_edit = scan(
        "consisti2v edit",
        lambda n: pipe.sample_with_pnp(traj, inv_ts, torch.cat([text] * 3), ff, ff,
                                       num_inference_steps=n, t_idx=max(0, n // 10 - 1),
                                       cfg_txt=35.0, cfg_img=1.0),
        n_edit, EDIT_STEPS, warm_steps)
    return record(arch, frames, size, full, pipe.device, t_inv, t_edit, t_enc, t_dec)


def bench_seine(device="cuda", arch: str = "seine", frames: int = 16, size: int = 512,
                full: bool = False, inv_steps: int = INV_MEASURE,
                edit_steps: int = EDIT_MEASURE, warm_steps: int = WARM_STEPS) -> dict:
    """The workload on SEINE, with seeded random bf16 UNet and VAE: frame 0
    unmasked, the others masked; the trajectory kept at half the inversion
    grid. Returns its JSON record."""
    from .utils.model_zoo import build_seine_pipeline

    log(f"building pipeline arch={arch}")
    pipe = build_seine_pipeline(arch, device=device, seed=0, dtype=torch.bfloat16,
                                components=("unet", "vae"))
    frames01, text = _inputs(pipe, frames, size, 120)
    latents, t_enc, t_dec = vae_times(lambda: pipe.encode_video(frames01), pipe.decode_latents)
    mask = torch.ones(latents.shape[:-1] + (1,), device=latents.device)
    mask[:, 0] = 0.0
    masked = latents * (1.0 - mask)
    n_inv, n_edit = step_counts(full, inv_steps, edit_steps)
    (traj, traj_ts), t_inv = scan(
        "seine invert",
        lambda n: pipe.invert(latents, mask, masked, text, num_inversion_steps=n,
                              num_save_steps=max(n // 2, 1)),
        n_inv, INV_STEPS, warm_steps)
    _, t_edit = scan(
        "seine edit",
        lambda n: pipe.sample_with_pnp(traj, traj_ts, torch.cat([text] * 3), mask, masked,
                                       masked, num_inference_steps=n, cfg_scale=4.0,
                                       sampler="ddpm", seed=7),
        n_edit, EDIT_STEPS, warm_steps)
    return record(arch, frames, size, full, pipe.device, t_inv, t_edit, t_enc, t_dec)


BACKBONES = {"consisti2v": bench_consisti2v, "seine": bench_seine}


def main(argv=None) -> None:
    full = os.environ.get("BENCH_FULL", "0") == "1"
    for name in (sys.argv[1:] if argv is None else argv) or list(BACKBONES):
        print(json.dumps(BACKBONES[name](full=full)), flush=True)


if __name__ == "__main__":
    main()
