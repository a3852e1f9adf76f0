"""SEINE DDIM inversion (counterpart of
``anyv2v_tpu/cli/seine_run_ddim_inversion.py``): one YAML config plus dotlist
overrides, the "first1" masked-video conditioning, a 500-step inversion whose
latents are kept on the 250-step save grid, the provenance files
``inversion_prompts.yaml`` and ``config.yaml``, and the reconstruction pass
(DDIM, cfg 1, no injection) with its PSNR report and ``min_psnr`` gate.
Writes the same ``ddim_latents_{t}.npy`` cache as the JAX CLI.

Usage:
    python -m anyv2v_torch.cli.seine_run_ddim_inversion --device cuda \\
        --config configs/seine/ddim_inversion.yaml exp_name=run1 ...

:func:`invert_video` and :func:`reconstruct` are the per-entry functions on
arrays; :func:`main` is the file/YAML shell around them.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..pipelines.seine import SeinePnPConfig
from ..utils.io import save_ddim_trajectory
from .common import build_pipeline_from_config, load_frames_for_config, prompt_ids, setup_logging

logger = logging.getLogger("anyv2v_torch.seine.inversion")


def invert_video(pipe, frames01: np.ndarray, *, text_ids: np.ndarray, n_steps: int,
                 n_save_steps: int = 250, output_dir: str | None = None):
    """One entry: VAE-encode ``frames01 [F, H, W, 3]`` in [0, 1], build the
    masked conditioning from frame 0, invert ``n_steps`` keeping the
    ``n_save_steps`` grid, and (with ``output_dir``) write the latent cache.
    Returns (latents ``[1, F, h, w, 4]``, trajectory, its timesteps)."""
    frames01 = np.asarray(frames01, np.float32)
    latents = pipe.encode_video(frames01)
    mask, masked = pipe.build_masked_inputs(frames01[0], frames01.shape[0])
    traj, traj_ts = pipe.invert(latents, mask, masked, pipe.encode_text(text_ids),
                                num_inversion_steps=n_steps, num_save_steps=n_save_steps)
    if output_dir is not None:
        save_ddim_trajectory(output_dir, traj.cpu().numpy(), traj_ts)
        logger.info("saved %d/%d-step trajectory to %s", len(traj_ts), n_steps, output_dir)
    return latents, traj, traj_ts


def reconstruct(pipe, frames01: np.ndarray, latents, traj, traj_ts, *, text_ids: np.ndarray,
                n_save_steps: int, output_dir: str | None = None, min_psnr=None):
    """Resample the video from the cached trajectory: DDIM at cfg 1 with no
    injection, 50 steps (or ``n_save_steps`` when 50 does not divide it, so
    the grid lies on the save grid). Logs the PSNR against the source decode
    and raises below ``min_psnr``; with ``output_dir`` writes
    ``ddim_reconstruction.mp4``. Returns (video ``[F, H, W, 3]``, PSNR)."""
    from ..utils.metrics import psnr

    frames01 = np.asarray(frames01, np.float32)
    mask, masked = pipe.build_masked_inputs(frames01[0], frames01.shape[0])
    text = pipe.encode_text(text_ids)
    out = pipe.sample_with_pnp(
        traj, traj_ts, torch.cat([text, text, text]), mask, masked, masked,
        num_inference_steps=50 if n_save_steps % 50 == 0 else n_save_steps,
        cfg_scale=1.0, sampler="ddim", pnp=SeinePnPConfig(0.0, 0.0, 0.0, 0.0))
    video = pipe.decode_latents(out).cpu().numpy()
    if output_dir is not None:
        from ..utils import io as vio

        vio.save_video(video, os.path.join(output_dir, "ddim_reconstruction.mp4"), fps=8)
    p = psnr(video, pipe.decode_latents(latents).cpu().numpy())
    logger.info("reconstruction PSNR vs source decode: %.2f dB", p)
    if min_psnr is not None and p < float(min_psnr):
        raise RuntimeError(f"reconstruction PSNR {p:.2f} dB below the min_psnr gate "
                           f"{float(min_psnr):.2f} dB")
    return video, p


def main(argv=None):
    from ..utils import io as vio
    from ..utils.config import from_dotlist, load_yaml, merge, resolve, to_yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/seine/ddim_inversion.yaml")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("optional_args", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_yaml(args.config)
    if args.optional_args:
        cfg = merge(cfg, from_dotlist(args.optional_args))
    cfg = resolve(cfg)
    setup_logging(bool(cfg.get("debug", False)))

    pipe, tokenizer = build_pipeline_from_config(cfg, args.device, default_arch="seine")
    # the reference's key names: src_video_path / n_frame_to_invert
    if "video_path" not in cfg and "src_video_path" in cfg:
        cfg["video_path"] = cfg["src_video_path"]
    if "n_frames" not in cfg:
        cfg["n_frames"] = cfg.get("n_frame_to_invert", 16)
    frames = load_frames_for_config(cfg)
    frames01 = vio.frames_to_array01(frames[:int(cfg.get("n_frame_to_invert", len(frames)))])
    prompt = cfg.get("inversion_prompt", "")
    ids = prompt_ids(pipe, tokenizer, prompt)
    n_save = int(cfg.get("n_save_steps", 250))
    out_dir = cfg.output_dir
    latents, traj, traj_ts = invert_video(pipe, frames01, text_ids=ids, n_steps=int(cfg.n_steps),
                                          n_save_steps=n_save, output_dir=out_dir)
    with open(os.path.join(out_dir, "inversion_prompts.yaml"), "w") as f:
        f.write(to_yaml({"inversion_prompt": prompt}))
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        f.write(to_yaml(dict(cfg)))
    if bool(cfg.get("enable_recon", True)):
        reconstruct(pipe, frames01, latents, traj, traj_ts, text_ids=ids, n_save_steps=n_save,
                    output_dir=out_dir, min_psnr=cfg.get("min_psnr", None))


if __name__ == "__main__":
    main()
