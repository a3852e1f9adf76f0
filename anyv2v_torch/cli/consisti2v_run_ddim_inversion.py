"""ConsistI2V DDIM inversion (counterpart of
``anyv2v_tpu/cli/consisti2v_run_ddim_inversion.py``): one YAML config plus
dotlist overrides, cfg_txt = cfg_img = 1, frame stride 3, and an optional
reconstruction with a PSNR report and gif/mp4 outputs. Writes the same
``ddim_latents_{t}.npy`` cache as the JAX CLI.

Usage:
    python -m anyv2v_torch.cli.consisti2v_run_ddim_inversion --device cuda \\
        --config configs/consisti2v/ddim_inversion.yaml video_name=square ...

:func:`invert_video` is the per-entry function on arrays; :func:`main` is the
file/YAML/image shell around it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..pipelines.consisti2v import guidance_mode
from ..schedulers import sampling_timesteps
from ..utils.io import save_ddim_trajectory
from .common import build_pipeline_from_config, load_frames_for_config, prompt_ids, setup_logging

logger = logging.getLogger("anyv2v_torch.consisti2v.inversion")


def invert_video(pipe, frames01: np.ndarray, *, text_ids: np.ndarray, n_steps: int,
                 frame_stride: int = 3, output_dir: str | None = None):
    """One entry: VAE-encode ``frames01 [F, H, W, 3]`` (frame 0 is the
    conditioning frame), invert ``n_steps``, and (with ``output_dir``) write
    the latent cache. Returns (latents ``[1, F, h, w, 4]``, trajectory,
    inversion timesteps)."""
    latents = pipe.encode_video(np.asarray(frames01, np.float32))
    traj, inv_ts = pipe.invert(latents, pipe.encode_text(text_ids),
                               num_inversion_steps=n_steps, frame_stride=frame_stride)
    if output_dir is not None:
        save_ddim_trajectory(output_dir, traj.cpu().numpy(), inv_ts)
        logger.info("saved %d-step trajectory to %s", len(inv_ts), output_dir)
    return latents, traj, inv_ts


def text_rows(pipe, tokenizer, mode, cond: str, neg: str):
    """Text embeddings of the guidance mode's rows: [cond], [neg, cond] or
    [neg, neg, cond]."""
    rows = {None: [cond], "text": [neg, cond], "both": [neg, neg, cond]}[mode]
    return torch.cat([pipe.encode_text(prompt_ids(pipe, tokenizer, p)) for p in rows])


def reconstruct(pipe, tokenizer, cfg, latents, traj, inv_ts):
    """Plain generation from the cached latent at ``timesteps[t_idx]``, with a
    PSNR report against the source decode and an opt-in ``min_psnr`` gate."""
    from ..utils import io as vio
    from ..utils.metrics import psnr

    rc = cfg.recon_config
    t_idx = int(rc.get("ddim_init_latents_t_idx", 0))
    cfg_txt, cfg_img = float(rc.get("cfg_txt", 1.0)), float(rc.get("cfg_img", 1.0))
    mode = guidance_mode(cfg_txt, cfg_img)
    ts = sampling_timesteps(pipe.schedule, int(rc.n_steps))
    row = int(np.where(inv_ts == int(ts[t_idx]))[0][0])
    out = pipe.sample(
        latents[:, :1], text_rows(pipe, tokenizer, mode, rc.get("prompt", ""),
                                  rc.get("negative_prompt", "")),
        num_frames=int(cfg.n_frames), num_inference_steps=int(rc.n_steps),
        cfg_txt=cfg_txt, cfg_img=cfg_img, frame_stride=int(rc.get("frame_stride", 3)),
        noise_sampling_method=str(rc.get("noise_sampling_method", "vanilla")),
        noise_alpha=float(rc.get("noise_alpha", 1.0)),
        use_frameinit=bool(rc.get("use_frameinit", False)),
        frameinit_noise_level=int(rc.get("frameinit_noise_level", 999)),
        init_latent=traj[row], t_idx=t_idx)
    video = pipe.decode_latents(out).cpu().numpy()
    os.makedirs(cfg.output_dir, exist_ok=True)
    for ext in (".mp4", ".gif"):
        vio.save_video(video, os.path.join(cfg.output_dir, "ddim_reconstruction" + ext), fps=10)
    p = psnr(video, pipe.decode_latents(latents).cpu().numpy())
    logger.info("reconstruction PSNR vs source decode: %.2f dB", p)
    min_psnr = rc.get("min_psnr", None)
    if min_psnr is not None and p < float(min_psnr):
        raise RuntimeError(f"reconstruction PSNR {p:.2f} dB below the min_psnr gate "
                           f"{float(min_psnr):.2f} dB")
    return p


def main(argv=None):
    from ..utils import io as vio
    from ..utils.config import from_dotlist, load_yaml, merge, resolve

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/consisti2v/ddim_inversion.yaml")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("optional_args", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_yaml(args.config)
    if args.optional_args:
        cfg = merge(cfg, from_dotlist(args.optional_args))
    cfg = resolve(cfg)
    setup_logging(bool(cfg.get("debug", False)))

    pipe, tokenizer = build_pipeline_from_config(cfg, args.device, default_arch="consisti2v")
    inv = cfg.inverse_config
    latents, traj, inv_ts = invert_video(
        pipe, vio.frames_to_array01(load_frames_for_config(cfg)),
        text_ids=prompt_ids(pipe, tokenizer, inv.get("prompt", "")), n_steps=int(inv.n_steps),
        frame_stride=int(inv.get("frame_stride", 3)), output_dir=inv.output_dir)
    rc = cfg.get("recon_config")
    if rc and rc.get("enable_recon", True):
        reconstruct(pipe, tokenizer, cfg, latents, traj, inv_ts)


if __name__ == "__main__":
    main()
