"""Batch DDIM inversion (counterpart of
``anyv2v_tpu/cli/run_group_ddim_inversion.py``): template YAML + group JSON,
per-entry skip-if-exists, static-video / null-image ablations, optional
reconstruction with a PSNR report. Writes the same ``ddim_latents_{t}.npy``
cache as the JAX CLI.

Usage:
    python -m anyv2v_torch.cli.run_group_ddim_inversion --device cuda \\
        --template_config configs/group_ddim_inversion/template.yaml \\
        --configs_json   configs/group_ddim_inversion/group_config.json

:func:`invert_video` is the per-entry function on arrays; :func:`main` is the
file/YAML/image shell around it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..pipelines.common import host_array
from ..utils.io import save_ddim_trajectory
from .common import (build_pipeline_from_config, clip_input, load_frames_for_config,
                     prompt_ids, setup_logging)

logger = logging.getLogger("anyv2v_torch.inversion")


def invert_video(pipe, frames01: np.ndarray, *, text_ids: np.ndarray, n_steps: int,
                 fps: int = 8, clip_width: int | None = None, output_dir: str | None = None,
                 static_video: bool = False, null_image: bool = False,
                 chunk_steps: int | None = None, traj_store: str = "device"):
    """One entry: VAE-encode ``frames01 [F, H, W, 3]``, invert ``n_steps``, and
    (with ``output_dir``) write the latent cache. ``traj_store="host"`` keeps
    the trajectory in host memory (``chunk_steps`` steps per device -> host
    copy), the long-video route; the cache is then written from there.
    Returns (latents, trajectory, inversion timesteps, text embeds, image
    latents, image embeds)."""
    frames01 = np.asarray(frames01, np.float32)
    if static_video:
        frames01 = np.repeat(frames01[:1], len(frames01), axis=0)
    first = np.zeros_like(frames01[0]) if null_image else frames01[0]
    latents = pipe.encode_video(frames01)
    text = pipe.encode_text(text_ids)
    img_lat = pipe.prepare_image_latents(first, len(frames01))
    img_emb = pipe.encode_image_clip(clip_input(pipe, first, clip_width or frames01.shape[2]))
    traj, inv_ts = pipe.invert(latents, text, img_lat, img_emb,
                               num_inversion_steps=n_steps, fps=fps,
                               chunk_steps=chunk_steps, traj_store=traj_store)
    if output_dir is not None:
        save_ddim_trajectory(output_dir, host_array(traj), inv_ts)
        logger.info("saved %d-step trajectory to %s", len(inv_ts), output_dir)
    return latents, traj, inv_ts, text, img_lat, img_emb


def reconstruct(pipe, tokenizer, cfg, latents, traj, inv_ts, img_lat, img_emb):
    """Optional DDIM reconstruction from the cache, with a PSNR report and an
    opt-in ``recon_config.min_psnr`` gate."""
    from ..utils import io as vio
    from ..utils.metrics import video_report

    from ..schedulers import sampling_timesteps

    rc = cfg.recon_config
    t_idx = int(rc.get("ddim_init_latents_t_idx", 0))
    start_t = int(sampling_timesteps(pipe.schedule, int(rc.n_steps))[t_idx])
    row = int(np.where(inv_ts == start_t)[0][0])
    cfg_scale = float(rc.get("cfg", 9.0))
    text = pipe.encode_text(prompt_ids(pipe, tokenizer, rc.get("prompt", "")))
    n_rows = 1
    if cfg_scale > 1.0:
        neg = pipe.encode_text(prompt_ids(pipe, tokenizer, rc.get("negative_prompt", "")))
        text, n_rows = torch.cat([neg, text]), 2
    recon = pipe.sample(traj[row], text, img_lat.repeat(n_rows, 1, 1, 1, 1),
                        img_emb.repeat(n_rows, 1, 1), num_inference_steps=int(rc.n_steps),
                        t_idx=t_idx, guidance_scale=cfg_scale,
                        fps=int(rc.get("target_fps", 8)))
    video = pipe.decode_latents(recon).cpu().numpy()
    out = os.path.join(cfg.output_dir, "ddim_reconstruction.mp4")
    vio.save_video(video, out, fps=int(rc.get("target_fps", 8)))
    report = video_report(video, pipe.decode_latents(latents).cpu().numpy())
    logger.info("reconstruction vs source decode: PSNR %.2f dB, SSIM %.4f -> %s",
                report["psnr"], report["ssim"], out)
    min_psnr = rc.get("min_psnr", None)
    if min_psnr is not None and report["psnr"] < float(min_psnr):
        raise RuntimeError(f"reconstruction PSNR {report['psnr']:.2f} dB below the "
                           f"min_psnr gate {float(min_psnr):.2f} dB")
    return report["psnr"]


def main(argv=None):
    from ..utils import io as vio
    from ..utils.config import load_group_configs, load_yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--template_config", default="configs/group_ddim_inversion/template.yaml")
    parser.add_argument("--configs_json", default="configs/group_ddim_inversion/group_config.json")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)

    setup_logging(bool(load_yaml(args.template_config).get("debug", False)))
    configs = load_group_configs(args.template_config, args.configs_json)
    logger.info("loaded %d active configs", len(configs))
    pipe = tokenizer = None
    for cfg in configs:
        inv = cfg.inverse_config
        if os.path.exists(os.path.join(inv.output_dir, "ddim_trajectory.npz")) and not cfg.get(
                "force_recompute_latents", False):
            logger.info("skip %s: latents exist (force_recompute_latents to redo)", cfg.video_name)
            continue
        if pipe is None:
            pipe, tokenizer = build_pipeline_from_config(cfg, args.device)
        frames01 = vio.frames_to_array01(load_frames_for_config(cfg))
        latents, traj, inv_ts, _, img_lat, img_emb = invert_video(
            pipe, frames01, text_ids=prompt_ids(pipe, tokenizer, inv.get("prompt", "")),
            n_steps=int(inv.n_steps), fps=int(inv.get("target_fps", 8)),
            clip_width=int(cfg.image_size[0]), output_dir=inv.output_dir,
            static_video=bool(inv.get("inverse_static_video", False)),
            null_image=bool(inv.get("null_image_inversion", False)),
            chunk_steps=None if inv.get("chunk_steps") is None else int(inv.chunk_steps),
            traj_store=str(inv.get("traj_store", "device")))
        if cfg.get("recon_config", {}).get("enable_recon", False):
            reconstruct(pipe, tokenizer, cfg, latents, traj, inv_ts, img_lat, img_emb)


if __name__ == "__main__":
    main()
