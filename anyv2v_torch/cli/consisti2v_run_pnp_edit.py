"""ConsistI2V PnP editing (counterpart of
``anyv2v_tpu/cli/consisti2v_run_pnp_edit.py``): one YAML config plus dotlist
overrides, dual text/image CFG (cfg_txt 35, cfg_img 1.0 by default),
``blend_ratio`` noise mixing and PnP thresholds 0.2/0.2/0.5. Reads either
package's inversion cache and writes the JAX CLI's output names.

Usage:
    python -m anyv2v_torch.cli.consisti2v_run_pnp_edit --device cuda \\
        --config configs/consisti2v/pnp_edit.yaml editing_prompt="..." ...

:func:`edit_video` is the per-entry function on arrays; :func:`main` is the
file/YAML/image shell around it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..pipelines.consisti2v import guidance_mode
from ..pipelines.i2vgen import PnPConfig
from ..schedulers import sampling_timesteps
from ..utils.io import load_ddim_trajectory
from .common import build_pipeline_from_config, load_frames_for_config, prompt_ids, setup_logging

logger = logging.getLogger("anyv2v_torch.consisti2v.pnp_edit")


def output_stem(cfg_txt, cfg_img, n_steps, t_idx) -> str:
    """The JAX CLI's output name for one edit."""
    return f"cfgtxt_{cfg_txt}_cfgimg_{cfg_img}_steps_{n_steps}_tidx_{t_idx}"


def edit_video(pipe, traj, inv_ts: np.ndarray, src01: np.ndarray, edited01: np.ndarray, *,
               text_ids: tuple, n_steps: int, t_idx: int, cfg_txt: float, cfg_img: float,
               pnp: PnPConfig, frame_stride: int = 3, blend_ratio: float = 0.0,
               seed: int = 0):
    """One entry: the dual-CFG PnP edit of a cached trajectory (rows with the
    clean frame 0 in front), conditioned on the source and edited first
    frames ``[H, W, 3]`` in [0, 1]. ``text_ids``: token ids of (inversion
    prompt, negative prompt, edit prompt). ``blend_ratio > 0`` mixes seeded
    noise from a ``torch.Generator`` into the start latent: the same blend as
    the JAX CLI, not its ``jax.random`` noise. Returns (latents
    ``[1, F, h, w, 4]``, video ``[F, H, W, 3]``)."""
    mode = guidance_mode(cfg_txt, cfg_img)
    inv, neg, cond = (pipe.encode_text(ids) for ids in text_ids)
    rows = {None: [inv, cond], "text": [inv, neg, cond], "both": [inv, neg, neg, cond]}[mode]
    src_ff = pipe.encode_video(np.asarray(src01, np.float32)[None])
    edited_ff = pipe.encode_video(np.asarray(edited01, np.float32)[None])

    traj = torch.as_tensor(traj, dtype=torch.float32, device=pipe.device)
    init_latent = None
    if blend_ratio > 0.0:
        start_t = int(sampling_timesteps(pipe.schedule, n_steps)[t_idx])
        base = traj[int(np.where(inv_ts == start_t)[0][0])][:, 1:]
        gen = torch.Generator(device=pipe.device).manual_seed(int(seed))
        noise = torch.randn(base.shape, generator=gen, device=pipe.device)
        init_latent = blend_ratio * noise + (1.0 - blend_ratio) * base

    latents = pipe.sample_with_pnp(
        traj, inv_ts, torch.cat(rows), edited_ff, src_ff, num_inference_steps=n_steps,
        t_idx=t_idx, cfg_txt=cfg_txt, cfg_img=cfg_img, pnp=pnp, frame_stride=frame_stride,
        init_latent=init_latent)
    return latents, pipe.decode_latents(latents)


def main(argv=None):
    from PIL import Image

    from ..utils import io as vio
    from ..utils.config import from_dotlist, load_yaml, merge, resolve

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/consisti2v/pnp_edit.yaml")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("optional_args", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_yaml(args.config)
    if args.optional_args:
        cfg = merge(cfg, from_dotlist(args.optional_args))
    cfg = resolve(cfg)
    setup_logging(bool(cfg.get("debug", False)))

    pipe, tokenizer = build_pipeline_from_config(cfg, args.device, default_arch="consisti2v")
    src = load_frames_for_config(cfg)[0]
    edited = Image.open(cfg.edited_first_frame_path).convert("RGB")
    if edited.size != src.size:
        edited = vio.center_crop_wide(edited, src.size)
    traj, inv_ts = load_ddim_trajectory(cfg.ddim_latents_path)
    cfg_txt, cfg_img = float(cfg.get("cfg_txt", 35.0)), float(cfg.get("cfg_img", 1.0))
    n_steps, t_idx = int(cfg.n_steps), int(cfg.ddim_init_latents_t_idx)
    _, video = edit_video(
        pipe, traj, inv_ts, vio.image_to_array01(src), vio.image_to_array01(edited),
        text_ids=tuple(prompt_ids(pipe, tokenizer, cfg.get(k, "")) for k in
                       ("ddim_inv_prompt", "editing_negative_prompt", "editing_prompt")),
        n_steps=n_steps, t_idx=t_idx, cfg_txt=cfg_txt, cfg_img=cfg_img,
        pnp=PnPConfig(float(cfg.get("pnp_f_t", 0.2)), float(cfg.get("pnp_spatial_attn_t", 0.2)),
                      float(cfg.get("pnp_temp_attn_t", 0.5))),
        frame_stride=int(cfg.get("frame_stride", 3)),
        blend_ratio=float(cfg.get("blend_ratio", 0.0)), seed=int(cfg.get("seed", 0)))
    video = video.cpu().numpy()
    os.makedirs(cfg.output_dir, exist_ok=True)
    stem = output_stem(cfg_txt, cfg_img, n_steps, t_idx)
    vio.save_video(video, os.path.join(cfg.output_dir, stem + ".mp4"), fps=10)
    vio.save_video(video, os.path.join(cfg.output_dir, stem + ".gif"), fps=10)
    vio.save_frames(video, os.path.join(cfg.output_dir, stem + "_frames"))
    logger.info("saved edited video to %s/%s.mp4", cfg.output_dir, stem)


if __name__ == "__main__":
    main()
