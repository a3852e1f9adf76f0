"""Batch PnP editing (counterpart of ``anyv2v_tpu/cli/run_group_pnp_edit.py``):
reads the inverted-latent cache (from either package's inversion CLI),
assembles the 3-way CFG conditioning, runs the PnP edit and saves
mp4/gif/pngs under the same config-derived names.

Usage:
    python -m anyv2v_torch.cli.run_group_pnp_edit --device cuda \\
        --template_config configs/group_pnp_edit/template.yaml \\
        --configs_json   configs/group_pnp_edit/group_config.json

:func:`edit_video` is the per-entry function on arrays; :func:`main` is the
file/YAML/image shell around it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..pipelines.common import HostTrajectory
from ..pipelines.i2vgen import PnPConfig
from ..schedulers import sampling_timesteps
from ..utils.io import load_ddim_trajectory
from .common import (build_pipeline_from_config, clip_input, load_frames_for_config,
                     prompt_ids, setup_logging)

logger = logging.getLogger("anyv2v_torch.pnp_edit")


def output_stem(cfg_scale, n_steps, t_idx, pnp_f_t, pnp_spatial_attn_t, pnp_temp_attn_t) -> str:
    """The JAX CLI's output name for one edit."""
    return (f"cfg_{cfg_scale}_steps_{n_steps}_tidx_{t_idx}"
            f"_pnpf_{pnp_f_t}_pnps_{pnp_spatial_attn_t}_pnpt_{pnp_temp_attn_t}")


def edit_video(pipe, traj, inv_ts: np.ndarray, src01: np.ndarray, edited01: np.ndarray, *,
               text_ids: tuple, n_frames: int, n_steps: int, t_idx: int,
               guidance_scale: float, pnp: PnPConfig, fps: int = 8,
               clip_width: int | None = None, random_ratio: float = 0.0, seed: int = 0,
               noise=None):
    """One entry: the PnP edit of a cached trajectory, conditioned on the
    source first frame ``src01`` and the edited first frame ``edited01``
    (``[H, W, 3]`` in [0, 1]). ``text_ids``: token ids of (inversion prompt,
    negative prompt, edit prompt). ``traj``: a host array (the cache as read
    from disk) or a :class:`HostTrajectory`, of which only the rows the edit
    reads reach the device, or a device tensor. ``random_ratio`` blends the
    initial latent with ``noise`` (a draw of its shape), or with a draw from a
    ``torch.Generator`` seeded with ``seed`` when ``noise`` is None. Returns
    (latents ``[1, F, h, w, 4]``, video ``[F, H, W, 3]``)."""
    width = clip_width or src01.shape[1]
    text_all = torch.cat([pipe.encode_text(ids) for ids in text_ids])
    lat_src = pipe.prepare_image_latents(src01, n_frames)
    lat_edit = pipe.prepare_image_latents(edited01, n_frames)
    emb_src = pipe.encode_image_clip(clip_input(pipe, src01, width))
    emb_edit = pipe.encode_image_clip(clip_input(pipe, edited01, width))

    if not torch.is_tensor(traj) and not isinstance(traj, HostTrajectory):
        # a cache read from disk: the edit moves only the rows it reads
        traj = HostTrajectory.from_array(traj, pipe.device)
    start_t = int(sampling_timesteps(pipe.schedule, n_steps)[t_idx])
    init_latent = traj[int(np.where(inv_ts == start_t)[0][0])]
    if random_ratio > 0.0:
        if noise is None:
            # torch's generator: the same blend as the JAX CLI, not its noise
            gen = torch.Generator(device=pipe.device).manual_seed(int(seed))
            noise = torch.randn(init_latent.shape, generator=gen, device=pipe.device)
        init_latent = random_ratio * pipe._tensor(noise) + (1.0 - random_ratio) * init_latent

    latents = pipe.sample_with_pnp(
        traj, inv_ts, text_all,
        torch.cat([lat_src, lat_edit, lat_edit]), torch.cat([emb_src, emb_edit, emb_edit]),
        num_inference_steps=n_steps, t_idx=t_idx, guidance_scale=guidance_scale,
        pnp=pnp, fps=fps, init_latent=init_latent)
    return latents, pipe.decode_latents(latents)


def main(argv=None):
    from PIL import Image

    from ..utils import io as vio
    from ..utils.config import load_group_configs, load_yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--template_config", default="configs/group_pnp_edit/template.yaml")
    parser.add_argument("--configs_json", default="configs/group_pnp_edit/group_config.json")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)

    setup_logging(bool(load_yaml(args.template_config).get("debug", False)))
    configs = load_group_configs(args.template_config, args.configs_json)
    logger.info("loaded %d active configs", len(configs))
    pipe = tokenizer = None
    for cfg in configs:
        required = ["video_name", "edited_video_name", "editing_prompt",
                    "edited_first_frame_path"]
        bad = [k for k in required if cfg.get(k) == "ReplaceMe"]
        if cfg.get("video_path") == "ReplaceMe" and cfg.get("video_frames_path") == "ReplaceMe":
            bad.append("video_path|video_frames_path")
        if bad:
            logger.error("skipping entry with unresolved placeholders: %s", bad)
            continue
        if pipe is None:
            pipe, tokenizer = build_pipeline_from_config(cfg, args.device)
        src = load_frames_for_config(cfg)[0]
        edited = Image.open(cfg.edited_first_frame_path).convert("RGB")
        if edited.size != src.size:
            edited = vio.center_crop_wide(edited, src.size)
        traj, inv_ts = load_ddim_trajectory(cfg.ddim_latents_path)
        n_steps, t_idx = int(cfg.n_steps), int(cfg.ddim_init_latents_t_idx)
        pnp_f = cfg.get("pnp_f_t", 0.2)
        pnp_s = cfg.get("pnp_spatial_attn_t", 0.2)
        pnp_t = cfg.get("pnp_temp_attn_t", 0.5)
        fps = int(cfg.get("target_fps", 8))
        _, video = edit_video(
            pipe, traj, inv_ts, vio.image_to_array01(src), vio.image_to_array01(edited),
            text_ids=tuple(prompt_ids(pipe, tokenizer, cfg.get(k, "")) for k in
                           ("ddim_inv_prompt", "editing_negative_prompt", "editing_prompt")),
            n_frames=int(cfg.n_frames), n_steps=n_steps, t_idx=t_idx,
            guidance_scale=float(cfg.cfg),
            pnp=PnPConfig(float(pnp_f), float(pnp_s), float(pnp_t)), fps=fps,
            clip_width=int(cfg.image_size[0]),
            random_ratio=float(cfg.get("random_ratio", 0.0)), seed=int(cfg.get("seed", 0)))
        video = video.cpu().numpy()
        os.makedirs(cfg.output_dir, exist_ok=True)
        stem = output_stem(cfg.cfg, n_steps, t_idx, pnp_f, pnp_s, pnp_t)
        vio.save_video(video, os.path.join(cfg.output_dir, stem + ".mp4"), fps=fps)
        vio.save_video(video, os.path.join(cfg.output_dir, stem + ".gif"), fps=fps)
        vio.save_frames(video, os.path.join(cfg.output_dir, stem + "_frames"))
        logger.info("saved edited video to %s/%s.mp4", cfg.output_dir, stem)


if __name__ == "__main__":
    main()
