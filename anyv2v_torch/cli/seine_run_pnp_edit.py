"""SEINE PnP editing (counterpart of ``anyv2v_tpu/cli/seine_run_pnp_edit.py``):
one YAML config plus dotlist overrides; reads either package's inversion
cache, builds the masked conditioning from the SOURCE first frame for the
source row and from the EDITED first frame for the edit rows, runs the DDPM
sampler (cache read at t + 1) at cfg_scale 4 with the four PnP threshold
families (conv, spatial, temporal, cross), and writes the JAX CLI's outputs
``edited_video.mp4``, ``edited_video.gif`` and ``frames/``.

Usage:
    python -m anyv2v_torch.cli.seine_run_pnp_edit --device cuda \\
        --config configs/seine/pnp_edit.yaml prompt="a cat" ...

The DDPM noise comes from a ``torch.Generator`` seeded with ``seed``, not
from ``jax.random``: the same seed gives another (equally valid) edit than
the JAX CLI. :func:`edit_video` is the per-entry function on arrays;
:func:`main` is the file/YAML/image shell around it.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..pipelines.seine import SeinePnPConfig
from ..utils.io import load_ddim_trajectory
from .common import build_pipeline_from_config, load_frames_for_config, prompt_ids, setup_logging

logger = logging.getLogger("anyv2v_torch.seine.pnp_edit")


def edit_video(pipe, traj, traj_ts: np.ndarray, src01: np.ndarray, edited01: np.ndarray, *,
               n_frames: int, text_ids: tuple, n_steps: int, cfg_scale: float = 4.0,
               sampler: str = "ddpm", pnp: Optional[SeinePnPConfig] = None, seed: int = 1):
    """One entry: the PnP edit of a cached trajectory conditioned on the
    source and edited first frames ``[H, W, 3]`` in [0, 1]. ``text_ids``:
    token ids of (inversion prompt, edit prompt, negative prompt), the text
    rows ``[inv, cond, uncond]``. Returns (latents ``[1, F, h, w, 4]``,
    video ``[F, H, W, 3]``)."""
    mask, masked_src = pipe.build_masked_inputs(src01, n_frames)
    _, masked_edit = pipe.build_masked_inputs(edited01, n_frames)
    text_all = torch.cat([pipe.encode_text(ids) for ids in text_ids])
    latents = pipe.sample_with_pnp(
        traj, traj_ts, text_all, mask, masked_edit, masked_src, num_inference_steps=n_steps,
        cfg_scale=cfg_scale, sampler=sampler, pnp=pnp, seed=seed)
    return latents, pipe.decode_latents(latents)


def main(argv=None):
    from PIL import Image

    from ..utils import io as vio
    from ..utils.config import from_dotlist, load_yaml, merge, resolve

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/seine/pnp_edit.yaml")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("optional_args", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = load_yaml(args.config)
    if args.optional_args:
        cfg = merge(cfg, from_dotlist(args.optional_args))
    cfg = resolve(cfg)
    setup_logging(bool(cfg.get("debug", False)))

    pipe, tokenizer = build_pipeline_from_config(cfg, args.device, default_arch="seine")
    if "video_path" not in cfg and "src_video_path" in cfg:
        cfg["video_path"] = cfg["src_video_path"]
    n_frames = int(cfg.get("n_frames", 16))
    cfg.setdefault("n_frames", n_frames)
    src01 = vio.frames_to_array01(load_frames_for_config(cfg)[:n_frames])[0]
    size = (int(cfg.image_size[0]), int(cfg.image_size[1]))
    edited = Image.open(cfg.edited_first_frame_path).convert("RGB").resize(size, Image.LANCZOS)
    traj, traj_ts = load_ddim_trajectory(cfg.ddim_inversion_dir)
    pnp = SeinePnPConfig(
        conv=float(cfg.get("pnp_f_t", 0.2)),
        spatial=float(cfg.get("pnp_spatial_attn_t", 0.2)),
        temporal=float(cfg.get("pnp_temp_attn_t", 0.5)),
        cross=float(cfg.get("pnp_cross_attn_t", 0.0)),
    ) if bool(cfg.get("enable_pnp", True)) else SeinePnPConfig(0.0, 0.0, 0.0, 0.0)
    _, video = edit_video(
        pipe, traj, traj_ts, src01, vio.image_to_array01(edited), n_frames=n_frames,
        text_ids=tuple(prompt_ids(pipe, tokenizer, cfg.get(k, "")) for k in
                       ("inversion_prompt", "prompt", "negative_prompt")),
        n_steps=int(cfg.get("n_steps", 50)), cfg_scale=float(cfg.get("cfg_scale", 4.0)),
        sampler=str(cfg.get("sample_method", "ddpm")), pnp=pnp, seed=int(cfg.get("seed", 1)))
    video = video.cpu().numpy()
    out_dir = cfg.output_dir
    os.makedirs(out_dir, exist_ok=True)
    vio.save_video(video, os.path.join(out_dir, "edited_video.mp4"), fps=8)
    vio.save_video(video, os.path.join(out_dir, "edited_video.gif"), fps=8)
    vio.save_frames(video, os.path.join(out_dir, "frames"))
    logger.info("saved edited video to %s", out_dir)


if __name__ == "__main__":
    main()
