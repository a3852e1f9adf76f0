"""Shared CLI plumbing (counterpart of ``anyv2v_tpu/cli/common.py``).

Everything here works on arrays and needs only torch and numpy; YAML, PIL,
OpenCV and imageio are imported by the CLI shells' ``main`` functions alone,
so the per-entry functions run where those packages are absent.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..models.clip import preprocess_clip_image
from ..utils.model_zoo import (
    build_consisti2v_pipeline,
    build_i2vgen_pipeline,
    build_seine_pipeline,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def setup_logging(debug: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s - %(levelname)s - [%(funcName)s] - %(message)s")


def build_pipeline_from_config(cfg, device, default_arch: str = "i2vgen-xl"):
    """(pipeline, tokenizer or None) from a config's ``model:`` section: an
    i2vgen, ConsistI2V or SEINE pipeline, by the ``arch`` it names. SEINE's
    configs give the schedule's betas at their top level."""
    model = cfg.get("model", {})
    arch = model.get("arch", default_arch)
    scheduler = dict(model.get("scheduler", {}))
    if arch.startswith("seine"):
        build = build_seine_pipeline
        scheduler.update({k: cfg[k] for k in ("beta_start", "beta_end", "beta_schedule")
                          if k in cfg})
    elif arch.startswith("consisti2v"):
        build = build_consisti2v_pipeline
    else:
        build = build_i2vgen_pipeline
    pipe = build(
        arch, device=device, init=model.get("init", "random"),
        seed=int(cfg.get("seed", 0)), dtype=_DTYPES[model.get("dtype", "bfloat16")],
        scheduler_kwargs=scheduler)
    tokenizer = None
    tok_path = model.get("tokenizer_path")
    if tok_path:
        from ..utils.tokenizer import CLIPTokenizer

        tokenizer = CLIPTokenizer(
            os.path.join(tok_path, "vocab.json"), os.path.join(tok_path, "merges.txt"),
            max_length=pipe.text_encoder.config.max_position_embeddings)
    return pipe, tokenizer


def prompt_ids(pipe, tokenizer, prompt: str) -> np.ndarray:
    """Token ids ``[1, L]``; without a tokenizer (random-weight runs) zeros,
    the JAX CLIs' placeholder."""
    if tokenizer is None:
        return np.zeros((1, pipe.text_encoder.config.max_position_embeddings), np.int64)
    return np.asarray(tokenizer([prompt]))


def clip_input(pipe, image01: np.ndarray, width: int) -> torch.Tensor:
    """The CLIP image input: centre crop to ``width x width`` after scaling
    the short relative side to fit, bilinear resize to the encoder's size,
    CLIP normalisation. ``[H, W, 3]`` in [0, 1] -> ``[1, S, S, 3]``."""
    size = pipe.vision_encoder.config.image_size
    x = torch.as_tensor(np.asarray(image01, np.float32), device=pipe.device)
    x = x.permute(2, 0, 1)[None]
    h, w = x.shape[-2:]
    scale = max(width / w, width / h)
    if (round(h * scale), round(w * scale)) != (h, w):
        x = F.interpolate(x, size=(round(h * scale), round(w * scale)), mode="bilinear",
                          align_corners=False, antialias=True)
    h, w = x.shape[-2:]
    y0, x0 = (h - width) // 2, (w - width) // 2
    x = x[..., y0:y0 + width, x0:x0 + width]
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return preprocess_clip_image(x.permute(0, 2, 3, 1))


def load_frames_for_config(cfg) -> list:
    """PIL frames from ``video_frames_path``, else extracted from
    ``video_path`` (needs PIL and OpenCV: CLI shells only)."""
    from ..utils import io as vio

    size = (int(cfg.image_size[0]), int(cfg.image_size[1]))
    n = int(cfg.n_frames)
    frames_path = cfg.get("video_frames_path", "ReplaceMe")
    if frames_path and frames_path != "ReplaceMe" and os.path.isdir(frames_path):
        return vio.load_video_frames(frames_path, n, size)
    video_path = cfg.get("video_path", "ReplaceMe")
    if video_path and video_path != "ReplaceMe" and os.path.exists(video_path):
        out_dir = os.path.join(cfg.output_dir, "frames")
        vio.convert_video_to_frames(video_path, out_dir, size)
        return vio.load_video_frames(out_dir, n, size)
    raise FileNotFoundError(
        f"neither video_frames_path ({frames_path}) nor video_path ({video_path}) exists")
