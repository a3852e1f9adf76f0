"""First-frame editing, AnyV2V's first stage (counterpart of
``anyv2v_tpu/cli/edit_image.py``):

    python -m anyv2v_torch.cli.edit_image --device cuda \\
        --model {instructpix2pix,magicbrush,cosxl} \\
        --video_path V | --dict_file J --input_dir D \\
        [--output_dir O] [--prompt P] [--force_512] [--seed N] [--negative_prompt S]

As the reference: only the FIRST frame of the video is edited and saved as
``<output_dir>/<prompt>.png`` at the source size; an existing result is kept
unless ``--overwrite``; the negative prompt defaults to the reference's;
``--dict_file`` maps videos to lists of ``{"image_model", "instruction"}``
entries, each with its own model. ``--arch_suffix -tiny`` selects the small
architectures (fp32), ``--init`` a ``.npz`` from
``anyv2v_torch.cli.convert_checkpoint``, ``--tokenizer_path`` a CLIP
``vocab.json`` / ``merges.txt`` pair (without it, the prompt ids are zeros:
a random-weight smoke run only). CosXL and InstantStyle run on zero text
embeddings, as the JAX CLI does, until their encoders are loaded.

:func:`edit_frame` and :func:`style_frame` are the per-frame functions on
arrays and need only torch and numpy; PIL and OpenCV are imported by the
file shells (:func:`read_first_frame`, :func:`infer_video`,
:func:`infer_video_style`, :func:`main`) alone.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

logger = logging.getLogger("anyv2v_torch.edit_image")

DEFAULT_NEGATIVE = ("worst quality, normal quality, low quality, low res, "
                    "blurry, watermark, jpeg artifacts")
STYLE_PROMPT = "masterpiece, best quality, high quality"


def read_first_frame(video_path: str):
    """The first frame (a PIL image) of a directory of PNG frames, an image
    file, or a video (OpenCV)."""
    from PIL import Image

    if os.path.isdir(video_path):
        frames = sorted(f for f in os.listdir(video_path) if f.endswith(".png"))
        if not frames:
            raise FileNotFoundError(f"no frames in {video_path}")
        return Image.open(os.path.join(video_path, frames[0])).convert("RGB")
    if video_path.endswith((".png", ".jpg", ".jpeg", ".gif")):
        return Image.open(video_path).convert("RGB")
    import cv2

    cap = cv2.VideoCapture(video_path)
    ok, frame = cap.read()
    cap.release()
    if not ok:
        raise IOError(f"could not read first frame of {video_path}")
    return Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))


def build_model(model_name: str, arch_suffix: str, init: str, seed: int, device):
    """The editor ``model_name + arch_suffix``: bf16, or fp32 for ``-tiny``."""
    from ..utils.model_zoo import build_image_edit_pipeline

    arch = model_name + arch_suffix
    dtype = torch.float32 if arch.endswith("-tiny") else torch.bfloat16
    return build_image_edit_pipeline(arch, device=device, init=init, seed=seed, dtype=dtype)


def prompt_rows(pipe, tokenizer, prompt: str, negative: str) -> torch.Tensor:
    """InstructPix2Pix's text rows ``[prompt, negative, negative]``."""
    n = pipe.text_encoder.config.max_position_embeddings
    ids = np.zeros((2, n), np.int64) if tokenizer is None else np.asarray(
        tokenizer([prompt, negative]))
    hidden = pipe.encode_text(ids)
    return torch.cat([hidden[:1], hidden[1:2], hidden[1:2]], dim=0)


def _pooled_dim(unet_cfg) -> int:
    return (unet_cfg.projection_class_embeddings_input_dim
            - 6 * unet_cfg.addition_time_embed_dim)


def edit_frame(model, image01: np.ndarray, prompt: str, tokenizer=None, seed: int = 42,
               negative_prompt: str = "", num_inference_steps: int = 100) -> np.ndarray:
    """One frame ``[H, W, 3]`` in [0, 1] through the editor: InstructPix2Pix /
    MagicBrush at guidance 7.5 / image guidance 1.5, or CosXL at guidance 7
    over at most 20 steps on zero text embeddings. Returns ``[H, W, 3]`` in
    [0, 1] (fp32, host)."""
    from ..pipelines.image_edit import CosXLEditPipeline

    if isinstance(model, CosXLEditPipeline):
        cfg = model.unet.config
        text3 = torch.zeros((3, 77, cfg.cross_attention_dim), device=model.device)
        pooled3 = torch.zeros((3, _pooled_dim(cfg)), device=model.device)
        out = model.edit(image01, text3, pooled3, seed=seed,
                         num_inference_steps=min(num_inference_steps, 20), guidance_scale=7.0)
    else:
        text3 = prompt_rows(model, tokenizer, prompt, negative_prompt)
        out = model.edit(image01, text3, num_inference_steps=num_inference_steps,
                         guidance_scale=7.5, image_guidance_scale=1.5, seed=seed)
    return out.cpu().numpy()


def style_frame(model, content01: np.ndarray, style_clip_embed=None, text_embeds2=None,
                pooled2=None, seed: int = 42, num_inference_steps: int = 30,
                control01: np.ndarray | None = None) -> np.ndarray:
    """InstantStyle on one frame ``[H, W, 3]`` in [0, 1]: its canny map (or
    ``control01``, a control image of the same size) steers the structure,
    the style embedding the IP-Adapter. Embeddings left out are zeros.
    Returns ``[H, W, 3]`` in [0, 1] (fp32, host)."""
    cfg = model.unet.config
    dev = model.device
    if style_clip_embed is None:
        style_clip_embed = torch.zeros((1, model.image_proj.proj.in_features), device=dev)
    if text_embeds2 is None:
        text_embeds2 = torch.zeros((2, 77, cfg.cross_attention_dim), device=dev)
    if pooled2 is None:
        pooled2 = torch.zeros((2, _pooled_dim(cfg)), device=dev)
    if control01 is None:
        from ..pipelines.instantstyle import canny_map

        control01 = canny_map(content01)
    out = model.generate(control01, style_clip_embed, text_embeds2, pooled2,
                         num_inference_steps=num_inference_steps, seed=seed)
    return out.cpu().numpy()


def _to_u8(image01: np.ndarray) -> np.ndarray:
    return (np.asarray(image01) * 255).astype(np.uint8)


def infer_video(model, video_path: str, output_dir: str, prompt: str, tokenizer=None,
                force_512: bool = False, seed: int = 42, negative_prompt: str = "",
                overwrite: bool = False, num_inference_steps: int = 100) -> str:
    """The reference's ``edit_image.infer_video``: the first frame only,
    saved as ``<output_dir>/<prompt>.png``."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    result_path = os.path.join(output_dir, prompt + ".png")
    if os.path.exists(result_path) and not overwrite:
        logger.info("Result already exists: %s", result_path)
        return result_path
    pil = read_first_frame(video_path)
    orig_size = pil.size
    if force_512:
        pil = pil.resize((512, 512), Image.LANCZOS)
    out = edit_frame(model, np.asarray(pil, np.float32) / 255.0, prompt, tokenizer, seed,
                     negative_prompt, num_inference_steps)
    result = Image.fromarray(_to_u8(out))
    if force_512:
        result = result.resize(orig_size, Image.LANCZOS)
    result.save(result_path)
    logger.info("Processed and saved the first frame: %s", result_path)
    return result_path


def infer_video_style(model, video_path: str, output_dir: str, prompt: str = STYLE_PROMPT,
                      style_clip_embed=None, text_embeds2=None, pooled2=None, seed: int = 42,
                      overwrite: bool = False, num_inference_steps: int = 30) -> str:
    """First-frame style transfer (the reference's ``infer_video_style``):
    the source frame's canny map controls the structure, the style image's
    CLIP embedding drives the IP-Adapter; saved as ``<prompt>.png``."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    result_path = os.path.join(output_dir, prompt + ".png")
    if os.path.exists(result_path) and not overwrite:
        logger.info("Result already exists: %s", result_path)
        return result_path
    first = np.asarray(read_first_frame(video_path), np.float32) / 255.0
    out = style_frame(model, first, style_clip_embed, text_embeds2, pooled2, seed,
                      num_inference_steps)
    Image.fromarray(_to_u8(out)).save(result_path)
    logger.info("Processed and saved the styled first frame: %s", result_path)
    return result_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="First-frame image editing")
    parser.add_argument("--model", type=str, default="instructpix2pix",
                        choices=["magicbrush", "instructpix2pix", "cosxl"])
    parser.add_argument("--video_path", type=str, default=None)
    parser.add_argument("--input_dir", type=str, default="./demo/")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--prompt", type=str, default="turn the man into darth vader")
    parser.add_argument("--force_512", action="store_true")
    parser.add_argument("--dict_file", type=str, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--negative_prompt", type=str, default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--arch_suffix", type=str, default="",
                        help="'-tiny' selects the small architectures")
    parser.add_argument("--init", type=str, default="random",
                        help="'random' or a .npz from anyv2v_torch.cli.convert_checkpoint")
    parser.add_argument("--tokenizer_path", type=str, default=None)
    parser.add_argument("--num_inference_steps", type=int, default=100)
    argv = list(sys.argv[1:] if argv is None else argv)
    for i, a in enumerate(argv[:-1]):   # "--arch_suffix -tiny": a value that looks like a flag
        if a == "--arch_suffix":
            argv[i:i + 2] = [f"--arch_suffix={argv[i + 1]}"]
            break
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    negative = DEFAULT_NEGATIVE if args.negative_prompt is None else args.negative_prompt
    tokenizer = None
    if args.tokenizer_path:
        from ..utils.tokenizer import CLIPTokenizer

        tokenizer = CLIPTokenizer(os.path.join(args.tokenizer_path, "vocab.json"),
                                  os.path.join(args.tokenizer_path, "merges.txt"))
    models = {}

    def model_for(name):
        if name not in models:
            models[name] = build_model(name, args.arch_suffix, args.init, args.seed, args.device)
        return models[name]

    if args.dict_file:
        with open(args.dict_file) as f:
            folders_info = json.load(f)
        for video_name, video_infos in folders_info.items():
            video_path = os.path.join(args.input_dir, video_name)
            for info in video_infos:
                prompt = info.get("instruction") or info.get("target_caption")
                if prompt is None:
                    continue
                out_dir = args.output_dir or os.path.dirname(video_path)
                infer_video(model_for(info.get("image_model", args.model)), video_path,
                            out_dir, prompt, tokenizer, args.force_512, args.seed, negative,
                            args.overwrite, args.num_inference_steps)
    else:
        out_dir = args.output_dir or os.path.dirname(args.video_path)
        infer_video(model_for(args.model), args.video_path, out_dir, args.prompt, tokenizer,
                    args.force_512, args.seed, negative, args.overwrite,
                    args.num_inference_steps)


if __name__ == "__main__":
    main()
