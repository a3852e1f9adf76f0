"""The gradio demos (counterpart of ``anyv2v_tpu/product/gradio_app.py``;
the reference's ``gradio_demo.py``, ``gradio_demo_style.py`` and
``gradio_demo_cosxl.py``): three stages, preprocess the video, edit its
first frame, run AnyV2V, wired to the in-process runner.

``build_demo`` imports gradio when it is called and raises ``ImportError``
without it; ``run_headless`` runs the same three stages without a UI (the
tests and the demo CLI's ``--headless``). Defaults as ``gradio_demo.py:365-379``:
inversion 500 steps, 50 sampling steps, cfg 9, t_idx 0, PnP 0.2 / 0.2 / 0.5.
The style variant takes up to 128 frames (reference README:182).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger("anyv2v_torch.gradio")

DEFAULTS = dict(
    ddim_inversion_steps=500,
    num_inference_steps=50,
    guidance_scale=9.0,
    ddim_init_latents_t_idx=0,
    conv_inj=0.2,
    spatial_inj=0.2,
    temp_inj=0.5,
    seed=42,
)

# the editor of each demo variant (reference: gradio_demo / _style / _cosxl)
EDITOR_FOR_VARIANT = {
    "instructpix2pix": "instructpix2pix",
    "style": "instantstyle",
    "cosxl": "cosxl",
}


def run_headless(
    video_path: str,
    prompt: str,
    instruct_prompt: str,
    variant: str = "instructpix2pix",
    negative_prompt: str = "",
    out_dir: Optional[str] = None,
    preprocess: Optional[dict] = None,
    runner_kwargs: Optional[dict] = None,
    editor_kwargs: Optional[dict] = None,
    editor: Optional[str] = None,
    device: str = "cuda",
    **overrides,
) -> str:
    """The three gradio stages without a UI, on ``device``; returns the edited
    video's path. The editor (``editor``, else the variant's; bf16, or fp32
    for a ``-tiny`` arch, unless ``editor_kwargs`` say otherwise) and the
    runner are built on every call, as in the JAX package. The editor runs
    ``image_edit_steps`` (default 20): CosXL at most 20, InstantStyle at
    most 30 on the frame's canny map, both on zero embeddings."""
    import numpy as np
    import torch
    from PIL import Image

    from ..cli.edit_image import edit_frame, read_first_frame, style_frame
    from ..pipelines.instantstyle import InstantStylePipeline
    from ..utils.io import image_to_array01
    from ..utils.model_zoo import build_image_edit_pipeline
    from ..utils.video_prep import crop_and_resize_video
    from .anyv2v import AnyV2VRunner

    out_dir = out_dir or os.path.join(os.path.dirname(video_path), "anyv2v_out")
    os.makedirs(out_dir, exist_ok=True)

    # Stage 1: preprocess (btn_preprocess_video_fn, gradio_demo.py:240-256)
    if preprocess:
        video_path = crop_and_resize_video(
            video_path, os.path.join(out_dir, "preprocessed"), **preprocess) or video_path

    # Stage 2: first-frame edit (the image-edit button, :259-275)
    name = editor or EDITOR_FOR_VARIANT.get(variant, variant)
    dtype = torch.float32 if name.endswith("-tiny") else torch.bfloat16
    model = build_image_edit_pipeline(name, device=device,
                                      **{"dtype": dtype, **(editor_kwargs or {})})
    image01 = image_to_array01(read_first_frame(video_path))
    steps = overrides.pop("image_edit_steps", 20)
    if isinstance(model, InstantStylePipeline):
        edited = style_frame(model, image01, num_inference_steps=min(steps, 30))
    else:
        edited = edit_frame(model, image01, instruct_prompt, negative_prompt=negative_prompt,
                            num_inference_steps=steps)
    edited_path = os.path.join(out_dir, "edited_first_frame.png")
    Image.fromarray((edited * 255).astype(np.uint8)).save(edited_path)

    # Stage 3: AnyV2V (btn_infer_fn, :278)
    runner = AnyV2VRunner(**{"device": device, **(runner_kwargs or {})})
    return runner.perform_anyv2v(
        video_path=video_path, video_prompt=prompt, video_negative_prompt=negative_prompt,
        edited_first_frame_path=edited_path, out_dir=out_dir, **{**DEFAULTS, **overrides})


def build_demo(variant: str = "instructpix2pix", runner_kwargs: Optional[dict] = None,
               device: str = "cuda"):
    """The gradio Blocks app (needs gradio)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use run_headless() or the CLI's --headless mode for "
            "the same flow") from e

    max_frames = 128 if variant == "style" else 16  # README:182 long-video UI

    with gr.Blocks(title=f"AnyV2V ({variant})") as demo:
        gr.Markdown(f"# AnyV2V — GPU ({variant})")
        with gr.Row():
            video_in = gr.Video(label="Source video")
            video_out = gr.Video(label="Edited video")
        prompt = gr.Textbox(label="Video prompt")
        instruct = gr.Textbox(label="First-frame edit instruction")
        negative = gr.Textbox(label="Negative prompt", value="")
        with gr.Accordion("Advanced", open=False):
            steps = gr.Slider(1, 100, value=DEFAULTS["num_inference_steps"],
                              step=1, label="Sampling steps")
            cfg = gr.Slider(1.0, 20.0, value=DEFAULTS["guidance_scale"],
                            label="Guidance scale")
            t_idx = gr.Slider(0, 10, value=DEFAULTS["ddim_init_latents_t_idx"],
                              step=1, label="ddim_init_latents_t_idx")
            conv = gr.Slider(0.0, 1.0, value=DEFAULTS["conv_inj"], label="pnp_f_t")
            spat = gr.Slider(0.0, 1.0, value=DEFAULTS["spatial_inj"],
                             label="pnp_spatial_attn_t")
            temp = gr.Slider(0.0, 1.0, value=DEFAULTS["temp_inj"],
                             label="pnp_temp_attn_t")
            seed = gr.Number(value=DEFAULTS["seed"], label="Seed", precision=0)
        btn = gr.Button("Run AnyV2V")

        def _run(video, p, ip, np_, st, cf, ti, cj, sj, tj, sd):
            return run_headless(
                video, p, ip, variant=variant, negative_prompt=np_,
                num_inference_steps=int(st), guidance_scale=float(cf),
                ddim_init_latents_t_idx=int(ti), conv_inj=float(cj),
                spatial_inj=float(sj), temp_inj=float(tj), seed=int(sd),
                runner_kwargs=runner_kwargs, device=device,
            )

        btn.click(_run,
                  inputs=[video_in, prompt, instruct, negative, steps, cfg,
                          t_idx, conv, spat, temp, seed],
                  outputs=[video_out])
        gr.Markdown(f"Max length: {max_frames} frames.")
    return demo
