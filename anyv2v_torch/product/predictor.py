"""Replicate-style prediction service (counterpart of
``anyv2v_tpu/product/predictor.py``; the reference's Cog ``predict.py``).

``setup`` builds the video pipeline and the first-frame editor once;
``predict`` answers one request: the first frame edited by InstructPix2Pix,
then AnyV2V (inversion and the PnP edit), with the reference's defaults
(PnP thresholds 1.0 / 1.0 / 1.0, ``predict.py:107-121``; 100 editor steps;
500 inversion and 50 sampling steps). The reference's weight download maps
to converted checkpoint files (``init``).

:meth:`Predictor.predict_arrays` answers on arrays (torch and numpy only);
:meth:`Predictor.predict` on files, as the reference does.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Optional

import numpy as np

from ..cli.edit_image import DEFAULT_NEGATIVE, build_model, edit_frame
from .anyv2v import AnyV2VRunner

logger = logging.getLogger("anyv2v_torch.predictor")


class Predictor:
    """setup() once, predict() per request: the Cog interface."""

    def setup(self, arch: str = "i2vgen-xl", init: str = "random",
              image_edit_arch: str = "instructpix2pix", image_edit_init: str = "random",
              tokenizer_path: Optional[str] = None, device: str = "cuda") -> None:
        """Builds the runner's pipeline (bf16) and the editor (bf16, or fp32
        for a ``-tiny`` arch) on ``device``."""
        t0 = time.time()
        self.runner = AnyV2VRunner(arch=arch, init=init, tokenizer_path=tokenizer_path,
                                   device=device)
        self.runner.pipeline()
        self.image_editor = build_model(image_edit_arch, "", image_edit_init, 0, device)
        self.tokenizer = None
        if tokenizer_path:
            from ..utils.tokenizer import CLIPTokenizer

            self.tokenizer = CLIPTokenizer(os.path.join(tokenizer_path, "vocab.json"),
                                           os.path.join(tokenizer_path, "merges.txt"))
        logger.info("setup took %.1f s", time.time() - t0)

    def edit_first_frame(self, image01, instruct_prompt: str,
                         video_negative_prompt: str = DEFAULT_NEGATIVE,
                         image_edit_steps: int = 100, seed: int = 42) -> np.ndarray:
        """Stage 1: ``image01 [H, W, 3]`` in [0, 1] edited by the instruction
        (guidance 7.5, image guidance 1.5), on the host."""
        return edit_frame(self.image_editor, np.asarray(image01, np.float32), instruct_prompt,
                          self.tokenizer, seed=seed, negative_prompt=video_negative_prompt,
                          num_inference_steps=image_edit_steps)

    def predict_arrays(self, frames01, instruct_prompt: str, video_prompt: str,
                       video_negative_prompt: str = DEFAULT_NEGATIVE,
                       num_inference_steps: int = 50, guidance_scale: float = 9.0,
                       pnp_f_t: float = 1.0, pnp_spatial_attn_t: float = 1.0,
                       pnp_temp_attn_t: float = 1.0, ddim_init_latents_t_idx: int = 0,
                       ddim_inversion_steps: int = 500, image_edit_steps: int = 100,
                       seed: int = 42):
        """One request on arrays: ``frames01 [F, H, W, 3]`` in [0, 1]. Returns
        (the edited video ``[F, H, W, 3]`` on the device, the edited first
        frame ``[H, W, 3]`` on the host)."""
        edited01 = self.edit_first_frame(frames01[0], instruct_prompt, video_negative_prompt,
                                         image_edit_steps, seed)
        video, _, _ = self.runner.edit_arrays(
            frames01, edited01, video_prompt, video_negative_prompt, conv_inj=pnp_f_t,
            spatial_inj=pnp_spatial_attn_t, temp_inj=pnp_temp_attn_t,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            ddim_init_latents_t_idx=ddim_init_latents_t_idx,
            ddim_inversion_steps=ddim_inversion_steps, seed=seed)
        return video, edited01

    def predict(self, video_path: str, instruct_prompt: str, video_prompt: str,
                video_negative_prompt: str = DEFAULT_NEGATIVE, num_inference_steps: int = 50,
                guidance_scale: float = 9.0, pnp_f_t: float = 1.0,
                pnp_spatial_attn_t: float = 1.0, pnp_temp_attn_t: float = 1.0,
                ddim_init_latents_t_idx: int = 0, ddim_inversion_steps: int = 500,
                image_edit_steps: int = 100, seed: int = 42,
                out_dir: Optional[str] = None) -> str:
        """One request on files: the video's first frame edited and written as
        ``edited_first_frame.png``, then the file-level runner. Returns the
        edited video's path."""
        from PIL import Image

        from ..cli.edit_image import read_first_frame
        from ..utils.io import image_to_array01

        t0 = time.time()
        out_dir = out_dir or tempfile.mkdtemp(prefix="anyv2v_predict_")
        os.makedirs(out_dir, exist_ok=True)

        edited = self.edit_first_frame(image_to_array01(read_first_frame(video_path)),
                                       instruct_prompt, video_negative_prompt,
                                       image_edit_steps, seed)
        edited_path = os.path.join(out_dir, "edited_first_frame.png")
        Image.fromarray((edited * 255).astype(np.uint8)).save(edited_path)
        logger.info("first-frame edit done at %.1f s", time.time() - t0)

        result = self.runner.perform_anyv2v(
            video_path=video_path, video_prompt=video_prompt,
            video_negative_prompt=video_negative_prompt, edited_first_frame_path=edited_path,
            conv_inj=pnp_f_t, spatial_inj=pnp_spatial_attn_t, temp_inj=pnp_temp_attn_t,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            ddim_init_latents_t_idx=ddim_init_latents_t_idx,
            ddim_inversion_steps=ddim_inversion_steps, seed=seed, out_dir=out_dir)
        logger.info("predict finished in %.1f s", time.time() - t0)
        return result
