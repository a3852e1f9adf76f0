"""In-process AnyV2V: the engine behind the gradio demos and the predictor
(counterpart of ``anyv2v_tpu/product/anyv2v.py``).

Rebuilds the reference's ``gradio_demo.py:79-222``
(``AnyV2V_I2VGenXL.perform_anyv2v``): inversion and the PnP edit in one
process, on the i2vgen-xl backbone, with the demo's defaults (inversion 500
steps, 50 sampling steps, cfg 9, t_idx 0, PnP 0.2 / 0.2 / 0.5).

Two levels:

- :meth:`AnyV2VRunner.edit_arrays` works on arrays and needs only torch and
  numpy: the source frames and the edited first frame in, the edited video
  out. The trajectory stays a device tensor between the two stages.
- :meth:`AnyV2VRunner.perform_anyv2v` is the reference's file-level call: a
  directory of PNG frames or a video, and the edited first frame as an image
  file, in; ``edited_video.mp4`` (and, on request, the latent cache) out.
  PIL and OpenCV are imported there alone.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..cli.common import _DTYPES, prompt_ids
from ..cli.run_group_ddim_inversion import invert_video
from ..cli.run_group_pnp_edit import edit_video
from ..pipelines.i2vgen import PnPConfig

logger = logging.getLogger("anyv2v_torch.product")


def read_frames01(video_path: str) -> np.ndarray:
    """``[F, H, W, 3]`` in [0, 1] from a directory of PNG frames (PIL) or a
    video file (OpenCV)."""
    if os.path.isdir(video_path):
        from PIL import Image

        from ..utils.io import image_to_array01

        names = sorted(f for f in os.listdir(video_path) if f.endswith(".png"))
        return np.stack([image_to_array01(Image.open(os.path.join(video_path, n)))
                         for n in names])
    from ..utils.video_prep import _read_video

    frames, _ = _read_video(video_path)
    return frames.astype(np.float32) / 255.0


@dataclass
class AnyV2VRunner:
    """Holds a built pipeline, so that request after request skips building
    it again (the reference re-loads its pipeline on every click,
    ``gradio_demo.py:96-100``). ``mesh``: the pipeline's frames shard over
    it (:func:`anyv2v_torch.parallel.mesh.make_mesh`); every rank then makes
    the same calls and gets the same edit."""

    arch: str = "i2vgen-xl"
    init: str = "random"
    dtype: str = "bfloat16"
    seed: int = 42
    tokenizer_path: Optional[str] = None
    device: str = "cuda"
    mesh: object = None
    _pipe: object = field(default=None, repr=False)
    _tokenizer: object = field(default=None, repr=False)

    def pipeline(self):
        """The pipeline, built on the first call and the same object on every
        later one. It takes no shape: unlike the JAX runner's, whose
        ``pipeline(image_size, n_frames)`` fixes the shapes of its first
        build, the port's pipeline runs any frame count and size."""
        if self._pipe is None:
            from ..utils.model_zoo import build_i2vgen_pipeline

            self._pipe = build_i2vgen_pipeline(self.arch, device=self.device, init=self.init,
                                               seed=self.seed, dtype=_DTYPES[self.dtype],
                                               mesh=self.mesh)
            if self.tokenizer_path:
                from ..utils.tokenizer import CLIPTokenizer

                self._tokenizer = CLIPTokenizer(
                    os.path.join(self.tokenizer_path, "vocab.json"),
                    os.path.join(self.tokenizer_path, "merges.txt"),
                    max_length=self._pipe.text_encoder.config.max_position_embeddings)
        return self._pipe

    def edit_arrays(self, frames01, edited01, video_prompt: str,
                    video_negative_prompt: str = "", conv_inj: float = 0.2,
                    spatial_inj: float = 0.2, temp_inj: float = 0.5,
                    num_inference_steps: int = 50, guidance_scale: float = 9.0,
                    ddim_init_latents_t_idx: int = 0, ddim_inversion_steps: int = 500,
                    seed: int = 42, random_ratio: float = 0.0, target_fps: int = 8,
                    noise=None):
        """AnyV2V on arrays: DDIM-invert ``frames01 [F, H, W, 3]`` (inversion
        prompt ""), then PnP-edit it towards ``edited01 [H, W, 3]`` (both in
        [0, 1]) with the CFG rows [source, negative, prompt], from the
        trajectory's latent at the sampling grid's step ``t_idx`` (at most
        ``num_inference_steps - 1``), blended with noise by ``random_ratio``
        (``noise``: a draw of the latent's shape, else one from a
        ``torch.Generator`` seeded with ``seed``). Returns (video ``[F, H, W,
        3]`` in [0, 1] on the device, the trajectory on the device, its
        timesteps)."""
        pipe = self.pipeline()
        frames01 = np.ascontiguousarray(frames01, np.float32)
        width = frames01.shape[2]
        t_idx = min(ddim_init_latents_t_idx, num_inference_steps - 1)
        ids = {p: prompt_ids(pipe, self._tokenizer, p)
               for p in ("", video_negative_prompt, video_prompt)}
        _, traj, inv_ts, *_ = invert_video(
            pipe, frames01, text_ids=ids[""], n_steps=ddim_inversion_steps, fps=target_fps,
            clip_width=width)
        _, video = edit_video(
            pipe, traj, inv_ts, frames01[0], np.ascontiguousarray(edited01, np.float32),
            text_ids=(ids[""], ids[video_negative_prompt], ids[video_prompt]),
            n_frames=len(frames01), n_steps=num_inference_steps, t_idx=t_idx,
            guidance_scale=guidance_scale, pnp=PnPConfig(conv_inj, spatial_inj, temp_inj),
            fps=target_fps, clip_width=width, random_ratio=random_ratio, seed=seed,
            noise=noise)
        return video, traj, inv_ts

    def perform_anyv2v(self, video_path: str, video_prompt: str, video_negative_prompt: str,
                       edited_first_frame_path: str, out_dir: Optional[str] = None,
                       save_latents: bool = False, **kwargs) -> str:
        """The whole of AnyV2V from files; returns the edited video's path.
        Without ``out_dir`` the run writes to ``<tempdir>/AnyV2V``, emptied
        first. The edited first frame is resized to the video's size
        (LANCZOS); ``save_latents`` writes the trajectory as the
        ``ddim_latents`` cache. ``kwargs``: those of :meth:`edit_arrays`."""
        from PIL import Image

        from ..pipelines.common import host_array
        from ..utils import io as vio

        tmp_dir = out_dir or os.path.join(tempfile.gettempdir(), "AnyV2V")
        if os.path.exists(tmp_dir) and out_dir is None:
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir, exist_ok=True)

        frames01 = read_frames01(video_path)
        size = (frames01.shape[2], frames01.shape[1])
        edited = Image.open(edited_first_frame_path).convert("RGB").resize(size, Image.LANCZOS)
        video, traj, inv_ts = self.edit_arrays(frames01, vio.image_to_array01(edited),
                                               video_prompt, video_negative_prompt, **kwargs)
        if save_latents:
            vio.save_ddim_trajectory(os.path.join(tmp_dir, "ddim_latents"), host_array(traj),
                                     inv_ts)
        output_path = os.path.join(tmp_dir, "edited_video.mp4")
        vio.save_video(video.cpu().numpy(), output_path, fps=kwargs.get("target_fps", 8))
        logger.info("edited video saved to %s", output_path)
        return output_path


def perform_anyv2v(**kwargs) -> str:
    """Functional one-shot wrapper: builds a runner from the runner's fields
    among ``kwargs`` and runs :meth:`AnyV2VRunner.perform_anyv2v` on the
    rest."""
    runner_keys = {"arch", "init", "dtype", "seed", "tokenizer_path", "device"}
    runner = AnyV2VRunner(**{k: v for k, v in kwargs.items() if k in runner_keys})
    return runner.perform_anyv2v(**{k: v for k, v in kwargs.items() if k not in runner_keys})
