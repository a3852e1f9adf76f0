"""First-frame image editors (counterpart of
``anyv2v_tpu/pipelines/image_edit.py``):

- :class:`InstructPix2PixPipeline`: SD1.5 instruct-pix2pix, and MagicBrush
  (the same architecture and recipe with other weights). 100 Euler-Ancestral
  steps, guidance 7.5, image guidance 1.5. The CFG batch has three rows:
  text ``[prompt, negative, negative]``, conditioning-image latent
  ``[img, img, zeros]``, and eps = uncond + s_txt (text - image) + s_img
  (image - uncond). The conditioning latent is the VAE posterior mode, NOT
  multiplied by the scaling factor (the diffusers ip2p convention); the
  noisy latent is scaled per step as usual.
- :class:`CosXLEditPipeline`: SDXL 8-channel instruct edit on the EDM Euler
  schedule (sigma 0.002-120, v-prediction), 1024^2, 20 steps, guidance 7,
  image guidance 1.5.

The JAX package's jitted ``lax.scan`` programs become Python step loops
(:meth:`edit_scan`), which take the initial latent and the per-step noises
as arguments, as the JAX ``_edit_scan`` does; without ``noises`` the
ancestral noise is drawn on the device from the run's ``torch.Generator``.
Every per-step scalar is a Python float (``schedulers/euler.py``), so a step
copies nothing from host memory. The latent is fp32; the UNet computes in
its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.vae import mode_from_moments
from ..schedulers import DiffusionSchedule
from ..schedulers.euler import (
    EDMGrid,
    edm_grid,
    edm_scale_model_input,
    edm_step_v,
    euler_ancestral_grid,
    euler_ancestral_step,
    euler_scale_model_input,
    sigma_to_t,
)
from .common import LatentCodecMixin


class ImageCodecMixin(LatentCodecMixin):
    """The editors' VAE side: the unscaled posterior mode of ``[N, H, W, 3]``
    images in [0, 1], and latents decoded to images in [0, 1]."""

    @torch.inference_mode()
    def encode_mode(self, image01) -> torch.Tensor:
        """``[N, H, W, 3]`` -> the UNSCALED posterior mode ``[N, h, w, 4]``, fp32."""
        x = self._tensor(image01) * 2.0 - 1.0
        return mode_from_moments(self.vae.encode_moments(x)).float()

    def decode(self, latents) -> torch.Tensor:
        """``[N, h, w, 4]`` -> ``[N, H, W, 3]`` in [0, 1], fp32."""
        return self._decode(self._tensor(latents))

    def _noise(self, shape, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))


def _cfg_rows(image_latent: torch.Tensor) -> torch.Tensor:
    """The conditioning-image rows of the CFG batch: [img, img, zeros]."""
    return torch.cat([image_latent, image_latent, torch.zeros_like(image_latent)], dim=0)


def _dual_guidance(out3: torch.Tensor, cfg_txt: float, cfg_img: float) -> torch.Tensor:
    """uncond + s_txt (text - image) + s_img (image - uncond) of the rows
    [text, image, uncond]."""
    e_txt, e_img, e_unc = out3.chunk(3, dim=0)
    return e_unc + cfg_txt * (e_txt - e_img) + cfg_img * (e_img - e_unc)


@dataclasses.dataclass
class InstructPix2PixPipeline(ImageCodecMixin):
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_encoder: Optional[torch.nn.Module]
    schedule: DiffusionSchedule
    device: torch.device
    dtype: torch.dtype = torch.bfloat16

    @torch.inference_mode()
    def edit_scan(self, init_latent, image_latent, text_embeds3, sigmas, cfg_txt: float,
                  cfg_img: float, noises=None, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """``len(sigmas) - 1`` Euler-Ancestral steps from ``init_latent
        [1, h, w, 4]`` with the conditioning latent ``image_latent [1, h, w,
        4]`` and text rows ``[3, S, D]``. ``noises [n, 1, h, w, 4]``: the
        per-step ancestral noise; None draws it from ``generator``."""
        sigmas = np.asarray(sigmas, np.float32)
        ts = sigma_to_t(self.schedule, sigmas[:-1])
        img_rows = _cfg_rows(self._tensor(image_latent))
        text3 = self._tensor(text_embeds3, self.dtype)
        x = self._tensor(init_latent)
        for i in range(len(sigmas) - 1):
            sigma = float(sigmas[i])
            scaled = euler_scale_model_input(x, sigma)
            inp3 = torch.cat([scaled.expand(3, -1, -1, -1), img_rows], dim=-1)
            eps3 = self.unet(inp3, float(ts[i]), text3).float()
            noise = (self._noise(x.shape, generator) if noises is None
                     else self._tensor(noises[i]))
            x = euler_ancestral_step(x, _dual_guidance(eps3, cfg_txt, cfg_img), sigma,
                                     float(sigmas[i + 1]), noise)
        return x

    def edit(self, image01, text_embeds3, num_inference_steps: int = 100,
             guidance_scale: float = 7.5, image_guidance_scale: float = 1.5,
             seed: int = 42) -> torch.Tensor:
        """``image01 [H, W, 3]`` in [0, 1], text rows ``[3, S, D]`` ([prompt,
        negative, negative]) -> the edited image ``[H, W, 3]`` in [0, 1]."""
        grid = euler_ancestral_grid(self.schedule, num_inference_steps)
        img_lat = self.encode_mode(self._tensor(image01)[None])
        gen = self._generator(seed)
        init = self._noise(img_lat.shape, gen) * grid.init_noise_sigma
        out = self.edit_scan(init, img_lat, text_embeds3, grid.sigmas, guidance_scale,
                             image_guidance_scale, generator=gen)
        return self.decode(out)[0]


def sdxl_time_ids(height: int, width: int, rows: int, device) -> torch.Tensor:
    """SDXL micro-conditioning ``[rows, 6]``: original size, crop (0, 0),
    target size."""
    ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32)
    return ids.expand(rows, 6).contiguous().to(device)


@dataclasses.dataclass
class CosXLEditPipeline(ImageCodecMixin):
    """SDXL instruct edit on the EDM v-prediction schedule; the text
    embeddings come precomputed (SDXL's two encoders: ``[3, S, 2048]``,
    pooled ``[3, 1280]``)."""

    unet: torch.nn.Module
    vae: torch.nn.Module
    schedule: DiffusionSchedule          # unused by EDM; kept for the interface
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    sigma_min: float = 0.002
    sigma_max: float = 120.0
    text_encoder: Optional[torch.nn.Module] = None

    @torch.inference_mode()
    def edit_scan(self, init_latent, image_latent, text_embeds3, pooled3, time_ids3, sigmas,
                  cfg_txt: float, cfg_img: float) -> torch.Tensor:
        """``len(sigmas) - 1`` EDM Euler steps (deterministic)."""
        sigmas = np.asarray(sigmas, np.float32)
        img_rows = _cfg_rows(self._tensor(image_latent))
        text3 = self._tensor(text_embeds3, self.dtype)
        pooled3, time_ids3 = self._tensor(pooled3), self._tensor(time_ids3)
        x = self._tensor(init_latent)
        for i in range(len(sigmas) - 1):
            sigma = float(sigmas[i])
            scaled = edm_scale_model_input(x, sigma)
            inp3 = torch.cat([scaled.expand(3, -1, -1, -1), img_rows], dim=-1)
            v3 = self.unet(inp3, EDMGrid.timestep(sigma), text3, added_text_embeds=pooled3,
                           added_time_ids=time_ids3).float()
            x = edm_step_v(x, _dual_guidance(v3, cfg_txt, cfg_img), sigma, float(sigmas[i + 1]))
        return x

    def edit(self, image01, text_embeds3, pooled3, num_inference_steps: int = 20,
             guidance_scale: float = 7.0, image_guidance_scale: float = 1.5,
             seed: int = 42) -> torch.Tensor:
        grid = edm_grid(num_inference_steps, self.sigma_min, self.sigma_max)
        img_lat = self.encode_mode(self._tensor(image01)[None])
        H, W = image01.shape[:2]
        init = self._noise(img_lat.shape, self._generator(seed)) * grid.init_noise_sigma
        out = self.edit_scan(init, img_lat, text_embeds3, pooled3,
                             sdxl_time_ids(H, W, 3, self.device), grid.sigmas, guidance_scale,
                             image_guidance_scale)
        return self.decode(out)[0]
