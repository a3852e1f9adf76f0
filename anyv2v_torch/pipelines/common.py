"""Shared pipeline plumbing (counterpart of ``anyv2v_tpu/pipelines/common.py``,
the parts the i2vgen-xl slice uses): the VAE latent codec, text encoding and
:func:`group_constant_runs`."""

from __future__ import annotations

import torch

from ..models.vae import mode_from_moments


def group_constant_runs(masks, k: int):
    """Group steps [0, k) into maximal runs of a constant per-step flag
    pattern. ``masks``: tuple of boolean arrays (one per flag). Returns
    ``[(start, pattern_tuple, stop), ...]`` with Python-bool patterns."""
    runs = []
    for i in range(k):
        pat = tuple(bool(m[i]) for m in masks)
        if runs and runs[-1][1] == pat:
            runs[-1] = (runs[-1][0], pat, i + 1)
        else:
            runs.append((i, pat, i + 1))
    return runs


class LatentCodecMixin:
    """Expects ``vae``, ``text_encoder`` and ``device`` attributes."""

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.inference_mode()
    def _encode_frames(self, frames01) -> torch.Tensor:
        """``[N, H, W, 3]`` in [0, 1] -> scaled latents ``[N, h, w, 4]`` (mode), fp32."""
        x = self._tensor(frames01) * 2.0 - 1.0
        z = mode_from_moments(self.vae.encode_moments(x))
        return z.float() * self.vae.config.scaling_factor

    def encode_video(self, frames01, chunk_size: int = 16) -> torch.Tensor:
        """``[F, H, W, 3]`` -> ``[1, F, h, w, 4]``, in chunks of frames to bound
        activation memory."""
        n = frames01.shape[0]
        outs = [self._encode_frames(frames01[i:i + chunk_size]) for i in range(0, n, chunk_size)]
        return torch.cat(outs, dim=0)[None]

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        img = self.vae.decode(latents / self.vae.config.scaling_factor)
        return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)

    def decode_latents(self, latents, chunk_size: int = 16) -> torch.Tensor:
        """``[1, F, h, w, 4]`` -> video ``[F, H, W, 3]`` in [0, 1], fp32."""
        z = self._tensor(latents)[0]
        return torch.cat([self._decode(z[i:i + chunk_size])
                          for i in range(0, z.shape[0], chunk_size)], dim=0)

    @torch.inference_mode()
    def encode_text(self, input_ids) -> torch.Tensor:
        hidden, _ = self.text_encoder(torch.as_tensor(input_ids, dtype=torch.long,
                                                      device=self.device))
        return hidden
