"""InstantStyle, the style editor of the first frame: SDXL, a canny ControlNet,
and an IP-Adapter restricted to one style block (counterpart of
``anyv2v_tpu/pipelines/instantstyle.py``):

- the canny map (50 / 200) of the SOURCE frame is the ControlNet's
  condition (:func:`canny_map`, OpenCV: CPU hosts only; a caller without
  OpenCV passes its own control image to :meth:`InstantStylePipeline.generate`);
- IP-Adapter-XL on ``up_blocks.0.attentions.1`` (``up_0_attn_1``) only: the
  image tokens come from :class:`ImageProjModel` on the style image's CLIP
  embedding, the unconditional row from a zero embedding;
- generation: SDXL text-to-image, Euler-Discrete 30 steps ("leading"),
  guidance 5, IP scale 1.0, ControlNet scale 0.6, CFG batch
  ``[uncond, prompt]``.

Also the projections of the other adapter variants (:class:`MLPProjModel`
for Full, :class:`Resampler` for Plus) and :func:`ip_image_embeds` for all of
them. Module key names are the IP-Adapter checkpoint's ``image_proj`` keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import layer_norm
from ..ops.attention import multi_head_attention
from ..schedulers import DiffusionSchedule
from ..schedulers.euler import (
    euler_discrete_grid,
    euler_discrete_step,
    euler_scale_model_input,
    sigma_to_t,
)
from .image_edit import ImageCodecMixin, sdxl_time_ids


@dataclasses.dataclass(frozen=True)
class ImageProjConfig:
    """The base IP-Adapter's projection: ``num_tokens`` tokens of the UNet's
    context width from one CLIP embedding."""

    cross_attention_dim: int = 2048
    clip_embeddings_dim: int = 1280
    num_tokens: int = 4
    dtype: torch.dtype = torch.bfloat16


class ImageProjModel(nn.Module):
    """IP-Adapter image projection: CLIP embedding ``[B, D_clip]`` -> Linear
    -> ``[B, num_tokens, cross_dim]`` -> LayerNorm."""

    def __init__(self, cross_attention_dim: int, clip_embeddings_dim: int,
                 num_tokens: int = 4):
        super().__init__()
        self.cross_attention_dim, self.num_tokens = cross_attention_dim, num_tokens
        self.proj = nn.Linear(clip_embeddings_dim, cross_attention_dim * num_tokens)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        dt = self.proj.weight.dtype
        x = self.proj(image_embeds.to(dt))
        x = x.reshape(x.shape[0], self.num_tokens, self.cross_attention_dim)
        return layer_norm(x, self.norm, dt)


class MLPProjModel(nn.Module):
    """IP-Adapter-Full projection: per-patch Linear -> GELU -> Linear ->
    LayerNorm over the CLIP penultimate hidden states (``proj.0``,
    ``proj.2``, ``proj.3``)."""

    def __init__(self, cross_attention_dim: int, clip_embeddings_dim: int):
        super().__init__()
        self.proj = nn.ModuleList([nn.Linear(clip_embeddings_dim, clip_embeddings_dim),
                                   nn.Identity(),
                                   nn.Linear(clip_embeddings_dim, cross_attention_dim),
                                   nn.LayerNorm(cross_attention_dim, eps=1e-5)])

    def forward(self, image_tokens: torch.Tensor) -> torch.Tensor:
        """``[B, S_img, D_clip]`` -> ``[B, S_img, cross_dim]``."""
        dt = self.proj[0].weight.dtype
        h = self.proj[2](F.gelu(self.proj[0](image_tokens.to(dt))))
        return layer_norm(h, self.proj[3], dt)


class _PerceiverAttention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.scale = heads, head_dim ** -0.5
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, tokens, latents):
        dt = self.to_q.weight.dtype
        ln1 = layer_norm(tokens, self.norm1, dt)
        ln2 = layer_norm(latents, self.norm2, dt)
        k, v = self.to_kv(torch.cat([ln1, ln2], dim=1)).chunk(2, dim=-1)
        out = multi_head_attention(self.to_q(ln2), k.contiguous(), v.contiguous(), self.heads,
                                   self.scale)
        return self.to_out(out)


class Resampler(nn.Module):
    """The perceiver resampler of the IP-Adapter Plus variants: learned
    latents attend over ``concat([image tokens, latents])`` through ``depth``
    blocks of (attention, feed-forward), then project out. Keys as the
    checkpoint's: ``layers.{i}.0`` the attention (``to_kv`` fused),
    ``layers.{i}.1`` the feed-forward ``[LayerNorm, Linear, GELU, Linear]``."""

    def __init__(self, dim: int = 1024, depth: int = 4, heads: int = 12, head_dim: int = 64,
                 num_queries: int = 16, embedding_dim: int = 1280, output_dim: int = 2048,
                 ff_mult: int = 4):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=1e-5)
        self.layers = nn.ModuleList()
        for _ in range(depth):
            ff = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5),
                                nn.Linear(dim, dim * ff_mult, bias=False), nn.Identity(),
                                nn.Linear(dim * ff_mult, dim, bias=False)])
            self.layers.append(nn.ModuleList([_PerceiverAttention(dim, heads, head_dim), ff]))

    def forward(self, image_tokens: torch.Tensor) -> torch.Tensor:
        """``[B, S_img, embedding_dim]`` -> ``[B, num_queries, output_dim]``."""
        dt = self.proj_in.weight.dtype
        x = self.latents.to(dt).expand(image_tokens.shape[0], -1, -1)
        tokens = self.proj_in(image_tokens.to(dt))
        for attn, ff in self.layers:
            x = x + attn(tokens, x)
            h = ff[1](layer_norm(x, ff[0], dt))
            x = x + ff[3](F.gelu(h))
        return layer_norm(self.proj_out(x), self.norm_out, dt)


@torch.inference_mode()
def ip_image_embeds(vision_encoder, proj_module, image_clip: torch.Tensor,
                    variant: str = "xl"):
    """(cond, uncond) IP tokens for every adapter variant:

    - base / xl: the pooled CLIP projection through :class:`ImageProjModel`;
      the unconditional row projects a ZERO CLIP embedding;
    - plus / plus-xl: the PENULTIMATE hidden states through
      :class:`Resampler`; the unconditional row runs a ZERO IMAGE through
      the encoder;
    - full: the penultimate hidden states through :class:`MLPProjModel`,
      unconditional as plus.

    ``image_clip``: CLIP-normalised ``[B, H, W, 3]``."""
    if variant in ("base", "xl"):
        _, pooled = vision_encoder(image_clip)
        return proj_module(pooled), proj_module(torch.zeros_like(pooled))
    if variant not in ("plus", "plus-xl", "full"):
        raise ValueError(f"unknown IP-Adapter variant {variant!r}")
    hidden, _ = vision_encoder(image_clip, penultimate=True)
    hidden0, _ = vision_encoder(torch.zeros_like(image_clip), penultimate=True)
    return proj_module(hidden), proj_module(hidden0)


def canny_map(image01: np.ndarray, low: int = 50, high: int = 200) -> np.ndarray:
    """cv2.Canny of an RGB ``[H, W, 3]`` image in [0, 1] -> a 3-channel map
    in [0, 1]. Needs OpenCV (CPU hosts)."""
    import cv2

    u8 = (np.clip(np.asarray(image01), 0, 1) * 255).astype(np.uint8)
    edges = cv2.Canny(cv2.cvtColor(u8, cv2.COLOR_RGB2BGR), low, high)
    return np.repeat(edges[..., None], 3, axis=-1).astype(np.float32) / 255.0


@dataclasses.dataclass
class InstantStylePipeline(ImageCodecMixin):
    """Text and image embeddings come precomputed (SDXL's two text encoders,
    CLIP vision)."""

    unet: torch.nn.Module
    controlnet: torch.nn.Module
    vae: torch.nn.Module
    image_proj: torch.nn.Module
    schedule: DiffusionSchedule
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    text_encoder: Optional[torch.nn.Module] = None

    @torch.inference_mode()
    def generate_scan(self, init_latent, text2, pooled2, time_ids2, ip_tokens2, cond_image,
                      sigmas, cfg: float, cn_scale: float, ip_scale: float) -> torch.Tensor:
        """``len(sigmas) - 1`` Euler-Discrete steps of the CFG batch
        ``[uncond, prompt]``; ``cond_image [H, W, 3]`` the control map."""
        sigmas = np.asarray(sigmas, np.float32)
        ts = sigma_to_t(self.schedule, sigmas[:-1])
        cond2 = self._tensor(cond_image)[None].expand(2, -1, -1, -1)
        text2 = self._tensor(text2, self.dtype)
        pooled2, time_ids2 = self._tensor(pooled2), self._tensor(time_ids2)
        ip_tokens2 = self._tensor(ip_tokens2, self.dtype)
        x = self._tensor(init_latent)
        for i in range(len(sigmas) - 1):
            sigma, t = float(sigmas[i]), float(ts[i])
            inp2 = euler_scale_model_input(x, sigma).expand(2, -1, -1, -1)
            down, mid = self.controlnet(inp2, t, text2, cond2, conditioning_scale=cn_scale,
                                        added_text_embeds=pooled2, added_time_ids=time_ids2)
            eps2 = self.unet(inp2, t, text2, added_text_embeds=pooled2, added_time_ids=time_ids2,
                             ip_tokens=ip_tokens2, ip_scale=ip_scale, down_block_residuals=down,
                             mid_block_residual=mid).float()
            e_unc, e_txt = eps2.chunk(2, dim=0)
            x = euler_discrete_step(x, e_unc + cfg * (e_txt - e_unc), sigma,
                                    float(sigmas[i + 1]))
        return x

    @torch.inference_mode()
    def style_tokens(self, style_clip_embed) -> torch.Tensor:
        """IP tokens of the rows [uncond (a zero CLIP embedding), style]."""
        emb = self._tensor(style_clip_embed)
        return torch.cat([self.image_proj(torch.zeros_like(emb)), self.image_proj(emb)], dim=0)

    def generate(self, cond_image, style_clip_embed, text_embeds2, pooled2,
                 num_inference_steps: int = 30, guidance_scale: float = 5.0,
                 ip_scale: float = 1.0, controlnet_conditioning_scale: float = 0.6,
                 seed: int = 42) -> torch.Tensor:
        """Generation under the control map ``cond_image [H, W, 3]`` in
        [0, 1]; returns ``[H, W, 3]`` in [0, 1]."""
        H, W = cond_image.shape[:2]
        grid = euler_discrete_grid(self.schedule, num_inference_steps)
        init = (self._noise((1, H // 8, W // 8, 4), self._generator(seed))
                * grid.init_noise_sigma)
        out = self.generate_scan(init, text_embeds2, pooled2, sdxl_time_ids(H, W, 2, self.device),
                                 self.style_tokens(style_clip_embed), cond_image, grid.sigmas,
                                 guidance_scale, controlnet_conditioning_scale, ip_scale)
        return self.decode(out)[0]

    def edit_with_style(self, content01, style_clip_embed, text_embeds2, pooled2,
                        **kwargs) -> torch.Tensor:
        """Style-transfers the frame ``content01 [H, W, 3]`` (its canny map
        controls the structure); keyword arguments as :meth:`generate`."""
        return self.generate(canny_map(np.asarray(content01)), style_clip_embed, text_embeds2,
                             pooled2, **kwargs)
