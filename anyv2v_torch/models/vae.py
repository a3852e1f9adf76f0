"""AutoencoderKL, channels-last (counterpart of ``anyv2v_tpu/models/vae.py``),
with diffusers key names. Frames are a batch axis."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..utils.profiling import spanned
from .layers import Attention, Downsample2D, ResnetBlock2D, Upsample2D, conv_nhwc, group_norm, linear_1x1


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16


class _VAEAttention(Attention):
    """Single-head self-attention over pixels with its group_norm
    (diffusers VAE mid attention: ``group_norm``, ``to_q/k/v`` with bias)."""

    def __init__(self, channels: int, groups: int):
        super().__init__(channels, heads=1, head_dim=channels, qkv_bias=True)
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, groups, 1e-6, dtype),
            ResnetBlock2D(channels, channels, None, groups, 1e-6, dtype)])
        self.attentions = nn.ModuleList([_VAEAttention(channels, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        b, h, w, c = x.shape
        attn = self.attentions[0]
        tokens = group_norm(x, attn.group_norm, self.dtype).reshape(b, h * w, c)
        x = x + attn(tokens).reshape(b, h, w, c)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt, g = cfg.dtype, cfg.norm_num_groups
        chs = cfg.block_out_channels
        self.dtype = dt
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = chs[0]
        for i, ch in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(cur, ch, None, g, 1e-6, dt))
                cur = ch
            if i < len(chs) - 1:
                # diffusers VAE downsample pads (0, 1, 0, 1), not symmetrically
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, asymmetric_pad=True)])
            self.down_blocks.append(blk)
        self.mid_block = _MidBlock(chs[-1], g, dt)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = conv_nhwc(self.conv_in, x.to(self.dtype))
        for blk in self.down_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = self.mid_block(x)
        x = group_norm(x, self.conv_norm_out, self.dtype, silu=True)
        return conv_nhwc(self.conv_out, x)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt, g = cfg.dtype, cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.dtype = dt
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g, dt)
        self.up_blocks = nn.ModuleList()
        cur = rev[0]
        for i, ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(cur, ch, None, g, 1e-6, dt))
                cur = ch
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = conv_nhwc(self.conv_in, z)
        x = self.mid_block(x)
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        x = group_norm(x, self.conv_norm_out, self.dtype, silu=True)
        return conv_nhwc(self.conv_out, x)


class AutoencoderKL(nn.Module):
    """encode: ``[N, H, W, 3]`` -> moments ``[N, H/8, W/8, 8]``; decode the
    reverse. Scaling by ``config.scaling_factor`` is the caller's job."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @spanned("vae.encode")
    def encode_moments(self, images):
        return linear_1x1(self.quant_conv, self.encoder(images))

    @spanned("vae.decode")
    def decode(self, latents):
        return self.decoder(linear_1x1(self.post_quant_conv, latents.to(self.config.dtype)))

    def forward(self, images, generator: Optional[torch.Generator] = None, noise=None):
        """Encode, draw from the posterior (its mode without ``generator``
        and ``noise``: :func:`sample_from_moments`), decode."""
        z = sample_from_moments(self.encode_moments(images), generator, noise)
        return self.decode(z)


def mode_from_moments(moments: torch.Tensor) -> torch.Tensor:
    """The diagonal Gaussian's mean (deterministic encode, as inversion wants)."""
    return moments.chunk(2, dim=-1)[0]


def sample_from_moments(moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A draw from the diagonal Gaussian of ``moments`` (mean and log-variance
    on the last axis), or its mean when neither ``generator`` nor ``noise``
    is given. ``noise``: a standard-normal draw of the mean's shape that
    replaces the generator's (``jax.random`` cannot be reproduced here)."""
    mean, logvar = moments.chunk(2, dim=-1)
    if generator is None and noise is None:
        return mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0).float())
    return mean + (std * noise.float()).to(mean.dtype)
