"""The Stable Diffusion AutoencoderKL (diffusers key names) in plain float32,
channels-last: the deterministic encode (the posterior's mean, scaled) and
the decode to frames in [0, 1]. Frames are a batch axis; ``cfg`` is the
configuration file's ``vae`` object."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import Params, attention, conv, downsample, group_norm, linear, resnet, upsample

CHUNK_FRAMES = 16   # frames per pass, so that the activations stay a few GiB


def _mid(P, name, x, c, g):
    x = resnet(P, f"{name}.resnets.0", x, c, c, groups=g, eps=1e-6)
    b, h, w, _ = x.shape
    a = f"{name}.attentions.0"
    t = group_norm(P, f"{a}.group_norm", x, g, 1e-6).reshape(b, h * w, c)
    qkv = [linear(P, f"{a}.to_{k}", t, c, c) for k in "qkv"]
    x = x + linear(P, f"{a}.to_out.0", attention(P, *qkv, 1), c, c).reshape(b, h, w, c)
    return resnet(P, f"{name}.resnets.1", x, c, c, groups=g, eps=1e-6)


def _encode(P, cfg, x):
    chs, g, lpb = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
    x = conv(P, "encoder.conv_in", x, cfg["in_channels"], chs[0])
    cur = chs[0]
    for i, ch in enumerate(chs):
        for j in range(lpb):
            x = resnet(P, f"encoder.down_blocks.{i}.resnets.{j}", x, cur, ch, groups=g, eps=1e-6)
            cur = ch
        if i < len(chs) - 1:
            x = downsample(P, f"encoder.down_blocks.{i}.downsamplers.0", x, ch, asymmetric=True)
    x = _mid(P, "encoder.mid_block", x, chs[-1], g)
    x = F.silu(group_norm(P, "encoder.conv_norm_out", x, g, 1e-6))
    lat = cfg["latent_channels"]
    x = conv(P, "encoder.conv_out", x, chs[-1], 2 * lat)
    return conv(P, "quant_conv", x, 2 * lat, 2 * lat, k=1)[..., :lat]


def _decode(P, cfg, z):
    rev, g, lpb = cfg["block_out_channels"][::-1], cfg["norm_num_groups"], cfg["layers_per_block"]
    lat = cfg["latent_channels"]
    x = conv(P, "post_quant_conv", z, lat, lat, k=1)
    x = conv(P, "decoder.conv_in", x, lat, rev[0])
    x = _mid(P, "decoder.mid_block", x, rev[0], g)
    cur = rev[0]
    for i, ch in enumerate(rev):
        for j in range(lpb + 1):
            x = resnet(P, f"decoder.up_blocks.{i}.resnets.{j}", x, cur, ch, groups=g, eps=1e-6)
            cur = ch
        if i < len(rev) - 1:
            x = upsample(P, f"decoder.up_blocks.{i}.upsamplers.0", x, ch)
    x = F.silu(group_norm(P, "decoder.conv_norm_out", x, g, 1e-6))
    return conv(P, "decoder.conv_out", x, rev[-1], cfg["out_channels"])


def encode(P: Params, cfg: dict, frames01: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, 3]`` in [0, 1] -> scaled latents ``[N, H/8, W/8, 4]``."""
    out = [_encode(P, cfg, frames01[i:i + CHUNK_FRAMES] * 2.0 - 1.0)
           for i in range(0, frames01.shape[0], CHUNK_FRAMES)]
    return torch.cat(out) * cfg["scaling_factor"]


def decode(P: Params, cfg: dict, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents ``[N, h, w, 4]`` -> frames ``[N, 8h, 8w, 3]`` in [0, 1]."""
    out = [_decode(P, cfg, latents[i:i + CHUNK_FRAMES] / cfg["scaling_factor"])
           for i in range(0, latents.shape[0], CHUNK_FRAMES)]
    return torch.clamp(torch.cat(out) / 2.0 + 0.5, 0.0, 1.0)
