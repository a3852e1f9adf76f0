"""2-D Stable-Diffusion-family conditional UNet of the first-frame editors
(counterpart of ``anyv2v_tpu/models/unet_sd.py``), channels-last, with
diffusers ``UNet2DConditionModel`` key names:

- SD1.5 InstructPix2Pix / MagicBrush: 8 input channels (noisy latent and
  conditioning-image latent), blocks (320, 640, 1280, 1280), 8 heads
  (40/80/160 wide), CLIP-L context 768;
- SDXL CosXL edit: 8 input channels, blocks (320, 640, 1280) with down
  types [plain, cross (depth 2), cross (depth 10)], 5/10/20 heads of 64,
  context 2048, and SDXL's addition embedding (the pooled text embedding
  with six sinusoidal time ids of width 256, through ``add_embedding``).

Call contract (as the JAX module): ``sample [B, h, w, Cin]``, ``timestep`` a
number or ``[B]`` (float: EDM feeds ``0.25 ln sigma``, negative at the end
of its grid), ``encoder_hidden_states [B, S, D]``; optional SDXL
``added_text_embeds [B, 1280]`` and ``added_time_ids [B, 6]``, IP-Adapter
``ip_tokens [B, N, D]`` with ``ip_scale`` (only the transformers named in
``ip_adapter_targets`` see them), and ControlNet residuals: one per skip,
added to the skips only, and the mid residual added after ``mid_resnet_1``.
Returns eps or v ``[B, h, w, 4]``.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from .layers import (
    Downsample2D,
    ResnetBlock2D,
    SpatialTransformer,
    TimestepEmbedding,
    Upsample2D,
    conv_nhwc,
    group_norm,
    sinusoidal_embedding,
)


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # the head COUNT (diffusers' attention_head_dim), one int or one per level
    num_attention_heads: Union[int, Tuple[int, ...]] = 8
    # transformer blocks per attention layer, one int or one per level
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    # which down blocks are cross-attention blocks, in down order
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    norm_num_groups: int = 32
    # "none" (SD1.5) or "sdxl" (pooled text embedding + 6 sinusoidal time ids)
    addition_embed: str = "none"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    # IP-Adapter target transformers by the JAX module's block names
    # ("up_0_attn_1" is diffusers' up_blocks.0.attentions.1)
    ip_adapter_targets: Tuple[str, ...] = ()
    # diffusers' use_linear_projection: proj_in / proj_out as Linear layers
    linear_projection: bool = False
    dtype: torch.dtype = torch.bfloat16

    def heads_for(self, level: int) -> int:
        h = self.num_attention_heads
        return h[level] if isinstance(h, tuple) else h

    def depth_for(self, level: int) -> int:
        d = self.transformer_depth
        return d[level] if isinstance(d, tuple) else d


def time_embeddings(module: nn.Module, cfg: SDUNetConfig, timestep, batch: int,
                    added_text_embeds=None, added_time_ids=None,
                    device=None) -> torch.Tensor:
    """The time embedding (plus SDXL's addition embedding) of the UNet and
    the ControlNet, ``[B, 4 * C0]`` in the config dtype."""
    dt, ch0 = cfg.dtype, cfg.block_out_channels[0]
    # a number fills on the device: a copy from host memory would wait for its queue
    ts = (torch.full((batch,), float(timestep), device=device)
          if isinstance(timestep, numbers.Number)
          else torch.as_tensor(timestep, device=device).float().reshape(-1).expand(batch))
    emb = module.time_embedding(sinusoidal_embedding(ts, ch0).to(dt))
    if cfg.addition_embed == "sdxl":
        ids = sinusoidal_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim)
        aug = torch.cat([added_text_embeds.float(), ids.reshape(batch, -1)], dim=-1)
        emb = emb + module.add_embedding(aug.to(dt))
    return emb


def build_down_path(module: nn.Module, cfg: SDUNetConfig, ip_targets=()) -> list:
    """conv_in, the time (and addition) embeddings and the down blocks of
    ``cfg`` on ``module`` (the UNet's and the ControlNet's shared layout);
    returns the channel count of every skip, in push order."""
    dt, g = cfg.dtype, cfg.norm_num_groups
    ch0 = cfg.block_out_channels[0]
    ted = ch0 * 4
    n = len(cfg.block_out_channels)
    module.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
    module.time_embedding = TimestepEmbedding(ch0, ted)
    if cfg.addition_embed == "sdxl":
        module.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, ted)
    elif cfg.addition_embed != "none":
        raise ValueError(f"unknown addition_embed {cfg.addition_embed!r}")
    skips, cur = [ch0], ch0
    module.down_blocks = nn.ModuleList()
    for i, ch in enumerate(cfg.block_out_channels):
        blk = nn.Module()
        blk.resnets = nn.ModuleList()
        if cfg.cross_attn_blocks[i]:
            blk.attentions = nn.ModuleList()
        for j in range(cfg.layers_per_block):
            blk.resnets.append(ResnetBlock2D(cur, ch, ted, g, dtype=dt))
            if cfg.cross_attn_blocks[i]:
                blk.attentions.append(transformer(cfg, i, ch, f"down_{i}_attn_{j}" in ip_targets))
            skips.append(ch)
            cur = ch
        if i < n - 1:
            blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
            skips.append(ch)
        module.down_blocks.append(blk)
    ch = cfg.block_out_channels[-1]
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, ted, g, dtype=dt),
                                 ResnetBlock2D(ch, ch, ted, g, dtype=dt)])
    mid.attentions = nn.ModuleList([transformer(cfg, n - 1, ch, "mid_attn" in ip_targets)])
    module.mid_block = mid
    return skips


def transformer(cfg: SDUNetConfig, level: int, ch: int, ip: bool) -> SpatialTransformer:
    heads = cfg.heads_for(level)
    return SpatialTransformer(ch, heads, ch // heads, cfg.cross_attention_dim,
                              cfg.norm_num_groups, cfg.dtype, depth=cfg.depth_for(level), ip=ip,
                              linear_projection=cfg.linear_projection)


def run_down_path(module: nn.Module, x, emb, context, ip_tokens=None, ip_scale: float = 1.0,
                  on_skip=None):
    """conv_in output ``x`` through the down blocks; returns (x, skips).
    ``on_skip(x)``, when given, maps each skip as it is pushed."""
    skips = [x if on_skip is None else on_skip(x)]
    for blk in module.down_blocks:
        for j in range(len(blk.resnets)):
            x = blk.resnets[j](x, emb)
            if hasattr(blk, "attentions"):
                x = blk.attentions[j](x, context, ip_tokens=ip_tokens, ip_scale=ip_scale)
            skips.append(x if on_skip is None else on_skip(x))
        if hasattr(blk, "downsamplers"):
            x = blk.downsamplers[0](x)
            skips.append(x if on_skip is None else on_skip(x))
    return x, skips


class SDUNet(nn.Module):
    """Input ``[B, h, w, in_channels]`` channels-last; output ``[B, h, w, 4]``."""

    def __init__(self, config: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        self.config = cfg = config
        dt, g = cfg.dtype, cfg.norm_num_groups
        ch0 = cfg.block_out_channels[0]
        ted = ch0 * 4
        n = len(cfg.block_out_channels)
        targets = set(cfg.ip_adapter_targets)
        skips = build_down_path(self, cfg, targets)

        self.up_blocks = nn.ModuleList()
        cur = cfg.block_out_channels[-1]
        rev_cross = tuple(reversed(cfg.cross_attn_blocks))
        for i, ch in enumerate(reversed(cfg.block_out_channels)):
            level = n - 1 - i
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if rev_cross[i]:
                blk.attentions = nn.ModuleList()
            for j in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(cur + skips.pop(), ch, ted, g, dtype=dt))
                if rev_cross[i]:
                    blk.attentions.append(transformer(cfg, level, ch, f"up_{i}_attn_{j}" in targets))
                cur = ch
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timestep, encoder_hidden_states,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None,
                ip_tokens: Optional[torch.Tensor] = None, ip_scale: float = 1.0,
                down_block_residuals: Optional[tuple] = None,
                mid_block_residual: Optional[torch.Tensor] = None):
        cfg = self.config
        dt = cfg.dtype
        emb = time_embeddings(self, cfg, timestep, sample.shape[0], added_text_embeds,
                              added_time_ids, sample.device)
        context = encoder_hidden_states.to(dt)

        x = conv_nhwc(self.conv_in, sample.to(dt))
        x, skips = run_down_path(self, x, emb, context, ip_tokens, ip_scale)
        if down_block_residuals is not None:
            # ControlNet: the residuals go to the skips only; the activation
            # entering the mid block is untouched
            if len(down_block_residuals) != len(skips):
                raise ValueError(f"{len(down_block_residuals)} ControlNet residuals for "
                                 f"{len(skips)} skips")
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_block_residuals)]

        mid = self.mid_block
        x = mid.resnets[0](x, emb)
        x = mid.attentions[0](x, context, ip_tokens=ip_tokens, ip_scale=ip_scale)
        x = mid.resnets[1](x, emb)
        if mid_block_residual is not None:
            x = x + mid_block_residual.to(x.dtype)

        for blk in self.up_blocks:
            for j in range(len(blk.resnets)):
                x = blk.resnets[j](torch.cat([x, skips.pop()], dim=-1), emb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context, ip_tokens=ip_tokens, ip_scale=ip_scale)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = group_norm(x, self.conv_norm_out, dt, silu=True)
        return conv_nhwc(self.conv_out, x)


# the checkpoints' configurations
SD15_IP2P = SDUNetConfig()   # timbrooks/instruct-pix2pix, vinesmsuic/magicbrush-jul7
SDXL_COSXL = SDUNetConfig(
    block_out_channels=(320, 640, 1280),
    cross_attention_dim=2048,
    num_attention_heads=(5, 10, 20),
    transformer_depth=(1, 2, 10),
    cross_attn_blocks=(False, True, True),
    addition_embed="sdxl",
    linear_projection=True,
)
