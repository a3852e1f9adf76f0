"""ControlNet, the SDXL canny variant InstantStyle conditions on (counterpart
of ``anyv2v_tpu/models/controlnet.py``), with diffusers ``ControlNetModel``
key names: a copy of the UNet's down and mid path, a conditioning embedding
(a conv pyramid on the control image at full image resolution), and 1x1
``controlnet_down_blocks`` giving one residual per UNet skip plus
``controlnet_mid_block``'s mid residual, all scaled by
``conditioning_scale``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv_nhwc, linear_1x1
from .unet_sd import SDUNetConfig, build_down_path, run_down_path, time_embeddings


class ControlNetConditioningEmbedding(nn.Module):
    """diffusers ``ControlNetConditioningEmbedding``: conv_in -> (3x3, 3x3
    stride 2) pairs over (16, 32, 96, 256) -> conv_out, SiLU between."""

    def __init__(self, out_channels: int, block_channels: Tuple[int, ...] = (16, 32, 96, 256),
                 in_channels: int = 3):
        super().__init__()
        ch = block_channels
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for i in range(len(ch) - 1):
            self.blocks.append(nn.Conv2d(ch[i], ch[i], 3, padding=1))
            self.blocks.append(nn.Conv2d(ch[i], ch[i + 1], 3, stride=2, padding=1))
        self.conv_out = nn.Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(conv_nhwc(self.conv_in, cond))
        for conv in self.blocks:
            x = F.silu(conv_nhwc(conv, x))
        return conv_nhwc(self.conv_out, x)


class ControlNet(nn.Module):
    """Returns (down residuals, one per UNet skip; mid residual)."""

    def __init__(self, config: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        self.config = cfg = config
        skips = build_down_path(self, cfg)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            cfg.block_out_channels[0])
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skips])
        ch = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(ch, ch, 1)

    def forward(self, sample, timestep, encoder_hidden_states, controlnet_cond,
                conditioning_scale: float = 1.0,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None):
        """``sample [B, h, w, 4]``, ``controlnet_cond [B, 8h, 8w, 3]`` in [0, 1]."""
        cfg = self.config
        dt = cfg.dtype
        emb = time_embeddings(self, cfg, timestep, sample.shape[0], added_text_embeds,
                              added_time_ids, sample.device)
        context = encoder_hidden_states.to(dt)
        x = conv_nhwc(self.conv_in, sample.to(dt))
        x = x + self.controlnet_cond_embedding(controlnet_cond.to(dt))
        zero_convs = iter(self.controlnet_down_blocks)
        x, residuals = run_down_path(self, x, emb, context,
                                     on_skip=lambda h: linear_1x1(next(zero_convs), h))
        mid = self.mid_block
        x = mid.resnets[0](x, emb)
        x = mid.attentions[0](x, context)
        x = mid.resnets[1](x, emb)
        mid_residual = linear_1x1(self.controlnet_mid_block, x)
        return (tuple(r * conditioning_scale for r in residuals),
                mid_residual * conditioning_scale)
