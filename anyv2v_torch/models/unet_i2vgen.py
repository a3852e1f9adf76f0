"""I2VGen-XL UNet, channels-last (counterpart of
``anyv2v_tpu/models/unet_i2vgen.py``), with diffusers ``I2VGenXLUNet`` key
names.

Call contract (as the JAX module): ``sample`` and ``image_latents``
``[B, F, h, w, 4]``, ``timestep`` and ``fps`` ints (or ``[B]`` tensors),
``encoder_hidden_states [B, S_text, D]``, ``image_embeddings [B, 1, D]``.
Returns eps ``[B, F, h, w, 4]`` in the compute dtype.

PnP: ``pnp=(conv, spatial, temporal)`` Python bools with the CFG batch
``[src, uncond, cond]``; injection points are the JAX module's
(``pnp_attn_targets``: up-block (i, j) spatial and temporal attn1 Q/K;
``pnp_conv_target``: after conv2 of that up-block resnet).

Frame sharding: inside a manual-SPMD region
(:func:`anyv2v_torch.parallel.mesh.manual_axis`) ``sample`` holds one
rank's frames and ``image_latents`` the whole clip's; the temporal layers
reshard themselves.

Head split: i2vgen-xl's checkpoint has 64 heads per block (diffusers issue
#2011), so head widths are C/64 = 5/10/20; :class:`..layers.Attention` stores
them padded to 8/16/32 for the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import current_manual_axis, local_frame_slice
from ..utils.profiling import span, spanned
from .layers import (
    Attention,
    Downsample2D,
    FeedForward,
    ResnetBlock2D,
    SpatialTransformer,
    TemporalConvLayer,
    TemporalTransformer,
    TimestepEmbedding,
    Upsample2D,
    adaptive_avg_pool_2d,
    conv_nhwc,
    fold_frames,
    group_norm,
    layer_norm,
    sinusoidal_embedding,
    unfold_frames,
)


@dataclasses.dataclass(frozen=True)
class I2VGenUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    # diffusers #2011 semantics: when set, the HEAD COUNT of the block
    # transformers (head_dim = C // heads); None -> heads = C // attention_head_dim
    num_attention_heads: Optional[int] = None
    norm_num_groups: int = 32
    num_image_context_tokens: int = 16
    pnp_attn_targets: Tuple[Tuple[int, int], ...] = (
        (1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2),
    )
    pnp_conv_target: Tuple[int, int] = (1, 1)
    dtype: torch.dtype = torch.bfloat16

    def heads(self, channels: int) -> Tuple[int, int]:
        if self.num_attention_heads:
            return self.num_attention_heads, channels // self.num_attention_heads
        return channels // self.attention_head_dim, self.attention_head_dim


class _TemporalEncoder(nn.Module):
    """Tiny transformer over frames for the projected image latents
    (diffusers ``I2VGenXLTransformerTemporalEncoder``): 2 heads of width C."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads=2, head_dim=dim, out_dim=dim)
        self.ff = FeedForward(dim, mult=4, activation="gelu")

    def forward(self, x):
        x = x + self.attn1(layer_norm(x, self.norm1, self.dtype))
        return x + self.ff(x)


class I2VGenUNet(nn.Module):
    def __init__(self, config: I2VGenUNetConfig = I2VGenUNetConfig()):
        super().__init__()
        self.config = cfg = config
        dt, g = cfg.dtype, cfg.norm_num_groups
        c_lat = cfg.in_channels
        ch0 = cfg.block_out_channels[0]
        ted = ch0 * 4
        ctx = cfg.cross_attention_dim

        self.conv_in = nn.Conv2d(2 * c_lat, ch0, 3, padding=1)
        # diffusers: TransformerTemporalModel(num_attention_heads=8,
        # attention_head_dim=<config head count>)
        self.transformer_in = TemporalTransformer(
            ch0, 8, cfg.num_attention_heads or cfg.attention_head_dim, g, dt)
        self.time_embedding = TimestepEmbedding(ch0, ted)
        self.fps_embedding = nn.Sequential(nn.Linear(ch0, ted), nn.SiLU(), nn.Linear(ted, ted))
        self.image_latents_proj_in = nn.Sequential(
            nn.Conv2d(c_lat, 4 * c_lat, 3, padding=1), nn.SiLU(),
            nn.Conv2d(4 * c_lat, 4 * c_lat, 3, padding=1), nn.SiLU(),
            nn.Conv2d(4 * c_lat, c_lat, 3, padding=1))
        self.image_latents_temporal_encoder = _TemporalEncoder(c_lat, dt)
        self.image_latents_context_embedding = nn.Sequential(
            nn.Conv2d(c_lat, 8 * c_lat, 3, padding=1), nn.SiLU(),
            nn.Identity(),   # AdaptiveAvgPool2d((32, 32)), applied channels-last
            nn.Conv2d(8 * c_lat, 16 * c_lat, 3, stride=2, padding=1), nn.SiLU(),
            nn.Conv2d(16 * c_lat, ctx, 3, stride=2, padding=1))
        self.context_embedding = nn.Sequential(
            nn.Linear(ctx, ted * 4), nn.SiLU(),
            nn.Linear(ted * 4, ctx * cfg.num_image_context_tokens))

        n = len(cfg.block_out_channels)
        skip_ch = [ch0]
        self.down_blocks = nn.ModuleList()
        cur = ch0
        for i, ch in enumerate(cfg.block_out_channels):
            heads, hd = cfg.heads(ch)
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            blk.temp_convs = nn.ModuleList()
            if i < n - 1:
                blk.attentions = nn.ModuleList()
                blk.temp_attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(cur, ch, ted, g, dtype=dt))
                blk.temp_convs.append(TemporalConvLayer(ch, g, dt))
                if i < n - 1:
                    blk.attentions.append(SpatialTransformer(ch, heads, hd, ctx, g, dt))
                    blk.temp_attentions.append(TemporalTransformer(ch, heads, hd, g, dt))
                cur = ch
                skip_ch.append(ch)
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
                skip_ch.append(ch)
            self.down_blocks.append(blk)

        ch = cfg.block_out_channels[-1]
        heads, hd = cfg.heads(ch)
        mid = nn.Module()
        mid.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, ted, g, dtype=dt),
                                     ResnetBlock2D(ch, ch, ted, g, dtype=dt)])
        mid.temp_convs = nn.ModuleList([TemporalConvLayer(ch, g, dt),
                                        TemporalConvLayer(ch, g, dt)])
        mid.attentions = nn.ModuleList([SpatialTransformer(ch, heads, hd, ctx, g, dt)])
        mid.temp_attentions = nn.ModuleList([TemporalTransformer(ch, heads, hd, g, dt)])
        self.mid_block = mid

        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(cfg.block_out_channels)):
            heads, hd = cfg.heads(ch)
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            blk.temp_convs = nn.ModuleList()
            if i > 0:
                blk.attentions = nn.ModuleList()
                blk.temp_attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(cur + skip_ch.pop(), ch, ted, g, dtype=dt))
                blk.temp_convs.append(TemporalConvLayer(ch, g, dt))
                if i > 0:
                    blk.attentions.append(SpatialTransformer(ch, heads, hd, ctx, g, dt))
                    blk.temp_attentions.append(TemporalTransformer(ch, heads, hd, g, dt))
                cur = ch
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    @spanned("unet.forward")
    def forward(self, sample, timestep, encoder_hidden_states, fps, image_latents,
                image_embeddings, pnp: Optional[Tuple[bool, bool, bool]] = None):
        cfg = self.config
        dt = cfg.dtype
        B, F_, H, W, C = sample.shape
        ch0 = cfg.block_out_channels[0]
        dev = sample.device

        # time + fps embedding, repeated per frame (batch-major)
        with span("unet.embed"):
            ts = torch.as_tensor(timestep, device=dev).reshape(-1).expand(B)
            fps_v = torch.as_tensor(fps, device=dev).reshape(-1).expand(B)
            emb = (self.time_embedding(sinusoidal_embedding(ts, ch0).to(dt))
                   + self.fps_embedding(sinusoidal_embedding(fps_v, ch0).to(dt)))
            emb = emb.repeat_interleave(F_, dim=0)

            # cross-attention context: text, 64 local image tokens, N global tokens
            ce = self.image_latents_context_embedding
            z = F.silu(conv_nhwc(ce[0], image_latents[:, 0].to(dt)))
            z = adaptive_avg_pool_2d(z, (32, 32))
            z = F.silu(conv_nhwc(ce[3], z))
            z = conv_nhwc(ce[5], z)
            img_ctx = z.reshape(B, -1, cfg.cross_attention_dim)
            gtok = self.context_embedding(image_embeddings.to(dt)).reshape(
                B, cfg.num_image_context_tokens, cfg.cross_attention_dim)
            context = torch.cat([encoder_hidden_states.to(dt), img_ctx, gtok], dim=1)
            context = context.repeat_interleave(F_, dim=0)

            # image-latent path: per-frame convs, then attention over frames per
            # pixel. Inside a manual-SPMD region image_latents arrive replicated
            # with every frame (the encoder attends across all of them) while
            # sample holds this rank's frames: the result is cut to its window.
            pi = self.image_latents_proj_in
            F_il = image_latents.shape[1]
            il = fold_frames(image_latents.to(dt))
            il = F.silu(conv_nhwc(pi[0], il))
            il = F.silu(conv_nhwc(pi[2], il))
            il = conv_nhwc(pi[4], il)
            il = unfold_frames(il, F_il).permute(0, 2, 3, 1, 4).reshape(B * H * W, F_il, C)
            il = self.image_latents_temporal_encoder(il)
            il = il.reshape(B, H, W, F_il, C).permute(0, 3, 1, 2, 4)
            if F_il != F_:
                region = current_manual_axis()
                if region is None or F_il != F_ * region[1]:
                    raise ValueError(f"image_latents have {F_il} frames and sample {F_}: they must "
                                     "match, or be the whole clip's inside a manual-SPMD region")
                il = local_frame_slice(il, region[0], F_)

        x = torch.cat([sample.to(dt), il], dim=-1)
        x = conv_nhwc(self.conv_in, fold_frames(x))
        x = fold_frames(self.transformer_in(unfold_frames(x, F_)))

        skips = [x]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                with span("unet.resnet"):
                    x = blk.resnets[j](x, emb)
                x = fold_frames(blk.temp_convs[j](unfold_frames(x, F_)))
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context=context)
                    x = fold_frames(blk.temp_attentions[j](unfold_frames(x, F_)))
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        with span("unet.resnet"):
            x = mid.resnets[0](x, emb)
        x = fold_frames(mid.temp_convs[0](unfold_frames(x, F_)))
        x = mid.attentions[0](x, context=context)
        x = fold_frames(mid.temp_attentions[0](unfold_frames(x, F_)))
        with span("unet.resnet"):
            x = mid.resnets[1](x, emb)
        x = fold_frames(mid.temp_convs[1](unfold_frames(x, F_)))

        targets = set(cfg.pnp_attn_targets)
        for i, blk in enumerate(self.up_blocks):
            for j in range(len(blk.resnets)):
                x = torch.cat([x, skips.pop()], dim=-1)
                inj_conv = pnp is not None and pnp[0] and (i, j) == cfg.pnp_conv_target
                with span("unet.resnet"):
                    x = blk.resnets[j](x, emb, inject=inj_conv)
                x = fold_frames(blk.temp_convs[j](unfold_frames(x, F_)))
                if hasattr(blk, "attentions"):
                    target = pnp is not None and (i, j) in targets
                    x = blk.attentions[j](x, context=context, inject=target and pnp[1])
                    x = fold_frames(blk.temp_attentions[j](
                        unfold_frames(x, F_), inject=target and pnp[2]))
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = group_norm(x, self.conv_norm_out, dt, silu=True)
        return unfold_frames(conv_nhwc(self.conv_out, x), F_)
