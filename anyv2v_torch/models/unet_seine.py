"""SEINE UNet: SD1.4 inflated to video, channels-last (counterpart of
``anyv2v_tpu/models/unet_seine.py``), with the reference checkpoint's key
names (``UNet3DConditionModel``: ``resnets``, ``attentions`` with
``transformer_blocks.0.{attn1, attn2, attn_temp, ff}``, 1x1-conv
``proj_in``/``proj_out``).

Call contract (as the JAX module): ``sample [B, F, h, w, 9]`` (the latent,
the frame mask and the masked-video latent, concatenated on channels),
``timestep`` an int (or ``[B]`` tensor), ``encoder_hidden_states [B, S, 768]``
-> eps ``[B, F, h, w, 4]``. Every conv works per frame (frames fold into the
batch); the only frame-coupled op is the temporal attention.

Each transformer block runs spatial self-attention ``attn1``, then cross
attention ``attn2``, then the temporal attention ``attn_temp`` over the frame
axis of the module-native ``[B, F, HW, C]`` tokens, then the GEGLU FF. The
temporal attention rotates the first ``min(32, head_dim)`` channels of each
head of q and k at frame positions and adds the T5 relative-position bias
``[heads, F, F]`` to the scaled scores (K2 with its bias operand).

PnP: ``pnp=(conv, spatial, cross, temporal)`` Python bools over the CFG batch
``[src, cond, uncond]``. The attention families replace Q and K (never V) of
the up-block targets with the source rows, the temporal one before rotation;
the conv family the features of ``pnp_conv_target``'s resnet. No mid-block or
``up_0`` resnet injects.

Frame sharding: inside a manual-SPMD region
(:func:`anyv2v_torch.parallel.mesh.manual_axis`) ``sample`` holds one rank's
frames; the temporal attention, the only frame-coupled op, reshards around
itself (an all-to-all to pixel sharding, or a gather of the frame axis where
the pixels do not divide), with positions and bias over the global frames.

Not here: the rotary modules' ``freqs`` buffers (the JAX converter skips them
too).
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rotary as _rotary
from ..ops.attention import temporal_attention
from ..ops.pnp import inject_source_rows
from ..ops.relpos import relative_position_bias
from ..parallel.mesh import around_frame_op
from .layers import (
    Attention,
    Downsample2D,
    FeedForward,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    conv_nhwc,
    fold_frames,
    group_norm,
    layer_norm,
    linear_1x1,
    sinusoidal_embedding,
    unfold_frames,
)


@dataclasses.dataclass(frozen=True)
class SeineUNetConfig:
    in_channels: int = 9
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_attention_heads: int = 8       # SD1.x: 8 heads, head_dim = C // 8
    norm_num_groups: int = 32
    relpos_num_buckets: int = 32
    relpos_max_distance: int = 32
    temporal_rotary_dim: int = 32      # clamped to head_dim for tiny configs
    pnp_chunks: int = 3
    pnp_attn_targets: Tuple[Tuple[int, int], ...] = (
        (1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2),
    )
    pnp_conv_target: Tuple[int, int] = (1, 1)
    dtype: torch.dtype = torch.bfloat16


class _RelativePositionBias(nn.Module):
    """The reference ``RelativePositionBias``: an ``[num_buckets, heads]``
    table (``relative_attention_bias``) gathered by bucketed frame offsets."""

    def __init__(self, heads: int, num_buckets: int, max_distance: int):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, frames: int) -> torch.Tensor:
        """``[heads, frames, frames]`` fp32, contiguous: K2's bias operand."""
        bias = relative_position_bias(self.relative_attention_bias.weight, frames, frames,
                                      self.num_buckets, self.max_distance)
        return bias.float().contiguous()


class _TemporalAttention(Attention):
    """``attn_temp``: the Attention projections plus the T5 bias table."""

    def __init__(self, dim: int, heads: int, head_dim: int, num_buckets: int,
                 max_distance: int, pnp_chunks: int):
        super().__init__(dim, heads, head_dim, pnp_chunks=pnp_chunks)
        self.time_rel_pos_bias = _RelativePositionBias(heads, num_buckets, max_distance)


class SeineTransformerBlock(nn.Module):
    """The reference ``BasicTransformerBlock`` on ``[(B F), HW, C]`` tokens:
    attn1 (spatial self) -> attn2 (cross) -> attn_temp (frames) -> ff."""

    def __init__(self, dim: int, heads: int, head_dim: int, cross_attention_dim: int,
                 num_buckets: int = 32, max_distance: int = 32, rotary_dim: int = 32,
                 dtype=torch.float32, pnp_chunks: int = 3):
        super().__init__()
        self.dtype, self.rotary_dim = dtype, rotary_dim
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, pnp_chunks=pnp_chunks)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, cross_attention_dim=cross_attention_dim,
                               pnp_chunks=pnp_chunks)
        self.norm_temp = nn.LayerNorm(dim, eps=1e-5)
        self.attn_temp = _TemporalAttention(dim, heads, head_dim, num_buckets, max_distance,
                                            pnp_chunks)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def _temporal(self, x4: torch.Tensor, inject: bool, pixel_sharded: bool = False
                  ) -> torch.Tensor:
        """attn_temp on ``[B, F, HW, C]`` holding every frame: Q/K injection,
        per-head partial rotary at frame positions, then K2 with the
        relative-position bias."""
        a = self.attn_temp
        f = x4.shape[1]
        q = inject_source_rows(a.to_q(x4), inject, a.pnp_chunks)
        k = inject_source_rows(a.to_k(x4), inject, a.pnp_chunks)
        v = a.to_v(x4)
        rot = min(self.rotary_dim, a.head_dim)
        if rot >= 2:
            pos = torch.arange(f, dtype=torch.float32, device=x4.device)
            q = _rotary.rotate_partial(q, pos, rot, a.heads)
            k = _rotary.rotate_partial(k, pos, rot, a.heads)
        out = temporal_attention(q, k, v, a.heads, a.scale, bias=a.time_rel_pos_bias(f),
                                 pixel_sharded=pixel_sharded)
        return a.to_out[0](out)

    def forward(self, x, context, frames: int, inject=(False, False, False)):
        """``x [(B F), HW, C]``, ``context [(B F), S, D]``; ``inject``: the
        (spatial, cross, temporal) PnP flags."""
        inj_spatial, inj_cross, inj_temporal = inject
        dt = self.dtype
        bf, hw, c = x.shape
        x = x + self.attn1(layer_norm(x, self.norm1, dt), inject=inj_spatial)
        x = x + self.attn2(layer_norm(x, self.norm2, dt), context=context, inject=inj_cross)
        h4 = layer_norm(x, self.norm_temp, dt).reshape(bf // frames, frames, hw, c)
        # sharded: every frame local around the whole op, whose positions and
        # bias span the global frames
        out4 = around_frame_op(lambda h, mode: self._temporal(h, inj_temporal, mode is not None),
                               (h4,))
        x = x + out4.reshape(bf, hw, c)
        return x + self.ff(layer_norm(x, self.norm3, dt))


class SeineTransformer3D(nn.Module):
    """``Transformer3DModel``: groupnorm -> 1x1-conv proj_in -> block ->
    1x1-conv proj_out -> residual, on ``[(B F), H, W, C]``."""

    def __init__(self, channels: int, heads: int, cross_attention_dim: int, groups: int,
                 cfg: SeineUNetConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        head_dim = channels // heads
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([SeineTransformerBlock(
            channels, heads, head_dim, cross_attention_dim, cfg.relpos_num_buckets,
            cfg.relpos_max_distance, cfg.temporal_rotary_dim, dtype, cfg.pnp_chunks)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, frames: int, inject=(False, False, False)):
        bf, h, w, c = x.shape
        y = linear_1x1(self.proj_in, group_norm(x, self.norm, self.dtype))
        ctx = context.to(self.dtype).repeat_interleave(frames, dim=0)
        y = self.transformer_blocks[0](y.reshape(bf, h * w, -1), ctx, frames, inject)
        return linear_1x1(self.proj_out, y.reshape(bf, h, w, -1)) + x


class SeineUNet(nn.Module):
    def __init__(self, config: SeineUNetConfig = SeineUNetConfig()):
        super().__init__()
        self.config = cfg = config
        dt, g = cfg.dtype, cfg.norm_num_groups
        ch0 = cfg.block_out_channels[0]
        ted = ch0 * 4
        heads = cfg.num_attention_heads

        def transformer(ch):
            return SeineTransformer3D(ch, heads, cfg.cross_attention_dim, g, cfg, dt)

        def block(cin, ch, n_layers, cross, skip_ch=None):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if cross:
                blk.attentions = nn.ModuleList()
            for _ in range(n_layers):
                extra = skip_ch.pop() if skip_ch is not None else 0
                blk.resnets.append(ResnetBlock2D(cin + extra, ch, ted, g, dtype=dt,
                                                 pnp_chunks=cfg.pnp_chunks))
                if cross:
                    blk.attentions.append(transformer(ch))
                cin = ch
            return blk

        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, ted)

        n = len(cfg.block_out_channels)
        skip_ch = [ch0]
        self.down_blocks = nn.ModuleList()
        cur = ch0
        for i, ch in enumerate(cfg.block_out_channels):
            blk = block(cur, ch, cfg.layers_per_block, i < n - 1)
            skip_ch += [ch] * cfg.layers_per_block
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
                skip_ch.append(ch)
            self.down_blocks.append(blk)
            cur = ch

        ch = cfg.block_out_channels[-1]
        mid = nn.Module()
        mid.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, ted, g, dtype=dt),
                                     ResnetBlock2D(ch, ch, ted, g, dtype=dt)])
        mid.attentions = nn.ModuleList([transformer(ch)])
        self.mid_block = mid

        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(cfg.block_out_channels)):
            blk = block(cur, ch, cfg.layers_per_block + 1, i > 0, skip_ch)
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
            cur = ch

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timestep, encoder_hidden_states,
                pnp: Optional[Tuple[bool, bool, bool, bool]] = None):
        cfg = self.config
        dt = cfg.dtype
        B, F_ = sample.shape[:2]
        ch0 = cfg.block_out_channels[0]
        dev = sample.device

        # a number fills on the device: a copy from host memory would wait for its queue
        ts = (torch.full((B,), timestep, device=dev) if isinstance(timestep, numbers.Number)
              else torch.as_tensor(timestep, device=dev).reshape(-1).expand(B))
        emb = self.time_embedding(sinusoidal_embedding(ts, ch0).to(dt))
        emb = emb.repeat_interleave(F_, dim=0)
        context = encoder_hidden_states.to(dt)

        x = conv_nhwc(self.conv_in, fold_frames(sample.to(dt)))
        skips = [x]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                x = blk.resnets[j](x, emb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context, F_)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, emb)
        x = mid.attentions[0](x, context, F_)
        x = mid.resnets[1](x, emb)

        targets = set(cfg.pnp_attn_targets)
        for i, blk in enumerate(self.up_blocks):
            for j in range(len(blk.resnets)):
                x = torch.cat([x, skips.pop()], dim=-1)
                inj_conv = pnp is not None and pnp[0] and (i, j) == cfg.pnp_conv_target
                x = blk.resnets[j](x, emb, inject=inj_conv)
                if hasattr(blk, "attentions"):
                    target = pnp is not None and (i, j) in targets
                    x = blk.attentions[j](x, context, F_, inject=(
                        target and pnp[1], target and pnp[2], target and pnp[3]))
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = group_norm(x, self.conv_norm_out, dt, silu=True)
        return unfold_frames(conv_nhwc(self.conv_out, x), F_)
