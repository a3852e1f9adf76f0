"""VideoLDM UNet, the ConsistI2V backbone, channels-last (counterpart of
``anyv2v_tpu/models/unet_videoldm.py``), with the reference checkpoint's key
names (``VideoLDMUNet3DConditionModel``: ``resnets``, ``conv3ds``,
``attentions``, ``tempo_attns``, linear ``proj_in``/``proj_out``).

Call contract (as the JAX module): ``sample [B, F, h, w, 4]``, ``timestep``
and ``frame_stride`` ints (or ``[B]`` tensors), ``encoder_hidden_states
[B, S, D]``, ``first_frame_latents [B, 1, h, w, 4]``. Every first-frame mode
but ``none`` prepends the first-frame latent on the frame axis and strips
frame 0 from the output; ``concat`` and ``conv2d`` also condition the
spatial self-attention on frame 0's keys and values (K5's split-KV mode);
``conv2d`` replaces frame 0 of the hidden states at each block entry with a
1x1 conv of the nearest-resized first-frame latent.

PnP: ``pnp=(conv, spatial, temporal)`` Python bools over a CFG batch of
``pnp_chunks`` rows whose first is the source; injection points as the JAX
module's (spatial attn1 Q/K and the first-frame K, temporal attn1 Q/K before
rotation, the conv features of ``pnp_conv_target``).

Frame sharding: inside a manual-SPMD region
(:func:`anyv2v_torch.parallel.mesh.manual_axis`) ``sample`` holds one rank's
frames and ``first_frame_latents`` rides every rank, so in the first-frame
modes the conditioning frame is row 0 of every rank's frame axis. The
temporal modules assemble the true frame sequence (the conditioning frame
once, then every rank's frames) around their frame-coupled ops
(:func:`anyv2v_torch.parallel.mesh.around_frame_op`), and the temporal transformer's positions
are global.

Not here: the reference's unused ``conv3ds.*.time_emb_proj`` and the rotary
modules' ``rotary_bias`` / ``freqs`` buffers (the JAX converter skips them
too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops import rotary as _rotary
from ..ops.attention import multi_head_attention, spatial_attention_ffconcat, temporal_attention
from ..ops.pnp import inject_source_rows
from ..ops.temporal_conv import groupnorm_silu_temporal_conv
from ..parallel.mesh import (around_frame_op, axis_index, gather_frames, local_pixel_slice,
                             sharded_region)
from ..utils.profiling import span, spanned
from .layers import (
    Attention,
    Downsample2D,
    FeedForward,
    ResnetBlock2D,
    TemporalConv3,
    TimestepEmbedding,
    Upsample2D,
    conv_nhwc,
    fold_frames,
    group_norm,
    layer_norm,
    sinusoidal_embedding,
    unfold_frames,
)


@dataclasses.dataclass(frozen=True)
class VideoLDMUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64       # spatial: heads = C // head_dim
    n_temp_heads: int = 8              # temporal: head_dim = C // n_temp_heads
    norm_num_groups: int = 32
    first_frame_condition_mode: str = "concat"   # none | concat | conv2d | input_only
    temp_pos_embedding: str = "rotary"           # rotary | sinusoidal
    augment_temporal_attention: bool = True
    use_frame_stride_condition: bool = True
    use_temporal: bool = True
    pnp_chunks: int = 4                # default CFG rows: [src, uncond, img, both]
    pnp_attn_targets: Tuple[Tuple[int, int], ...] = (
        (1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2),
    )
    pnp_conv_target: Tuple[int, int] = (1, 1)
    dtype: torch.dtype = torch.bfloat16


def videoldm_positional_encoding(length: int, dim: int) -> np.ndarray:
    """Vendored ConsistI2V ``PositionalEncoding`` (``videoldm_attention.py:644``):
    freq = exp(arange(dim/2)/dim * ln 10000); pe = interleave(sin, cos)."""
    pos = np.arange(length, dtype=np.float64)
    freq = np.exp(np.arange(dim // 2, dtype=np.float64) / dim * np.log(10000.0))
    x = pos[:, None] / freq[None, :]
    pe = np.stack([np.sin(x), np.cos(x)], axis=-1).reshape(length, dim)
    return pe.astype(np.float32)


def _alpha(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p.float(), 0.0, 1.0)


class AlphaTemporalResnet(nn.Module):
    """Reference ``TemporalResnetBlock`` on ``[B, F, H, W, C]``: two
    (groupnorm -> SiLU -> (3,1,1) conv) stages, one K4 launch each, then the
    gate ``a*x + (1-a)*(x + h)`` with ``a`` clamped to [0, 1].
    ``first_frame_replicated``: in a manual-SPMD region, row 0 of the frame
    axis is the conditioning frame every rank holds (the first-frame modes);
    the true sequence is assembled once around both stages, so that the conv
    and the group statistics count that frame once."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6,
                 first_frame_replicated: bool = False):
        super().__init__()
        self.first_frame_replicated = first_frame_replicated
        self.norm1 = nn.GroupNorm(groups, channels, eps=eps)
        self.conv1 = TemporalConv3(channels, channels)
        self.norm2 = nn.GroupNorm(groups, channels, eps=eps)
        self.conv2 = TemporalConv3(channels, channels)
        self.alpha = nn.Parameter(torch.ones(1))

    @spanned("unet.resnet")
    def forward(self, x):
        b, f = x.shape[:2]
        f0row = int(self.first_frame_replicated and sharded_region() is not None)
        h = around_frame_op(self._stages, (x.reshape(b, f, -1, x.shape[-1]),), f0row)
        out = x + h.reshape(x.shape)
        a = _alpha(self.alpha)
        return (a * x + (1.0 - a) * out).to(x.dtype)

    def _stages(self, h, mode):
        for norm, conv in ((self.norm1, self.conv1), (self.norm2, self.conv2)):
            h = groupnorm_silu_temporal_conv(h, norm, conv.weight, conv.bias,
                                             pixel_sharded=mode is not None)
        return h


class _Block(nn.Module):
    """The transformer block's modules: norm1 -> attn1 -> norm2 -> attn2
    (cross) -> norm3 -> ff. The forward passes live in the transformers."""

    def __init__(self, dim: int, heads: int, head_dim: int, cross_attention_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, cross_attention_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)


class VideoLDMSpatialTransformer(nn.Module):
    """Spatial ``Transformer2DConditionModel`` (no gate) over ``[(B F), H, W, C]``.
    With ``condition_on_first_frame`` the self-attention keys and values are
    the frame's own plus frame 0's (projected once per batch row)."""

    def __init__(self, channels: int, heads: int, head_dim: int, cross_attention_dim: int,
                 condition_on_first_frame: bool, groups: int = 32, dtype=torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.condition_on_first_frame = condition_on_first_frame
        inner = heads * head_dim
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([_Block(inner, heads, head_dim,
                                                        cross_attention_dim)])
        self.proj_out = nn.Linear(inner, channels)

    @spanned("unet.spatial")
    def forward(self, x, context, frames: int, inject: bool = False, pnp_chunks: int = 4):
        bf, h_, w_, c = x.shape
        dt = self.dtype
        blk = self.transformer_blocks[0]
        a1, a2 = blk.attn1, blk.attn2
        y = self.proj_in(group_norm(x, self.norm, dt)).reshape(bf, h_ * w_, -1)

        h = layer_norm(y, blk.norm1, dt)
        q, k, v = a1.to_q(h), a1.to_k(h), a1.to_v(h)
        if inject:   # PnP: Q/K substituted, V untouched
            q = inject_source_rows(q, True, pnp_chunks)
            k = inject_source_rows(k, True, pnp_chunks)
        if self.condition_on_first_frame:
            ff = h.reshape(bf // frames, frames, h_ * w_, -1)[:, 0]
            k_ctx, v_ctx = a1.to_k(ff), a1.to_v(ff)
            if inject:
                k_ctx = inject_source_rows(k_ctx, True, pnp_chunks)
            attn = spatial_attention_ffconcat(q, k, v, k_ctx, v_ctx, frames, self.heads, a1.scale)
        else:
            attn = multi_head_attention(q, k, v, self.heads, a1.scale)
        y = y + a1.to_out[0](attn)

        h = layer_norm(y, blk.norm2, dt)
        ctx = context.to(dt).repeat_interleave(frames, dim=0)
        attn = multi_head_attention(a2.to_q(h), a2.to_k(ctx), a2.to_v(ctx), self.heads, a2.scale)
        y = y + a2.to_out[0](attn)
        y = y + blk.ff(layer_norm(y, blk.norm3, dt))
        return self.proj_out(y.reshape(bf, h_, w_, -1)) + x


def _first_frame_adjacent_slices(first_frame_tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """8-neighbourhood of each pixel of frame 0, replicate-padded, centre
    excluded, in unfold order: ``[B, HW, C]`` -> ``[B, 8, HW, C]`` (frame-axis
    rows of the native temporal layout)."""
    b, hw, c = first_frame_tokens.shape
    img = first_frame_tokens.reshape(b, h, w, c)
    dev = img.device
    slices = []
    for di, dj in ((0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 2)):
        rows = torch.clamp(torch.arange(h, device=dev) + di - 1, 0, h - 1)
        cols = torch.clamp(torch.arange(w, device=dev) + dj - 1, 0, w - 1)
        slices.append(img[:, rows][:, :, cols])
    return torch.stack(slices, dim=1).reshape(b, 8, hw, c)


@spanned("layer.rotary")
def _rotate(x: torch.Tensor, positions: torch.Tensor, inner: int) -> torch.Tensor:
    """Rotary on the first ``inner // 2`` channels of ``[B, F, HW, inner]``
    tokens at frame positions ``positions [F]`` (fp32, on x's device)."""
    return _rotary.rotate_partial(x, positions, inner // 2)


class VideoLDMTemporalTransformer(nn.Module):
    """Temporal ``Transformer2DConditionModel`` over ``[(B F), H, W, C]``, gated
    as a whole by ``alpha``. attn1 attends over the frame axis (K2) of the
    module-native ``[B, F, HW, C]`` tokens, with rotary or sinusoidal
    positions and, with ``augment``, frame 0's 8-neighbourhood as 8 extra
    keys at rotary position 0. attn2 is one cross-attention of all
    ``F*HW`` tokens of a batch row to its text (K5), the query rotated."""

    def __init__(self, channels: int, heads: int, head_dim: int, cross_attention_dim: int,
                 augment: bool, rotary: bool, groups: int = 32, dtype=torch.float32,
                 first_frame_replicated: bool = False):
        super().__init__()
        self.heads, self.dtype, self.augment, self.rotary = heads, dtype, augment, rotary
        self.first_frame_replicated = first_frame_replicated
        inner = heads * head_dim
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([_Block(inner, heads, head_dim,
                                                        cross_attention_dim)])
        self.proj_out = nn.Linear(inner, channels)
        self.alpha = nn.Parameter(torch.ones(1))

    def _self_attention(self, x, adj, inject: bool, pnp_chunks: int,
                        pixel_sharded: bool = False):
        a1 = self.transformer_blocks[0].attn1
        b, f, hw, inner = x.shape
        if not self.rotary:
            pe = torch.from_numpy(videoldm_positional_encoding(f, inner)).to(x.device, x.dtype)
            x = x + pe[None, :, None, :]
            if adj is not None:
                adj = adj + pe[0].reshape(1, 1, 1, inner)
        ctx = x if adj is None else torch.cat([x, adj], dim=1)
        q, k, v = a1.to_q(x), a1.to_k(ctx), a1.to_v(ctx)
        if inject:   # before rotation, as the reference processor
            q = inject_source_rows(q, True, pnp_chunks)
            k = inject_source_rows(k, True, pnp_chunks)
        if self.rotary:
            pos = torch.arange(f, device=x.device, dtype=torch.float32)
            q = _rotate(q, pos, inner)
            k_pos = pos if adj is None else torch.cat(
                [pos, torch.zeros(ctx.shape[1] - f, device=x.device)])
            k = _rotate(k, k_pos, inner)
        out = temporal_attention(q, k, v, self.heads, a1.scale, pixel_sharded=pixel_sharded)
        return a1.to_out[0](out)

    @spanned("unet.temporal")
    def forward(self, x, context, frames: int, inject: bool = False, pnp_chunks: int = 4):
        bf, h_, w_, c = x.shape
        b, f, hw = bf // frames, frames, h_ * w_
        dt = self.dtype
        blk = self.transformer_blocks[0]
        tokens = self.proj_in(group_norm(x, self.norm, dt)).reshape(bf, hw, -1)
        inner = tokens.shape[-1]

        normed4 = layer_norm(tokens, blk.norm1, dt).reshape(b, f, hw, inner)
        region = sharded_region()
        f0row = int(bool(region) and self.first_frame_replicated)
        adj = None
        if self.augment:
            # frame 0's tokens, whole: a rank that does not hold global frame
            # 0 (no conditioning row in front) gathers it
            ff = (gather_frames(normed4[:, :1], region[0], 1)[:, 0] if region and not f0row
                  else normed4[:, 0])
            adj = _first_frame_adjacent_slices(ff, h_, w_)

        def attend(seq, mode):
            # sharded: every frame local, positions over the true sequence
            a = local_pixel_slice(adj, *region, 2) if adj is not None and mode == "pixels" else adj
            return self._self_attention(seq, a, inject, pnp_chunks, pixel_sharded=mode is not None)

        attn = around_frame_op(attend, (normed4,), f0row)
        tokens = tokens + attn.reshape(bf, hw, inner)

        normed4 = layer_norm(tokens, blk.norm2, dt).reshape(b, f, hw, inner)
        f_glob, pos = f, torch.arange(f, device=x.device, dtype=torch.float32)
        if region:
            f_real = f - f0row
            f_glob = f0row + f_real * region[1]
            pos = torch.cat([pos[:f0row], f0row + axis_index(region[0]) * f_real + pos[:f_real]])
        if not self.rotary:
            # the reference adds the sinusoidal PE in every call, attn2 included
            pe = torch.from_numpy(videoldm_positional_encoding(f_glob, inner)).to(x.device, dt)
            normed4 = normed4 + pe[pos.long()][None, :, None, :]
        a2 = blk.attn2
        q4 = a2.to_q(normed4)
        if self.rotary:
            # the query rotates in cross-attention too; the text keys do not
            q4 = _rotate(q4, pos, inner)
        ctx = context.to(dt)
        cross = multi_head_attention(q4.reshape(b, f * hw, inner), a2.to_k(ctx), a2.to_v(ctx),
                                     self.heads, a2.scale)
        tokens = tokens + a2.to_out[0](cross).reshape(bf, hw, inner)
        tokens = tokens + blk.ff(layer_norm(tokens, blk.norm3, dt))

        out = self.proj_out(tokens.reshape(bf, h_, w_, inner)) + x
        a = _alpha(self.alpha)
        return (a * x + (1.0 - a) * out).to(x.dtype)


class VideoLDMUNet(nn.Module):
    def __init__(self, config: VideoLDMUNetConfig = VideoLDMUNetConfig()):
        super().__init__()
        self.config = cfg = config
        dt, g = cfg.dtype, cfg.norm_num_groups
        ch0 = cfg.block_out_channels[0]
        ted = ch0 * 4
        ctx = cfg.cross_attention_dim
        mode = cfg.first_frame_condition_mode
        if mode not in ("none", "concat", "conv2d", "input_only"):
            raise ValueError(f"first_frame_condition_mode {mode!r}")
        cond_spatial = mode in ("concat", "conv2d")
        ff_row = mode != "none"   # the conditioning frame rides as frame 0
        rotary = cfg.temp_pos_embedding == "rotary"

        def spatial(ch):
            return VideoLDMSpatialTransformer(ch, ch // cfg.attention_head_dim,
                                              cfg.attention_head_dim, ctx, cond_spatial, g, dt)

        def temporal(ch):
            return VideoLDMTemporalTransformer(ch, cfg.n_temp_heads, ch // cfg.n_temp_heads, ctx,
                                               cfg.augment_temporal_attention, rotary, g, dt,
                                               first_frame_replicated=ff_row)

        def block(cin, ch, n_layers, cross, skip_ch=None):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if cfg.use_temporal:
                blk.conv3ds = nn.ModuleList()
            if cross:
                blk.attentions = nn.ModuleList()
                if cfg.use_temporal:
                    blk.tempo_attns = nn.ModuleList()
            if mode == "conv2d":   # acts at the block entry, on `cin` channels
                blk.first_frame_conv = nn.Conv2d(cfg.in_channels, cin, 1)
            for _ in range(n_layers):
                extra = skip_ch.pop() if skip_ch is not None else 0
                blk.resnets.append(ResnetBlock2D(cin + extra, ch, ted, g, dtype=dt))
                if cfg.use_temporal:
                    blk.conv3ds.append(AlphaTemporalResnet(ch, g, first_frame_replicated=ff_row))
                if cross:
                    blk.attentions.append(spatial(ch))
                    if cfg.use_temporal:
                        blk.tempo_attns.append(temporal(ch))
                cin = ch
            return blk

        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, ted)
        if cfg.use_frame_stride_condition:
            self.frame_stride_embedding = TimestepEmbedding(ch0, ted)

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
        if cfg.use_temporal:
            mid.conv3ds = nn.ModuleList([AlphaTemporalResnet(ch, g, first_frame_replicated=ff_row)
                                         for _ in range(2)])
        mid.attentions = nn.ModuleList([spatial(ch)])
        if mode == "conv2d":
            mid.first_frame_conv = nn.Conv2d(cfg.in_channels, ch, 1)
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

    @spanned("unet.forward")
    def forward(self, sample, timestep, encoder_hidden_states, first_frame_latents=None,
                frame_stride=None, pnp: Optional[Tuple[bool, bool, bool]] = None,
                pnp_chunks: Optional[int] = None):
        cfg = self.config
        dt = cfg.dtype
        mode = cfg.first_frame_condition_mode
        chunks = pnp_chunks or cfg.pnp_chunks
        if mode != "none":
            if first_frame_latents is None:
                raise ValueError("first_frame_condition_mode needs first_frame_latents")
            sample = torch.cat([first_frame_latents.to(sample.dtype), sample], dim=1)
        B, F_, H, W, _ = sample.shape
        ch0 = cfg.block_out_channels[0]
        dev = sample.device

        with span("unet.embed"):
            ts = torch.as_tensor(timestep, device=dev).reshape(-1).expand(B)
            emb = self.time_embedding(sinusoidal_embedding(ts, ch0).to(dt))
            if cfg.use_frame_stride_condition:
                fs = torch.as_tensor(1 if frame_stride is None else frame_stride,
                                     device=dev).reshape(-1).expand(B)
                emb = emb + self.frame_stride_embedding(sinusoidal_embedding(fs, ch0).to(dt))
            emb = emb.repeat_interleave(F_, dim=0)
        context = encoder_hidden_states.to(dt)

        @spanned("unet.embed")
        def ff_conv_inject(x, conv):
            """conv2d mode: frame 0 of the hidden states becomes a 1x1 conv of
            the nearest-resized first-frame latent (torch-nearest indexing)."""
            bf, h_, w_, c = x.shape
            ff = first_frame_latents[:, 0].to(dt)
            ih, iw = ff.shape[1:3]
            if (ih, iw) != (h_, w_):
                idx_h = torch.floor(torch.arange(h_, device=dev) * (ih / h_)).long()
                idx_w = torch.floor(torch.arange(w_, device=dev) * (iw / w_)).long()
                ff = ff[:, idx_h][:, :, idx_w]
            ff = conv_nhwc(conv, ff).to(x.dtype)
            xv = x.reshape(bf // F_, F_, h_, w_, c)
            return torch.cat([ff[:, None], xv[:, 1:]], dim=1).reshape(bf, h_, w_, c)

        def temporal_resnet(m, x):
            return fold_frames(m(unfold_frames(x, F_)))

        x = conv_nhwc(self.conv_in, fold_frames(sample.to(dt)))
        skips = [x]
        for blk in self.down_blocks:
            if mode == "conv2d":
                x = ff_conv_inject(x, blk.first_frame_conv)
            for j in range(len(blk.resnets)):
                with span("unet.resnet"):
                    x = blk.resnets[j](x, emb)
                if cfg.use_temporal:
                    x = temporal_resnet(blk.conv3ds[j], x)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context, F_)
                    if cfg.use_temporal:
                        x = blk.tempo_attns[j](x, context, F_)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        if mode == "conv2d":
            x = ff_conv_inject(x, mid.first_frame_conv)
        with span("unet.resnet"):
            x = mid.resnets[0](x, emb)
        if cfg.use_temporal:
            x = temporal_resnet(mid.conv3ds[0], x)
        x = mid.attentions[0](x, context, F_)
        with span("unet.resnet"):
            x = mid.resnets[1](x, emb)
        if cfg.use_temporal:
            x = temporal_resnet(mid.conv3ds[1], x)

        targets = set(cfg.pnp_attn_targets)
        for i, blk in enumerate(self.up_blocks):
            if mode == "conv2d":
                x = ff_conv_inject(x, blk.first_frame_conv)
            for j in range(len(blk.resnets)):
                x = torch.cat([x, skips.pop()], dim=-1)
                inj_conv = pnp is not None and pnp[0] and (i, j) == cfg.pnp_conv_target
                with span("unet.resnet"):
                    x = blk.resnets[j](x, emb, inject=inj_conv, pnp_chunks=chunks)
                if cfg.use_temporal:
                    x = temporal_resnet(blk.conv3ds[j], x)
                if hasattr(blk, "attentions"):
                    target = pnp is not None and (i, j) in targets
                    x = blk.attentions[j](x, context, F_, inject=target and pnp[1],
                                          pnp_chunks=chunks)
                    if cfg.use_temporal:
                        x = blk.tempo_attns[j](x, context, F_, inject=target and pnp[2],
                                               pnp_chunks=chunks)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = group_norm(x, self.conv_norm_out, dt, silu=True)
        out = unfold_frames(conv_nhwc(self.conv_out, x), F_)
        return out[:, 1:] if mode != "none" else out
