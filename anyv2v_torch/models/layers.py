"""Shared UNet building blocks, channels-last (counterpart of
``anyv2v_tpu/models/layers.py``).

Layouts: spatial activations ``[(B F), H, W, C]``, temporal activations
``[B, F, H, W, C]`` (frames unfolded only inside temporal layers), attention
tokens ``[..., C]``. 3x3 convolutions run on ``torch.channels_last`` views of
these tensors, so no layer permutes its data in memory.

Parameters carry the diffusers key names and shapes in ``state_dict()``, so
a diffusers checkpoint (or the JAX params through
:mod:`anyv2v_torch.utils.weights`) loads directly. Two modules store their
weights in another form for the kernels and convert in their state-dict
hooks: :class:`Attention` pads every head to :func:`padded_head_dim`
(i2vgen-xl's 5/10/20 -> 8/16/32), and the temporal conv stores ``[3, C, C']``.

Norms keep fp32 statistics and round once to the module's dtype
(:mod:`anyv2v_torch.ops.norm`); everything else computes in that dtype. PnP injection
flags are Python bools (see :mod:`anyv2v_torch.ops.pnp`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention, padded_head_dim, temporal_attention
from ..ops import norm as _norm
from ..ops.ffn import ffn_geglu, ffn_gelu, fits as ffn_fits
from ..ops.pnp import inject_source_rows
from ..ops.temporal_conv import groupnorm_silu_temporal_conv
from ..parallel.mesh import all_gather_axis, around_frame_op, sharded_region
from ..utils.profiling import span, spanned

# ---------------------------------------------------------------------------
# functional helpers
# ---------------------------------------------------------------------------


@spanned("layer.norm")
def group_norm(x: torch.Tensor, norm: nn.GroupNorm, dtype: Optional[torch.dtype] = None,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over every axis but the first and last of a channels-last
    tensor, then SiLU where ``silu``: fp32 statistics and arithmetic, one
    rounding to ``dtype`` (x's by default). Calls the KN entry through its
    module (``_norm.group_norm``), as the benchmark wraps it."""
    return _norm.group_norm(x.contiguous(), norm.weight, norm.bias, norm.num_groups, norm.eps,
                            x.dtype if dtype is None else dtype, silu=silu)


def clip_group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm of ``[B, F, H, W, C]`` with each clip's statistics taken over
    its frames and pixels together, as diffusers' ``TransformerTemporalModel``
    normalises ``[B, C, F, H, W]``: :func:`group_norm` on ``[B, F*H*W, C]``.
    Inside a manual-SPMD region x holds this rank's frames; KN's partial
    moments are then gathered from every rank before the apply."""
    b, f, h, w, c = x.shape
    region = sharded_region()
    if region is None:
        return group_norm(x.reshape(b, f * h * w, c), norm).reshape(x.shape)
    group, ranks = region
    with span("layer.norm"):
        y = _norm.group_norm(x.reshape(b, f * h * w, c).contiguous(), norm.weight, norm.bias,
                             norm.num_groups, norm.eps, x.dtype,
                             gather=lambda part: all_gather_axis(part, group, 2), shares=ranks)
    return y.reshape(x.shape)


@spanned("layer.norm")
def layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics and affine, one rounding
    to ``dtype`` (x's by default)."""
    return _norm.layer_norm(x.contiguous(), norm.weight, norm.bias, norm.eps,
                            x.dtype if dtype is None else dtype)


@spanned("layer.conv")
def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """nn.Conv2d on a channels-last ``[N, H, W, C]`` tensor."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride,
                 conv.padding)
    return y.permute(0, 2, 3, 1).contiguous()


def linear_1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 nn.Conv2d applied to channels-last tokens as a matmul."""
    return F.linear(x, conv.weight.reshape(conv.out_channels, conv.in_channels), conv.bias)


def _pointwise(proj: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 nn.Conv2d or an nn.Linear on channels-last tokens."""
    return linear_1x1(proj, x) if isinstance(proj, nn.Conv2d) else proj(x)


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                         downscale_freq_shift: float = 0.0,
                         max_period: float = 10000.0) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` (fp32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` on channels-last ``[B, H, W, C]``: an exact
    reshape-mean when the sizes divide (64x64 -> 32x32 at 512^2), the JAX
    package's linear resize otherwise."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return x.reshape(b, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=oh < h or ow < w)
    return y.permute(0, 2, 3, 1).contiguous()


def fold_frames(x: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, C] -> [(B F), H, W, C]"""
    b, f, h, w, c = x.shape
    return x.reshape(b * f, h, w, c)


def unfold_frames(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[(B F), H, W, C] -> [B, F, H, W, C]"""
    bf, h, w, c = x.shape
    return x.reshape(bf // num_frames, num_frames, h, w, c)


# ---------------------------------------------------------------------------
# embeddings and resnets
# ---------------------------------------------------------------------------


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D; the PnP conv injection point is after conv2,
    before the shortcut add."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-5, dtype=torch.float32,
                 pnp_chunks: int = 3):
        super().__init__()
        self.dtype, self.pnp_chunks = dtype, pnp_chunks
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels) if temb_dim else None
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None, inject: bool = False, pnp_chunks: Optional[int] = None):
        h = conv_nhwc(self.conv1, group_norm(x, self.norm1, self.dtype, silu=True))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = conv_nhwc(self.conv2, group_norm(h, self.norm2, self.dtype, silu=True))
        h = inject_source_rows(h, inject, pnp_chunks or self.pnp_chunks)
        if self.conv_shortcut is not None:
            x = linear_1x1(self.conv_shortcut, x)
        return x + h


# ---------------------------------------------------------------------------
# temporal conv
# ---------------------------------------------------------------------------


class TemporalConv3(nn.Module):
    """(3,1,1) Conv3d parameters stored as ``weight [3, C, C']`` for the K4
    kernel; ``state_dict()`` shows the diffusers Conv3d shape
    ``[C', C, 3, 1, 1]`` and loading converts back."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self._register_state_dict_hook(TemporalConv3._export)
        self._register_load_state_dict_pre_hook(TemporalConv3._import, with_module=True)

    @staticmethod
    def _export(module, state_dict, prefix, local_metadata):
        w = state_dict[prefix + "weight"]
        state_dict[prefix + "weight"] = w.permute(2, 1, 0)[..., None, None].contiguous()

    @staticmethod
    def _import(module, state_dict, prefix, *args):
        key = prefix + "weight"
        if key in state_dict and state_dict[key].dim() == 5:
            state_dict[key] = state_dict[key][:, :, :, 0, 0].permute(2, 1, 0).contiguous()


class TemporalConvLayer(nn.Module):
    """diffusers ``TemporalConvLayer``: four (groupnorm -> silu -> (3,1,1)
    conv) stages with an identity residual, on ``[B, F, H, W, C]``. Each stage
    is one K4 launch; the group statistics are a plain reduction. Inside a
    manual-SPMD region one all-to-all to pixel sharding, hoisted around the
    four stages, gives them every frame (where the pixels divide into shares
    of at least 8; elsewhere each stage gathers the frames itself)."""

    def __init__(self, channels: int, groups: int = 32, dtype=torch.float32):
        super().__init__()
        for i in range(1, 5):
            stage = nn.Module()
            stage.add_module("0", nn.GroupNorm(groups, channels, eps=1e-5))
            stage.add_module("2" if i == 1 else "3", TemporalConv3(channels, channels))
            self.add_module(f"conv{i}", stage)

    @spanned("unet.resnet")
    def forward(self, x):
        b, f = x.shape[:2]
        h = around_frame_op(self._stages, (x.reshape(b, f, -1, x.shape[-1]),), gather=False)
        return x + h.reshape(x.shape[:-1] + (h.shape[-1],))

    def _stages(self, h, mode):
        for i in range(1, 5):
            stage = getattr(self, f"conv{i}")
            conv = stage._modules["2" if i == 1 else "3"]
            h = groupnorm_silu_temporal_conv(h, stage._modules["0"], conv.weight, conv.bias,
                                             pixel_sharded=mode == "pixels")
        return h


# ---------------------------------------------------------------------------
# attention and transformer blocks
# ---------------------------------------------------------------------------


_PROJECTIONS = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")   # head-padded outputs


class Attention(nn.Module):
    """diffusers Attention with the PnP Q/K injection point (Q and K only,
    never V) and padded head storage: ``to_q/to_k/to_v`` hold each head
    padded to :func:`padded_head_dim` with zero rows, ``to_out`` the matching
    zero columns, so activations come out of the projections already in the
    kernels' head widths. ``state_dict()`` strips the padding (the
    checkpoint's true widths) and loading pads again. The softmax scale comes
    from the true head width. ``ip=True`` adds the IP-Adapter's ``to_k_ip`` /
    ``to_v_ip`` (padded the same way): given ``ip_tokens``, the output is
    ``attn(q, k, v) + ip_scale * attn(q, k_ip, v_ip)``."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 qkv_bias: bool = False, pnp_chunks: int = 3, ip: bool = False):
        super().__init__()
        self.heads, self.head_dim, self.pnp_chunks = heads, head_dim, pnp_chunks
        self.stored_head_dim = padded_head_dim(head_dim)
        self.scale = float(head_dim) ** -0.5
        inner = heads * self.stored_head_dim
        kv_dim = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, out_dim or query_dim)])
        if ip:   # the IP-Adapter branch: image tokens through their own K/V
            self.to_k_ip = nn.Linear(kv_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(kv_dim, inner, bias=False)
        if self.stored_head_dim != head_dim:
            self._register_state_dict_hook(Attention._strip_padding)
            self._register_load_state_dict_pre_hook(Attention._pad_heads, with_module=True)

    @staticmethod
    def _strip_padding(module, state_dict, prefix, local_metadata):
        h, d, p = module.heads, module.head_dim, module.stored_head_dim
        for name in _PROJECTIONS:
            for suffix in ("weight", "bias"):
                key = f"{prefix}{name}.{suffix}"
                if key in state_dict:
                    w = state_dict[key]
                    w = w.reshape(h, p, *w.shape[1:])[:, :d]
                    state_dict[key] = w.reshape(h * d, *w.shape[2:]).contiguous()
        key = f"{prefix}to_out.0.weight"
        w = state_dict[key]
        state_dict[key] = w.reshape(w.shape[0], h, p)[:, :, :d].reshape(w.shape[0], h * d).contiguous()

    @staticmethod
    def _pad_heads(module, state_dict, prefix, *args):
        h, d, p = module.heads, module.head_dim, module.stored_head_dim
        for name in _PROJECTIONS:
            for suffix in ("weight", "bias"):
                key = f"{prefix}{name}.{suffix}"
                if key in state_dict and state_dict[key].shape[0] == h * d:
                    w = state_dict[key]
                    w = w.reshape(h, d, *w.shape[1:])
                    w = F.pad(w, (0, 0) * (w.dim() - 2) + (0, p - d))
                    state_dict[key] = w.reshape(h * p, *w.shape[2:])
        key = f"{prefix}to_out.0.weight"
        if key in state_dict and state_dict[key].shape[1] == h * d:
            w = state_dict[key]
            w = F.pad(w.reshape(w.shape[0], h, d), (0, p - d))
            state_dict[key] = w.reshape(w.shape[0], h * p)

    def forward(self, x, context=None, inject: bool = False, frame_axis: bool = False,
                ip_tokens: Optional[torch.Tensor] = None, ip_scale: float = 1.0,
                pixel_sharded: bool = False, bias: Optional[torch.Tensor] = None):
        """``bias``: an additive score bias, broadcastable to ``[B, heads, Sq,
        Sk]`` (with ``frame_axis``: fp32 ``[heads, S, Sk]``)."""
        ctx = x if context is None else context
        q = inject_source_rows(self.to_q(x), inject, self.pnp_chunks)
        k = inject_source_rows(self.to_k(ctx), inject, self.pnp_chunks)
        v = self.to_v(ctx)
        if frame_axis:
            # temporal tokens [B, F, HW, C]: attend over F in place
            out = temporal_attention(q, k, v, self.heads, self.scale, bias=bias,
                                     pixel_sharded=pixel_sharded)
        else:
            out = multi_head_attention(q, k, v, self.heads, self.scale, bias=bias)
        if ip_tokens is not None and hasattr(self, "to_k_ip"):
            # out + ip_scale * attn(q, k_ip, v_ip): the same queries over the
            # image tokens, under a softmax of their own
            ip = ip_tokens.to(q.dtype)
            out = out + ip_scale * multi_head_attention(q, self.to_k_ip(ip), self.to_v_ip(ip),
                                                        self.heads, self.scale)
        return self.to_out[0](out)


class _Proj(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out)


class FeedForward(nn.Module):
    """diffusers FeedForward (``net.0.proj``, ``net.2``) with exact-erf GELU.
    Both forms route to the K3 kernel where it fits (C <= 768, C % 32 == 0),
    as the JAX package's to its fused Pallas kernel."""

    def __init__(self, dim: int, mult: int = 4, activation: str = "geglu"):
        super().__init__()
        if activation not in ("geglu", "gelu"):
            raise ValueError(activation)
        self.activation = activation
        inner = dim * mult
        self.net = nn.ModuleList([
            _Proj(dim, 2 * inner if activation == "geglu" else inner),
            nn.Identity(),
            nn.Linear(inner, dim),
        ])

    @spanned("layer.ffn")
    def forward(self, x):
        proj, out = self.net[0].proj, self.net[2]
        if self.activation == "geglu":
            if ffn_fits(x.shape[-1], out.in_features):
                return ffn_geglu(x.contiguous(), proj.weight, proj.bias, out.weight, out.bias)
            h, gate = proj(x).chunk(2, dim=-1)
            return out(h * F.gelu(gate))
        if ffn_fits(x.shape[-1], out.in_features):
            return ffn_gelu(x.contiguous(), proj.weight, proj.bias, out.weight, out.bias)
        return out(F.gelu(proj(x)))


class BasicTransformerBlock(nn.Module):
    """norm1 -> attn1 (self) -> norm2 -> attn2 (cross, or self when no context
    dim) -> norm3 -> ff. PnP injection reaches attn1 only, IP-Adapter tokens
    attn2 only (``ip=True``: the target blocks)."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None, dtype=torch.float32,
                 pnp_chunks: int = 3, ip: bool = False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, pnp_chunks=pnp_chunks)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, cross_attention_dim=cross_attention_dim,
                               ip=ip)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, inject: bool = False, frame_axis: bool = False,
                ip_tokens=None, ip_scale: float = 1.0, pixel_sharded: bool = False,
                bias: Optional[torch.Tensor] = None):
        """``bias`` reaches attn1 only, as in the JAX block."""
        dt = self.dtype
        x = x + self.attn1(layer_norm(x, self.norm1, dt), inject=inject,
                           frame_axis=frame_axis, pixel_sharded=pixel_sharded, bias=bias)
        x = x + self.attn2(layer_norm(x, self.norm2, dt), context=context,
                           frame_axis=frame_axis, ip_tokens=ip_tokens, ip_scale=ip_scale,
                           pixel_sharded=pixel_sharded)
        return x + self.ff(layer_norm(x, self.norm3, dt))


class SpatialTransformer(nn.Module):
    """diffusers Transformer2DModel over ``[(B F), H, W, C]``: groupnorm ->
    proj_in -> ``depth`` blocks on the flattened pixels -> proj_out ->
    residual. ``proj_in`` / ``proj_out`` are 1x1 convs, or Linear layers with
    ``linear_projection`` (diffusers' ``use_linear_projection``, SDXL's
    checkpoints): the same matmul either way, in the checkpoint's shapes."""

    def __init__(self, channels: int, heads: int, head_dim: int, cross_attention_dim: int,
                 groups: int = 32, dtype=torch.float32, pnp_chunks: int = 3, depth: int = 1,
                 ip: bool = False, linear_projection: bool = False):
        super().__init__()
        self.dtype = dtype
        inner = heads * head_dim
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        proj = nn.Linear if linear_projection else functools.partial(nn.Conv2d, kernel_size=1)
        self.proj_in = proj(channels, inner)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner, heads, head_dim, cross_attention_dim, dtype, pnp_chunks, ip)
            for _ in range(depth)])
        self.proj_out = proj(inner, channels)

    @spanned("unet.spatial")
    def forward(self, x, context=None, inject: bool = False, ip_tokens=None,
                ip_scale: float = 1.0):
        b, h, w, c = x.shape
        y = _pointwise(self.proj_in, group_norm(x, self.norm, self.dtype))
        y = y.reshape(b, h * w, -1)
        for block in self.transformer_blocks:
            y = block(y, context=context, inject=inject, ip_tokens=ip_tokens, ip_scale=ip_scale)
        return _pointwise(self.proj_out, y.reshape(b, h, w, -1)) + x


class TemporalTransformer(nn.Module):
    """diffusers TransformerTemporalModel over ``[B, F, H, W, C]``: the group
    norm's statistics span each clip's frames (:func:`clip_group_norm`);
    tokens are frames per pixel and stay in the module-native ``[B, F, HW,
    C]`` layout; both attentions of the block attend over F (K2). Inside a
    manual-SPMD region one all-to-all at the module boundary gives the whole
    block every frame (projections and FF are per token), where the pixels
    divide into shares of at least 8; elsewhere each attention gathers the
    frames.

    With a ``bias`` (broadcastable to ``[B*H*W, heads, F, F]``, added to
    attn1's scores) the block runs on ``[(B H W), F, C]`` rows through the
    dispatcher, as the JAX module does; a bias that every row shares reaches
    K2 there, on the ``[B, S, 1, C]`` view. The frames are then gathered (or
    the pixels sharded) around the whole block inside a manual-SPMD
    region."""

    def __init__(self, channels: int, heads: int, head_dim: int, groups: int = 32,
                 dtype=torch.float32, pnp_chunks: int = 3):
        super().__init__()
        self.dtype = dtype
        inner = heads * head_dim
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner, heads, head_dim, None, dtype, pnp_chunks)])
        self.proj_out = nn.Linear(inner, channels)

    @spanned("unet.temporal")
    def forward(self, x, inject: bool = False, bias: Optional[torch.Tensor] = None):
        b, f, h, w, c = x.shape
        y = clip_group_norm(x, self.norm)   # x is in the module's dtype

        def block(y, mode):
            y = self.proj_in(y)
            if bias is None:
                y = self.transformer_blocks[0](y, inject=inject, frame_axis=True,
                                               pixel_sharded=mode == "pixels")
            else:
                rb, rf, rp, rc = y.shape
                rows = y.transpose(1, 2).reshape(rb * rp, rf, rc)
                y = self.transformer_blocks[0](rows, inject=inject, bias=bias)
                y = y.reshape(rb, rp, rf, -1).transpose(1, 2)
            return self.proj_out(y)

        y = around_frame_op(block, (y.reshape(b, f, h * w, c),), gather=bias is not None)
        return y.reshape(b, f, h, w, c) + x


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


class Downsample2D(nn.Module):
    """Strided 3x3 conv. ``asymmetric_pad``: the diffusers VAE encoder's
    padding=0 conv after an explicit right/bottom pad of one pixel."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return conv_nhwc(self.conv, x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        return conv_nhwc(self.conv, x)
