"""The I2VGen-XL UNet (diffusers ``I2VGenXLUNet``, ali-vilab/i2vgen-xl) in
plain float32, channels-last, with AnyV2V's plug-and-play injection.

``unet(P, cfg, sample, t, text, fps, image_latents, image_embeds, pnp)``:
``sample`` and ``image_latents`` ``[B, F, h, w, 4]``, ``text [B, S, D]``,
``image_embeds [B, 1, D]``, ``t`` and ``fps`` ints; returns eps
``[B, F, h, w, 4]``. ``pnp = (conv, spatial, temporal)`` over a batch of
``chunks`` row groups whose first is the source: the conv features after
conv2 of up-block resnet ``pnp_conv_target``, and the Q/K of spatial and
temporal attn1 in the up-block layers of ``pnp_attn_targets``, are replaced
by the source rows'.

``cfg`` is the configuration file's ``unet`` object. The checkpoint's
``num_attention_heads`` = 64 is the head count (as diffusers reads its 3D UNets), so
the heads are 5/10/20 wide, computed at that width.

As the published modules: the temporal transformer's group norm takes its
statistics over every frame of a clip (diffusers ``TransformerTemporalModel``
permutes to ``[B, C, F, H, W]`` before ``self.norm``), as the temporal conv
layer's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import (Params, attn_module, conv, downsample, feed_forward, group_norm, layer_norm,
                 linear, mlp, resnet, sinusoidal, temporal_conv3, upsample)


def heads_of(cfg: dict, channels: int):
    n = cfg.get("num_attention_heads")
    if n:
        return n, channels // n
    return channels // cfg["attention_head_dim"], cfg["attention_head_dim"]


def block(P, name, x, dim, heads, hd, ctx=None, ctx_dim=None, pnp=False, chunks=3,
          frames=False):
    """norm1 -> attn1 (self) -> norm2 -> attn2 (cross, or self without a
    context) -> norm3 -> GEGLU; PnP reaches attn1 only."""
    h = layer_norm(P, f"{name}.norm1", x)
    x = x + attn_module(P, f"{name}.attn1", h, h, dim, heads, hd, dim, pnp, chunks, frames)
    h = layer_norm(P, f"{name}.norm2", x)
    c, cd = (h, dim) if ctx is None else (ctx, ctx_dim)
    x = x + attn_module(P, f"{name}.attn2", h, c, dim, heads, hd, cd, frames=frames)
    return x + feed_forward(P, f"{name}.ff", layer_norm(P, f"{name}.norm3", x), dim)


def spatial_transformer(P, name, x, ch, heads, hd, ctx, ctx_dim, groups, pnp, chunks):
    """Transformer2DModel over ``[N, H, W, C]`` with 1x1-conv projections."""
    n, h, w, _ = x.shape
    inner = heads * hd
    y = conv(P, f"{name}.proj_in", group_norm(P, f"{name}.norm", x, groups, 1e-6), ch, inner, k=1)
    y = block(P, f"{name}.transformer_blocks.0", y.reshape(n, h * w, inner), inner, heads, hd,
              ctx, ctx_dim, pnp, chunks)
    return conv(P, f"{name}.proj_out", y.reshape(n, h, w, inner), inner, ch, k=1) + x


def temporal_transformer(P, name, x, ch, heads, hd, groups, pnp=False, chunks=3):
    """TransformerTemporalModel over ``[B, F, H, W, C]``: the group norm over
    every frame of a clip, then both attentions of the block over the frame
    axis, every pixel on its own."""
    b, f, h, w, c = x.shape
    inner = heads * hd
    y = group_norm(P, f"{name}.norm", x, groups, 1e-6)
    y = linear(P, f"{name}.proj_in", y.reshape(b, f, h * w, c), ch, inner)
    y = block(P, f"{name}.transformer_blocks.0", y, inner, heads, hd, pnp=pnp, chunks=chunks,
              frames=True)
    return linear(P, f"{name}.proj_out", y, inner, ch).reshape(x.shape) + x


def temporal_conv_layer(P, name, x, ch, groups):
    """Four groupnorm -> SiLU -> (3,1,1) conv stages, identity residual; the
    norm's statistics over every frame of a clip."""
    b, f = x.shape[:2]
    h = x.reshape(b, f, -1, ch)
    for i in range(1, 5):
        h = F.silu(group_norm(P, f"{name}.conv{i}.0", h, groups, 1e-5))
        h = temporal_conv3(P, f"{name}.conv{i}.{2 if i == 1 else 3}", h, ch, ch)
    return x + h.reshape(x.shape)


def pool_2d(x, oh, ow):
    """AdaptiveAvgPool2d on channels-last ``[B, H, W, C]``."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (oh, ow))
    return y.permute(0, 2, 3, 1)


def unet(P: Params, cfg: dict, sample, t: int, text, fps: int, image_latents, image_embeds,
         pnp=None, chunks: int = 3):
    chs = cfg["block_out_channels"]
    ch0, ted, ctx_dim = chs[0], chs[0] * 4, cfg["cross_attention_dim"]
    g, c_lat, n_tok = cfg["norm_num_groups"], cfg["in_channels"], cfg["num_image_context_tokens"]
    B, Fr, H, W, _ = sample.shape
    dev = sample.device
    pnp = pnp or (False, False, False)

    emb = (mlp(P, "time_embedding", sinusoidal(torch.full((B,), float(t), device=dev), ch0),
               ch0, ted)
           + mlp(P, "fps_embedding", sinusoidal(torch.full((B,), float(fps), device=dev), ch0),
                 ch0, ted, keys=("0", "2")))
    emb = emb.repeat_interleave(Fr, dim=0)

    # cross-attention context: text, 64 local image tokens, n_tok global tokens
    ce = "image_latents_context_embedding"
    z = F.silu(conv(P, f"{ce}.0", image_latents[:, 0], c_lat, 8 * c_lat))
    z = pool_2d(z, 32, 32)
    z = F.silu(conv(P, f"{ce}.3", z, 8 * c_lat, 16 * c_lat, stride=2))
    z = conv(P, f"{ce}.5", z, 16 * c_lat, ctx_dim, stride=2)
    img_ctx = z.reshape(B, -1, ctx_dim)
    gtok = linear(P, "context_embedding.2", F.silu(
        linear(P, "context_embedding.0", image_embeds, ctx_dim, ted * 4)), ted * 4,
        ctx_dim * n_tok).reshape(B, n_tok, ctx_dim)
    context = torch.cat([text, img_ctx, gtok], dim=1).repeat_interleave(Fr, dim=0)

    # image latents: per-frame convs, then a 2-head transformer over frames per pixel
    pi = "image_latents_proj_in"
    il = image_latents.reshape(B * Fr, H, W, c_lat)
    il = F.silu(conv(P, f"{pi}.0", il, c_lat, 4 * c_lat))
    il = F.silu(conv(P, f"{pi}.2", il, 4 * c_lat, 4 * c_lat))
    il = conv(P, f"{pi}.4", il, 4 * c_lat, c_lat)
    il = il.reshape(B, Fr, H * W, c_lat).permute(0, 2, 1, 3).reshape(B * H * W, Fr, c_lat)
    te = "image_latents_temporal_encoder"
    h = layer_norm(P, f"{te}.norm1", il)
    il = il + attn_module(P, f"{te}.attn1", h, h, c_lat, 2, c_lat, c_lat)
    il = il + feed_forward(P, f"{te}.ff", il, c_lat, gelu_only=True)
    il = il.reshape(B, H, W, Fr, c_lat).permute(0, 3, 1, 2, 4)

    x = conv(P, "conv_in", torch.cat([sample, il], dim=-1).reshape(B * Fr, H, W, 2 * c_lat),
             2 * c_lat, ch0)
    tin_hd = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    x = temporal_transformer(P, "transformer_in", x.reshape(B, Fr, H, W, ch0), ch0, 8, tin_hd,
                             g).reshape(B * Fr, H, W, ch0)

    def temporal(fn, x, *a, **kw):
        n, h, w, c = x.shape
        return fn(P, *a[:1], x.reshape(B, Fr, h, w, c), *a[1:], **kw).reshape(n, h, w, c)

    n = len(chs)
    skips, skip_ch, cur = [x], [ch0], ch0
    for i, ch in enumerate(chs):
        heads, hd = heads_of(cfg, ch)
        name = f"down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            x = resnet(P, f"{name}.resnets.{j}", x, cur, ch, emb, ted, g)
            x = temporal(temporal_conv_layer, x, f"{name}.temp_convs.{j}", ch, g)
            if i < n - 1:
                x = spatial_transformer(P, f"{name}.attentions.{j}", x, ch, heads, hd, context,
                                        ctx_dim, g, False, chunks)
                x = temporal(temporal_transformer, x, f"{name}.temp_attentions.{j}", ch, heads,
                             hd, g)
            cur = ch
            skips.append(x)
            skip_ch.append(ch)
        if i < n - 1:
            x = downsample(P, f"{name}.downsamplers.0", x, ch)
            skips.append(x)
            skip_ch.append(ch)

    ch = chs[-1]
    heads, hd = heads_of(cfg, ch)
    x = resnet(P, "mid_block.resnets.0", x, ch, ch, emb, ted, g)
    x = temporal(temporal_conv_layer, x, "mid_block.temp_convs.0", ch, g)
    x = spatial_transformer(P, "mid_block.attentions.0", x, ch, heads, hd, context, ctx_dim, g,
                            False, chunks)
    x = temporal(temporal_transformer, x, "mid_block.temp_attentions.0", ch, heads, hd, g)
    x = resnet(P, "mid_block.resnets.1", x, ch, ch, emb, ted, g)
    x = temporal(temporal_conv_layer, x, "mid_block.temp_convs.1", ch, g)

    targets = {tuple(tg) for tg in cfg["pnp_attn_targets"]}
    for i, ch in enumerate(reversed(chs)):
        heads, hd = heads_of(cfg, ch)
        name = f"up_blocks.{i}"
        for j in range(cfg["layers_per_block"] + 1):
            c_skip = skip_ch.pop()
            x = torch.cat([x, skips.pop()], dim=-1)
            inj_conv = pnp[0] and (i, j) == tuple(cfg["pnp_conv_target"])
            x = resnet(P, f"{name}.resnets.{j}", x, cur + c_skip, ch, emb, ted, g, pnp=inj_conv,
                       chunks=chunks)
            x = temporal(temporal_conv_layer, x, f"{name}.temp_convs.{j}", ch, g)
            if i > 0:
                tg = (i, j) in targets
                x = spatial_transformer(P, f"{name}.attentions.{j}", x, ch, heads, hd, context,
                                        ctx_dim, g, tg and pnp[1], chunks)
                x = temporal(temporal_transformer, x, f"{name}.temp_attentions.{j}", ch, heads,
                             hd, g, pnp=tg and pnp[2], chunks=chunks)
            cur = ch
        if i < n - 1:
            x = upsample(P, f"{name}.upsamplers.0", x, ch)

    x = F.silu(group_norm(P, "conv_norm_out", x, g, 1e-5))
    return conv(P, "conv_out", x, ch0, cfg["out_channels"]).reshape(B, Fr, H, W, -1)


