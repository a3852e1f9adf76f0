"""The ConsistI2V UNet (TIGER-Lab/ConsistI2V: SD2.1-base with VideoLDM temporal
layers) in plain float32, channels-last, with AnyV2V's plug-and-play
injection.

``unet(P, cfg, sample, t, text, first_frame, frame_stride, pnp, chunks)``:
``sample [B, F, h, w, 4]`` (the denoised frames), ``first_frame
[B, 1, h, w, 4]`` (the clean conditioning latent, put in front of the frame
axis and stripped from the output), ``text [B, S, D]``. ``cfg`` is the
configuration file's ``unet`` object; the modes it names are
``first_frame_condition_mode: concat`` (spatial self-attention also attends
to frame 0's keys and values), rotary temporal positions, and the augmented
temporal attention (frame 0's 8-neighbourhood as 8 extra keys at position 0).
Spatial heads are 64 wide (5/10/20 of them), temporal heads 8 of 40/80/160.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import (Params, attention, conv, downsample, feed_forward, frame_attention, group_norm,
                 inject, layer_norm, linear, mlp, resnet, sinusoidal, temporal_conv3, upsample)


def rotate(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary positions (``rotary_embedding_torch``, 'lang' frequencies,
    interleaved pairs) on the first half of the channels of ``[B, F, P, C]``
    tokens, at frame positions ``pos [F]``."""
    rot = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, rot, 2, dtype=torch.float64)[: rot // 2] / rot))
    ang = (pos.double()[:, None] * freqs.to(pos.device)[None]).float().repeat_interleave(2, -1)
    ang = ang[None, :, None, :]
    xr, rest = x[..., :rot], x[..., rot:]
    pair = torch.stack([-xr[..., 1::2], xr[..., 0::2]], dim=-1).reshape(xr.shape)
    return torch.cat([xr * torch.cos(ang) + pair * torch.sin(ang), rest], dim=-1)


def neighbours(ff: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Frame 0's 8-neighbourhood of every pixel, replicate-padded, centre
    left out: ``[B, HW, C]`` -> ``[B, 8, HW, C]``."""
    b, _, c = ff.shape
    img = F.pad(ff.reshape(b, h, w, c).permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    img = img.permute(0, 2, 3, 1)
    out = [img[:, di:di + h, dj:dj + w] for di in range(3) for dj in range(3)
           if (di, dj) != (1, 1)]
    return torch.stack(out, dim=1).reshape(b, 8, h * w, c)


def alpha_mix(P, name, x, out):
    a = torch.clamp(P(f"{name}.alpha", 1), 0.0, 1.0)
    return a * x + (1.0 - a) * out


def temporal_resnet(P, name, x, ch, groups):
    """Two groupnorm -> SiLU -> (3,1,1) conv stages over ``[B, F, H, W, C]``
    (statistics over the clip), residual, then the gate ``alpha``."""
    b, f = x.shape[:2]
    h = x.reshape(b, f, -1, ch)
    for k in (1, 2):
        h = F.silu(group_norm(P, f"{name}.norm{k}", h, groups, 1e-6))
        h = temporal_conv3(P, f"{name}.conv{k}", h, ch, ch)
    return alpha_mix(P, name, x, x + h.reshape(x.shape))


def spatial_transformer(P, name, x, ch, heads, hd, context, ctx_dim, frames, groups, pnp, chunks):
    """Spatial transformer; self-attention over the frame's own keys and
    values plus frame 0's (``concat`` mode)."""
    bf, h_, w_, _ = x.shape
    inner, blk = heads * hd, f"{name}.transformer_blocks.0"
    y = linear(P, f"{name}.proj_in", group_norm(P, f"{name}.norm", x, groups, 1e-6), ch, inner)
    y = y.reshape(bf, h_ * w_, inner)
    h = layer_norm(P, f"{blk}.norm1", y)
    a1 = f"{blk}.attn1"
    q = inject(linear(P, f"{a1}.to_q", h, inner, inner, False), pnp, chunks)
    k = inject(linear(P, f"{a1}.to_k", h, inner, inner, False), pnp, chunks)
    v = linear(P, f"{a1}.to_v", h, inner, inner, False)
    f0 = h.reshape(bf // frames, frames, h_ * w_, inner)[:, 0]
    k0 = inject(linear(P, f"{a1}.to_k", f0, inner, inner, False), pnp, chunks)
    v0 = linear(P, f"{a1}.to_v", f0, inner, inner, False)
    k = torch.cat([k, k0.repeat_interleave(frames, dim=0)], dim=1)
    v = torch.cat([v, v0.repeat_interleave(frames, dim=0)], dim=1)
    y = y + linear(P, f"{a1}.to_out.0", attention(P, q, k, v, heads), inner, inner)
    h = layer_norm(P, f"{blk}.norm2", y)
    ctx = context.repeat_interleave(frames, dim=0)
    a2 = f"{blk}.attn2"
    y = y + linear(P, f"{a2}.to_out.0", attention(
        P, linear(P, f"{a2}.to_q", h, inner, inner, False),
        linear(P, f"{a2}.to_k", ctx, ctx_dim, inner, False),
        linear(P, f"{a2}.to_v", ctx, ctx_dim, inner, False), heads), inner, inner)
    y = y + feed_forward(P, f"{blk}.ff", layer_norm(P, f"{blk}.norm3", y), inner)
    return linear(P, f"{name}.proj_out", y.reshape(bf, h_, w_, inner), inner, ch) + x


def temporal_transformer(P, name, x, ch, heads, hd, context, ctx_dim, frames, groups, pnp,
                         chunks):
    """Temporal transformer, gated by ``alpha``: self-attention over the frame
    axis with rotary positions and frame 0's neighbourhood as 8 extra keys at
    position 0; cross-attention of every token of a row to its text, the
    query rotated."""
    bf, h_, w_, _ = x.shape
    b, hw, inner, blk = bf // frames, h_ * w_, heads * hd, f"{name}.transformer_blocks.0"
    tok = linear(P, f"{name}.proj_in", group_norm(P, f"{name}.norm", x, groups, 1e-6), ch, inner)
    tok = tok.reshape(bf, hw, inner)
    pos = torch.arange(frames, device=x.device, dtype=torch.float32)

    n1 = layer_norm(P, f"{blk}.norm1", tok).reshape(b, frames, hw, inner)
    kv_in = torch.cat([n1, neighbours(n1[:, 0], h_, w_)], dim=1)
    a1 = f"{blk}.attn1"
    q = inject(linear(P, f"{a1}.to_q", n1, inner, inner, False), pnp, chunks)
    k = inject(linear(P, f"{a1}.to_k", kv_in, inner, inner, False), pnp, chunks)
    v = linear(P, f"{a1}.to_v", kv_in, inner, inner, False)
    q = rotate(q, pos)
    k = rotate(k, torch.cat([pos, torch.zeros(8, device=x.device)]))
    out = linear(P, f"{a1}.to_out.0", frame_attention(P, q, k, v, heads), inner, inner)
    tok = tok + out.reshape(bf, hw, inner)

    n2 = layer_norm(P, f"{blk}.norm2", tok).reshape(b, frames, hw, inner)
    a2 = f"{blk}.attn2"
    q = rotate(linear(P, f"{a2}.to_q", n2, inner, inner, False), pos).reshape(b, frames * hw, inner)
    cross = attention(P, q, linear(P, f"{a2}.to_k", context, ctx_dim, inner, False),
                      linear(P, f"{a2}.to_v", context, ctx_dim, inner, False), heads)
    tok = tok + linear(P, f"{a2}.to_out.0", cross, inner, inner).reshape(bf, hw, inner)
    tok = tok + feed_forward(P, f"{blk}.ff", layer_norm(P, f"{blk}.norm3", tok), inner)
    out = linear(P, f"{name}.proj_out", tok.reshape(bf, h_, w_, inner), inner, ch) + x
    return alpha_mix(P, name, x, out)


def unet(P: Params, cfg: dict, sample, t: int, text, first_frame, frame_stride: int,
         pnp=None, chunks: int = 3):
    chs = cfg["block_out_channels"]
    ch0, ted, ctx_dim, g = chs[0], chs[0] * 4, cfg["cross_attention_dim"], cfg["norm_num_groups"]
    ahd, nth = cfg["attention_head_dim"], cfg["n_temp_heads"]
    pnp = pnp or (False, False, False)
    sample = torch.cat([first_frame, sample], dim=1)
    B, Fr, H, W, _ = sample.shape
    dev = sample.device

    emb = (mlp(P, "time_embedding", sinusoidal(torch.full((B,), float(t), device=dev), ch0),
               ch0, ted)
           + mlp(P, "frame_stride_embedding",
                 sinusoidal(torch.full((B,), float(frame_stride), device=dev), ch0), ch0, ted))
    emb = emb.repeat_interleave(Fr, dim=0)

    def temporal(x, name, ch):
        n, h, w, c = x.shape
        return temporal_resnet(P, name, x.reshape(B, Fr, h, w, c), ch, g).reshape(n, h, w, c)

    def spatial(x, name, ch, inj=False):
        return spatial_transformer(P, name, x, ch, ch // ahd, ahd, text, ctx_dim, Fr, g, inj,
                                   chunks)

    def tempo(x, name, ch, inj=False):
        return temporal_transformer(P, name, x, ch, nth, ch // nth, text, ctx_dim, Fr, g, inj,
                                    chunks)

    x = conv(P, "conv_in", sample.reshape(B * Fr, H, W, -1), cfg["in_channels"], ch0)
    n = len(chs)
    skips, skip_ch, cur = [x], [ch0], ch0
    for i, ch in enumerate(chs):
        name = f"down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            x = resnet(P, f"{name}.resnets.{j}", x, cur, ch, emb, ted, g)
            x = temporal(x, f"{name}.conv3ds.{j}", ch)
            if i < n - 1:
                x = spatial(x, f"{name}.attentions.{j}", ch)
                x = tempo(x, f"{name}.tempo_attns.{j}", ch)
            cur = ch
            skips.append(x)
            skip_ch.append(ch)
        if i < n - 1:
            x = downsample(P, f"{name}.downsamplers.0", x, ch)
            skips.append(x)
            skip_ch.append(ch)

    ch = chs[-1]
    x = resnet(P, "mid_block.resnets.0", x, ch, ch, emb, ted, g)
    x = temporal(x, "mid_block.conv3ds.0", ch)
    x = spatial(x, "mid_block.attentions.0", ch)
    x = resnet(P, "mid_block.resnets.1", x, ch, ch, emb, ted, g)
    x = temporal(x, "mid_block.conv3ds.1", ch)

    targets = {tuple(tg) for tg in cfg["pnp_attn_targets"]}
    for i, ch in enumerate(reversed(chs)):
        name = f"up_blocks.{i}"
        for j in range(cfg["layers_per_block"] + 1):
            c_skip = skip_ch.pop()
            x = torch.cat([x, skips.pop()], dim=-1)
            inj_conv = pnp[0] and (i, j) == tuple(cfg["pnp_conv_target"])
            x = resnet(P, f"{name}.resnets.{j}", x, cur + c_skip, ch, emb, ted, g, pnp=inj_conv,
                       chunks=chunks)
            x = temporal(x, f"{name}.conv3ds.{j}", ch)
            if i > 0:
                tg = (i, j) in targets
                x = spatial(x, f"{name}.attentions.{j}", ch, tg and pnp[1])
                x = tempo(x, f"{name}.tempo_attns.{j}", ch, tg and pnp[2])
            cur = ch
        if i < n - 1:
            x = upsample(P, f"{name}.upsamplers.0", x, ch)

    x = F.silu(group_norm(P, "conv_norm_out", x, g, 1e-5))
    out = conv(P, "conv_out", x, ch0, cfg["out_channels"]).reshape(B, Fr, H, W, -1)
    return out[:, 1:]
