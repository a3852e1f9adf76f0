"""JAX params -> the port's ``state_dict`` (numpy in, numpy out).

:func:`state_dict_from_jax` is the exact inverse of the converters in
``anyv2v_tpu/utils/convert.py`` (``convert_unet_i2vgen``,
``convert_unet_videoldm``, ``convert_unet_seine``, ``convert_vae``,
``convert_clip_text``, ``convert_clip_vision``; for the first-frame editors
``convert_unet_sd`` with ``merge_ip_adapter_into_unet``,
``convert_controlnet``, ``convert_ip_adapter``'s ``image_proj``,
``convert_resampler`` and ``convert_mlp_proj``): the port's modules use the
diffusers / Hugging Face (and, for the ConsistI2V and SEINE UNets, the
reference checkpoints') key names, so the output also has a real
checkpoint's layout. Attention projections lose the zero columns that
``pad_attention_heads`` added (checked to be zero); the port pads them back
when the state dict is loaded (``models.layers.Attention``).

Also reads the JAX package's ``save_params`` ``.npz`` files with numpy alone.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from ..ops.attention import padded_head_dim

Tree = Dict[str, Any]
StateDict = Dict[str, np.ndarray]


def _params(tree: Tree) -> Tree:
    return tree["params"] if "params" in tree else tree


def _linear(sd: StateDict, prefix: str, t: Tree) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(t["kernel"]).T)
    if "bias" in t:
        sd[f"{prefix}.bias"] = np.asarray(t["bias"])


def _conv(sd: StateDict, prefix: str, t: Tree) -> None:
    k = np.asarray(t["kernel"])
    perm = (3, 2, 0, 1) if k.ndim == 4 else (4, 3, 0, 1, 2)
    sd[f"{prefix}.weight"] = np.ascontiguousarray(k.transpose(perm))
    if "bias" in t:
        sd[f"{prefix}.bias"] = np.asarray(t["bias"])


def _norm(sd: StateDict, prefix: str, t: Tree) -> None:
    sd[f"{prefix}.weight"] = np.asarray(t["scale"])
    sd[f"{prefix}.bias"] = np.asarray(t["bias"])


def _unpad(t: Tree, heads: int, head_dim: int, axis: int, where: str) -> Tree:
    """Drop the zero pad of each head along ``axis`` of the kernel (1: output
    columns of to_q/k/v, 0: input rows of to_out), and of the bias."""
    pd = padded_head_dim(head_dim)
    if pd == head_dim:
        return t
    out = dict(t)
    k = np.asarray(t["kernel"])
    if axis == 1:
        kh = k.reshape(k.shape[0], heads, pd)
        pad, keep = kh[:, :, head_dim:], kh[:, :, :head_dim]
        out["kernel"] = keep.reshape(k.shape[0], heads * head_dim)
    else:
        kh = k.reshape(heads, pd, k.shape[1])
        pad, keep = kh[:, head_dim:], kh[:, :head_dim]
        out["kernel"] = keep.reshape(heads * head_dim, k.shape[1])
    if np.any(pad != 0):
        raise ValueError(f"{where}: padded head columns are not zero")
    if "bias" in t and axis == 1:
        b = np.asarray(t["bias"]).reshape(heads, pd)
        if np.any(b[:, head_dim:] != 0):
            raise ValueError(f"{where}: padded head bias is not zero")
        out["bias"] = b[:, :head_dim].reshape(heads * head_dim)
    return out


def _attn(sd: StateDict, p: str, t: Tree, heads: int, head_dim: int) -> None:
    for n in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
        if n in t:
            _linear(sd, f"{p}.{n}", _unpad(t[n], heads, head_dim, 1, f"{p}.{n}"))
    _linear(sd, f"{p}.to_out.0", _unpad(t["to_out"], heads, head_dim, 0, f"{p}.to_out"))


def _ff(sd: StateDict, p: str, t: Tree) -> None:
    _linear(sd, f"{p}.net.0.proj", t["proj_in"])
    _linear(sd, f"{p}.net.2", t["proj_out"])


def _block(sd: StateDict, p: str, t: Tree, heads: int, head_dim: int) -> None:
    _norm(sd, f"{p}.norm1", t["norm1"])
    _attn(sd, f"{p}.attn1", t["attn1"], heads, head_dim)
    if "attn2" in t:
        _norm(sd, f"{p}.norm2", t["norm2"])
        _attn(sd, f"{p}.attn2", t["attn2"], heads, head_dim)
    _norm(sd, f"{p}.norm3", t["norm3"])
    _ff(sd, f"{p}.ff", t["ff"])


def _transformer(sd: StateDict, p: str, t: Tree, heads: int, head_dim: int,
                 spatial: bool) -> None:
    _norm(sd, f"{p}.norm", t["norm"])
    put = _conv if spatial else _linear
    put(sd, f"{p}.proj_in", t["proj_in"])
    _block(sd, f"{p}.transformer_blocks.0", t["blocks_0"], heads, head_dim)
    put(sd, f"{p}.proj_out", t["proj_out"])


def _resnet(sd: StateDict, p: str, t: Tree) -> None:
    _norm(sd, f"{p}.norm1", t["norm1"])
    _conv(sd, f"{p}.conv1", t["conv1"])
    _norm(sd, f"{p}.norm2", t["norm2"])
    _conv(sd, f"{p}.conv2", t["conv2"])
    if "time_emb_proj" in t:
        _linear(sd, f"{p}.time_emb_proj", t["time_emb_proj"])
    if "conv_shortcut" in t:
        _conv(sd, f"{p}.conv_shortcut", t["conv_shortcut"])


def _temp_conv(sd: StateDict, p: str, t: Tree) -> None:
    for i in range(1, 5):
        _norm(sd, f"{p}.conv{i}.0", t[f"norm{i}"])
        _conv(sd, f"{p}.conv{i}.{2 if i == 1 else 3}", t[f"conv{i}"])


def unet_state_dict(tree: Tree, cfg) -> StateDict:
    """I2VGenUNet params -> diffusers ``I2VGenXLUNet`` keys; ``cfg`` an
    :class:`~anyv2v_torch.models.unet_i2vgen.I2VGenUNetConfig`."""
    p = _params(tree)
    sd: StateDict = {}
    _conv(sd, "conv_in", p["conv_in"])
    _transformer(sd, "transformer_in", p["transformer_in"], 8,
                 cfg.num_attention_heads or cfg.attention_head_dim, spatial=False)
    for name in ("linear_1", "linear_2"):
        _linear(sd, f"time_embedding.{name}", p["time_embedding"][name])
    _linear(sd, "fps_embedding.0", p["fps_embedding"]["linear_1"])
    _linear(sd, "fps_embedding.2", p["fps_embedding"]["linear_2"])
    for i, idx in ((1, 0), (2, 2), (3, 4)):
        _conv(sd, f"image_latents_proj_in.{idx}", p[f"img_lat_proj{i}"])
    for i, idx in ((1, 0), (2, 3), (3, 5)):
        _conv(sd, f"image_latents_context_embedding.{idx}", p[f"img_ctx_conv{i}"])
    _linear(sd, "context_embedding.0", p["context_embedding_1"])
    _linear(sd, "context_embedding.2", p["context_embedding_2"])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    te = p["image_latents_temporal_encoder"]
    _norm(sd, "image_latents_temporal_encoder.norm1", te["norm1"])
    _attn(sd, "image_latents_temporal_encoder.attn1", te["attn1"], 2, cfg.in_channels)
    _ff(sd, "image_latents_temporal_encoder.ff", te["ff"])

    chs = cfg.block_out_channels
    n = len(chs)
    for i, ch in enumerate(chs):
        heads, hd = cfg.heads(ch)
        base = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"{base}.resnets.{j}", p[f"down_{i}_resnet_{j}"])
            _temp_conv(sd, f"{base}.temp_convs.{j}", p[f"down_{i}_tempconv_{j}"])
            if i < n - 1:
                _transformer(sd, f"{base}.attentions.{j}", p[f"down_{i}_attn_{j}"],
                             heads, hd, spatial=True)
                _transformer(sd, f"{base}.temp_attentions.{j}", p[f"down_{i}_tempattn_{j}"],
                             heads, hd, spatial=False)
        if i < n - 1:
            _conv(sd, f"{base}.downsamplers.0.conv", p[f"down_{i}_downsample"]["conv"])
    heads, hd = cfg.heads(chs[-1])
    _resnet(sd, "mid_block.resnets.0", p["mid_resnet_0"])
    _temp_conv(sd, "mid_block.temp_convs.0", p["mid_tempconv_0"])
    _transformer(sd, "mid_block.attentions.0", p["mid_attn"], heads, hd, spatial=True)
    _transformer(sd, "mid_block.temp_attentions.0", p["mid_tempattn"], heads, hd, spatial=False)
    _resnet(sd, "mid_block.resnets.1", p["mid_resnet_1"])
    _temp_conv(sd, "mid_block.temp_convs.1", p["mid_tempconv_1"])
    for i, ch in enumerate(reversed(chs)):
        heads, hd = cfg.heads(ch)
        base = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"{base}.resnets.{j}", p[f"up_{i}_resnet_{j}"])
            _temp_conv(sd, f"{base}.temp_convs.{j}", p[f"up_{i}_tempconv_{j}"])
            if i > 0:
                _transformer(sd, f"{base}.attentions.{j}", p[f"up_{i}_attn_{j}"],
                             heads, hd, spatial=True)
                _transformer(sd, f"{base}.temp_attentions.{j}", p[f"up_{i}_tempattn_{j}"],
                             heads, hd, spatial=False)
        if i < n - 1:
            _conv(sd, f"{base}.upsamplers.0.conv", p[f"up_{i}_upsample"]["conv"])
    return sd


def _proj_1x1(sd: StateDict, prefix: str, t: Tree) -> None:
    """A 1x1 conv kernel ``[1, 1, in, out]`` -> the checkpoint's Linear."""
    k = np.asarray(t["kernel"])
    sd[f"{prefix}.weight"] = np.ascontiguousarray(k.reshape(k.shape[-2], k.shape[-1]).T)
    if "bias" in t:
        sd[f"{prefix}.bias"] = np.asarray(t["bias"])


def _alpha_temporal_resnet(sd: StateDict, p: str, t: Tree) -> None:
    for i in (1, 2):
        _norm(sd, f"{p}.norm{i}", t[f"norm{i}"])
        _conv(sd, f"{p}.conv{i}", t[f"conv{i}"])
    sd[f"{p}.alpha"] = np.asarray(t["alpha"]).reshape(1)


def _flat_attn(sd: StateDict, p: str, t: Tree, name: str, key: str = "") -> None:
    """Attention ``p.name`` from the JAX block's flat ``{key}_to_q`` ...
    entries (``key`` defaults to ``name``)."""
    key = key or name
    for n in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{p}.{name}.{n}", t[f"{key}_{n}"])
    _linear(sd, f"{p}.{name}.to_out.0", t[f"{key}_to_out"])


def _videoldm_spatial(sd: StateDict, p: str, t: Tree) -> None:
    _norm(sd, f"{p}.norm", t["norm"])
    _proj_1x1(sd, f"{p}.proj_in", t["proj_in"])
    _proj_1x1(sd, f"{p}.proj_out", t["proj_out"])
    b, bt = f"{p}.transformer_blocks.0", t["block"]
    for n in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{b}.{n}", bt[n])
    _ff(sd, f"{b}.ff", bt["ff"])
    _flat_attn(sd, b, bt, "attn1")
    _flat_attn(sd, b, bt, "attn2")


def _videoldm_temporal(sd: StateDict, p: str, t: Tree) -> None:
    _norm(sd, f"{p}.norm", t["norm"])
    _proj_1x1(sd, f"{p}.proj_in", t["proj_in"])
    _proj_1x1(sd, f"{p}.proj_out", t["proj_out"])
    sd[f"{p}.alpha"] = np.asarray(t["alpha"]).reshape(1)
    b = f"{p}.transformer_blocks.0"
    for n in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{b}.{n}", t[n])
    _ff(sd, f"{b}.ff", t["ff"])
    a1 = t["attn1"]
    for n in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{b}.attn1.{n}", a1[n])
    _linear(sd, f"{b}.attn1.to_out.0", a1["to_out"])
    _flat_attn(sd, b, t, "attn2")


def videoldm_unet_state_dict(tree: Tree, cfg) -> StateDict:
    """VideoLDMUNet params -> the ConsistI2V reference checkpoint's keys (the
    inverse of ``convert_unet_videoldm``); ``cfg`` a
    :class:`~anyv2v_torch.models.unet_videoldm.VideoLDMUNetConfig`."""
    p = _params(tree)
    sd: StateDict = {}
    _conv(sd, "conv_in", p["conv_in"])
    for name in ("linear_1", "linear_2"):
        _linear(sd, f"time_embedding.{name}", p["time_embedding"][name])
    if "frame_stride_fc1" in p:
        _linear(sd, "frame_stride_embedding.linear_1", p["frame_stride_fc1"])
        _linear(sd, "frame_stride_embedding.linear_2", p["frame_stride_fc2"])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    n = len(cfg.block_out_channels)

    def layer(base: str, key: str, j: int, cross: bool) -> None:
        _resnet(sd, f"{base}.resnets.{j}", p[f"{key}_resnet_{j}"])
        if f"{key}_conv3d_{j}" in p:
            _alpha_temporal_resnet(sd, f"{base}.conv3ds.{j}", p[f"{key}_conv3d_{j}"])
        if cross:
            _videoldm_spatial(sd, f"{base}.attentions.{j}", p[f"{key}_attn_{j}"])
            if f"{key}_tempattn_{j}" in p:
                _videoldm_temporal(sd, f"{base}.tempo_attns.{j}", p[f"{key}_tempattn_{j}"])

    for i in range(n):
        base, key = f"down_blocks.{i}", f"down_{i}"
        if f"{key}_first_frame_conv" in p:
            _conv(sd, f"{base}.first_frame_conv", p[f"{key}_first_frame_conv"])
        for j in range(cfg.layers_per_block):
            layer(base, key, j, i < n - 1)
        if i < n - 1:
            _conv(sd, f"{base}.downsamplers.0.conv", p[f"{key}_downsample"]["conv"])
    for j in range(2):
        _resnet(sd, f"mid_block.resnets.{j}", p[f"mid_resnet_{j}"])
        if f"mid_conv3d_{j}" in p:
            _alpha_temporal_resnet(sd, f"mid_block.conv3ds.{j}", p[f"mid_conv3d_{j}"])
    _videoldm_spatial(sd, "mid_block.attentions.0", p["mid_attn"])
    if "mid_first_frame_conv" in p:
        _conv(sd, "mid_block.first_frame_conv", p["mid_first_frame_conv"])
    for i in range(n):
        base, key = f"up_blocks.{i}", f"up_{i}"
        if f"{key}_first_frame_conv" in p:
            _conv(sd, f"{base}.first_frame_conv", p[f"{key}_first_frame_conv"])
        for j in range(cfg.layers_per_block + 1):
            layer(base, key, j, i > 0)
        if i < n - 1:
            _conv(sd, f"{base}.upsamplers.0.conv", p[f"{key}_upsample"]["conv"])
    return sd


def _seine_transformer(sd: StateDict, p: str, t: Tree) -> None:
    _norm(sd, f"{p}.norm", t["norm"])
    _conv(sd, f"{p}.proj_in", t["proj_in"])
    _conv(sd, f"{p}.proj_out", t["proj_out"])
    b, bt = f"{p}.transformer_blocks.0", t["block"]
    for n in ("norm1", "norm2", "norm_temp", "norm3"):
        _norm(sd, f"{b}.{n}", bt[n])
    _ff(sd, f"{b}.ff", bt["ff"])
    _flat_attn(sd, b, bt, "attn1")
    _flat_attn(sd, b, bt, "attn2")
    _flat_attn(sd, b, bt, "attn_temp", "temp")
    sd[f"{b}.attn_temp.time_rel_pos_bias.relative_attention_bias.weight"] = np.asarray(
        bt["time_rel_pos_bias"])


def seine_unet_state_dict(tree: Tree, cfg) -> StateDict:
    """SeineUNet params -> the SEINE reference checkpoint's keys (the inverse
    of ``convert_unet_seine``); ``cfg`` a
    :class:`~anyv2v_torch.models.unet_seine.SeineUNetConfig`."""
    p = _params(tree)
    sd: StateDict = {}
    _conv(sd, "conv_in", p["conv_in"])
    for name in ("linear_1", "linear_2"):
        _linear(sd, f"time_embedding.{name}", p["time_embedding"][name])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    n = len(cfg.block_out_channels)
    for i in range(n):
        base = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"{base}.resnets.{j}", p[f"down_{i}_resnet_{j}"])
            if i < n - 1:
                _seine_transformer(sd, f"{base}.attentions.{j}", p[f"down_{i}_attn_{j}"])
        if i < n - 1:
            _conv(sd, f"{base}.downsamplers.0.conv", p[f"down_{i}_downsample"]["conv"])
    for j in range(2):
        _resnet(sd, f"mid_block.resnets.{j}", p[f"mid_resnet_{j}"])
    _seine_transformer(sd, "mid_block.attentions.0", p["mid_attn"])
    for i in range(n):
        base = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"{base}.resnets.{j}", p[f"up_{i}_resnet_{j}"])
            if i > 0:
                _seine_transformer(sd, f"{base}.attentions.{j}", p[f"up_{i}_attn_{j}"])
        if i < n - 1:
            _conv(sd, f"{base}.upsamplers.0.conv", p[f"up_{i}_upsample"]["conv"])
    return sd


def _vae_mid(sd: StateDict, p: str, t: Tree) -> None:
    _resnet(sd, f"{p}.resnets.0", t["resnet_0"])
    _norm(sd, f"{p}.attentions.0.group_norm", t["attn_norm"])
    _attn(sd, f"{p}.attentions.0", t["attn"], 1, np.asarray(t["attn"]["to_q"]["kernel"]).shape[1])
    _resnet(sd, f"{p}.resnets.1", t["resnet_1"])


def vae_state_dict(tree: Tree, cfg) -> StateDict:
    """AutoencoderKL params -> diffusers ``AutoencoderKL`` keys."""
    p = _params(tree)
    enc, dec = p["encoder"], p["decoder"]
    n = len(cfg.block_out_channels)
    sd: StateDict = {}
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down_{i}_resnet_{j}"])
        if i < n - 1:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  enc[f"down_{i}_downsample"]["conv"])
    _vae_mid(sd, "encoder.mid_block", enc["mid"])
    _norm(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _conv(sd, "quant_conv", enc["quant_conv"])
    _conv(sd, "post_quant_conv", dec["post_quant_conv"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder.mid_block", dec["mid"])
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up_{i}_resnet_{j}"])
        if i < n - 1:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dec[f"up_{i}_upsample"]["conv"])
    _norm(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd


def _clip_layers(sd: StateDict, base: str, p: Tree, num_layers: int) -> None:
    for i in range(num_layers):
        t, pre = p[f"layers_{i}"], f"{base}encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{pre}.self_attn.{n}", t["self_attn"][n])
        _norm(sd, f"{pre}.layer_norm1", t["layer_norm1"])
        _norm(sd, f"{pre}.layer_norm2", t["layer_norm2"])
        _linear(sd, f"{pre}.mlp.fc1", t["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", t["fc2"])


def clip_text_state_dict(tree: Tree, cfg) -> StateDict:
    p = _params(tree)
    sd: StateDict = {
        "text_model.embeddings.token_embedding.weight": np.asarray(p["token_embedding"]["embedding"]),
        "text_model.embeddings.position_embedding.weight": np.asarray(p["position_embedding"]),
    }
    _clip_layers(sd, "text_model.", p, cfg.num_layers)
    _norm(sd, "text_model.final_layer_norm", p["final_layer_norm"])
    if "text_projection" in p:
        _linear(sd, "text_projection", p["text_projection"])
    return sd


def clip_vision_state_dict(tree: Tree, cfg) -> StateDict:
    p = _params(tree)
    sd: StateDict = {
        "vision_model.embeddings.class_embedding": np.asarray(p["class_embedding"]),
        "vision_model.embeddings.position_embedding.weight": np.asarray(p["position_embedding"]),
    }
    _conv(sd, "vision_model.embeddings.patch_embedding", p["patch_embedding"])
    _norm(sd, "vision_model.pre_layrnorm", p["pre_layrnorm"])
    _clip_layers(sd, "vision_model.", p, cfg.num_layers)
    _norm(sd, "vision_model.post_layernorm", p["post_layernorm"])
    if "visual_projection" in p:
        _linear(sd, "visual_projection", p["visual_projection"])
    return sd


def _sd_transformer(sd: StateDict, p: str, t: Tree, heads: int, head_dim: int,
                    linear: bool) -> None:
    """A Transformer2DModel of ``depth`` blocks (the JAX tree's ``blocks_k``);
    proj_in / proj_out as Linear layers with ``linear`` (SDXL), else 1x1
    convs."""
    _norm(sd, f"{p}.norm", t["norm"])
    put = _proj_1x1 if linear else _conv
    put(sd, f"{p}.proj_in", t["proj_in"])
    put(sd, f"{p}.proj_out", t["proj_out"])
    k = 0
    while f"blocks_{k}" in t:
        _block(sd, f"{p}.transformer_blocks.{k}", t[f"blocks_{k}"], heads, head_dim)
        k += 1


def _sd_down_mid(sd: StateDict, p: Tree, cfg):
    """conv_in, the embeddings, the down blocks and the mid block shared by
    the SD UNet and the ControlNet; returns the attention writer
    ``attn(prefix, key, level)``."""
    _conv(sd, "conv_in", p["conv_in"])
    for emb in ("time_embedding", "add_embedding"):
        if emb in p:
            for name in ("linear_1", "linear_2"):
                _linear(sd, f"{emb}.{name}", p[emb][name])
    n = len(cfg.block_out_channels)

    def attn(prefix, key, level):
        ch = cfg.block_out_channels[level]
        heads = cfg.heads_for(level)
        _sd_transformer(sd, prefix, p[key], heads, ch // heads, cfg.linear_projection)

    for i in range(n):
        base = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"{base}.resnets.{j}", p[f"down_{i}_resnet_{j}"])
            if cfg.cross_attn_blocks[i]:
                attn(f"{base}.attentions.{j}", f"down_{i}_attn_{j}", i)
        if i < n - 1:
            _conv(sd, f"{base}.downsamplers.0.conv", p[f"down_{i}_downsample"]["conv"])
    _resnet(sd, "mid_block.resnets.0", p["mid_resnet_0"])
    attn("mid_block.attentions.0", "mid_attn", n - 1)
    _resnet(sd, "mid_block.resnets.1", p["mid_resnet_1"])
    return attn


def sd_unet_state_dict(tree: Tree, cfg) -> StateDict:
    """SDUNet params (with any merged IP-Adapter ``to_k_ip`` / ``to_v_ip``)
    -> diffusers ``UNet2DConditionModel`` keys: the inverse of
    ``convert_unet_sd`` and ``merge_ip_adapter_into_unet``; ``cfg`` an
    :class:`~anyv2v_torch.models.unet_sd.SDUNetConfig`."""
    p = _params(tree)
    sd: StateDict = {}
    attn = _sd_down_mid(sd, p, cfg)
    n = len(cfg.block_out_channels)
    rev_cross = tuple(reversed(cfg.cross_attn_blocks))
    for i in range(n):
        base = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"{base}.resnets.{j}", p[f"up_{i}_resnet_{j}"])
            if rev_cross[i]:
                attn(f"{base}.attentions.{j}", f"up_{i}_attn_{j}", n - 1 - i)
        if i < n - 1:
            _conv(sd, f"{base}.upsamplers.0.conv", p[f"up_{i}_upsample"]["conv"])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    return sd


def controlnet_state_dict(tree: Tree, cfg) -> StateDict:
    """ControlNet params -> diffusers ``ControlNetModel`` keys (the inverse of
    ``convert_controlnet``)."""
    p = _params(tree)
    sd: StateDict = {}
    _sd_down_mid(sd, p, cfg)
    ce = p["controlnet_cond_embedding"]
    _conv(sd, "controlnet_cond_embedding.conv_in", ce["conv_in"])
    _conv(sd, "controlnet_cond_embedding.conv_out", ce["conv_out"])
    k = 0
    while f"blocks_{k}" in ce:
        _conv(sd, f"controlnet_cond_embedding.blocks.{k}", ce[f"blocks_{k}"])
        k += 1
    k = 0
    while f"controlnet_down_blocks_{k}" in p:
        _conv(sd, f"controlnet_down_blocks.{k}", p[f"controlnet_down_blocks_{k}"])
        k += 1
    _conv(sd, "controlnet_mid_block", p["controlnet_mid_block"])
    return sd


def image_proj_state_dict(tree: Tree, cfg=None) -> StateDict:
    """ImageProjModel params -> the IP-Adapter ``image_proj`` keys."""
    p = _params(tree)
    sd: StateDict = {}
    _linear(sd, "proj", p["proj"])
    _norm(sd, "norm", p["norm"])
    return sd


def resampler_state_dict(tree: Tree) -> StateDict:
    """Resampler params -> the IP-Adapter Plus ``image_proj`` keys (the
    inverse of ``convert_resampler``: ``to_kv`` fused again, k rows first)."""
    p = _params(tree)
    sd: StateDict = {"latents": np.asarray(p["latents"])[None]}
    _linear(sd, "proj_in", p["proj_in"])
    _linear(sd, "proj_out", p["proj_out"])
    _norm(sd, "norm_out", p["norm_out"])
    i = 0
    while f"layers_{i}_to_q" in p:
        a, f = f"layers.{i}.0", f"layers.{i}.1"
        _norm(sd, f"{a}.norm1", p[f"layers_{i}_norm1"])
        _norm(sd, f"{a}.norm2", p[f"layers_{i}_norm2"])
        _linear(sd, f"{a}.to_q", p[f"layers_{i}_to_q"])
        sd[f"{a}.to_kv.weight"] = np.ascontiguousarray(np.concatenate(
            [np.asarray(p[f"layers_{i}_to_kv_k"]["kernel"]).T,
             np.asarray(p[f"layers_{i}_to_kv_v"]["kernel"]).T], axis=0))
        _linear(sd, f"{a}.to_out", p[f"layers_{i}_to_out"])
        _norm(sd, f"{f}.0", p[f"layers_{i}_ff_norm"])
        _linear(sd, f"{f}.1", p[f"layers_{i}_ff_in"])
        _linear(sd, f"{f}.3", p[f"layers_{i}_ff_out"])
        i += 1
    return sd


def mlp_proj_state_dict(tree: Tree) -> StateDict:
    """MLPProjModel params -> the IP-Adapter Full ``image_proj`` keys (the
    inverse of ``convert_mlp_proj``)."""
    p = _params(tree)
    sd: StateDict = {}
    _linear(sd, "proj.0", p["proj_0"])
    _linear(sd, "proj.2", p["proj_2"])
    _norm(sd, "proj.3", p["proj_3"])
    return sd


def state_dict_from_jax(params: Tree, arch) -> Dict[str, StateDict]:
    """``{"unet", "vae", "text", "vision"}`` JAX param trees (numpy leaves;
    the editors' also ``controlnet`` and ``image_proj``) -> the port's state
    dicts for the same components, for ``ARCHS[arch]`` (i2vgen-xl,
    ConsistI2V, SEINE or a first-frame editor) or, given a dict, for those
    component configs."""
    from ..models.unet_sd import SDUNetConfig
    from ..models.unet_seine import SeineUNetConfig
    from ..models.unet_videoldm import VideoLDMUNetConfig
    from .model_zoo import ARCHS

    spec = arch if isinstance(arch, dict) else ARCHS[arch]
    unet = {VideoLDMUNetConfig: videoldm_unet_state_dict, SDUNetConfig: sd_unet_state_dict,
            SeineUNetConfig: seine_unet_state_dict}.get(type(spec["unet"]), unet_state_dict)
    convert = {"unet": unet, "vae": vae_state_dict,
               "text": clip_text_state_dict, "vision": clip_vision_state_dict,
               "controlnet": controlnet_state_dict, "image_proj": image_proj_state_dict}
    return {name: convert[name](params[name], spec[name])
            for name in convert if name in params}


def load_jax_npz(path: str):
    """Read a ``anyv2v_tpu.utils.model_zoo.save_params`` file with numpy:
    returns (nested param tree, meta dict)."""
    data = np.load(path)
    tree: Tree = {}
    meta: Dict[str, Any] = {}
    for name in data.files:
        if name == "__meta__":
            meta = json.loads(str(data[name]))
            continue
        node = tree
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[name]
    return tree, meta
