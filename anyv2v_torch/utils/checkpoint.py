"""Checkpoint folders in the diffusers layout -> the port's state dicts
(counterpart of the folder loaders of ``anyv2v_tpu/utils/convert.py``:
``load_torch_state_dict`` :107, ``load_folder_state_dict`` :1040,
``_convert_vae_dir`` :1069, ``convert_i2vgen_pipeline_dir`` :1081,
``convert_consisti2v_dir`` :1120, ``convert_seine_checkpoint`` :1144,
``convert_sd_editor_dir`` :1166, ``convert_ip_adapter`` :945 and the head
rule ``resolve_i2vgen_heads`` :408).

The port's modules carry the diffusers / reference key names, so a folder's
tensors load as they are: no key map, and i2vgen-xl's 5/10/20-wide heads are
padded by the modules at load (``models.layers.Attention``). What a
converter adds is the architecture, read from each subfolder's
``config.json`` by the JAX converters' rules, so a small folder builds a
small model; a field the port's modules cannot take raises and names it.

The files are read with numpy and torch alone (no ``safetensors`` package):
:func:`read_safetensors` parses the format (an 8-byte little-endian header
length, a JSON header, then raw little-endian data), and ``*.bin``, ``*.pt``
and ``*.ckpt`` go through ``torch.load(weights_only=True)``.

:func:`save_checkpoint` writes one ``.npz``: every component's state dict
under ``<component>/<key>`` in the checkpoint's dtype (bf16 as its bits), and
``__meta__`` holding the backbone, the architecture fields and the layout
tag :data:`LAYOUT`, which tells it apart from a JAX ``save_params`` file.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
LAYOUT = "anyv2v_torch.state_dicts/1"

# ---------------------------------------------------------------------------
# reading tensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.int16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, as CPU tensors in the file's
    dtype (``BF16`` read as 16-bit words into ``torch.bfloat16``)."""
    out = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
            start, end = info["data_offsets"]
            f.seek(base + start)
            buf = bytearray(end - start)
            if f.readinto(buf) != len(buf):
                raise IOError(f"{path}: tensor {name} is truncated")
            arr = np.frombuffer(buf, np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
            t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=False))
            if info["dtype"] == "BF16":
                t = t.view(torch.bfloat16)
            out[name] = t.reshape(info["shape"])
    return out


def load_torch_state_dict(path: str) -> StateDict:
    """One checkpoint file: safetensors, or a torch pickle whose tensors may sit
    in a nested container (``ema``, then ``state_dict``, then ``module``, as
    SEINE's ``seine.pt`` keeps its EMA weights)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and not any(torch.is_tensor(v) for v in obj.values()):
        for key in ("ema", "state_dict", "module"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def load_folder_state_dict(folder: str) -> StateDict:
    """All tensors of a diffusers model folder: every ``*.safetensors`` shard
    merged; without one, every ``*.bin``, ``*.pt`` and ``*.ckpt``."""
    sd: StateDict = {}
    shards = sorted(glob.glob(os.path.join(folder, "*.safetensors")))
    if shards:
        for s in shards:
            sd.update(read_safetensors(s))
        return sd
    for pat in ("*.bin", "*.pt", "*.ckpt"):
        for f in sorted(glob.glob(os.path.join(folder, pat))):
            sd.update(load_torch_state_dict(f))
    if not sd:
        raise FileNotFoundError(f"no weight files in {folder}")
    return sd


def _read_config(folder: str, required: bool = True) -> Dict[str, Any]:
    path = os.path.join(folder, "config.json")
    if not os.path.exists(path):
        if required:
            raise FileNotFoundError(f"no config.json in {folder}")
        return {}
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# architecture from config.json
# ---------------------------------------------------------------------------


def _unsupported(component: str, field: str, value, why: str):
    return ValueError(f"{component} config.json: {field}={value!r} cannot be built by the "
                      f"port's modules ({why})")


def _choice(cfg: Mapping, component: str, field: str, default, allowed):
    value = cfg.get(field, default)
    if value not in allowed:
        raise _unsupported(component, field, value, f"takes {sorted(allowed)}")
    return value


def _check_block_types(cfg: Mapping, n: int) -> None:
    """The port's UNets have cross-attention at every level but the last going
    down and the first going up."""
    want = {"down_block_types": [True] * (n - 1) + [False],
            "up_block_types": [False] + [True] * (n - 1)}
    for field, cross in want.items():
        value = cfg.get(field)
        if value is not None and [("CrossAttn" in v) for v in value] != cross:
            raise _unsupported("unet", field, value, "cross-attention at every level but the "
                               "last going down and the first going up")


def resolve_i2vgen_heads(hf_config: Mapping) -> int:
    """diffusers' head rule (issue #2011): ``num_attention_heads`` falls back
    to ``attention_head_dim``, and the value is the HEAD COUNT of the block
    transformers."""
    return int(hf_config.get("num_attention_heads")
               or hf_config.get("attention_head_dim", 64))


def _head_counts(cfg: Mapping, n_levels: int, default):
    """The 2-D UNet head rule: ``num_attention_heads`` or else
    ``attention_head_dim`` is the head count, one int or one per level."""
    v = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", default)
    counts = list(v) if isinstance(v, (list, tuple)) else [v] * n_levels
    if len(counts) != n_levels:
        raise _unsupported("unet", "attention_head_dim", v, "one head count per level")
    return [int(c) for c in counts]


def _unet_common(cfg: Mapping, defaults, check_blocks: bool = True) -> Dict[str, Any]:
    boc = [int(c) for c in cfg.get("block_out_channels", defaults.block_out_channels)]
    groups = int(cfg.get("norm_num_groups", defaults.norm_num_groups))
    if check_blocks:
        _check_block_types(cfg, len(boc))
    for c in boc:
        if c % groups:
            raise _unsupported("unet", "norm_num_groups", groups,
                               f"does not divide block_out_channels {boc}")
    return {"in_channels": int(cfg.get("in_channels", defaults.in_channels)),
            "out_channels": int(cfg.get("out_channels", defaults.out_channels)),
            "block_out_channels": boc,
            "layers_per_block": int(cfg.get("layers_per_block", defaults.layers_per_block)),
            "cross_attention_dim": int(cfg.get("cross_attention_dim",
                                               defaults.cross_attention_dim)),
            "norm_num_groups": groups}


def _i2vgen_unet_fields(cfg: Mapping, sd: StateDict) -> Dict[str, Any]:
    from ..models.unet_i2vgen import I2VGenUNetConfig

    fields = _unet_common(cfg, I2VGenUNetConfig())
    heads = resolve_i2vgen_heads(cfg)
    for c in fields["block_out_channels"]:
        if c % heads:
            raise _unsupported("unet", "num_attention_heads", heads,
                               f"does not divide block_out_channels {fields['block_out_channels']}")
    fields["num_attention_heads"] = heads
    # the image-context token count, from the checkpoint itself (as the JAX
    # converter derives it from context_embedding_2)
    fields["num_image_context_tokens"] = int(
        sd["context_embedding.2.weight"].shape[0] // fields["cross_attention_dim"])
    return fields


def _videoldm_unet_fields(cfg: Mapping, sd: StateDict) -> Dict[str, Any]:
    from ..models.unet_videoldm import VideoLDMUNetConfig

    d = VideoLDMUNetConfig()
    fields = _unet_common(cfg, d)
    boc = fields["block_out_channels"]
    counts = _head_counts(cfg, len(boc), [c // d.attention_head_dim
                                          for c in d.block_out_channels])
    widths = {c // h for c, h in zip(boc, counts)}
    if len(widths) != 1 or any(c % h for c, h in zip(boc, counts)):
        raise _unsupported("unet", "attention_head_dim", counts,
                           f"the port takes one spatial head width for block_out_channels {boc}")
    fields["attention_head_dim"] = widths.pop()
    fields["n_temp_heads"] = int(cfg.get("n_temp_heads", d.n_temp_heads))
    fields["first_frame_condition_mode"] = _choice(
        cfg, "unet", "first_frame_condition_mode", d.first_frame_condition_mode,
        {"none", "concat", "conv2d", "input_only"})
    fields["temp_pos_embedding"] = _choice(cfg, "unet", "temp_pos_embedding",
                                           d.temp_pos_embedding, {"rotary", "sinusoidal"})
    for flag in ("augment_temporal_attention", "use_frame_stride_condition", "use_temporal"):
        fields[flag] = bool(cfg.get(flag, getattr(d, flag)))
    return fields


def _seine_unet_fields(cfg: Mapping, sd: StateDict) -> Dict[str, Any]:
    from ..models.unet_seine import SeineUNetConfig

    d = SeineUNetConfig()
    fields = _unet_common(cfg, d)
    counts = set(_head_counts(cfg, len(fields["block_out_channels"]), d.num_attention_heads))
    if len(counts) != 1:
        raise _unsupported("unet", "attention_head_dim", sorted(counts),
                           "SEINE's blocks take one head count")
    fields["num_attention_heads"] = counts.pop()
    # SD1.4's config says 4; seine.pt's conv_in takes latents, mask and
    # masked latents
    fields["in_channels"] = int(sd["conv_in.weight"].shape[1])
    return fields


def _per_level(v, n: int, field: str):
    """An int, or a tuple of one int per level."""
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise _unsupported("unet", field, v, "one value per level")
        return tuple(int(x) for x in v)
    return int(v)


def _sd_unet_fields(cfg: Mapping, sd: StateDict) -> Dict[str, Any]:
    """The first-frame editors' 2-D UNet (the JAX ``convert_sd_editor_dir``
    rules): SDXL when ``addition_embed_type`` is ``text_time``; the head
    count per level from ``attention_head_dim``; the cross-attention levels
    from ``down_block_types``; the depth from ``transformer_layers_per_block``."""
    from ..models.unet_sd import SD15_IP2P

    d = SD15_IP2P
    fields = _unet_common(cfg, d, check_blocks=False)
    n = len(fields["block_out_channels"])
    down = cfg.get("down_block_types", ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"])
    cross = tuple(t.startswith("CrossAttn") for t in down)
    up = cfg.get("up_block_types")
    if len(cross) != n or (up is not None
                           and tuple("CrossAttn" in t for t in up) != cross[::-1]):
        raise _unsupported("unet", "up_block_types", up,
                           f"the reverse of down_block_types {down}")
    fields["cross_attn_blocks"] = cross
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", d.num_attention_heads)
    fields["num_attention_heads"] = _per_level(heads, n, "attention_head_dim")
    fields["transformer_depth"] = _per_level(cfg.get("transformer_layers_per_block", 1), n,
                                             "transformer_layers_per_block")
    for i, c in enumerate(fields["block_out_channels"]):
        h = heads[i] if isinstance(heads, (list, tuple)) else heads
        if c % int(h):
            raise _unsupported("unet", "attention_head_dim", heads,
                               f"does not divide block_out_channels {fields['block_out_channels']}")
    kind = cfg.get("addition_embed_type")
    if kind not in (None, "text_time"):
        raise _unsupported("unet", "addition_embed_type", kind, "takes None or 'text_time'")
    fields["addition_embed"] = "sdxl" if kind == "text_time" else "none"
    if kind == "text_time":
        fields["addition_time_embed_dim"] = int(cfg.get("addition_time_embed_dim", 256))
        fields["projection_class_embeddings_input_dim"] = int(
            cfg.get("projection_class_embeddings_input_dim", 2816))
    fields["linear_projection"] = bool(cfg.get("use_linear_projection", False))
    return fields


def _vae_fields(cfg: Mapping, sd: StateDict) -> Dict[str, Any]:
    from ..models.vae import VAEConfig

    d = VAEConfig()
    return {"in_channels": int(cfg.get("in_channels", d.in_channels)),
            "out_channels": int(cfg.get("out_channels", d.out_channels)),
            "latent_channels": int(cfg.get("latent_channels", d.latent_channels)),
            "block_out_channels": [int(c) for c in cfg.get("block_out_channels",
                                                           d.block_out_channels)],
            "layers_per_block": int(cfg.get("layers_per_block", d.layers_per_block)),
            "norm_num_groups": int(cfg.get("norm_num_groups", d.norm_num_groups)),
            "scaling_factor": float(cfg.get("scaling_factor", d.scaling_factor))}


def _clip_fields(cfg: Mapping, component: str, d) -> Dict[str, Any]:
    return {"hidden_size": int(cfg.get("hidden_size", d.hidden_size)),
            "intermediate_size": int(cfg.get("intermediate_size", d.intermediate_size)),
            "num_layers": int(cfg["num_hidden_layers"]),
            "num_heads": int(cfg.get("num_attention_heads", d.num_heads)),
            "hidden_act": _choice(cfg, component, "hidden_act", d.hidden_act,
                                  {"gelu", "quick_gelu"})}


def _text_fields(cfg: Mapping, sd: StateDict) -> Dict[str, Any]:
    from ..models.clip import CLIPTextConfig

    d = CLIPTextConfig()
    fields = _clip_fields(cfg, "text_encoder", d)
    fields["vocab_size"] = int(sd["text_model.embeddings.token_embedding.weight"].shape[0])
    fields["max_position_embeddings"] = int(
        sd["text_model.embeddings.position_embedding.weight"].shape[0])
    proj = sd.get("text_projection.weight")
    fields["projection_dim"] = None if proj is None else int(proj.shape[0])
    return fields


def _vision_fields(cfg: Mapping, sd: StateDict) -> Dict[str, Any]:
    from ..models.clip import CLIPVisionConfig

    d = CLIPVisionConfig()
    fields = _clip_fields(cfg, "image_encoder", d)
    fields.update(image_size=int(cfg.get("image_size", d.image_size)),
                  patch_size=int(cfg.get("patch_size", d.patch_size)),
                  num_channels=int(cfg.get("num_channels", d.num_channels)),
                  projection_dim=int(sd["visual_projection.weight"].shape[0]))
    return fields


# ---------------------------------------------------------------------------
# the backbones and the first-frame editors
# ---------------------------------------------------------------------------


def convert_i2vgen_pipeline_dir(src: str) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
    """ali-vilab/i2vgen-xl snapshot (``unet/``, ``vae/``, ``text_encoder/``,
    ``image_encoder/``) -> (state dicts ``{unet, vae, text, vision}``, meta)."""
    parts = {"unet": ("unet", _i2vgen_unet_fields), "vae": ("vae", _vae_fields),
             "text": ("text_encoder", _text_fields), "vision": ("image_encoder", _vision_fields)}
    return _convert(src, "i2vgen-xl", parts)


def convert_consisti2v_dir(src: str) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
    """TIGER-Lab/ConsistI2V snapshot (``unet/``, ``vae/``, ``text_encoder/``)
    -> (state dicts ``{unet, vae, text}``, meta)."""
    parts = {"unet": ("unet", _videoldm_unet_fields),
             "vae": ("vae", _vae_fields), "text": ("text_encoder", _text_fields)}
    return _convert(src, "consisti2v", parts)


def convert_seine_checkpoint(sd_path: str, ckpt_path: str
                             ) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
    """SD1.4 snapshot (``vae/``, ``text_encoder/``, and ``unet/config.json``
    when present) plus SEINE's ``seine.pt`` (its ``ema`` dict) -> (state
    dicts ``{unet, vae, text}``, meta). SEINE's UNet is SD1.4's inflated, so
    its architecture is SD1.4's ``unet/config.json``; without one, SD1.4's
    fixed architecture. The input channels come from the weights (9:
    latents, mask, masked latents)."""
    parts = {"vae": ("vae", _vae_fields), "text": ("text_encoder", _text_fields)}
    states, meta = _convert(sd_path, "seine", parts)
    unet = load_torch_state_dict(ckpt_path)
    states["unet"] = unet
    meta["arch"]["unet"] = _seine_unet_fields(
        _read_config(os.path.join(sd_path, "unet"), required=False), unet)
    return states, meta


def convert_sd_editor_dir(src: str, model: str) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
    """An InstructPix2Pix / MagicBrush snapshot (``unet/``, ``vae/``,
    ``text_encoder/``) or a CosXL one (``unet/``, ``vae/``; its text
    encoders are not read) -> (state dicts, meta) for ``model``."""
    sdxl = _read_config(os.path.join(src, "unet")).get("addition_embed_type") == "text_time"
    if sdxl != (model == "cosxl"):
        raise ValueError(f"{src}: an {'SDXL' if sdxl else 'SD1.5'} UNet is not a {model} "
                         "checkpoint")
    parts = {"unet": ("unet", _sd_unet_fields), "vae": ("vae", _vae_fields)}
    if not sdxl:
        parts["text"] = ("text_encoder", _text_fields)
    return _convert(src, model, parts)


# ---------------------------------------------------------------------------
# IP-Adapter weights
# ---------------------------------------------------------------------------


def sdxl_attn2_order(cfg):
    """(kind, level, layer, block) of every cross-attention in diffusers'
    ``attn_processors`` order as the JAX package reads it (``sdxl_attn2_order``
    in ``anyv2v_tpu/utils/convert.py``: down, mid, up; each attention module
    gives attn1 then attn2, so attn2 sits at the odd positions)."""
    n = len(cfg.block_out_channels)
    order = [("down", i, j, k) for i in range(n) if cfg.cross_attn_blocks[i]
             for j in range(cfg.layers_per_block) for k in range(cfg.depth_for(i))]
    order += [("mid", n - 1, 0, k) for k in range(cfg.depth_for(n - 1))]
    rev_cross = tuple(reversed(cfg.cross_attn_blocks))
    order += [("up", i, j, k) for i in range(n) if rev_cross[i]
              for j in range(cfg.layers_per_block + 1) for k in range(cfg.depth_for(n - 1 - i))]
    return order


def read_ip_adapter(src, unet_cfg) -> Tuple[StateDict, StateDict]:
    """An IP-Adapter file (``ip-adapter_sdxl.bin``: ``{"image_proj": ...,
    "ip_adapter": {"<idx>.to_k_ip.weight": ...}}``, a path or the loaded
    dict) -> (the projection's state dict, the UNet keys of the
    ``to_k_ip`` / ``to_v_ip`` weights of ``unet_cfg.ip_adapter_targets``),
    in the JAX package's index order (ROADMAP R5 holds a doubt on that
    order). The other blocks' weights are not read: the reference runs them
    with processors that ignore image tokens."""
    obj = torch.load(src, map_location="cpu", weights_only=True) if isinstance(src, str) else src
    adapter = obj["ip_adapter"]
    unet: StateDict = {}
    for pos, (kind, i, j, k) in enumerate(sdxl_attn2_order(unet_cfg)):
        name = "mid_attn" if kind == "mid" else f"{kind}_{i}_attn_{j}"
        if name not in unet_cfg.ip_adapter_targets:
            continue
        base = "mid_block.attentions.0" if kind == "mid" else f"{kind}_blocks.{i}.attentions.{j}"
        for proj in ("to_k_ip", "to_v_ip"):
            unet[f"{base}.transformer_blocks.{k}.attn2.{proj}.weight"] = torch.as_tensor(
                adapter[f"{2 * pos + 1}.{proj}.weight"])
    return {key: torch.as_tensor(v) for key, v in obj["image_proj"].items()}, unet


def _convert(src: str, backbone: str, parts) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
    states, arch = {}, {}
    for name, (sub, fields_of) in parts.items():
        folder = os.path.join(src, sub)
        states[name] = load_folder_state_dict(folder)
        arch[name] = fields_of(_read_config(folder), states[name])
    return states, {"layout": LAYOUT, "backbone": backbone, "arch": arch}


# ---------------------------------------------------------------------------
# the converted file
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, states: Mapping[str, StateDict], meta: Mapping[str, Any]) -> None:
    """One ``.npz`` with numpy alone: ``<component>/<key>`` in each tensor's
    dtype (bf16 as 16-bit words, listed in the meta's ``bf16``), and
    ``__meta__``."""
    flat, bf16 = {}, []
    for comp, sd in states.items():
        for key, t in sd.items():
            name = f"{comp}/{key}"
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                bf16.append(name)
                t = t.view(torch.int16)
            flat[name] = t.numpy()
    flat["__meta__"] = np.asarray(json.dumps({**meta, "layout": LAYOUT, "bf16": bf16}))
    with open(path, "wb") as f:
        np.savez(f, **flat)


def read_meta(path: str) -> Dict[str, Any]:
    """The ``__meta__`` of an ``.npz`` (the port's or a JAX ``save_params``
    file), ``{}`` when it has none."""
    with np.load(path) as data:
        return json.loads(str(data["__meta__"])) if "__meta__" in data.files else {}


def is_port_checkpoint(meta: Mapping[str, Any]) -> bool:
    return meta.get("layout") == LAYOUT


def load_checkpoint(path: str) -> Tuple[Dict[str, StateDict], Dict[str, Any]]:
    """(state dicts by component, meta) of a :func:`save_checkpoint` file."""
    meta = read_meta(path)
    if not is_port_checkpoint(meta):
        raise ValueError(f"{path} is not a converted checkpoint of layout {LAYOUT}")
    bf16 = set(meta.get("bf16", ()))
    states: Dict[str, StateDict] = {}
    with np.load(path) as data:
        for name in data.files:
            if name == "__meta__":
                continue
            comp, key = name.split("/", 1)
            t = torch.from_numpy(data[name])
            states.setdefault(comp, {})[key] = t.view(torch.bfloat16) if name in bf16 else t
    return states, meta


def config_overrides(meta: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The architecture fields of a converted checkpoint, per component, as
    ``dataclasses.replace`` arguments (JSON lists back to tuples)."""
    return {comp: {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
            for comp, fields in meta["arch"].items()}


def validate(states: Mapping[str, StateDict], meta: Mapping[str, Any], arch: str) -> None:
    """Strict ``load_state_dict`` of every component into modules of
    ``ARCHS[arch]`` with the checkpoint's architecture, built on the ``meta``
    device (no memory): a missing, extra or misshapen key raises."""
    from .model_zoo import build_modules

    modules = build_modules(arch, torch.float32, overrides=config_overrides(meta))
    if set(modules) != set(states):
        raise ValueError(f"components {sorted(states)} do not match {arch}'s {sorted(modules)}")
    for name, m in modules.items():
        m.load_state_dict({k: v.to("meta") for k, v in states[name].items()}, strict=True)

