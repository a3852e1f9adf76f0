"""i2vgen-xl, ConsistI2V, SEINE and first-frame editor (InstructPix2Pix /
MagicBrush, CosXL, InstantStyle) model configurations and pipeline
construction (counterpart of ``anyv2v_tpu/utils/model_zoo.py``).

Parameters come from ``init``:

- ``"random"``: seeded random weights, drawn on the target device with a
  ``torch.Generator``: normal with std ``fan_in ** -0.5`` for matrices and
  kernels, 0.02 for embeddings, 1 for SEINE's relative-position tables (at
  0.02 the bias would shift the temporal logits by a few hundredths and
  change nothing), ones for norm scales, zeros for biases, the
  last conv of every i2vgen temporal conv layer zero (the layer starts as the
  identity, as in the JAX package), and ConsistI2V's temporal gates
  ``alpha`` at 0.5 (the JAX package starts them at 1, which bypasses the
  temporal layers; half-open gates let the temporal kernels count in a
  random-weight run; the ControlNet's output convolutions are random too,
  where the JAX package starts them at zero, so that its residuals reach
  the UNet). Not the JAX package's random weights: use a ``.npz``
  for identical weights in both packages.
- a path to a ``.npz`` written by ``anyv2v_torch.cli.convert_checkpoint``
  from a checkpoint folder (:mod:`anyv2v_torch.utils.checkpoint`): the
  state dicts load as they are, into modules of ``arch`` with the
  architecture fields the file carries (so a small folder builds a small
  model), and every key must match;
- a path to a ``.npz`` written by ``anyv2v_tpu.utils.model_zoo.save_params``:
  loaded with numpy and carried over by
  :func:`anyv2v_torch.utils.weights.state_dict_from_jax`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..models.clip import CLIPTextConfig, CLIPTextModel, CLIPVisionConfig, CLIPVisionModel
from ..models.controlnet import ControlNet
from ..models.unet_i2vgen import I2VGenUNet, I2VGenUNetConfig
from ..models.unet_sd import SD15_IP2P, SDXL_COSXL, SDUNet, SDUNetConfig
from ..models.unet_seine import SeineUNet, SeineUNetConfig
from ..models.unet_videoldm import VideoLDMUNet, VideoLDMUNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..pipelines.consisti2v import ConsistI2VPipeline
from ..pipelines.i2vgen import I2VGenPipeline
from ..pipelines.image_edit import CosXLEditPipeline, InstructPix2PixPipeline
from ..pipelines.instantstyle import ImageProjConfig, ImageProjModel, InstantStylePipeline
from ..pipelines.seine import SeinePipeline
from ..schedulers import make_schedule

# ali-vilab/i2vgen-xl: the checkpoint's attention_head_dim=64 is the HEAD
# COUNT in diffusers' 3D UNets (issue #2011), so heads are 5/10/20 wide
I2VGEN_XL = dict(
    unet=I2VGenUNetConfig(num_attention_heads=64),
    vae=VAEConfig(),
    text=CLIPTextConfig(),
    vision=CLIPVisionConfig(),
)

# small but structured: every block kind, for tests and CPU runs
I2VGEN_TINY = dict(
    unet=I2VGenUNetConfig(
        block_out_channels=(16, 32, 32, 32),
        layers_per_block=1,
        cross_attention_dim=32,
        attention_head_dim=8,
        norm_num_groups=8,
        num_image_context_tokens=2,
        pnp_attn_targets=((1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)),
        pnp_conv_target=(1, 1),
    ),
    vae=VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8),
    text=CLIPTextConfig(vocab_size=49408, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=4, projection_dim=None),
    vision=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                            num_heads=4, image_size=224, patch_size=32, projection_dim=32),
)

# TIGER-Lab/ConsistI2V: SD2.1-base UNet + VideoLDM temporal layers, rotary
# temporal PE, augmented temporal attention; the i2vgen VAE and OpenCLIP text
# encoder
CONSISTI2V = dict(
    unet=VideoLDMUNetConfig(),
    vae=VAEConfig(),
    text=CLIPTextConfig(),
)
CONSISTI2V_TINY = dict(
    unet=VideoLDMUNetConfig(
        block_out_channels=(16, 32, 32, 32),
        layers_per_block=1,
        cross_attention_dim=32,
        attention_head_dim=8,
        n_temp_heads=2,
        norm_num_groups=8,
        pnp_attn_targets=((1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)),
        pnp_conv_target=(1, 1),
    ),
    vae=I2VGEN_TINY["vae"],
    text=I2VGEN_TINY["text"],
)

# SEINE (Vchitect/SEINE, seine.pt's EMA weights on SD1.4): the 9-channel
# masked-video UNet with 8 heads of 40/80/160, the SD VAE and SD1.4's text
# encoder (openai/clip-vit-large-patch14: 768 wide, quick_gelu)
SEINE = dict(
    unet=SeineUNetConfig(),
    vae=VAEConfig(),
    text=CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_layers=12,
                        num_heads=12, hidden_act="quick_gelu", projection_dim=None),
)
SEINE_TINY = dict(
    unet=SeineUNetConfig(
        block_out_channels=(8, 16, 16, 16), layers_per_block=1,
        cross_attention_dim=16, num_attention_heads=2, norm_num_groups=4,
        pnp_attn_targets=((1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)),
        pnp_conv_target=(1, 1),
    ),
    vae=VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4),
    text=CLIPTextConfig(vocab_size=49408, hidden_size=16, intermediate_size=32,
                        num_layers=1, num_heads=2, projection_dim=None),
)
# SEINE's schedule: plain linear betas 1e-4..0.02 (configs/seine/*.yaml)
SEINE_SCHEDULER = dict(beta_start=1e-4, beta_end=0.02, beta_schedule="linear")

# ---------------------------------------------------------------------------
# the first-frame editors
# ---------------------------------------------------------------------------

# SD1.5's text encoder (openai/clip-vit-large-patch14: quick_gelu)
SD15_TEXT = CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_layers=12,
                           num_heads=12, hidden_act="quick_gelu", projection_dim=None)
# SDXL's two text encoders: CLIP ViT-L (penultimate hidden states) and
# OpenCLIP ViT-bigG (penultimate hidden states and the projected pooled output)
SDXL_TEXT_1 = SD15_TEXT
SDXL_TEXT_2 = CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_layers=32,
                             num_heads=20, hidden_act="gelu", projection_dim=1280)
SDXL_TEXT_1_TINY = CLIPTextConfig(vocab_size=49408, hidden_size=16, intermediate_size=32,
                                  num_layers=2, num_heads=2, projection_dim=None)
SDXL_TEXT_2_TINY = dataclasses.replace(SDXL_TEXT_1_TINY, projection_dim=16)

_EDITOR_TINY_VAE = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                             norm_num_groups=4)
_SDXL_TINY_UNET = SDUNetConfig(
    block_out_channels=(8, 16, 16), layers_per_block=1, cross_attention_dim=16,
    num_attention_heads=(2, 2, 2), transformer_depth=(1, 1, 2),
    cross_attn_blocks=(False, True, True), norm_num_groups=4, addition_embed="sdxl",
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=16 + 6 * 8,
    linear_projection=True)

# timbrooks/instruct-pix2pix and vinesmsuic/magicbrush-jul7 share the
# architecture; CosXL is SDXL with an 8-channel input and the SDXL VAE scale
IMAGE_EDIT_ARCHS = {
    "instructpix2pix": dict(unet=SD15_IP2P, vae=VAEConfig(), text=SD15_TEXT),
    "magicbrush": dict(unet=SD15_IP2P, vae=VAEConfig(), text=SD15_TEXT),
    "cosxl": dict(unet=SDXL_COSXL, vae=VAEConfig(scaling_factor=0.13025)),
    "instructpix2pix-tiny": dict(
        unet=SDUNetConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                          cross_attention_dim=16, num_attention_heads=2, norm_num_groups=4),
        vae=_EDITOR_TINY_VAE,
        text=CLIPTextConfig(vocab_size=49408, hidden_size=16, intermediate_size=32,
                            num_layers=1, num_heads=2, projection_dim=None)),
    "cosxl-tiny": dict(unet=_SDXL_TINY_UNET,
                       vae=dataclasses.replace(_EDITOR_TINY_VAE, scaling_factor=0.13025)),
}
IMAGE_EDIT_ARCHS["magicbrush-tiny"] = IMAGE_EDIT_ARCHS["instructpix2pix-tiny"]

# InstantStyle: SDXL base (4-channel) with the IP-Adapter on up_blocks.0.attentions.1,
# diffusers/controlnet-canny-sdxl-1.0, and ip-adapter_sdxl.bin's projection of
# the OpenCLIP bigG image embedding (1280) to 4 tokens
INSTANTSTYLE_ARCHS = {
    "instantstyle": dict(
        unet=dataclasses.replace(SDXL_COSXL, in_channels=4, ip_adapter_targets=("up_0_attn_1",)),
        controlnet=dataclasses.replace(SDXL_COSXL, in_channels=4),
        vae=VAEConfig(scaling_factor=0.13025),
        image_proj=ImageProjConfig(cross_attention_dim=2048, clip_embeddings_dim=1280)),
    "instantstyle-tiny": dict(
        unet=dataclasses.replace(_SDXL_TINY_UNET, in_channels=4,
                                 ip_adapter_targets=("up_0_attn_1",)),
        controlnet=dataclasses.replace(_SDXL_TINY_UNET, in_channels=4),
        vae=dataclasses.replace(_EDITOR_TINY_VAE, scaling_factor=0.13025),
        image_proj=ImageProjConfig(cross_attention_dim=16, clip_embeddings_dim=16)),
}

ARCHS = {"i2vgen-xl": I2VGEN_XL, "i2vgen-tiny": I2VGEN_TINY,
         "consisti2v": CONSISTI2V, "consisti2v-tiny": CONSISTI2V_TINY,
         "seine": SEINE, "seine-tiny": SEINE_TINY,
         **IMAGE_EDIT_ARCHS, **INSTANTSTYLE_ARCHS}

_MODULES = {I2VGenUNetConfig: I2VGenUNet, VideoLDMUNetConfig: VideoLDMUNet,
            SeineUNetConfig: SeineUNet, SDUNetConfig: SDUNet, VAEConfig: AutoencoderKL,
            CLIPTextConfig: CLIPTextModel, CLIPVisionConfig: CLIPVisionModel,
            ImageProjConfig: lambda c: ImageProjModel(c.cross_attention_dim,
                                                      c.clip_embeddings_dim, c.num_tokens)}
# components whose module is not their config type's
_COMPONENT_MODULES = {"controlnet": ControlNet}


def build_modules(arch: str, dtype: torch.dtype, device="meta",
                  overrides: Optional[Dict[str, dict]] = None) -> Dict[str, nn.Module]:
    """The modules of ``ARCHS[arch]`` (unet, vae, text and, for i2vgen,
    vision) with compute dtype ``dtype``, parameters uninitialised (on
    ``meta`` unless another device is given). ``overrides``: config fields
    per component (a converted checkpoint's architecture)."""
    overrides = overrides or {}
    with torch.device(device):
        return {name: _COMPONENT_MODULES.get(name, _MODULES[type(cfg)])(
                    dataclasses.replace(cfg, **overrides.get(name, {}), dtype=dtype))
                for name, cfg in ARCHS[arch].items()}


def backbone_of(arch: str) -> str:
    """The family of ``arch``: ``"i2vgen-xl"``, ``"consisti2v"``, ``"seine"``,
    ``"instructpix2pix"`` (MagicBrush too), ``"cosxl"`` or ``"instantstyle"``."""
    family = {I2VGenUNetConfig: "i2vgen-xl", VideoLDMUNetConfig: "consisti2v",
              SeineUNetConfig: "seine"}.get(type(ARCHS[arch]["unet"]))
    if family:
        return family
    base = arch[:-len("-tiny")] if arch.endswith("-tiny") else arch
    return "instructpix2pix" if base == "magicbrush" else base


# CLIP's token / position tables and class token
_EMBEDDINGS = ("token_embedding.weight", "position_embedding.weight", "class_embedding")
_RELPOS_TABLES = "relative_attention_bias.weight"   # SEINE's T5 bias tables


def random_state_dict(module: nn.Module, generator: torch.Generator,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``module`` in its state-dict (diffusers)
    shapes, fp32 on ``device``."""
    out = {}
    for name, ref in module.state_dict().items():
        if name.endswith("bias"):
            t = torch.zeros(ref.shape, device=device)
        elif name.endswith("weight") and ref.dim() == 1:   # norm scales
            t = torch.ones(ref.shape, device=device)
        elif ".temp_convs." in name and ".conv4." in name:
            t = torch.zeros(ref.shape, device=device)
        elif name.endswith("alpha"):
            t = torch.full(ref.shape, 0.5, device=device)
        else:
            std = (0.02 if name.endswith(_EMBEDDINGS) else 1.0 if name.endswith(_RELPOS_TABLES)
                   else float(np.prod(ref.shape[1:])) ** -0.5)
            t = torch.randn(ref.shape, generator=generator, device=device) * std
        out[name] = t
    return out


def _load_modules(arch: str, dev: torch.device, init: str, seed: int,
                  dtype: torch.dtype, components=None) -> Dict[str, nn.Module]:
    """``build_modules`` with weights from ``init``, on ``dev``, in eval mode;
    only the named ``components`` where given. A random init draws the built
    modules' weights in the order unet, vae, text, vision, so leaving out the
    encoders leaves the UNet's and the VAE's weights as they were."""

    def chosen(modules):
        return {n: m for n, m in modules.items() if components is None or n in components}

    if init == "random":
        modules = chosen(build_modules(arch, dtype))
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        states = {name: random_state_dict(m, gen, dev) for name, m in modules.items()}
    elif os.path.exists(init):
        from . import checkpoint

        if checkpoint.is_port_checkpoint(checkpoint.read_meta(init)):
            states, meta = checkpoint.load_checkpoint(init)
            if backbone_of(meta["backbone"]) != backbone_of(arch):
                raise ValueError(f"{init} holds a {meta['backbone']} checkpoint, not {arch}")
            modules = chosen(build_modules(arch, dtype,
                                           overrides=checkpoint.config_overrides(meta)))
        else:
            from .weights import load_jax_npz, state_dict_from_jax

            modules = chosen(build_modules(arch, dtype))
            tree, _ = load_jax_npz(init)
            states = {name: {k: torch.from_numpy(np.asarray(v, np.float32))
                             for k, v in sd.items()}
                      for name, sd in state_dict_from_jax(tree, arch).items()}
    else:
        raise ValueError(f"unknown init: {init}")
    for name, m in modules.items():
        m.to_empty(device=dev)
        m.to(dtype)
        m.load_state_dict(states[name])
        m.eval().requires_grad_(False)
    return modules


def _mesh_device(device, mesh) -> torch.device:
    """The checked device; a mesh must be over the same device type."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for a pipeline on {dev}")
    return dev


def build_i2vgen_pipeline(arch: str = "i2vgen-xl", *, device, init: str = "random",
                          seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                          scheduler_kwargs: Optional[dict] = None, mesh=None,
                          components=None) -> I2VGenPipeline:
    """``mesh``: shard the frames (and plain CFG rows) over it
    (:func:`anyv2v_torch.parallel.mesh.make_mesh`); the weights are
    replicated from its first rank. ``components``: the modules to build (default all:
    unet, vae, text and, for i2vgen, vision; the JAX builders' option); a
    pipeline without its encoders takes embeddings only."""
    dev = _mesh_device(device, mesh)
    modules = _load_modules(arch, dev, init, seed, dtype, components)
    schedule = make_schedule(**(scheduler_kwargs or {}), device=dev)
    return I2VGenPipeline(unet=modules["unet"], vae=modules["vae"],
                          text_encoder=modules.get("text"), vision_encoder=modules.get("vision"),
                          schedule=schedule, device=dev, dtype=dtype, mesh=mesh)


def build_consisti2v_pipeline(arch: str = "consisti2v", *, device, init: str = "random",
                              seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                              scheduler_kwargs: Optional[dict] = None,
                              mesh=None, components=None) -> ConsistI2VPipeline:
    """``mesh``, ``components``: as :func:`build_i2vgen_pipeline`'s."""
    if not isinstance(ARCHS[arch]["unet"], VideoLDMUNetConfig):
        raise ValueError(f"{arch} is not a ConsistI2V architecture")
    dev = _mesh_device(device, mesh)
    modules = _load_modules(arch, dev, init, seed, dtype, components)
    schedule = make_schedule(**(scheduler_kwargs or {}), device=dev)
    return ConsistI2VPipeline(unet=modules["unet"], vae=modules["vae"],
                              text_encoder=modules.get("text"), schedule=schedule,
                              device=dev, dtype=dtype, mesh=mesh)


def build_seine_pipeline(arch: str = "seine", *, device, init: str = "random", seed: int = 0,
                         dtype: torch.dtype = torch.bfloat16,
                         scheduler_kwargs: Optional[dict] = None, mesh=None,
                         components=None) -> SeinePipeline:
    """SEINE with its linear-beta schedule (``scheduler_kwargs`` override it);
    ``mesh``, ``components`` as :func:`build_i2vgen_pipeline`'s."""
    if not isinstance(ARCHS[arch]["unet"], SeineUNetConfig):
        raise ValueError(f"{arch} is not a SEINE architecture")
    dev = _mesh_device(device, mesh)
    modules = _load_modules(arch, dev, init, seed, dtype, components)
    schedule = make_schedule(**{**SEINE_SCHEDULER, **(scheduler_kwargs or {})}, device=dev)
    return SeinePipeline(unet=modules["unet"], vae=modules["vae"],
                         text_encoder=modules.get("text"),
                         schedule=schedule, device=dev, dtype=dtype, mesh=mesh)


def build_image_edit_pipeline(model: str = "instructpix2pix", *, device, init: str = "random",
                              seed: int = 0, dtype: torch.dtype = torch.bfloat16):
    """A first-frame editor by the reference's ``edit_image.py --model`` names:
    instructpix2pix / magicbrush / cosxl, and instantstyle; ``-tiny`` for the
    small architectures."""
    if model.startswith("instantstyle"):
        return build_instantstyle_pipeline(model, device=device, init=init, seed=seed,
                                           dtype=dtype)
    if model not in IMAGE_EDIT_ARCHS:
        raise ValueError(f"{model} is not a first-frame editor architecture")
    dev = resolve_device(device)
    modules = _load_modules(model, dev, init, seed, dtype)
    if ARCHS[model]["unet"].addition_embed == "sdxl":
        return CosXLEditPipeline(unet=modules["unet"], vae=modules["vae"],
                                 schedule=make_schedule(device=dev), device=dev, dtype=dtype)
    return InstructPix2PixPipeline(unet=modules["unet"], vae=modules["vae"],
                                   text_encoder=modules["text"],
                                   schedule=make_schedule(device=dev), device=dev, dtype=dtype)


def build_instantstyle_pipeline(arch: str = "instantstyle", *, device, init: str = "random",
                                seed: int = 0, dtype: torch.dtype = torch.bfloat16
                                ) -> InstantStylePipeline:
    """SDXL base + controlnet-canny-sdxl + ip-adapter_sdxl (style target block
    ``up_blocks.0.attentions.1``)."""
    if arch not in INSTANTSTYLE_ARCHS:
        raise ValueError(f"{arch} is not an InstantStyle architecture")
    dev = resolve_device(device)
    modules = _load_modules(arch, dev, init, seed, dtype)
    return InstantStylePipeline(unet=modules["unet"], controlnet=modules["controlnet"],
                                vae=modules["vae"], image_proj=modules["image_proj"],
                                schedule=make_schedule(device=dev), device=dev, dtype=dtype)


def build_sdxl_text_encoders(*, device, tiny: bool = False, seed: int = 0,
                             dtype: torch.dtype = torch.bfloat16):
    """SDXL's two text encoders with seeded random weights, on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    encoders = []
    for cfg in ((SDXL_TEXT_1_TINY, SDXL_TEXT_2_TINY) if tiny else (SDXL_TEXT_1, SDXL_TEXT_2)):
        with torch.device("meta"):
            enc = CLIPTextModel(dataclasses.replace(cfg, dtype=dtype))
        state = random_state_dict(enc, gen, dev)
        enc.to_empty(device=dev).to(dtype)
        enc.load_state_dict(state)
        encoders.append(enc.eval().requires_grad_(False))
    return tuple(encoders)


@torch.inference_mode()
def encode_sdxl_prompt(enc1, enc2, input_ids1, input_ids2):
    """SDXL's prompt embedding: both encoders' PENULTIMATE hidden states
    concatenated on the feature axis (768 + 1280 = 2048), and the second
    encoder's projected pooled output."""
    h1, _ = enc1(input_ids1, penultimate=True)
    h2, pooled2 = enc2(input_ids2, penultimate=True)
    return torch.cat([h1, h2], dim=-1), pooled2
