"""CLIP text and vision encoders (counterpart of ``anyv2v_tpu/models/clip.py``)
with Hugging Face key names (``text_model.*``, ``vision_model.*``).

The text encoder uses a causal mask and pools at the first EOS token; the
vision encoder is a ViT with a class token and pre/post layer norms, and
returns the projected class token (``image_embeds``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa_attention
from .layers import layer_norm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    hidden_act: str = "gelu"
    projection_dim: int = 1024
    dtype: torch.dtype = torch.float32


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(name)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, causal: bool):
        scale = (x.shape[-1] // self.heads) ** -0.5
        # the JAX package leaves CLIP's attention to XLA: no TPU kernel to port
        out = sdpa_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                             self.heads, scale, causal=causal)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)


class _Layer(nn.Module):
    def __init__(self, d: int, heads: int, inner: int, act: str, dtype):
        super().__init__()
        self.act, self.dtype = act, dtype
        self.self_attn = _SelfAttention(d, heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = _MLP(d, inner)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(layer_norm(x, self.layer_norm1, self.dtype), causal)
        h = self.mlp.fc1(layer_norm(x, self.layer_norm2, self.dtype))
        return x + self.mlp.fc2(_act(self.act, h))


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([
            _Layer(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.hidden_act,
                   cfg.dtype) for _ in range(cfg.num_layers)])


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """Returns (last_hidden_state, pooled) like HF; ``pooled`` goes through
    ``text_projection`` when the config has one."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = _TextModel(config)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor, penultimate: bool = False):
        """``penultimate=True`` returns the hidden state before the last layer
        (HF ``hidden_states[-2]``, no final norm) as the first output, what
        SDXL's two text encoders feed the UNet; ``pooled`` always comes from
        the whole stack."""
        cfg, tm = self.config, self.text_model
        b, s = input_ids.shape
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :s]).to(cfg.dtype)
        for layer in tm.encoder.layers:
            before_last = x
            x = layer(x, causal=True)
        x = layer_norm(x, tm.final_layer_norm, cfg.dtype)
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos_pos]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return (before_last if penultimate else x), pooled


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n_patches + 1, cfg.hidden_size)


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)   # HF's spelling
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    """Input channels-last ``[B, H, W, 3]``, already CLIP-normalised. Returns
    (last_hidden_state, image_embeds)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = _VisionModel(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor, penultimate: bool = False):
        """``penultimate=True`` returns the hidden state before the last layer
        (HF ``hidden_states[-2]``, no final norm) as the first output, what
        the IP-Adapter Plus and Full variants project; ``image_embeds``
        always comes from the whole stack."""
        cfg, vm = self.config, self.vision_model
        emb = vm.embeddings
        b = pixel_values.shape[0]
        patches = F.conv2d(pixel_values.to(cfg.dtype).permute(0, 3, 1, 2),
                           emb.patch_embedding.weight, stride=cfg.patch_size)
        patches = patches.flatten(2).transpose(1, 2)                 # [B, N, D]
        cls = emb.class_embedding.to(cfg.dtype)[None, None].expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight[None].to(cfg.dtype)
        x = layer_norm(x, vm.pre_layrnorm, cfg.dtype)
        for layer in vm.encoder.layers:
            before_last = x
            x = layer(x, causal=False)
        pooled = layer_norm(x[:, 0], vm.post_layernorm, cfg.dtype)
        return (before_last if penultimate else x), self.visual_projection(pooled)


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_clip_image(images01: torch.Tensor) -> torch.Tensor:
    """``[N, 224, 224, 3]`` in [0, 1] -> CLIP-normalised."""
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=images01.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, device=images01.device)
    return (images01 - mean) / std
