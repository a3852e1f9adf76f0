"""Plain float32 building blocks of the reference models, channels-last.

Every function reads its weights through a :class:`Params` getter by the
diffusers key names and shapes of the published checkpoints, so head widths
are the true ones (i2vgen-xl's 64 heads of 5/10/20). Nothing here imports the
program under test, JAX or a kernel: matrix products are ``torch`` matmuls and
convolutions, attention is an explicit softmax computed in chunks.

Precision: float32 (the reference: TF32 must be off, see
:func:`strict_fp32`), or with ``Params(..., fp8=True)`` float8 (the control:
every operand of a matrix product or convolution rounded to float8 e4m3 with
a per-tensor scale, the products accumulated in float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                 # largest finite float8 e4m3fn
ATTN_CHUNK = 1 << 28            # score elements per attention chunk (1 GiB in fp32)


def strict_fp32() -> None:
    """Float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Params:
    """Weights by key. ``Params(tensors)`` serves a state dict (each access
    checks the shape the architecture declares); ``Params()`` records the
    declared keys and shapes and serves zeros on the ``meta`` device: a
    forward on meta inputs then gives the architecture's key list
    (:attr:`spec`) and, under ``FlopCounterMode``, its operation count.
    ``fp8``: the control's precision."""

    def __init__(self, tensors=None, fp8: bool = False):
        self.tensors, self.fp8 = tensors, fp8
        self.spec: dict = {}

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product as the precision holds it."""
        return to_fp8(x) if self.fp8 and x.device.type != "meta" else x

    def __call__(self, name: str, *shape: int) -> torch.Tensor:
        if self.tensors is None:
            self.spec[name] = tuple(shape)
            return torch.zeros(shape, device="meta")
        w = self.tensors[name]
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(w.shape)}, the architecture says {shape}")
        return w


def linear(P: Params, name: str, x: torch.Tensor, d_in: int, d_out: int,
           bias: bool = True) -> torch.Tensor:
    w = P(f"{name}.weight", d_out, d_in)
    b = P(f"{name}.bias", d_out) if bias else None
    return F.linear(P.q(x), P.q(w), b)


def conv(P: Params, name: str, x: torch.Tensor, c_in: int, c_out: int, k: int = 3,
         stride: int = 1, padding=None) -> torch.Tensor:
    """nn.Conv2d on channels-last ``[N, H, W, C]``."""
    w = P(f"{name}.weight", c_out, c_in, k, k)
    b = P(f"{name}.bias", c_out)
    pad = k // 2 if padding is None else padding
    y = F.conv2d(P.q(x).permute(0, 3, 1, 2), P.q(w), b, stride, pad)
    return y.permute(0, 2, 3, 1)


def group_norm(P: Params, name: str, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over every axis but the first and the last."""
    n, c = x.shape[0], x.shape[-1]
    w, b = P(f"{name}.weight", c), P(f"{name}.bias", c)
    xg = x.reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * w + b


def layer_norm(P: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    c = x.shape[-1]
    return F.layer_norm(x, (c,), P(f"{name}.weight", c), P(f"{name}.bias", c), eps)


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos, shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def mlp(P: Params, name: str, x: torch.Tensor, d_in: int, d_out: int,
        keys=("linear_1", "linear_2")) -> torch.Tensor:
    """linear -> SiLU -> linear."""
    h = F.silu(linear(P, f"{name}.{keys[0]}", x, d_in, d_out))
    return linear(P, f"{name}.{keys[1]}", h, d_out, d_out)


def inject(x: torch.Tensor, on: bool, chunks: int) -> torch.Tensor:
    """PnP: every batch chunk replaced by the first (the source rows)."""
    if not on or chunks == 1:
        return x
    b = x.shape[0] // chunks
    return x[:b].repeat((chunks,) + (1,) * (x.dim() - 1))


def attention(P: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """Softmax attention, q ``[B, Sq, H*d]``, k/v ``[B, Sk, H*d]``, scale
    ``d ** -0.5``; the score tensor computed a group of (row, head) pairs at
    a time so that it stays near 1 GiB."""
    b, sq, c = q.shape
    sk, d = k.shape[1], c // heads

    def split(x, s):
        return x.reshape(b, s, heads, d).transpose(1, 2).reshape(b * heads, s, d)

    qh, kh, vh = split(P.q(q), sq), split(P.q(k), sk), split(P.q(v), sk)
    out = torch.empty_like(qh)
    step = max(1, ATTN_CHUNK // max(1, sq * sk))
    for i in range(0, b * heads, step):
        s = torch.bmm(qh[i:i + step], kh[i:i + step].transpose(1, 2)) * d ** -0.5
        out[i:i + step] = torch.bmm(P.q(torch.softmax(s, dim=-1)), vh[i:i + step])
    return out.reshape(b, heads, sq, d).transpose(1, 2).reshape(b, sq, c)


def frame_attention(P: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Attention over the frame axis of ``[B, S, P, C]`` tokens (keys
    ``[B, Sk, P, C]``), every pixel on its own."""
    b, s, p, c = q.shape

    def rows(x):
        return x.permute(0, 2, 1, 3).reshape(b * p, x.shape[1], c)

    out = attention(P, rows(q), rows(k), rows(v), heads)
    return out.reshape(b, p, s, c).permute(0, 2, 1, 3)


def attn_module(P: Params, name: str, x: torch.Tensor, ctx: torch.Tensor, dim: int, heads: int,
                head_dim: int, ctx_dim: int, pnp: bool = False, chunks: int = 3,
                frames: bool = False, qkv_bias: bool = False, out_dim=None) -> torch.Tensor:
    """diffusers Attention: Q/K (never V) injected from the source rows under
    PnP; ``frames``: ``[B, S, P, C]`` tokens attending over S."""
    inner = heads * head_dim
    qv = inject(linear(P, f"{name}.to_q", x, dim, inner, qkv_bias), pnp, chunks)
    kv = inject(linear(P, f"{name}.to_k", ctx, ctx_dim, inner, qkv_bias), pnp, chunks)
    vv = linear(P, f"{name}.to_v", ctx, ctx_dim, inner, qkv_bias)
    out = (frame_attention if frames else attention)(P, qv, kv, vv, heads)
    return linear(P, f"{name}.to_out.0", out, inner, out_dim or dim)


def feed_forward(P: Params, name: str, x: torch.Tensor, dim: int, gelu_only: bool = False,
                 mult: int = 4) -> torch.Tensor:
    """GEGLU (or plain GELU) feed-forward, exact-erf GELU."""
    inner = dim * mult
    if gelu_only:
        h = F.gelu(linear(P, f"{name}.net.0.proj", x, dim, inner))
    else:
        h, gate = linear(P, f"{name}.net.0.proj", x, dim, 2 * inner).chunk(2, dim=-1)
        h = h * F.gelu(gate)
    return linear(P, f"{name}.net.2", h, inner, dim)


def resnet(P: Params, name: str, x: torch.Tensor, c_in: int, c_out: int, temb=None,
           temb_dim: int = 0, groups: int = 32, eps: float = 1e-5, pnp: bool = False,
           chunks: int = 3) -> torch.Tensor:
    """diffusers ResnetBlock2D; the PnP conv features are those after conv2."""
    h = conv(P, f"{name}.conv1", F.silu(group_norm(P, f"{name}.norm1", x, groups, eps)),
             c_in, c_out)
    if temb is not None:
        h = h + linear(P, f"{name}.time_emb_proj", F.silu(temb), temb_dim, c_out)[:, None, None]
    h = conv(P, f"{name}.conv2", F.silu(group_norm(P, f"{name}.norm2", h, groups, eps)),
             c_out, c_out)
    h = inject(h, pnp, chunks)
    if c_in != c_out:
        x = conv(P, f"{name}.conv_shortcut", x, c_in, c_out, k=1)
    return x + h


def temporal_conv3(P: Params, name: str, x: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """Conv3d with kernel (3, 1, 1) and zero padding over the frame axis of
    ``[B, F, P, C]``."""
    w = P(f"{name}.weight", c_out, c_in, 3, 1, 1)[:, :, :, 0, 0]
    b = P(f"{name}.bias", c_out)
    f = x.shape[1]
    xp = F.pad(P.q(x), (0, 0, 0, 0, 1, 1))
    w8 = P.q(w)
    out = sum(torch.matmul(xp[:, d:d + f], w8[:, :, d].t()) for d in range(3))
    return out + b


def downsample(P: Params, name: str, x: torch.Tensor, c: int, asymmetric: bool = False):
    if asymmetric:   # the diffusers VAE encoder: pad right and bottom by one, no conv padding
        return conv(P, f"{name}.conv", F.pad(x, (0, 0, 0, 1, 0, 1)), c, c, stride=2, padding=0)
    return conv(P, f"{name}.conv", x, c, c, stride=2)


def upsample(P: Params, name: str, x: torch.Tensor, c: int):
    """Nearest 2x, then a 3x3 conv."""
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return conv(P, f"{name}.conv", x, c, c)
