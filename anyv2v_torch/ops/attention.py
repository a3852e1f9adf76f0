"""Attention dispatcher (counterpart of ``anyv2v_tpu/ops/attention.py``).

Contract, as in the JAX package: flat ``[B, S, heads*dh]`` tokens in and out,
an explicit ``scale`` (the true head width's, since projections store each
head padded by :func:`padded_head_dim`), :func:`temporal_attention` on
``[B, S, HW, C]`` temporal tokens with no transposes, and
:func:`spatial_attention_ffconcat` for ConsistI2V's first-frame-conditioned
spatial self-attention.

Hopper routes on CUDA tensors, the same on every call:

=============================================  ======================  =========
call                                           shapes                  route
=============================================  ======================  =========
i2vgen-xl spatial self / cross, 64 heads       dh 8/16/32 (padded)     K1
short self / cross (Sq, Sk <= 128)             dh 8/16/32/64           K1
  (i2vgen mid block, image-latent encoder,
  ConsistI2V mid cross)
other attention, not causal                    dh 8, 16, ..., 128      K5
  (ConsistI2V spatial cross, 5/10/20 heads     (multiples of 8), 160
  of 64; temporal cross over [B, F*HW, C],
  8 heads of 40/80/160; SEINE spatial self
  at HW 4096/1024/256, mid self at HW 64
  and cross over 77 text tokens, 8 heads
  of 40/80/160)
:func:`multi_head_attention` with a bias       Sq <= 128, Sq <= Sk <=  K2 (S <= 32) or
  shared by the batch (``[H, Sq, Sk]``,        Sq + 16, Sk <= 128,     K2 long + bias,
  ``[1, H, Sq, Sk]``, or broadcastable to      dh 8/16/32/40/64/80/    on the [B, S, 1, C]
  them; JAX: ``_short_kernel``)                160                     view
:func:`multi_head_attention`, any other bias   dh as K5                K5 + bias
:func:`multi_head_attention` with a ``mask``                           SDPA (bool mask)
:func:`spatial_attention_ffconcat`             dh as K5                K5 split-KV
:func:`temporal_attention` (frame axis)        S <= 32, Sk <= S + 16,  K2
  (i2vgen-xl: 64 heads of 8/16/32,             dh 8/16/32/40/64/
  transformer_in 8 of 64; ConsistI2V: Sk       80/160
  25, 8 heads of 40/80/160)
:func:`temporal_attention` with ``bias``       the same, bias          K2 + bias
  (SEINE: S = Sk = 16, 8 heads of              ``[H, S, Sk]`` fp32
  40/80/160, T5 relative positions)
:func:`temporal_attention`, long video         32 < S <= 128,          K2 long
  (i2vgen-xl at 128 frames: 64 heads of        Sk <= S + 16,
  8/16/32, transformer_in 8 of 64)             bias optional
:func:`multi_head_attention`, a bias at a      dh not K5's             SDPA in fp32
  width K5 lacks, or a bias with a mask                                (fp32 float
                                                                       mask)
everything else (the VAE's 512-wide head)                              SDPA
=============================================  ======================  =========

K1 is one tensor-core kernel for every class it takes (``mma.sync`` on K/V
tiles from a ``cp.async`` ring, several heads or packed batch rows per
block); it replaces a CUDA-core body with one thread per query row. K2 and
K2 long launch one tensor-core body for every frame count up to 128 (several
pixels per block at 16 frames, one at 128); it replaces the two CUDA-core
bodies that K2 had for S <= 32. The two wrappers keep their own launch
counts and kernel symbols.

K1 takes what it took before K5 existed except window-packed heads of 64,
which no i2vgen-xl call has (its windowed calls are 64 heads of 8/16/32);
the JAX package likewise sends only heads narrower than 64 to its packed
kernels. Biased and masked calls follow the JAX ``_resolve``: a bias that the
batch shares goes, at short lengths, where JAX sends it (``_short_kernel``,
here the frame kernels on the ``[B, S, 1, C]`` view, one pixel per batch row:
the same function as the frame axis of ``[B, S, HW, C]``), any other bias to
the split-head flash kernel (K5 with its bias operand), and a mask, which
JAX sends to XLA, to SDPA. No model of the repo passes a bias or a mask to
this function: SEINE's relative-position bias goes to
:func:`temporal_attention`. Past 32 frames the JAX package transposes the
temporal tokens to ``[B*HW, S, C]`` for ``_short_kernel``; K2 long reads
them in place. Frame
counts past 128 raise, as the JAX kernel's cap. CLIP's text and vision
encoders call :func:`sdpa_attention` directly, as the JAX package left them
to XLA. The JAX row and length
thresholds were tuned on a TPU and are not copied. On CPU tensors every route
takes the kernel's plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from .flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS, flash_attention
from .folded_attention import HEAD_DIMS, folded_attention
from .frame_attention import frame_attention, frame_attention_long, takes, takes_long


def padded_head_dim(d: int) -> int:
    """Storage width of one head: widths that are not a multiple of 8 pad to
    the next power of two (>= 8) — i2vgen-xl's 5/10/20 become 8/16/32.
    Zero q/k columns add nothing to a score and zero v columns give zero
    output lanes, so the padded math is exact."""
    if d % 8 == 0:
        return d
    p = 8
    while p < d:
        p *= 2
    return p


def window_packable(heads: int, head_dim: int) -> bool:
    """Whole heads tile 128-channel windows (the JAX package's
    ``_window_packable``): the 64-head i2vgen-xl split at dh 8/16/32."""
    return (head_dim <= 64 and 128 % head_dim == 0
            and (heads * head_dim) % 128 == 0 and heads >= 128 // head_dim)


def uses_folded_kernel(sq: int, sk: int, heads: int, head_dim: int) -> bool:
    """K1's route (the same on CPU, where the route runs its plain version)."""
    return head_dim in HEAD_DIMS and (
        (head_dim < 64 and window_packable(heads, head_dim)) or (sq <= 128 and sk <= 128))


def sdpa_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                   heads: int, scale: float, causal: bool = False,
                   attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PyTorch's ``scaled_dot_product_attention`` on a head-split view;
    ``attn_mask`` broadcastable to ``[B, H, Sq, Sk]`` (boolean, or added to
    the scaled scores)."""
    b, sq, c = query.shape
    dh = c // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, dh).transpose(1, 2)

    out = F.scaled_dot_product_attention(split(query), split(key), split(value),
                                         attn_mask=attn_mask, is_causal=causal, scale=scale)
    return out.transpose(1, 2).reshape(b, sq, c)


def _sdpa_fp32_bias(query, key, value, heads: int, scale: float,
                    bias: torch.Tensor) -> torch.Tensor:
    """SDPA with an fp32 float mask on fp32 operands, cast back to the
    query's dtype: the bias is added to fp32 scores, as K5 and the JAX
    package's XLA path add it, and is not rounded to a bf16 mask."""
    return sdpa_attention(query.float(), key.float(), value.float(), heads, scale,
                          attn_mask=bias).to(query.dtype)


def _as_4d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((1,) * (4 - x.dim()) + tuple(x.shape))


def _shared_head_bias(bias: torch.Tensor, heads: int, sq: int, sk: int) -> Optional[torch.Tensor]:
    """A bias that every batch row shares (leading dim 1 once read as
    ``[B, H, Sq, Sk]``) as the kernels take it: contiguous fp32
    ``[H, Sq, Sk]``; else None."""
    b4 = _as_4d(bias)
    if b4.shape[0] != 1:
        return None
    return b4[0].float().expand(heads, sq, sk).contiguous()


def _short_bias_route(sq: int, sk: int, dh: int):
    """The frame kernel that takes a shared bias at these lengths on the
    ``[B, S, 1, C]`` view (the JAX ``_short_kernel`` class: Sq, Sk <= 128,
    Sq <= Sk <= Sq + 16), or None."""
    if sk > 128:
        return None
    if takes(sq, sk, dh):
        return frame_attention
    if takes_long(sq, sk, dh):
        return frame_attention_long
    return None


@spanned("layer.attn")
def multi_head_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                         heads: int, scale: float, causal: bool = False,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """query ``[B, Sq, H*dh]``, key/value ``[B, Sk, H*dh]`` -> ``[B, Sq, H*dh]``.

    ``bias``: an additive score bias broadcastable to ``[B, H, Sq, Sk]``,
    added after the scale; ``mask``: a boolean mask broadcastable to the
    same, True where a query may attend (every query row keeps at least one
    key). Neither goes with ``causal``."""
    b, sq, c = query.shape
    sk, dh = key.shape[1], c // heads
    if (bias is not None or mask is not None) and causal:
        raise ValueError("multi_head_attention: a bias or a mask does not go with causal")
    if mask is not None:
        attn_mask = mask.bool()
        if bias is not None:
            return _sdpa_fp32_bias(query, key, value, heads, scale,
                                   bias.float().masked_fill(~attn_mask, float("-inf")))
        return sdpa_attention(query, key, value, heads, scale, attn_mask=attn_mask)
    if bias is not None:
        shared = _shared_head_bias(bias, heads, sq, sk)
        frame_kernel = _short_bias_route(sq, sk, dh)
        if shared is not None and frame_kernel is not None:
            out = frame_kernel(query.unsqueeze(2), key.unsqueeze(2), value.unsqueeze(2), heads,
                               scale, shared)
            return out.squeeze(2)
        if dh in FLASH_HEAD_DIMS:
            operand = shared if shared is not None else (
                _as_4d(bias).float().expand(b, heads, sq, sk).contiguous())
            return flash_attention(query, key, value, heads, scale, bias=operand)
        return _sdpa_fp32_bias(query, key, value, heads, scale, bias.float())
    if not causal:
        if uses_folded_kernel(sq, sk, heads, dh):
            return folded_attention(query, key, value, heads, scale)
        if dh in FLASH_HEAD_DIMS:
            return flash_attention(query, key, value, heads, scale)
    return sdpa_attention(query, key, value, heads, scale, causal)


@spanned("layer.attn")
def spatial_attention_ffconcat(query: torch.Tensor, k_self: torch.Tensor,
                               v_self: torch.Tensor, k_ctx: torch.Tensor,
                               v_ctx: torch.Tensor, frames: int, heads: int,
                               scale: float) -> torch.Tensor:
    """ConsistI2V first-frame-concat spatial self-attention
    (``videoldm_transformer_blocks.py:479-504``): every frame's queries
    ``[(B F), Sq, C]`` attend over their own keys ``[(B F), Sk1, C]`` plus the
    keys of their batch row's first frame ``[B, Sk2, C]``, under one softmax.
    K5's split-KV mode reads the shared context once per row instead of
    building the per-frame repeat that the reference concatenates."""
    return flash_attention(query, k_self, v_self, heads, scale, k_ctx, v_ctx, frames)


@spanned("layer.attn")
def temporal_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                       heads: int, scale: float, bias: Optional[torch.Tensor] = None,
                       pixel_sharded: bool = False) -> torch.Tensor:
    """Self-attention over the frame axis S of ``[B, S, HW, C]`` tokens; keys
    and values ``[B, Sk, HW, C]`` may carry up to 16 extra frames. ``bias``:
    an fp32 ``[heads, S, Sk]`` table over the global frame axis, added to the
    scaled scores of every batch row and pixel (SEINE's relative-position
    bias).

    Inside a manual-SPMD region (:func:`anyv2v_torch.parallel.mesh.manual_axis`:
    the tokens hold this rank's frames) the op reshards itself around the
    attention (:func:`anyv2v_torch.parallel.mesh.around_frame_op`: an
    all-to-all to pixel sharding and back, or a gather of the short frame
    axis). ``pixel_sharded``: the caller already holds every frame (it
    hoisted the all-to-all to its module boundary)."""
    from ..parallel.mesh import around_frame_op

    if pixel_sharded:
        return _temporal_attention(query, key, value, heads, scale, bias)
    return around_frame_op(lambda q, k, v, _: _temporal_attention(q, k, v, heads, scale, bias),
                           (query, key, value))


def _temporal_attention(query, key, value, heads: int, scale: float, bias=None):
    s, sk, dh = query.shape[1], key.shape[1], query.shape[-1] // heads
    if takes(s, sk, dh):
        return frame_attention(query, key, value, heads, scale, bias)
    if takes_long(s, sk, dh):
        return frame_attention_long(query, key, value, heads, scale, bias)
    raise NotImplementedError(
        f"frame-axis attention of {s} query frames over {sk} key frames at head width {dh} "
        f"has no kernel: K2 takes S <= 32, K2 long 32 < S <= 128, Sk <= S + 16")
