"""The port's five kernel functions against the JAX package's Pallas entries.

Each CUDA kernel of ``anyv2v_torch/csrc`` has a plain PyTorch version in its
module; on CPU tensors the kernel's wrapper runs that version. Here the
wrapper (so the plain version) and the Pallas entry it replaces run on the
same numpy-seeded fp32 inputs; off-TPU the Pallas entries run in interpret
mode. Shapes are small but cover each routed class: self and cross, padded
head widths 8/16/32/64, 16 frames with a pixel count that tiles; for K5 the
split-head flash (head widths 40/80/160, ragged Sq and Sk), split-KV and
short-K/V cross classes, and its score bias (shared by the batch or per
row, head widths 8/16/32/40/64, ragged Sq and Sk); for K2 the augmented key
axis Sk = S + 8 and the per-head score bias (SEINE's relative-position bias)
in both Pallas forms, and on the ``[B, S, 1, C]`` view through which the
dispatcher sends a shared bias on ``[B, S, C]`` tokens; for K3 both forms,
GEGLU and GELU.

Tolerance: rtol 1e-4, atol 2e-5 (the block goldens' in
tests/test_convert_golden.py). The kernels themselves are checked against the
same plain versions on the GPU by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.ops import pallas_temporal_conv
from anyv2v_tpu.ops.pallas_attention import flash_attention_bshd, flash_attention_splitkv
from anyv2v_tpu.ops.pallas_cross_attention import cross_attention_short_kv
from anyv2v_tpu.ops.pallas_ffn import fused_ffn
from anyv2v_tpu.ops.pallas_packed_flash import packed_flash_attention
from anyv2v_tpu.ops.pallas_short_attention import short_attention_bsc, short_attention_frames
from anyv2v_tpu.ops.pallas_temporal_conv import temporal_conv3
from anyv2v_tpu.ops.pallas_temporal_ew import temporal_ew_attention
from anyv2v_torch.ops.attention import multi_head_attention
from anyv2v_torch.ops.ffn import ffn_geglu, ffn_gelu
from anyv2v_torch.ops import flash_attention as fl
from anyv2v_torch.ops.flash_attention import flash_attention, flash_attention_plain
from anyv2v_torch.ops.folded_attention import folded_attention
from anyv2v_torch.ops.frame_attention import frame_attention
from anyv2v_torch.ops.temporal_conv import gn_silu_temporal_conv, groupnorm_scale_shift

TOL = dict(rtol=1e-4, atol=2e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _case(b, sq, sk, heads, dh, true_dh, variant=None):
    """A case of the packed-flash test; the default route keeps its old id."""
    ident = "-".join(str(x) for x in (b, sq, sk, heads, dh, true_dh))
    return pytest.param(b, sq, sk, heads, dh, true_dh, variant,
                        id=ident if variant is None else f"{ident}-{variant}")


@pytest.mark.parametrize(
    "b,sq,sk,heads,dh,true_dh,variant",
    [
        _case(1, 256, 256, 64, 8, 5),      # L0 self class (dh 5 -> 8)
        _case(1, 256, 157, 64, 8, 5),      # L0 cross: text + image context
        _case(1, 256, 256, 32, 16, 10),    # L1 self class (dh 10 -> 16)
        _case(2, 256, 157, 16, 32, 20),    # L2 cross class (dh 20 -> 32)
        # _packed_whole_kernel (pipe=False): the whole K/V window, no online state
        _case(1, 256, 256, 64, 8, 5, "whole"),
        _case(1, 128, 200, 32, 16, 10, "whole"),
        # _packed_kernel: the online-softmax form; Sk > 512 with a ragged tail
        _case(1, 256, 256, 64, 8, 5, "online"),
        _case(1, 200, 600, 16, 32, 20, "online"),
    ],
)
def test_folded_attention_vs_packed_flash(b, sq, sk, heads, dh, true_dh, variant, monkeypatch):
    """``variant`` sets ``ANYV2V_PACKED_VARIANT``, which alone reaches the
    Pallas kernels of PERF.md rows 4 (``whole``) and 5 (``online``); K1
    computes their function."""
    if variant is not None:
        monkeypatch.setenv("ANYV2V_PACKED_VARIANT", variant)
    rng = np.random.RandomState(0)
    c = heads * dh
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    scale = true_dh ** -0.5
    want = packed_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  heads=heads, scale=scale)
    got = folded_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           heads, scale)
    _close(got, want)


@pytest.mark.parametrize(
    "b,s,heads,dh,true_dh",
    [
        (4, 64, 64, 32, 20),   # mid-block spatial self (8x8 tokens)
        (64, 16, 2, 8, 4),     # image-latent temporal encoder (2 heads, dh 4 -> 8)
    ],
)
def test_folded_attention_vs_short_attention(b, s, heads, dh, true_dh):
    rng = np.random.RandomState(1)
    c = heads * dh
    q, k, v = _rand(rng, b, s, c), _rand(rng, b, s, c), _rand(rng, b, s, c)
    scale = true_dh ** -0.5
    want = short_attention_bsc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               heads=heads, scale=scale)
    got = folded_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           heads, scale)
    _close(got, want)


@pytest.mark.parametrize(
    "b,s,hw,heads,dh,true_dh",
    [
        (1, 16, 64, 64, 8, 5),    # L0 temporal class
        (3, 8, 32, 4, 16, 10),    # edit batch, short clip
    ],
)
def test_frame_attention_vs_temporal_ew(b, s, hw, heads, dh, true_dh):
    rng = np.random.RandomState(2)
    c = heads * dh
    q, k, v = (_rand(rng, b, s, hw, c, scale=0.3) for _ in range(3))
    scale = true_dh ** -0.5
    want = temporal_ew_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 heads=heads, scale=scale)
    got = frame_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, scale)
    _close(got, want)


@pytest.mark.parametrize(
    "b,s,hw,heads,dh,true_dh",
    [
        (3, 16, 64, 8, 64, 64),    # transformer_in class (8 heads x 64)
        (2, 16, 64, 64, 16, 10),   # L1 temporal class
        (2, 8, 16, 2, 16, 16),     # tiny arch
    ],
)
def test_frame_attention_vs_short_attention_frames(b, s, hw, heads, dh, true_dh):
    rng = np.random.RandomState(3)
    c = heads * dh
    q, k, v = (_rand(rng, b, s, hw, c) for _ in range(3))
    scale = true_dh ** -0.5
    want = short_attention_frames(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  heads=heads, scale=scale)
    got = frame_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, scale)
    _close(got, want)


@pytest.mark.parametrize(
    "b,s,sk,hw,heads,dh",
    [
        (2, 17, 25, 16, 8, 40),    # ConsistI2V L0 temporal: 16 frames + conditioning, 8 window keys
        (1, 17, 25, 8, 8, 80),     # L1 temporal
        (1, 5, 13, 8, 2, 16),      # tiny arch
    ],
)
def test_frame_attention_extra_keys_vs_short_attention_frames(b, s, sk, hw, heads, dh):
    rng = np.random.RandomState(8)
    c = heads * dh
    q = _rand(rng, b, s, hw, c)
    k, v = _rand(rng, b, sk, hw, c), _rand(rng, b, sk, hw, c)
    want = short_attention_frames(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  heads=heads, scale=dh ** -0.5)
    got = frame_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, dh ** -0.5)
    _close(got, want)


def _bias(rng, heads, s, sk):
    return _rand(rng, heads, s, sk)


@pytest.mark.parametrize(
    "b,s,hw,heads,dh",
    [
        (3, 16, 16, 8, 40),    # SEINE L0 temporal class: 8 heads of 40, T5 bias
        (3, 16, 8, 8, 80),     # L1
        (1, 16, 8, 8, 160),    # L2 and mid
        (3, 4, 16, 2, 8),      # seine-tiny (dh 4 stored as 8): the pair body
    ],
)
def test_frame_attention_bias_vs_short_attention_frames(b, s, hw, heads, dh):
    """The per-head score bias [heads, S, S], added after the scale."""
    rng = np.random.RandomState(12)
    c = heads * dh
    q, k, v = (_rand(rng, b, s, hw, c) for _ in range(3))
    bias = _bias(rng, heads, s, s)
    want = short_attention_frames(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  heads=heads, scale=dh ** -0.5, bias=jnp.asarray(bias))
    got = frame_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, dh ** -0.5, torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize("b,s,sk,hw,heads,dh", [(1, 16, 16, 64, 64, 8), (2, 5, 13, 16, 2, 8)])
def test_frame_attention_bias_vs_temporal_ew(b, s, sk, hw, heads, dh):
    """The elementwise kernel's bias (folded with log2 e), Sk == S and the
    augmented key axis."""
    rng = np.random.RandomState(13)
    c = heads * dh
    q = _rand(rng, b, s, hw, c, scale=0.3)
    k, v = _rand(rng, b, sk, hw, c, scale=0.3), _rand(rng, b, sk, hw, c, scale=0.3)
    bias = _bias(rng, heads, s, sk)
    want = temporal_ew_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
                                 scale=dh ** -0.5, bias=jnp.asarray(bias))
    got = frame_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, dh ** -0.5, torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize(
    "b,sq,sk,heads,dh",
    [
        (1, 17 * 16, 77, 8, 40),    # temporal cross over [B, F*HW, C], dh 40
        (2, 130, 77, 8, 80),        # dh 80, ragged Sq
        (1, 100, 70, 2, 160),       # dh 160, ragged Sk
        (2, 150, 90, 3, 24),        # the Pallas kernel's other widths: dh 24 (pad chunk)
        (1, 130, 140, 2, 128),      # and dh 128
    ],
)
def test_flash_attention_vs_flash_bshd(b, sq, sk, heads, dh):
    rng = np.random.RandomState(9)
    c = heads * dh
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    want = flash_attention_bshd(*(jnp.asarray(x.reshape(b, x.shape[1], heads, dh))
                                  for x in (q, k, v)), scale=dh ** -0.5)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, dh ** -0.5)
    _close(got, np.asarray(want).reshape(b, sq, c))


@pytest.mark.parametrize(
    "b,sq,sk,heads,dh,form",
    [
        (2, 130, 77, 2, 8, "shared"),     # ragged Sq past one query tile, keys of one tile
        (1, 64, 200, 3, 16, "batch"),     # ragged Sk past one key tile
        (2, 100, 150, 2, 32, "shared4"),  # [1, H, Sq, Sk]
        (3, 40, 40, 2, 40, "batch"),
        (1, 129, 131, 1, 64, "shared"),
    ],
)
def test_flash_attention_bias_vs_flash_bshd(b, sq, sk, heads, dh, form):
    """K5's bias operand: an fp32 score bias added after the scale, shared by
    the batch ([H, Sq, Sk] or [1, H, Sq, Sk]) or per row ([B, H, Sq, Sk])."""
    rng = np.random.RandomState(14)
    c = heads * dh
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    bias = _rand(rng, *{"shared": (heads, sq, sk), "shared4": (1, heads, sq, sk),
                        "batch": (b, heads, sq, sk)}[form])
    want = flash_attention_bshd(*(jnp.asarray(x.reshape(b, x.shape[1], heads, dh))
                                  for x in (q, k, v)), bias=jnp.asarray(bias), scale=dh ** -0.5)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads, dh ** -0.5)
    got = flash_attention_plain(*args, bias=torch.from_numpy(bias))
    _close(got, np.asarray(want).reshape(b, sq, c))
    # the wrapper takes the same operand (its plain version, on the CPU)
    _close(flash_attention(*args, bias=torch.from_numpy(bias)), np.asarray(want).reshape(b, sq, c))


@pytest.mark.parametrize(
    "b,sq,sk,heads,dh",
    [
        (4, 16, 16, 8, 40),     # SEINE's temporal widths, F 16
        (3, 17, 25, 2, 64),     # the augmented key axis
        (2, 40, 48, 2, 16),     # past 32 frames: K2 long's class
        (5, 7, 7, 4, 8),
    ],
)
def test_biased_bsc_attention_vs_short_attention_bsc(b, sq, sk, heads, dh):
    """A bias shared by the batch at short lengths: ``multi_head_attention``
    sends it to the frame kernels on the ``[B, S, 1, C]`` view, the function
    of the Pallas ``_short_kernel`` with its ``[H, Sq, Sk]`` bias."""
    rng = np.random.RandomState(15)
    c = heads * dh
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    bias = _bias(rng, heads, sq, sk)
    want = short_attention_bsc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
                               scale=dh ** -0.5, bias=jnp.asarray(bias))
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               heads, dh ** -0.5, bias=torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize("b,frames,s,heads,dh", [(2, 3, 64, 2, 64), (1, 4, 40, 1, 40)])
def test_flash_attention_splitkv_vs_pallas(b, frames, s, heads, dh):
    """First-frame K/V shared by each batch row's frames, one softmax."""
    rng = np.random.RandomState(10)
    c = heads * dh
    q, k, v = (_rand(rng, b * frames, s, c) for _ in range(3))
    kc, vc = _rand(rng, b, s, c), _rand(rng, b, s, c)

    def heads_split(x):
        return jnp.asarray(x.reshape(x.shape[0], x.shape[1], heads, dh))

    want = flash_attention_splitkv(*(heads_split(x) for x in (q, k, v, kc, vc)),
                                   frames=frames, scale=dh ** -0.5)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, dh ** -0.5, torch.from_numpy(kc), torch.from_numpy(vc), frames)
    _close(got, np.asarray(want).reshape(b * frames, s, c))


@pytest.mark.parametrize("b,sq,sk,heads", [(2, 256, 77, 5), (1, 200, 30, 2)])
def test_flash_attention_vs_cross_short_kv(b, sq, sk, heads):
    """The spatial cross-attention class: long queries over text, dh 64."""
    rng = np.random.RandomState(11)
    c = heads * 64
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    want = cross_attention_short_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    heads=heads, scale=0.125)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, 0.125)
    _close(got, want)


@pytest.mark.parametrize("sk", [1, 4, 16, 17, 77, 80, 128, 129])
def test_flash_attention_one_tile_key_widths_vs_cross_short_kv(sk):
    """K5's one-key-tile body takes Sk rounded up to 16 as its key width (16,
    32, ..., 80; past 80 keys the tiles body): the wrapper at key counts on
    each side of each width and of the tiles body's one tile (128) against
    the Pallas cross kernel, 5 heads of 64 (one head group of 320
    channels)."""
    b, sq, heads = 2, 70, 5
    plan = fl.flash_plan(13, 4100, heads, 64, None, sk)   # chip_smoke's case of this Sk
    assert plan["body"] == ("short" if sk <= fl.SHORT_MAX_KEYS else "tiles")
    assert plan["key_tile"] == (-(-sk // 16) * 16 if sk <= fl.SHORT_MAX_KEYS else 128)
    rng = np.random.RandomState(16)
    c = heads * 64
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    want = cross_attention_short_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    heads=heads, scale=0.125)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, 0.125)
    _close(got, want)


@pytest.mark.parametrize(
    "b,sq,sk,heads,dh,group",
    [
        (2, 70, 77, 3, 40, 3),      # fewer heads of 40 than a group of 8: one ragged group
        (1, 65, 33, 12, 40, 8),     # 8 + 4
        (2, 70, 50, 6, 80, 4),      # 4 + 2
        (1, 40, 50, 3, 160, 2),     # 2 + 1
        (2, 70, 20, 7, 64, 5),      # 5 + 2
        (2, 70, 77, 5, 64, 5),      # one whole group
    ],
)
def test_flash_attention_ragged_head_groups_vs_flash_bshd(b, sq, sk, heads, dh, group):
    """The short body's items cover a group of heads whose channels are whole
    64-channel chunks; where the head count is not a multiple of the group,
    the last group is ragged (the group asserted at a call that fills the
    card). The wrapper against the Pallas split-head kernel at such head
    counts."""
    plan = fl.flash_plan(13, 4100, heads, dh, None, sk)   # a call that fills the card
    assert plan["body"] == "short" and plan["head_group"] == group
    rng = np.random.RandomState(17)
    c = heads * dh
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    want = flash_attention_bshd(*(jnp.asarray(x.reshape(b, x.shape[1], heads, dh))
                                  for x in (q, k, v)), scale=dh ** -0.5)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          heads, dh ** -0.5)
    _close(got, np.asarray(want).reshape(b, sq, c))


@pytest.mark.parametrize("lead,c", [((1024,), 128), ((2, 300), 320), ((4, 40), 64)])
def test_ffn_geglu_vs_fused_ffn(lead, c):
    rng = np.random.RandomState(4)
    inner = 4 * c
    x = _rand(rng, *lead, c)
    w1, b1 = _rand(rng, c, 2 * inner, scale=0.02), _rand(rng, 2 * inner, scale=0.1)
    w2, b2 = _rand(rng, inner, c, scale=0.02), _rand(rng, c, scale=0.1)
    want = fused_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), activation="geglu")
    # the port keeps torch Linear layouts: [out, in]
    got = ffn_geglu(torch.from_numpy(x), torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
                    torch.from_numpy(w2.T.copy()), torch.from_numpy(b2))
    _close(got, want)


@pytest.mark.parametrize("lead,c", [((1024,), 128), ((2, 300), 320), ((4, 40), 64)])
def test_ffn_gelu_vs_fused_ffn(lead, c):
    """K3's GELU form: ``gelu(x W1 + b1)`` rounded where the Pallas body
    rounds, then ``W2``; the Pallas GELU is a degree-9 fit, 6.5e-6 from erf."""
    rng = np.random.RandomState(16)
    inner = 4 * c
    x = _rand(rng, *lead, c)
    w1, b1 = _rand(rng, c, inner, scale=0.02), _rand(rng, inner, scale=0.1)
    w2, b2 = _rand(rng, inner, c, scale=0.02), _rand(rng, c, scale=0.1)
    want = fused_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), activation="gelu")
    got = ffn_gelu(torch.from_numpy(x), torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
                   torch.from_numpy(w2.T.copy()), torch.from_numpy(b2))
    _close(got, want)


@pytest.mark.parametrize("b,f,p,c,c_out", [(1, 16, 64, 128, 128), (3, 8, 24, 64, 32)])
def test_temporal_conv_vs_temporal_conv3(b, f, p, c, c_out):
    rng = np.random.RandomState(5)
    x = _rand(rng, b, f, p, c)
    w, bias = _rand(rng, 3, c, c_out, scale=0.05), _rand(rng, c_out, scale=0.1)
    want = temporal_conv3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = gn_silu_temporal_conv(torch.from_numpy(x), None, None, torch.from_numpy(w),
                                torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize("b,f,p,c,c_out,groups", [(1, 16, 64, 128, 128, 32),
                                                  (3, 8, 24, 64, 64, 8)])
def test_temporal_conv_prologue_vs_pallas_run(b, f, p, c, c_out, groups):
    """The fused groupnorm-apply + SiLU prologue (Pallas ``_run`` with s/t)."""
    rng = np.random.RandomState(6)
    x = _rand(rng, b, f, p, c)
    gamma, beta = 1.0 + _rand(rng, c, scale=0.1), _rand(rng, c, scale=0.1)
    w, bias = _rand(rng, 3, c, c_out, scale=0.05), _rand(rng, c_out, scale=0.1)
    xt = torch.from_numpy(x)
    s, t = groupnorm_scale_shift(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                                 groups, 1e-5)
    want = pallas_temporal_conv._run(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                     jnp.asarray(s.numpy()), jnp.asarray(t.numpy()),
                                     jnp.float32)
    got = gn_silu_temporal_conv(xt, s, t, torch.from_numpy(w), torch.from_numpy(bias))
    _close(got, want)


def test_groupnorm_scale_shift_is_groupnorm():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_rand(rng, 2, 4, 12, 32))
    gamma, beta = torch.from_numpy(1 + _rand(rng, 32)), torch.from_numpy(_rand(rng, 32))
    s, t = groupnorm_scale_shift(x, gamma, beta, 8, 1e-5)
    want = torch.nn.functional.group_norm(x.permute(0, 3, 1, 2), 8, gamma, beta, 1e-5)
    np.testing.assert_allclose((x * s[:, None, None] + t[:, None, None]).numpy(),
                               want.permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-5)
