"""Every attention, feed-forward and temporal-conv shape the three backbones
route, at tiny and full width.

Each UNet runs one forward on the ``meta`` device (shapes only, no data),
batch 3 with every PnP flag on, with the kernel wrappers replaced by stand-ins
that record their operands' shapes and return an empty output. Every
frame-axis attention must satisfy ``frame_attention.takes`` (S <= 32) or
``takes_long`` (32 < S <= 128), so the one tensor-core body takes it; the
stored head widths are at least 8 (``models/layers.py`` pads every head), so
the widths 2 and 4 that K2's old channel-pair body took are never asked for.
Every K1 and K2 shape must also get a launch plan that one block can hold,
and so must every K3 (GEGLU feed-forward) and K4 (temporal conv) shape.
"""

import pytest
import torch

from anyv2v_torch.models import layers, unet_videoldm
from anyv2v_torch.ops import _build, attention, ffn
from anyv2v_torch.ops import folded_attention as fa
from anyv2v_torch.ops import frame_attention as fr
from anyv2v_torch.ops import temporal_conv as tc
from anyv2v_torch.utils.model_zoo import ARCHS, build_modules


def _meta(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


def _routes(monkeypatch, arch, frames, hw=None, batch=3):
    """{wrapper name: set of (q shape, k shape, heads)} of one forward."""
    seen = {}

    def record(name):
        def call(q, k, v, heads, scale, *args, **kw):
            seen.setdefault(name, set()).add((tuple(q.shape), tuple(k.shape), heads))
            return torch.empty_like(q)
        return call

    for name in ("frame_attention", "frame_attention_long", "folded_attention",
                 "flash_attention"):
        monkeypatch.setattr(attention, name, record(name))
    def ffn(x, w1, b1, w2, b2):
        seen.setdefault("ffn_geglu", set()).add((x.numel() // x.shape[-1], x.shape[-1],
                                                 w2.shape[1]))
        return torch.empty(*x.shape[:-1], w2.shape[0], device=x.device, dtype=x.dtype)

    def tconv(x, s, t, w, b):
        seen.setdefault("gn_silu_temporal_conv", set()).add(
            (tuple(x.shape), w.shape[2], s is not None))
        return torch.empty(*x.shape[:-1], w.shape[2], device=x.device, dtype=x.dtype)

    monkeypatch.setattr(layers, "ffn_geglu", ffn)

    monkeypatch.setattr(layers, "gn_silu_temporal_conv", tconv)
    monkeypatch.setattr(unet_videoldm, "gn_silu_temporal_conv", tconv)

    cfg = ARCHS[arch]["unet"]
    hw = hw or (64 if cfg.block_out_channels[0] >= 320 else 16)
    unet = build_modules(arch, torch.bfloat16)["unet"].to(torch.bfloat16).eval()
    ctx = cfg.cross_attention_dim
    with torch.inference_mode():
        if arch.startswith("i2vgen"):
            unet(_meta(batch, frames, hw, hw, 4), 501, _meta(batch, 77, ctx), 8,
                 _meta(batch, frames, hw, hw, 4), _meta(batch, 1, ctx), pnp=(True, True, True))
        elif arch.startswith("consisti2v"):
            unet(_meta(batch, frames, hw, hw, 4), 501, _meta(batch, 77, ctx),
                 _meta(batch, 1, hw, hw, 4), 3, pnp=(True, True, True), pnp_chunks=3)
        else:
            unet(_meta(batch, frames, hw, hw, 9), 501, _meta(batch, 77, ctx),
                 pnp=(True, True, True, True))
    return seen


_ARCH_FRAMES = [
    ("i2vgen-xl", 16), ("i2vgen-xl", 128), ("i2vgen-tiny", 8), ("i2vgen-tiny", 40),
    ("consisti2v", 16), ("consisti2v-tiny", 8), ("seine", 16), ("seine-tiny", 8),
]


@pytest.mark.parametrize("arch,frames", _ARCH_FRAMES)
def test_every_routed_attention_shape_has_a_kernel_and_a_plan(monkeypatch, arch, frames):
    seen = _routes(monkeypatch, arch, frames)
    temporal = seen.get("frame_attention", set()) | seen.get("frame_attention_long", set())
    assert temporal, "no frame-axis attention reached the dispatcher"
    for q, k, heads in temporal:
        b, s, hw, c = q
        sk, dh = k[1], c // heads
        assert dh >= 8 and dh in fr.HEAD_DIMS
        assert fr.takes(s, sk, dh) if s <= fr.MAX_FRAMES else fr.takes_long(s, sk, dh)
        _build.check_plan("frame_attention", fr.frame_plan(b, s, sk, hw, heads, dh))
    for (b, sq, c), k, heads in seen.get("folded_attention", set()):
        dh = c // heads
        assert dh in fa.HEAD_DIMS
        _build.check_plan("folded_attention", fa.folded_plan(b, sq, k[1], heads, dh))
    # the frame count picks the route: K2 long only past 32 frames
    assert bool(seen.get("frame_attention_long")) == (frames + arch.startswith("consisti2v")
                                                       > fr.MAX_FRAMES)




@pytest.mark.parametrize("arch,frames", _ARCH_FRAMES)
def test_every_routed_ffn_and_temporal_conv_shape_has_a_plan(monkeypatch, arch, frames):
    """K3 and K4 run on hopper.cuh's GEMM main loop: each shape a forward
    sends them gets plans (K3 per chunk of rows) that one block can hold, K4
    only at C and C' multiples of 8 and with its prologue on. i2vgen-xl and
    ConsistI2V reach both, SEINE only K3; seine-tiny's widths (8, 16) are
    too narrow for K3's gate and reach neither."""
    seen = _routes(monkeypatch, arch, frames)
    ffns, tconvs = seen.get("ffn_geglu", set()), seen.get("gn_silu_temporal_conv", set())
    assert bool(ffns) == (arch != "seine-tiny")
    assert bool(tconvs) == (not arch.startswith("seine"))
    for n, c, inner in ffns:
        assert ffn.fits(c, inner)
        for i in range(0, n, ffn.CHUNK_ROWS):
            plan = ffn.ffn_plan(min(ffn.CHUNK_ROWS, n - i), c, inner)
            for part in ("geglu", "out"):
                _build.check_plan("ffn_geglu", plan[part])
    for (b, f, p, c), c_out, prologue in tconvs:
        assert prologue and c % 8 == 0 and c_out % 8 == 0
        _build.check_plan("gn_silu_temporal_conv", tc.tconv_plan(b, f, p, c, c_out))


def test_dropped_widths_are_refused():
    """K2's old channel-pair body took head widths 2 and 4; no model stores a
    head that narrow, and neither route takes one now."""
    for dh in (2, 4):
        assert not fr.takes(16, 16, dh) and not fr.takes_long(64, 64, dh)
    assert fr.takes(16, 32, 32) and fr.takes(16, 32, 64)   # widths 32/64 at Sk > S
