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
The modes that no backbone reaches, K5's score bias, K3's GELU form and K2
on the ``[B, S, 1, C]`` view of a biased ``[B, S, C]`` call, are driven
through the port's modules at the widths ``chip_smoke.py``'s "op surfaces"
path gives them, and must get a kernel and a plan too.
"""

import pytest
import torch

from anyv2v_torch.models import layers
from anyv2v_torch.ops import _build, attention, ffn, norm, rotary
from anyv2v_torch.ops import flash_attention as fl
from anyv2v_torch.ops import folded_attention as fa
from anyv2v_torch.ops import frame_attention as fr
from anyv2v_torch.ops import temporal_conv as tc
from anyv2v_torch.utils.model_zoo import ARCHS, build_modules


def _meta(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


def _stub_norms(monkeypatch, seen):
    """Replace KN's wrappers (``anyv2v_torch.ops.norm``, which the models
    call through the module) by stand-ins that record (images, pixels an
    image, C, groups) of the group norms and of K4's statistics, (rows, C) of
    the layer norms, into ``seen``."""
    def gn(x, weight, bias, groups, eps, dtype, silu=False):
        n, c = x.shape[0], x.shape[-1]
        seen.setdefault("group_norm", set()).add((n, x.numel() // (n * c), c, groups))
        return torch.empty(x.shape, device=x.device, dtype=dtype)

    def stats(x, weight, bias, groups, eps):
        n, c = x.shape[0], x.shape[-1]
        seen.setdefault("group_scale_shift", set()).add((n, x.numel() // (n * c), c, groups))
        return tuple(torch.empty(n, c, device=x.device) for _ in range(2))

    def ln(x, weight, bias, eps, dtype):
        seen.setdefault("layer_norm", set()).add((x.numel() // x.shape[-1], x.shape[-1]))
        return torch.empty(x.shape, device=x.device, dtype=dtype)

    monkeypatch.setattr(norm, "group_norm", gn)
    monkeypatch.setattr(norm, "group_scale_shift", stats)
    monkeypatch.setattr(norm, "layer_norm", ln)


def _check_norm_plans(seen):
    """Each routed norm shape has a launch plan that the card takes."""
    for n, p, c, groups in seen.get("group_norm", set()):
        _build.check_plan("group_norm", norm.norm_plan(n, p, c, groups))
    for n, p, c, groups in seen.get("group_scale_shift", set()):
        _build.check_plan("group_norm", norm.norm_plan(n, p, c, groups, stats_only=True))
    for rows, c in seen.get("layer_norm", set()):
        _build.check_plan("layer_norm", norm.layer_norm_plan(rows, c))


def _stub_kernels(monkeypatch, norms=None):
    """Replace every kernel wrapper (and the dispatcher's SDPA) by a stand-in
    that records its operands' shapes: returns {wrapper name: set of (q
    shape, k shape, heads)}, K3's entries (rows, C, inner) and K4's (x
    shape, C', prologue), KR's (x shape, rot, groups); K5's split-KV calls
    also under "flash_attention_context", with the context's length and
    frames. KN's shapes go to ``norms`` (:func:`_stub_norms`)."""
    seen = {}
    _stub_norms(monkeypatch, {} if norms is None else norms)

    def record(name):
        def call(q, k, v, heads, scale, *args, **kw):
            seen.setdefault(name, set()).add((tuple(q.shape), tuple(k.shape), heads))
            if name == "flash_attention" and args and args[0] is not None:
                # K5's split-KV context: its key length and frames per row
                seen.setdefault("flash_attention_context", set()).add(
                    (tuple(q.shape), tuple(k.shape), heads, args[0].shape[1], args[2]))
            return torch.empty_like(q)
        return call

    for name in ("frame_attention", "frame_attention_long", "folded_attention",
                 "flash_attention", "sdpa_attention"):
        monkeypatch.setattr(attention, name, record(name))
    def ffn(name):
        def call(x, w1, b1, w2, b2):
            seen.setdefault(name, set()).add((x.numel() // x.shape[-1], x.shape[-1],
                                              w2.shape[1]))
            return torch.empty(*x.shape[:-1], w2.shape[0], device=x.device, dtype=x.dtype)
        return call

    def tconv(x, s, t, w, b):
        seen.setdefault("gn_silu_temporal_conv", set()).add(
            (tuple(x.shape), w.shape[2], s is not None))
        return torch.empty(*x.shape[:-1], w.shape[2], device=x.device, dtype=x.dtype)

    monkeypatch.setattr(layers, "ffn_geglu", ffn("ffn_geglu"))
    monkeypatch.setattr(layers, "ffn_gelu", ffn("ffn_gelu"))
    # the temporal convs of both UNets launch K4 through
    # temporal_conv.groupnorm_silu_temporal_conv
    monkeypatch.setattr(tc, "gn_silu_temporal_conv", tconv)

    def rotate(x, positions, rot, groups=1):
        seen.setdefault("rotate_partial", set()).add((tuple(x.shape), rot, groups))
        return torch.empty_like(x)

    monkeypatch.setattr(rotary, "rotate_partial", rotate)
    return seen


def _routes(monkeypatch, arch, frames, hw=None, batch=3, norms=None):
    """{wrapper name: set of (q shape, k shape, heads)} of one forward."""
    seen = _stub_kernels(monkeypatch, norms)
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
def test_every_routed_rotary_shape_has_a_plan(monkeypatch, arch, frames):
    """ConsistI2V's and SEINE's temporal attention send KR their q and k
    (ConsistI2V also its cross-attention q, and its keys with the 8
    augmented rows), each at a layout KR takes with a plan one block can
    hold; i2vgen-xl sends none."""
    seen = _routes(monkeypatch, arch, frames)
    calls = seen.get("rotate_partial", set())
    assert bool(calls) == (not arch.startswith("i2vgen"))
    if arch.startswith("consisti2v"):
        assert {x[1] for x, _, _ in calls} == {frames + 1, frames + 9}
    for shape, rot, groups in calls:
        _build.check_plan("rotate_partial", rotary.rotary_plan(shape, rot, groups))


@pytest.mark.parametrize("arch,frames", _ARCH_FRAMES)
def test_every_routed_ffn_and_temporal_conv_shape_has_a_plan(monkeypatch, arch, frames):
    """K3 and K4 run on hopper.cuh's GEMM main loop: each shape a forward
    sends them gets plans (K3 per chunk of rows) that one block can hold, K4
    only at C and C' multiples of 8 and with its prologue on, its A by TMA
    exactly where P % 128 == 0 (a 128-row tile is then 128 pixels of one
    frame) and gathered elsewhere. i2vgen-xl and ConsistI2V reach both,
    SEINE only K3; seine-tiny's widths (8, 16) are too narrow for K3's gate
    and reach neither."""
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
        plan = tc.tconv_plan(b, f, p, c, c_out)
        _build.check_plan("gn_silu_temporal_conv", plan)
        assert plan["tma_a"] == (p % 128 == 0)
        if plan["tma_a"]:
            assert (b * f * p) % 128 == 0 and p % 128 == 0
        else:
            assert p < 128 or arch.endswith("-tiny")


@pytest.mark.parametrize("arch,frames", _ARCH_FRAMES)
def test_every_routed_norm_shape_has_a_plan(monkeypatch, arch, frames):
    """Every group norm, layer norm and K4 statistics call of a forward
    reaches KN with a plan that the card takes; the temporal UNets reach all
    three, SEINE no K4 statistics."""
    seen = {}
    _routes(monkeypatch, arch, frames, norms=seen)
    assert seen.get("group_norm") and seen.get("layer_norm")
    assert bool(seen.get("group_scale_shift")) == (not arch.startswith("seine"))
    _check_norm_plans(seen)


def test_dropped_widths_are_refused():
    """K2's old channel-pair body took head widths 2 and 4; no model stores a
    head that narrow, and neither route takes one now."""
    for dh in (2, 4):
        assert not fr.takes(16, 16, dh) and not fr.takes_long(64, 64, dh)
    assert fr.takes(16, 32, 32) and fr.takes(16, 32, 64)   # widths 32/64 at Sk > S


# the first-frame editors at full width: InstructPix2Pix at 512^2 (batch 3),
# CosXL at 1024^2 (batch 3), InstantStyle's UNet with IP tokens and its
# ControlNet at 1024^2 (batch 2), and the IP-Adapter Plus resampler
_EDITORS = [("instructpix2pix", 512, 3), ("cosxl", 1024, 3), ("instantstyle", 1024, 2),
            ("instructpix2pix-tiny", 64, 3), ("cosxl-tiny", 64, 3), ("instantstyle-tiny", 64, 2)]


def _editor_routes(monkeypatch, arch, size, batch, norms=None):
    from anyv2v_torch.pipelines.instantstyle import Resampler

    seen = _stub_kernels(monkeypatch, norms)
    modules = {k: m.to(torch.bfloat16).eval() for k, m in build_modules(arch, torch.bfloat16).items()}
    cfg = ARCHS[arch]["unet"]
    h, ctx = size // 8, cfg.cross_attention_dim
    kw = {}
    if cfg.addition_embed == "sdxl":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        kw = {"added_text_embeds": _meta(batch, pooled), "added_time_ids": _meta(batch, 6)}
    with torch.inference_mode():
        if "controlnet" in modules:
            down, mid = modules["controlnet"](_meta(batch, h, h, 4), 501.0, _meta(batch, 77, ctx),
                                              _meta(batch, size, size, 3), 0.6, **kw)
            kw.update(ip_tokens=_meta(batch, 4, ctx), down_block_residuals=down,
                      mid_block_residual=mid)
        modules["unet"](_meta(batch, h, h, cfg.in_channels), 501.0, _meta(batch, 77, ctx), **kw)
        if arch == "instantstyle":
            Resampler().to(device="meta", dtype=torch.bfloat16)(_meta(batch, 257, 1280))
    return seen, modules


@pytest.mark.parametrize("arch,size,batch", _EDITORS[3:])
def test_tiny_editor_attentions_have_a_kernel_and_a_plan(monkeypatch, arch, size, batch):
    """The tiny editors' attentions (the card's reference checks run them)
    take K1 (short, 8 wide) or K5, each with a plan; none reaches SDPA."""
    seen, _ = _editor_routes(monkeypatch, arch, size, batch)
    assert seen.get("folded_attention") and set(seen) - {"ffn_geglu"} <= {
        "folded_attention", "flash_attention"}, sorted(seen)
    for (b, sq, c), k, heads in seen["folded_attention"]:
        assert c // heads in fa.HEAD_DIMS
        _build.check_plan("folded_attention", fa.folded_plan(b, sq, k[1], heads, c // heads))
    for (b, sq, c), k, heads in seen.get("flash_attention", ()):
        _build.check_plan("flash_attention", fl.flash_plan(b, sq, heads, c // heads))


@pytest.mark.parametrize("arch,size,batch", _EDITORS[:3])
def test_editor_attentions_route_to_k5_with_a_plan(monkeypatch, arch, size, batch):
    """Every UNet (and ControlNet, and resampler) attention of the editors is
    K5's, with a launch plan one block can hold: self-attention at every
    level, cross over 77 text tokens, InstantStyle's IP attention over 4
    keys on each of ``up_0_attn_1``'s transformer blocks, the resampler's 16
    queries over 273 keys. No attention reaches K1, K2 or SDPA."""
    seen, modules = _editor_routes(monkeypatch, arch, size, batch)
    assert set(seen) - {"ffn_geglu"} == {"flash_attention"}, sorted(seen)
    for (b, sq, c), k, heads in seen["flash_attention"]:
        assert c // heads in fl.HEAD_DIMS
        _build.check_plan("flash_attention", fl.flash_plan(b, sq, heads, c // heads))
    keys = {k[1] for _, k, _ in seen["flash_attention"]}
    assert 77 in keys
    if arch.startswith("instantstyle"):
        ip_calls = [(q, k) for q, k, _ in seen["flash_attention"] if k[1] == 4]
        ip_blocks = len(modules["unet"].up_blocks[0].attentions[1].transformer_blocks)
        assert ip_calls and all(q[1] == (size // 32) ** 2 for q, _ in ip_calls)
        assert ip_blocks == ARCHS[arch]["unet"].depth_for(2)
    if arch == "instantstyle":
        assert ((2, 16, 768), (2, 273, 768), 12) in seen["flash_attention"]
    if arch == "cosxl":   # SDXL's self-attention: 10 heads of 64 at 4096 tokens, 20 at 1024
        assert {((3, 4096, 640), 10), ((3, 1024, 1280), 20)} <= {
            (q, h) for q, k, h in seen["flash_attention"] if k[1] == q[1]}


@pytest.mark.parametrize("arch,size,batch", _EDITORS[:3])
def test_editor_ffns_take_k3_below_c768_only(monkeypatch, arch, size, batch):
    """K3 takes the GEGLU feed-forwards at C 320 / 640 (with plans for their
    rows) and refuses C 1280, which stays on cuBLAS as the JAX gate leaves
    it; no editor feed-forward has the GELU form."""
    from anyv2v_torch.models.layers import FeedForward

    seen, modules = _editor_routes(monkeypatch, arch, size, batch)
    assert {c for _, c, _ in seen["ffn_geglu"]} == ({320, 640} if arch == "instructpix2pix"
                                                    else {640})
    for n, c, inner in seen["ffn_geglu"]:
        plan = ffn.ffn_plan(min(ffn.CHUNK_ROWS, n), c, inner)
        for part in ("geglu", "out"):
            _build.check_plan("ffn_geglu", plan[part])
    ffns = [m for mod in modules.values() for m in mod.modules() if isinstance(m, FeedForward)]
    assert all(m.activation == "geglu" for m in ffns)
    wide = {m.net[2].out_features for m in ffns} - {320, 640}
    assert wide == {1280} and not ffn.fits(1280, 5120)


def test_op_surfaces_route_to_the_bias_and_gelu_kernels_with_a_plan(monkeypatch):
    """chip_smoke's "op surfaces" path on the ``meta`` device: the biased
    ``Attention`` calls reach K5 with the bias (shared, per row, dh 32), the
    biased ``TemporalTransformer`` reaches K2 on the ``[B, S, 1, C]`` view
    (its second attention, unbiased, K5 at dh 40; its feed-forward K3's
    GEGLU form), and ``FeedForward(gelu)`` K3's GELU form; each with a plan
    one block can hold."""
    import chip_smoke

    seen = {}

    def record(name):
        def call(q, k, v, heads, scale, *args, bias=None, **kw):
            if name == "frame_attention" and args:
                bias = args[0]
            seen.setdefault(name, []).append((tuple(q.shape), tuple(k.shape), heads,
                                              None if bias is None else tuple(bias.shape)))
            return torch.empty_like(q)
        return call

    for name in ("frame_attention", "frame_attention_long", "folded_attention",
                 "flash_attention", "sdpa_attention"):
        monkeypatch.setattr(attention, name, record(name))
    for name in ("ffn_geglu", "ffn_gelu"):
        monkeypatch.setattr(layers, name, lambda x, w1, b1, w2, b2, name=name: seen.setdefault(
            name, []).append((x.numel() // x.shape[-1], x.shape[-1], w2.shape[1]))
            or torch.empty_like(x))
    norms = {}
    _stub_norms(monkeypatch, norms)
    with torch.inference_mode():
        chip_smoke.op_surfaces(device="meta")
    _check_norm_plans(norms)
    assert set(seen) == {"flash_attention", "frame_attention", "ffn_gelu", "ffn_geglu"}, \
        sorted(seen)
    forms = set()
    for (b, sq, c), k, heads, bias in seen["flash_attention"]:
        dh = c // heads
        assert dh in fl.HEAD_DIMS
        form = None if bias is None else fl.bias_form(torch.empty(bias, device="meta"), b,
                                                      heads, sq, k[1])
        assert bias is None or form is not None
        forms.add((form, dh))
        _build.check_plan("flash_attention", fl.flash_plan(b, sq, heads, dh, form, k[1]))
    assert {("shared", 40), ("batch", 64), ("shared", 32)} <= forms
    for q, k, heads, bias in seen["frame_attention"]:
        b, s, hw, c = q
        assert hw == 1 and bias == (heads, s, k[1]) and fr.takes(s, k[1], c // heads)
        _build.check_plan("frame_attention", fr.frame_plan(b, s, k[1], hw, heads, c // heads))
    assert {c for _, c, _ in seen["ffn_gelu"]} == {320, 640}
    for n, c, inner in seen["ffn_gelu"]:
        assert ffn.fits(c, inner)
        plan = ffn.ffn_plan(min(ffn.CHUNK_ROWS, n), c, inner, activation="gelu")
        for part in ("gelu", "out"):
            _build.check_plan("ffn_gelu", plan[part])


@pytest.mark.parametrize("arch,size,batch", _EDITORS)
def test_every_editor_norm_shape_has_a_plan(monkeypatch, arch, size, batch):
    seen = {}
    _editor_routes(monkeypatch, arch, size, batch, norms=seen)
    assert seen.get("group_norm") and seen.get("layer_norm")
    _check_norm_plans(seen)
