"""KN, the port's norms (``anyv2v_torch/ops/norm.py``, ``csrc/norm.cu``), on the CPU.

The plain versions against ``torch.nn.functional``'s group and layer norms
(with and without SiLU, fp32 and bf16 in and out, groups of 4-80 channels, a
group of about a million elements far from zero); the launch plans within
the card's grid and shared-memory limits at every shape the configurations
route to the kernels; the model helpers' output dtype; and the benchmark's
KN family: its ``WRAP`` sees every norm call of a tiny ConsistI2V edit (as
many as the program's ``layer.norm`` and ``layer.tconv`` spans), its byte
counts, its name patterns against the kernels of ``csrc/``, and its loading
against a program without the entry points. The kernels themselves run on
the card only (``chip_smoke.py``).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from anyv2v_torch.models import layers
from anyv2v_torch.ops import _build, norm
from anyv2v_torch.utils.model_zoo import ARCHS, build_consisti2v_pipeline, build_modules
from anyv2v_torch.utils.profiling import tracing

BF16, FP32 = torch.bfloat16, torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(shape, dtype, mean=0.0, std=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (mean + std * torch.randn(*shape, generator=g)).to(dtype)


def _affine(c, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return ((1 + 0.1 * torch.randn(c, generator=g)).to(dtype),
            (0.1 * torch.randn(c, generator=g)).to(dtype))


def _close(got, want, out_dtype):
    """fp32 outputs to fp32 rounding; bf16 outputs to one bf16 step (the
    fp32 values either side of a rounding boundary)."""
    tol = dict(rtol=1e-5, atol=2e-5) if out_dtype == FP32 else dict(rtol=2 ** -7, atol=2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("c,groups", [(128, 32), (320, 32), (64, 8), (2560, 32)],
                         ids=["4 a group", "10 a group", "8 a group", "80 a group"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("x_dtype,out_dtype", [(FP32, FP32), (BF16, BF16), (BF16, FP32),
                                               (FP32, BF16)])
def test_group_norm_plain_is_torch_group_norm(c, groups, silu, x_dtype, out_dtype):
    x = _x((3, 5, 7, c), x_dtype, mean=0.5)
    w, b = _affine(c, x_dtype)
    got = norm.group_norm_plain(x, w, b, groups, 1e-6, out_dtype, silu=silu)
    want = F.group_norm(x.float().permute(0, 3, 1, 2), groups, w.float(), b.float(), 1e-6)
    want = want.permute(0, 2, 3, 1)
    want = (F.silu(want) if silu else want).to(out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    _close(got, want, out_dtype)


def test_group_norm_plain_holds_a_group_of_a_million_far_from_zero():
    """8 channels a group over 131072 pixels (the VAE's 512^2 groups hold
    about a million elements), the mean 300 standard deviations from zero:
    the fp32 statistics against float64's."""
    x = _x((1, 131072, 64), FP32, mean=3.0, std=0.01, seed=4)
    w, b = _affine(64, FP32)
    got = norm.group_norm_plain(x, w, b, 8, 1e-6, FP32)
    want = F.group_norm(x.double().permute(0, 2, 1), 8, w.double(), b.double(), 1e-6)
    torch.testing.assert_close(got.double(), want.permute(0, 2, 1), rtol=0, atol=2e-3)
    s, t = norm.group_scale_shift_plain(x, w, b, 8, 1e-6)
    torch.testing.assert_close((x.double() * s.double()[:, None] + t.double()[:, None]),
                               want.permute(0, 2, 1), rtol=0, atol=2e-3)


@pytest.mark.parametrize("c,groups", [(320, 32), (64, 8)])
def test_group_scale_shift_plain_is_the_group_norm(c, groups):
    x = _x((2, 4, 12, c), FP32, mean=-0.3)
    w, b = _affine(c, FP32)
    s, t = norm.group_scale_shift_plain(x, w, b, groups, 1e-5)
    assert s.shape == t.shape == (2, c) and s.dtype == t.dtype == FP32
    want = norm.group_norm_plain(x, w, b, groups, 1e-5, FP32)
    torch.testing.assert_close(x * s[:, None, None] + t[:, None, None], want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c", [4, 320, 768, 1024, 1280, 2048])
@pytest.mark.parametrize("x_dtype,out_dtype", [(FP32, FP32), (BF16, BF16), (BF16, FP32),
                                               (FP32, BF16)])
def test_layer_norm_plain_is_torch_layer_norm(c, x_dtype, out_dtype):
    x = _x((2, 9, c), x_dtype, mean=0.2)
    w, b = _affine(c, x_dtype)
    got = norm.layer_norm_plain(x, w, b, 1e-5, out_dtype)
    want = F.layer_norm(x.float(), (c,), w.float(), b.float(), 1e-5).to(out_dtype)
    assert got.dtype == out_dtype
    _close(got, want, out_dtype)


@pytest.mark.parametrize("helper", ["group_norm", "group_norm silu", "layer_norm"])
def test_model_helpers_round_once_to_the_callers_dtype(helper):
    """``layers.group_norm`` / ``layer_norm`` return the dtype asked for (x's
    by default), the fp32 result rounded once."""
    x = _x((2, 4, 4, 32), BF16)
    if helper == "layer_norm":
        mod = torch.nn.LayerNorm(32).to(BF16)
        call = layers.layer_norm
        want = F.layer_norm(x.float(), (32,), mod.weight.float(), mod.bias.float(), mod.eps)
    else:
        mod = torch.nn.GroupNorm(8, 32).to(BF16)
        silu = helper.endswith("silu")

        def call(x, mod, dtype=None):
            return layers.group_norm(x, mod, dtype, silu=silu)
        want = F.group_norm(x.float().permute(0, 3, 1, 2), 8, mod.weight.float(),
                            mod.bias.float(), mod.eps).permute(0, 2, 3, 1)
        want = F.silu(want) if silu else want
    assert call(x, mod).dtype == BF16
    _close(call(x, mod, FP32), want, FP32)
    _close(call(x, mod, BF16), want.to(BF16), BF16)


# ---------------------------------------------------------------------------
# launch plans at the routed shapes
# ---------------------------------------------------------------------------


def _norm_widths(arch):
    mods = build_modules(arch, BF16)
    gn = {(m.num_channels, m.num_groups) for mod in mods.values() for m in mod.modules()
          if isinstance(m, torch.nn.GroupNorm)}
    ln = {m.normalized_shape[0] for mod in mods.values() for m in mod.modules()
          if isinstance(m, torch.nn.LayerNorm)}
    return gn, ln


FULL_ARCHS = [a for a in ARCHS if not a.endswith("-tiny")]
# (images, pixels an image) of the UNets' spatial norms at 512^2 latents of
# 64x64 (and SDXL's 128x128 at 1024^2): batch rows x frames, 16/17 frames,
# rows 1-3, the CFG batches and the long video; the VAE at 512^2 and 1024^2
UNET_IMAGES = (1, 2, 3, 16, 17, 32, 34, 48, 51, 128, 384)
UNET_PIXELS = (16384, 4096, 1024, 256, 64, 16)
VAE_IMAGES = (1, 16, 17)
VAE_PIXELS = (1024 ** 2, 512 ** 2, 256 ** 2, 128 ** 2, 64 ** 2)


def _check_group_plan(plan, n, p, c, groups, sms):
    c8 = c // 8
    assert plan["threads"] % 32 == 0 and plan["threads"] <= norm.GN_MAX_THREADS
    assert plan["rows"] * c8 <= plan["threads"] < plan["rows"] * c8 + 32
    assert plan["split_rows"] % plan["rows"] == 0
    assert plan["splits"] * plan["split_rows"] >= p > (plan["splits"] - 1) * plan["split_rows"]
    assert plan["grid"] == (plan["splits"], n, 1)
    # the apply's own cut of the pixels: as fine as the statistics' or finer
    assert plan["apply_split_rows"] % plan["rows"] == 0
    assert (plan["apply_splits"] * plan["apply_split_rows"] >= p
            > (plan["apply_splits"] - 1) * plan["apply_split_rows"])
    assert plan["apply_splits"] >= plan["splits"]
    assert plan["smem_bytes"] == 4 * (2 * plan["rows"] * c + plan["rows"]
                                      + 2 * plan["rows"] * groups)
    assert plan["scratch_floats"] == n * groups * plan["splits"] * 3
    assert 2 * groups * 4 <= norm.GN_SMEM_LIMIT   # the apply's and finalize's shared memory
    _build.check_plan("group_norm", plan)


@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_norm_plans_fit_every_routed_shape(arch):
    """Every group norm of the configuration at every (images, pixels) its
    paths give (the VAE's widths at the VAE's sizes, bf16 and fp32), K4's
    statistics over a clip's frames, and every layer norm's width at the
    row counts of those paths: within the grid, thread and shared-memory
    limits, and the shapes the C side accepts (``group_plan_ok``)."""
    gn, ln = _norm_widths(arch)
    vae = {(m.num_channels, m.num_groups) for m in build_modules(arch, BF16)["vae"].modules()
           if isinstance(m, torch.nn.GroupNorm)}
    sms = _build.H100_SMS
    for c, groups in sorted(gn):
        shapes = [(n, p) for n in UNET_IMAGES for p in UNET_PIXELS]
        # i2vgen-xl's temporal transformers: a batch row's frames x pixels as one image
        shapes += [(b, frames * p) for b in (1, 2, 3) for frames in (16, 128)
                   for p in UNET_PIXELS]
        if (c, groups) in vae:
            shapes += [(n, p) for n in VAE_IMAGES for p in VAE_PIXELS]
        for n, p in shapes:
            for itemsize in (2, 4):
                _check_group_plan(norm.norm_plan(n, p, c, groups, itemsize, sms=sms), n, p, c,
                                  groups, sms)
        for b in (1, 2, 3):   # K4: a batch row's frames x pixels
            for frames in (16, 17, 128):
                for p in UNET_PIXELS:
                    plan = norm.norm_plan(b, frames * p, c, groups, stats_only=True, sms=sms)
                    _check_group_plan(plan, b, frames * p, c, groups, sms)
    for c in sorted(ln):
        for rows in (1, 77, 257, 2 * 77, 3 * 17 * 4096, 384 * 4096, 16 * 4096):
            plan = norm.layer_norm_plan(rows, c, sms)
            _build.check_plan("layer_norm", plan)
            assert plan["chunks"] * plan["lanes"] * plan["vec"] >= c
            assert plan["lanes"] in (1, 2, 4, 8, 16, 32) and plan["chunks"] in norm.LN_CHUNKS
            assert plan["smem_bytes"] <= norm.GN_SMEM_LIMIT


@pytest.mark.parametrize("c,groups,n,p,stats_only,splits", [
    (320, 32, 51, 4096, False, 21), (320, 32, 3, 4096, False, 76),
    (128, 32, 16, 512 ** 2, False, 66), (1280, 32, 51, 64, False, 5),
    (2560, 32, 34, 256, False, 32), (320, 32, 3, 17 * 4096, True, 88)])
def test_norm_plan_splits_follow_the_shape(c, groups, n, p, stats_only, splits):
    """As many splits an image as put eight blocks on each of 132 SMs (two
    for K4's statistics alone: one wave), at most 128 (256), and none that
    streams less than 32 KB; the last split's pixels as many as the others'
    or fewer (3 images of 4096: 76 splits of 54 pixels)."""
    assert norm.norm_plan(n, p, c, groups, stats_only=stats_only)["splits"] == splits


# i2vgen-xl's temporal transformer norms at 512^2: (level, pixels a frame, C)
CLIP_LEVELS = [("L0", 4096, 320), ("L1", 1024, 640), ("L2", 256, 1280), ("L3", 64, 1280)]


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("level,hw,c", CLIP_LEVELS, ids=[lv[0] for lv in CLIP_LEVELS])
def test_clip_norm_plan_fills_the_card_as_the_per_frame_one(b, level, hw, c):
    """A clip of 16 frames normalised as one image (N = b, P = 16 x H x W):
    the statistics keep at most ``MAX_SPLITS`` splits an image, and the
    apply's grid is as large as that of the same tensor cut per frame (N =
    16 b) to within 5 % (the rounding of a split to whole pixel slots), and
    no larger than the plan's aim of eight blocks an SM."""
    clip = norm.norm_plan(b, 16 * hw, c, 32)
    per_frame = norm.norm_plan(16 * b, hw, c, 32)
    assert clip["splits"] <= norm.MAX_SPLITS
    blocks = clip["apply_splits"] * b
    assert blocks >= 0.95 * per_frame["apply_splits"] * 16 * b
    assert blocks <= norm.GN_BLOCKS_PER_SM * _build.H100_SMS + b


@pytest.mark.parametrize("cuts,silu", [((2, 2), False), ((1, 3), True), ((5, 2, 9), False),
                                       ((3, 3, 3, 3), True)])
def test_group_norm_over_shares_is_the_whole_norm(cuts, silu):
    """x cut along its pixels into shares (of ``cuts`` x 16 pixels: unequal
    where the cuts differ, as Chan's merge allows), each share normalised
    with every share's partial moments (``gather``): the norm of the whole
    x. fp32, rtol and atol 1e-5 (the merge of a few shares' moments rounds
    as the whole tensor's two-pass variance does, about 1e-7); the shares'
    means lie apart, so a share's own norm misses by more than 0.1."""
    c, groups = 64, 8
    x = _x((3, 16 * sum(cuts), c), FP32, mean=0.4, seed=6)
    shares = list(torch.split(x, [16 * k for k in cuts], dim=1))
    shares = [s + i for i, s in enumerate(shares)]
    x = torch.cat(shares, dim=1)
    w, bias = _affine(c, FP32)
    parts = []
    for s in shares:
        norm.group_norm_plain(s, w, bias, groups, 1e-6, FP32, silu,
                              gather=lambda part: parts.append(part) or part)
    every = torch.cat(parts, dim=2)
    assert every.shape == (3, groups, len(cuts), 3)
    got = torch.cat([norm.group_norm_plain(s, w, bias, groups, 1e-6, FP32, silu,
                                           gather=lambda part: every) for s in shares], dim=1)
    want = norm.group_norm_plain(x, w, bias, groups, 1e-6, FP32, silu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    own = norm.group_norm_plain(shares[-1], w, bias, groups, 1e-6, FP32, silu)
    assert (own - want[:, -16 * cuts[-1]:]).abs().max() > 0.1


@pytest.mark.parametrize("shares", [1, 2, 4, 8])
def test_norm_plan_divides_the_statistics_among_shares(shares):
    """One rank's share of a clip (one of ``shares``: 32 of 128 frames at L0,
    batch 3): its statistics take at most ``MAX_SPLITS // shares`` splits, so
    that the apply merges no more partials of every rank's than of one whole
    image's; the apply's own cut is the unshared plan's."""
    n, p, c = 3, 32 * 4096, 320
    plan = norm.norm_plan(n, p, c, 32, shares=shares)
    assert plan["splits"] * shares <= norm.MAX_SPLITS
    assert plan["apply_splits"] == norm.norm_plan(n, p, c, 32)["apply_splits"]
    _check_group_plan(plan, n, p, c, 32, _build.H100_SMS)


@pytest.mark.parametrize("c,groups", [(12, 4), (320, 30), (8192, 32)])
def test_plans_refuse_widths_the_kernels_do_not_take(c, groups):
    with pytest.raises(ValueError):
        norm.norm_plan(2, 64, c, groups)
    if c % 4 or c > norm.MAX_CHANNELS:
        with pytest.raises(ValueError):
            norm.layer_norm_plan(64, c)


# ---------------------------------------------------------------------------
# the benchmark's KN family
# ---------------------------------------------------------------------------


def _families():
    from v2vbench import manifest

    return manifest.kernel_families()


def test_kn_family_wraps_every_norm_call_of_a_tiny_edit():
    """The entries in ``WRAP`` see every norm call of a tiny ConsistI2V
    encode, inversion, edit and decode: as many calls as the program opened
    ``layer.norm`` spans (group and layer norms) and ``layer.tconv`` spans
    (K4's statistics), and the wrapping leaves the outputs as they were."""
    from v2vbench.trace import Shapes

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe = build_consisti2v_pipeline("consisti2v-tiny", device="cpu", seed=3,
                                         dtype=FP32, components=("unet", "vae"))
        rng = np.random.RandomState(1)
        frames01 = rng.rand(3, 64, 64, 3).astype(np.float32)
        text = torch.from_numpy(rng.randn(1, 6, pipe.unet.config.cross_attention_dim)
                                .astype(np.float32))

        def run():
            latents = pipe.encode_video(frames01)
            traj, inv_ts = pipe.invert(latents, text, num_inversion_steps=2, traj_store="host",
                                       chunk_steps=2)
            ff = latents[:, :1]
            edited = pipe.sample_with_pnp(traj, inv_ts, torch.cat([text] * 3), ff, ff,
                                          num_inference_steps=2, t_idx=0)
            return pipe.decode_latents(edited)

        kn = _families()["kn"]
        assert set(kn.WRAP) == set(kn.ENTRIES)
        with torch.inference_mode():
            plain = run()
            with Shapes({"kn": kn}) as shapes, tracing() as tracer:
                wrapped = run()
        spans = [s.name for s in tracer.take()]
    finally:
        torch.set_num_threads(n_threads)
    norms, tconvs = spans.count("layer.norm"), spans.count("layer.tconv")
    assert norms > 0 and tconvs > 0
    assert shapes.calls["kn"] == norms + tconvs
    assert shapes.ideal["kn"] > 0
    assert norm.group_norm is not None and not hasattr(norm.group_norm, "__wrapped__")
    assert torch.equal(torch.as_tensor(np.asarray(plain)), torch.as_tensor(np.asarray(wrapped)))


def test_kn_cost_counts_bytes_by_hand():
    kn = _families()["kn"]

    def t(*shape, dtype=BF16):
        return torch.zeros(*shape, dtype=dtype, device="meta")

    x, w, b = t(51, 64, 64, 320), t(320), t(320)
    elems = 51 * 64 * 64 * 320
    assert kn.cost(x, w, b, 32, 1e-6, BF16, silu=True) == (0, 2 * elems + 2 * elems + 2 * 640)
    assert kn.cost(x, w, b, 32, 1e-6, FP32) == (0, 2 * elems + 4 * elems + 2 * 640)
    assert kn.cost(x, w, b, 1e-5, BF16) == (0, 4 * elems + 2 * 640)          # layer norm
    xf, wf = t(3, 17, 4096, 320, dtype=FP32), t(320, dtype=FP32)
    assert kn.cost(xf, wf, wf, 32, 1e-5) == (0, 4 * 3 * 17 * 4096 * 320 + 2 * 3 * 320 * 4
                                             + 2 * 320 * 4)                  # K4's s, t


def test_kn_patterns_match_the_norm_kernels_alone():
    """Every ``__global__`` of ``csrc/`` matches one family; the KN kernels
    match KN's patterns and no other family's, and PyTorch's own layer norm
    kernel matches none."""
    import re

    from v2vbench.trace import port_kernel_names

    fams = _families()
    pats = {n: re.compile("|".join(f.PATTERNS)) for n, f in fams.items()}
    names = port_kernel_names()
    kn_kernels = {n for n in names if n.startswith("kn_")}
    assert kn_kernels == {"kn_group_stats_kernel", "kn_group_apply_kernel",
                          "kn_group_finalize_kernel", "kn_layer_norm_kernel"}
    for name in names:
        assert len([f for f, p in pats.items() if p.search(name)]) == 1, name
    for name in kn_kernels:
        demangled = f"void (anonymous namespace)::{name}<__nv_bfloat16, __nv_bfloat16, 8>(int)"
        assert [f for f, p in pats.items() if p.search(demangled)] == ["kn"]
    assert not any(p.search("void at::native::(anonymous namespace)::"
                            "vectorized_layer_norm_kernel<float, float, false>(int)")
                   for p in pats.values())


def test_kn_family_loads_against_a_program_without_its_entries(monkeypatch):
    """Against a program older than the kernels (no ``anyv2v_torch.ops.norm``,
    or a module without the names) the family loads with an empty ``WRAP``;
    the harness's wrapping then wraps nothing and the roofline reads None."""
    import sys

    from v2vbench import manifest
    from v2vbench.trace import Shapes

    path = os.path.join(REPO, "v2vbench", "kernels", "kn.py")
    monkeypatch.setitem(sys.modules, "anyv2v_torch.ops.norm", None)
    kn = manifest.load_file(path, "v2vbench_kernel_kn_without_entries")
    assert kn.WRAP == ()
    assert kn.present((("anyv2v_torch.ops.temporal_conv", "no_such_entry"),)) == ()
    with Shapes({"kn": kn}) as shapes:
        pass
    assert shapes.calls == {"kn": 0}
