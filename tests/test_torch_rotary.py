"""KR, the partial rotary of ConsistI2V's and SEINE's temporal attention
(``anyv2v_torch/ops/rotary.py``, ``csrc/rotary.cu``), on the CPU.

The entry ``rotate_partial`` against the published formula the models used
before it, bit for bit (ConsistI2V's queries, its keys with the 8 augmented
keys at position 0, a rank's cross-attention queries at offset positions;
SEINE's per-head layout with fewer rotated channels than a head stores, and
seine-tiny's 4 of 8); its frequency table made once per (rot, device); KR's
launch plan at every shape the configurations route to it, and its refusal
of the layouts it does not take; and the benchmark's KR family: its ``WRAP``
sees every rotary call of a tiny ConsistI2V and SEINE forward, its byte
counts, its name pattern, and its loading against a program without the
entry. The kernel itself runs on the card only (``chip_smoke.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from anyv2v_torch.models import unet_seine, unet_videoldm
from anyv2v_torch.ops import _build, rotary
from anyv2v_torch.utils.model_zoo import build_consisti2v_pipeline, build_seine_pipeline
from anyv2v_torch.utils.profiling import tracing

BF16, FP32 = torch.bfloat16, torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (3 * torch.randn(*shape, generator=g)).to(dtype)


def _published(x, pos, rot, groups):
    """The formula the models applied before KR: ConsistI2V's angles
    ``[1, F, 1, rot]`` on ``[B, F, HW, inner]``, SEINE's ``[F, 1, 1, rot]``
    on ``[B, F, HW, heads, D]``, each from the numpy frequencies."""
    ang = rotary.rotary_angles(pos, rotary.rotary_freqs(rot))
    if groups == 1:
        return rotary.apply_rotary_partial(x, ang[None, :, None, :], rot)
    b, f, hw, c = x.shape
    xh = x.reshape(b, f, hw, groups, c // groups)
    return rotary.apply_rotary_partial(xh, ang[:, None, None, :], rot).reshape(x.shape)


F17 = torch.arange(17, dtype=FP32)
CASES = {
    # [B, F, HW, inner], rot inner / 2
    "consisti2v q": ((3, 17, 16, 64), F17, 32, 1),
    "consisti2v k, 8 augmented keys at 0": ((3, 25, 16, 64), torch.cat([F17, torch.zeros(8)]),
                                           32, 1),
    "consisti2v cross q, rank 2 of 4": ((2, 5, 8, 160), torch.cat([torch.zeros(1),
                                                                  1 + 8 + torch.arange(4.)]),
                                        80, 1),
    # [B, F, HW, heads * D]: 40 wide heads stored at 48, the first 32 rotated
    "seine heads": ((3, 16, 8, 2 * 48), torch.arange(16, dtype=FP32), 32, 2),
    "seine-tiny 4 of 8": ((3, 4, 8, 2 * 8), torch.arange(4, dtype=FP32), 4, 2),
}


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("case", list(CASES))
def test_rotate_partial_is_the_published_formula(case, dtype):
    shape, pos, rot, groups = CASES[case]
    x = _x(shape, dtype)
    before = rotary.rotate_partial.launches
    got = rotary.rotate_partial(x, pos, rot, groups)
    want = _published(x, pos, rot, groups)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)
    assert not torch.equal(got, x)
    assert rotary.rotate_partial.launches == before      # the CPU takes the plain version


def test_rotary_table_is_made_once_per_rot_and_device(monkeypatch):
    """A second call at the same (rot, device) returns the same table and
    reaches neither the numpy frequencies nor a host copy."""
    cpu = torch.device("cpu")
    table = rotary.rotary_table(32, cpu)
    assert rotary.rotary_table(32, cpu) is table
    assert table.dtype == FP32 and not table.is_inference()
    assert torch.equal(table, torch.as_tensor(rotary.rotary_freqs(32), dtype=FP32))
    assert rotary.rotary_table(16, cpu) is not table

    def no_host_copy(*args, **kwargs):
        raise AssertionError("the rotary's call path built or copied a table")

    x, pos = _x((2, 4, 8, 64), BF16), torch.arange(4, dtype=FP32)
    want = rotary.rotate_partial(x, pos, 32)
    monkeypatch.setattr(rotary, "rotary_freqs", no_host_copy)
    monkeypatch.setattr(rotary.torch, "as_tensor", no_host_copy)
    with torch.inference_mode():
        got = rotary.rotate_partial(x, pos, 32)
    assert torch.equal(got, want)


# every shape the configurations route to KR: ConsistI2V's q (17 rows), k
# (25) and cross q (17) at L0-L2 (HW 4096 / 1024 / 256, inner 320 / 640 /
# 1280) at the edit's batches 3 and 2 and the inversion's 1; SEINE's q and k
# (8 heads of 40 / 80 / 160, 32 rotated) at 16 frames; the tiny archs; a
# rank's 4 + 1 frames
ROUTED = ([((b, f, hw, c), c // 2, 1) for b in (1, 2, 3) for f in (17, 25)
           for hw, c in ((4096, 320), (1024, 640), (256, 1280))]
          + [((b, 16, hw, 8 * d), 32, 8) for b in (1, 2, 3)
             for hw, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))]
          + [((3, 9, 256, 16), 8, 1), ((3, 9, 64, 32), 16, 1), ((3, 8, 256, 16), 4, 2),
             ((3, 8, 64, 16), 8, 2), ((3, 5, 4096, 320), 160, 1)])
# and every case chip_smoke.py holds KR to on the card
CHIP_SMOKE = [pytest.param((s["b"], s["p"], s["hw"], s["c"]), s["rot"], s["groups"],
                           id=f"chip_smoke: {label}")
              for name, label, make, *_ in chip_smoke._kernel_cases()
              if name == "rotate_partial" for s in (make.shape,)]


@pytest.mark.parametrize("shape,rot,groups", ROUTED + CHIP_SMOKE)
def test_kr_plan_fits_every_routed_shape(shape, rot, groups):
    plan = rotary.rotary_plan(shape, rot, groups)
    _build.check_plan("rotate_partial", plan)
    blocks, p, r0 = plan["grid"]
    assert (p, r0) == (shape[1], shape[0])
    per_block = rotary.KR_THREADS * rotary.KR_VECS
    assert (blocks - 1) * per_block < plan["slab_vecs"] <= blocks * per_block
    assert plan["slab_vecs"] * rotary.VEC == int(np.prod(shape[2:]))
    assert plan["slab_vecs"] % plan["d_vecs"] == 0
    assert plan["pairs"] == rot // 2 <= 4 * plan["d_vecs"]


def _meta(*shape, dtype=BF16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape,rot,groups", [
    ((2, 4, 8, 20), 10, 1),        # a group's width not a multiple of 8
    ((2, 4, 8, 96), 16, 5),        # groups that do not divide the channels
    ((2, 4, 8, 64), 33, 1),
    ((2, 4, 8, 2 * 8), 16, 2),     # more rotated channels than a group holds
    ((8, 64), 32, 1),              # no position axis
    ((2, 4, 8, 4096), 4096, 1),    # a table larger than a block's shared memory
], ids=["width 20", "5 groups of 96", "odd rot", "rot past the group", "2-D", "rot 4096"])
def test_kr_refuses_layouts_it_does_not_take(shape, rot, groups):
    """A non-CPU tensor of a layout KR does not take raises before any
    launch, and never takes the plain version, which the CPU would run."""
    before = rotary.rotate_partial.launches
    with pytest.raises(ValueError, match="rotate_partial: "):
        rotary.rotate_partial(_meta(*shape), _meta(shape[1], dtype=FP32), rot, groups)
    with pytest.raises(ValueError, match="rotate_partial: "):
        rotary.rotary_plan(shape, rot, groups)
    assert rotary.rotate_partial.launches == before


# ---------------------------------------------------------------------------
# the benchmark's KR family
# ---------------------------------------------------------------------------


def _kr():
    from v2vbench import manifest

    return manifest.kernel_families()["kr"]


def _consisti2v_forward():
    pipe = build_consisti2v_pipeline("consisti2v-tiny", device="cpu", seed=3, dtype=FP32,
                                     components=("unet", "vae"))
    rng = np.random.RandomState(1)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(3, 4, 16, 16, 4), rng.randn(3, 6, 32), rng.randn(3, 1, 16, 16, 4))]
    temporal = sum(isinstance(m, unet_videoldm.VideoLDMTemporalTransformer)
                   for m in pipe.unet.modules())
    return (lambda: pipe.unet(args[0], 501, args[1], args[2], 3, pnp=(True, True, True),
                              pnp_chunks=3)), 3 * temporal


def _seine_forward():
    pipe = build_seine_pipeline("seine-tiny", device="cpu", seed=3, dtype=FP32,
                                components=("unet", "vae"))
    rng = np.random.RandomState(1)
    x, text = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(3, 4, 16, 16, 9), rng.randn(3, 6, 16)))
    blocks = sum(isinstance(m, unet_seine.SeineTransformerBlock) for m in pipe.unet.modules())
    return (lambda: pipe.unet(x, 501, text, pnp=(True, True, True, True))), 2 * blocks


@pytest.mark.parametrize("forward", [_consisti2v_forward, _seine_forward],
                         ids=["consisti2v-tiny", "seine-tiny"])
def test_kr_family_wraps_every_rotary_call_of_a_tiny_forward(forward):
    """The entry in ``WRAP`` sees every rotary call of a tiny UNet forward at
    the edit batch with every PnP flag on: 3 a ConsistI2V temporal
    transformer (as many as the program's ``layer.rotary`` spans), 2 a SEINE
    transformer block; the wrapping leaves the output as it was."""
    from v2vbench.trace import Shapes

    kr = _kr()
    assert kr.WRAP == kr.ENTRIES
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run, calls = forward()
        with torch.inference_mode():
            plain = run()
            with Shapes({"kr": kr}) as shapes, tracing() as tracer:
                wrapped = run()
        spans = [s.name for s in tracer.take()]
    finally:
        torch.set_num_threads(n_threads)
    assert calls > 0 and shapes.calls["kr"] == calls
    if forward is _consisti2v_forward:
        assert spans.count("layer.rotary") == calls
    assert shapes.ideal["kr"] > 0
    assert not hasattr(rotary.rotate_partial, "__wrapped__")
    assert torch.equal(plain, wrapped)


def test_kr_cost_counts_bytes_by_hand():
    x, pos = _meta(3, 25, 4096, 320), _meta(25, dtype=FP32)
    assert _kr().cost(x, pos, 160) == (0, 2 * 2 * 3 * 25 * 4096 * 320 + 4 * 25 + 4 * 80)
    xs = _meta(3, 16, 4096, 8 * 40)
    assert _kr().cost(xs, _meta(16, dtype=FP32), 32, 8) == (0, 4 * 3 * 16 * 4096 * 320
                                                           + 4 * 16 + 4 * 16)


def test_kr_pattern_matches_the_rotary_kernel_alone():
    """KR's pattern takes the rotary kernel, under its demangled name too,
    and no other ``__global__`` of ``csrc/``."""
    from v2vbench.trace import port_kernel_names

    pat = re.compile("|".join(_kr().PATTERNS))
    names = port_kernel_names()
    assert {n for n in names if pat.search(n)} == {"kr_rotary_kernel"}
    assert pat.search("(anonymous namespace)::kr_rotary_kernel(uint4 const*, float const*, "
                      "float const*, uint4*, int, int, int)")


def test_kr_family_loads_against_a_program_without_its_entry(monkeypatch):
    """Against a program older than KR (a rotary module without
    ``rotate_partial``) the family loads with an empty ``WRAP``; the
    harness's wrapping wraps nothing and the roofline reads None."""
    from v2vbench import manifest
    from v2vbench.trace import Shapes

    monkeypatch.delattr(rotary, "rotate_partial")
    kr = manifest.load_file(os.path.join(REPO, "v2vbench", "kernels", "kr.py"),
                            "v2vbench_kernel_kr_without_entry")
    assert kr.WRAP == ()
    with Shapes({"kr": kr}) as shapes:
        pass
    assert shapes.calls == {"kr": 0}
