"""The launch plans of K2 long and K5, checked on the CPU.

The CUDA kernels cannot run here, but the shared-memory and grid arithmetic
of their launches lives in Python (``frame_attention.long_plan``,
``flash_attention.flash_plan``) and is passed to the C entries, which refuse
a plan that does not match the shape. Every class each kernel takes must get
a plan that one H100 block can hold (at most 232,448 bytes of dynamic shared
memory) and a grid and block inside the launch limits.
"""

import pytest

from anyv2v_torch.ops import _build
from anyv2v_torch.ops import flash_attention as fl
from anyv2v_torch.ops import frame_attention as fr

SMEM = 232448
GRID_X, GRID_YZ = 2 ** 31 - 1, 65535


def _heads(dh):
    """Head counts of the configurations at this width, and a few others."""
    return {8: (64, 2, 3), 16: (64, 5), 32: (64, 4), 40: (8, 2, 3), 64: (8, 2, 5),
            80: (8, 2, 3), 160: (8, 1, 3)}[dh]


@pytest.mark.parametrize("dh", fr.LONG_HEAD_DIMS)
@pytest.mark.parametrize("s,sk", [(128, 144), (128, 128), (33, 33), (40, 47), (64, 80)])
def test_long_plan_fits_one_block(dh, s, sk):
    assert fr.takes_long(s, sk, dh)
    for heads in _heads(dh):
        for b, hw in ((3, 4096), (1, 37)):
            plan = fr.long_plan(b, s, sk, hw, heads, dh)
            hb = plan["heads_per_block"]
            assert heads % hb == 0 and hb * dh <= max(fr.LONG_GROUP_CHANNELS, dh)
            # whole 16-row tiles of Q, K and V, rows strided by an odd number
            # of 16-byte units
            ld = plan["row_stride"]
            assert ld >= hb * dh and (ld * 2 // 16) % 2 == 1
            rows = -(-s // 16) * 16 + 2 * (-(-sk // 16) * 16)
            assert plan["smem_bytes"] == rows * ld * 2 <= SMEM
            assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 32 * fr.LONG_MAX_WARPS
            assert plan["grid"] == (b * hw, heads // hb)
            assert plan["grid"][0] <= GRID_X and plan["grid"][1] <= GRID_YZ


def test_long_plan_of_the_128_frame_path():
    """i2vgen-xl at 128 frames: 64 heads of 8/16/32 and transformer_in's 8 of
    64 take 128 channels per block, two blocks' shared memory on one SM."""
    for heads, dh in ((64, 8), (64, 16), (64, 32), (8, 64)):
        plan = fr.long_plan(3, 128, 128, 4096, heads, dh)
        assert plan["heads_per_block"] * dh == 128 and plan["threads"] == 256
        assert 2 * plan["smem_bytes"] <= SMEM


@pytest.mark.parametrize("dh", fl.HEAD_DIMS)
def test_flash_plan_fits_one_block(dh):
    for b, sq, heads in ((51, 4096, 5), (3, 17 * 4096, 8), (48, 64, 8), (6, 1000, 3)):
        plan = fl.flash_plan(b, sq, heads, dh)
        assert plan["smem_bytes"] <= SMEM
        assert plan["threads"] == 384 and plan["stages"] in (2, 3)
        assert plan["grid"] == (-(-sq // 128), heads, b)
        assert plan["grid"][0] <= GRID_X and max(plan["grid"][1:]) <= GRID_YZ


def test_flash_plan_holds_its_tiles():
    """Q (the score depth padded to 16) and each stage of K and V, all as
    [128 rows, channels] bf16, plus the barriers: the depth pad appears at
    head widths 8 and 40 only."""
    for dh in fl.HEAD_DIMS:
        plan = fl.flash_plan(1, 128, 1, dh)
        dp = -(-dh // 16) * 16
        assert (dp == dh) == (dh not in (8, 40))
        tiles = 128 * dp * 2 + plan["stages"] * 128 * (dp + dh) * 2
        assert tiles < plan["smem_bytes"] <= tiles + (2 * plan["stages"] + 1) * 8 + 128


def test_plan_check_refuses_what_one_block_cannot_hold():
    """The wrappers' check: a plan past one block's shared memory or the grid
    limits raises instead of launching."""
    ok = {"smem_bytes": SMEM, "grid": (GRID_X, GRID_YZ, GRID_YZ)}
    _build.check_plan("k", ok)
    for bad in ({**ok, "smem_bytes": SMEM + 1}, {**ok, "grid": (GRID_X + 1, 1)},
                {**ok, "grid": (1, GRID_YZ + 1)}, {**ok, "grid": (1, 1, GRID_YZ + 1)}):
        with pytest.raises(ValueError, match="no launch"):
            _build.check_plan("k", bad)
