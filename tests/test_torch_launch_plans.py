"""The launch plans of K1, K2 (both routes), K3, K4 and K5, checked on the CPU.

The CUDA kernels cannot run here, but the shared-memory and grid arithmetic
of their launches lives in Python (``folded_attention.folded_plan``,
``frame_attention.frame_plan``, ``flash_attention.flash_plan``,
``ffn.ffn_plan``, ``temporal_conv.tconv_plan``) and is passed to the C
entries, which refuse a plan that does not match the shape. Every
class each kernel takes must get a plan that one H100 block can hold (at most
232,448 bytes of dynamic shared memory) and a grid and block inside the
launch limits. K1's and K2's plans are also checked at every K1 and K2 case
of ``chip_smoke.py`` (the shapes the card is held to), where the grid must
cover each (batch row, head group, query tile) or (batch row, pixel, head
group) exactly once; K3's and K4's persistent grids must take each (row
tile, column tile) of every chip_smoke case and of the tiny archs' shapes
exactly once, and so must K5's persistent walk over (query tile, head, batch
row) items at every K5 case and every shape the archs route to K5. The
operand modes take the same plans: K5 with a score bias (at every biased
chip_smoke case: no shared memory added, a bias shared by the batch read
from HBM once) and K3's GELU form (launch 1 over 128-column tiles of h).
"""

import itertools
import math

import pytest

import chip_smoke
from anyv2v_torch.ops import _build, ffn
from anyv2v_torch.ops import flash_attention as fl
from anyv2v_torch.ops import folded_attention as fa
from anyv2v_torch.ops import frame_attention as fr
from anyv2v_torch.ops import temporal_conv as tc
from test_torch_routes import _ARCH_FRAMES, _EDITORS, _editor_routes, _routes

SMEM = 232448
GRID_X, GRID_YZ = 2 ** 31 - 1, 65535


def _heads(dh):
    """Head counts of the configurations at this width, and a few others."""
    return {8: (64, 2, 3), 16: (64, 5), 32: (64, 4), 40: (8, 2, 3), 64: (8, 2, 5),
            80: (8, 2, 3), 160: (8, 1, 3)}[dh]


def _check_frame_plan(plan, b, s, sk, hw, heads, dh):
    """K2's plan (S <= 32): pixels per block, two blocks per SM."""
    assert s <= fr.MAX_FRAMES
    hb = plan["heads_per_block"]
    assert heads % hb == 0 and hb * dh <= max(fr.GROUP_CHANNELS, dh)
    # whole 16-row tiles of Q, K and V per pixel, rows strided by an odd
    # number of 16-byte units
    ld = plan["row_stride"]
    assert ld >= hb * dh and (ld * 2 // 16) % 2 == 1
    rows = -(-s // 16) * 16 + 2 * (-(-sk // 16) * 16)
    assert plan["pixel_bytes"] == rows * ld * 2
    pixels = plan["pixels_per_block"]
    assert 1 <= pixels <= b * hw
    assert plan["smem_bytes"] == pixels * plan["pixel_bytes"] <= SMEM
    if pixels > 1:   # pixels are added only while two blocks share one SM
        assert 2 * plan["smem_bytes"] <= SMEM
    # a block moves at least MIN_BLOCK_BYTES unless the pixels or the SM run out
    assert (plan["smem_bytes"] >= fr.MIN_BLOCK_BYTES or pixels == b * hw
            or 2 * (pixels + 1) * plan["pixel_bytes"] > SMEM)
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 32 * fr.MAX_WARPS
    assert plan["grid"] == (-(-b * hw // pixels), heads // hb)
    assert plan["grid"][0] <= GRID_X and plan["grid"][1] <= GRID_YZ


def _check_tma(dims, strides, boxes, inner=8):
    """A TMA map as the C entry encodes it: its innermost dimension
    ``inner`` bf16 (16 bytes, or a 128-byte-swizzled row of 64), global
    strides multiples of 16 bytes under 2^40, every box dimension 1..256."""
    assert dims[0] % inner == 0 and inner * 2 in (16, 128)
    assert all(x % 16 == 0 and 0 < x < 2 ** 40 for x in strides), strides
    for box in boxes:
        assert box[0] == inner and len(box) == len(dims)
        assert all(1 <= x <= 256 for x in box), box


# one field of a K2 long plan changed: each must be refused
_FRAME_LONG_EDITS = [
    ("heads_per_block", lambda v: v * 2), ("q_tiles", lambda v: 3 - v),
    ("key_rows", lambda v: 272 - v), ("stages", lambda v: 3 - v), ("items", lambda v: v + 1),
    ("threads", lambda v: v - 32), ("smem_bytes", lambda v: v + 16),
    ("grid", lambda v: (v[0] - 1 or 2,)), ("swizzle", lambda v: not v),
]


def check_frame_long_launch(b, s, sk, hw, heads, dh, sms=_build.H100_SMS):
    """K2 long's plan of one call, as the wrapper makes it: the shared bytes
    are the layout's and fit one block, the TMA boxes of the native layout
    are within the limits, the persistent walk takes each (batch row, pixel,
    head group) exactly once and its units every head and query frame, and
    a plan with any field changed is refused."""
    assert fr.takes_long(s, sk, dh)
    plan = fr.frame_plan(b, s, sk, hw, heads, dh, sms=sms)
    assert plan == fr.frame_long_plan(b, s, sk, hw, heads, dh, sms=sms)
    _build.check_plan("frame_attention_long", plan)
    hb, qt, kr, st = (plan[x] for x in ("heads_per_block", "q_tiles", "key_rows", "stages"))
    assert heads % hb == 0 and hb * dh <= max(fr.GROUP_CHANNELS, dh)
    assert hb == max(d for d in range(1, heads + 1)
                     if heads % d == 0 and d * dh <= max(fr.GROUP_CHANNELS, dh))
    assert qt == (2 if s > 64 else 1) and 64 * qt >= s and kr == (128 if sk <= 128 else 144)
    nwg = 2   # consumer warpgroups
    assert kr >= sk and plan["threads"] == fr.LONG_THREADS == 128 * nwg + 32
    g = hb * dh
    assert plan["smem_bytes"] == fr.frame_long_layout_bytes(g, qt, kr, st) <= SMEM
    assert st == 2 or fr.frame_long_layout_bytes(g, qt, kr, 2) > SMEM
    c = heads * dh
    assert plan["swizzle"] == (64 % dh == 0 and g % 64 == 0)
    if plan["swizzle"]:   # 64-channel slabs of 128-byte rows
        _check_tma([64, s, hw, b], [hw * c * 2, c * 2, s * hw * c * 2], [[64, 64 * qt, 1, 1]],
                   inner=64)
        _check_tma([64, sk, hw, b], [hw * c * 2, c * 2, sk * hw * c * 2], [[64, kr, 1, 1]],
                   inner=64)
    else:
        _check_tma([8, s, c // 8, hw, b], [hw * c * 2, 16, c * 2, s * hw * c * 2],
                   [[8, 64 * qt, g // 8, 1, 1]])
        _check_tma([8, sk, c // 8, hw, b], [hw * c * 2, 16, c * 2, sk * hw * c * 2],
                   [[8, kr, g // 8, 1, 1]])
    # the walk: block x takes items x, x + grid, ...; item it is head group
    # it % ng of pixel it // ng; its units (u = wg + nwg i < q_tiles * hb)
    # take query tile u % q_tiles of head u // q_tiles
    ng, items, grid = heads // hb, plan["items"], plan["grid"][0]
    assert items == b * hw * ng and grid == max(1, min(items, sms)) <= GRID_X
    taken = {}
    for x in range(grid):
        for it in range(x, items, grid):
            taken[(it // ng, it % ng)] = taken.get((it // ng, it % ng), 0) + 1
    assert len(taken) == items and set(taken.values()) == {1}
    units = sorted((u % qt, u // qt) for wg in range(nwg) for u in range(wg, qt * hb, nwg))
    assert units == sorted(itertools.product(range(qt), range(hb)))
    for key, edit in _FRAME_LONG_EDITS:
        with pytest.raises(ValueError, match="no launch"):
            _build.check_plan("frame_attention_long", {**plan, key: edit(plan[key])})
    return plan


@pytest.mark.parametrize("dh", fr.HEAD_DIMS)
@pytest.mark.parametrize("s,sk", [(128, 144), (128, 128), (33, 33), (40, 47), (64, 80)])
def test_long_plan_fits_one_block(dh, s, sk):
    for heads in _heads(dh):
        for b, hw in ((3, 4096), (1, 37)):
            check_frame_long_launch(b, s, sk, hw, heads, dh)


@pytest.mark.parametrize("dh", fr.HEAD_DIMS)
@pytest.mark.parametrize("s,sk", [(16, 16), (17, 25), (32, 48), (1, 1), (7, 13), (8, 8)])
def test_short_plan_fits_one_block(dh, s, sk):
    """S <= 32 on the mma.sync body: several pixels per block, two blocks per SM."""
    assert fr.takes(s, sk, dh)
    for heads in _heads(dh):
        for b, hw in ((3, 4096), (2, 37), (1, 1)):
            _check_frame_plan(fr.frame_plan(b, s, sk, hw, heads, dh), b, s, sk, hw, heads, dh)


def test_long_plan_of_the_128_frame_path():
    """i2vgen-xl at 128 frames: 64 heads of 8/16/32 and transformer_in's 8 of
    64 take 128 channels an item, two 64-frame query tiles, keys in one tile
    of 128, two item stages (the next pixel in flight), one block per SM."""
    for heads, dh in ((64, 8), (64, 16), (64, 32), (8, 64)):
        plan = fr.frame_plan(3, 128, 128, 4096, heads, dh)
        assert plan["heads_per_block"] * dh == 128 and plan["threads"] == 288
        assert plan["q_tiles"] == 2 and plan["key_rows"] == 128 and plan["stages"] == 2
        assert plan["grid"] == (_build.H100_SMS,) and plan["items"] == 3 * 4096 * heads * dh // 128


def test_short_plan_of_the_16_frame_path():
    """i2vgen-xl at 16 frames: one pixel of 128 channels is 13 KB, so a block
    takes two (26 KB), and the L0 call has 2048 blocks of 8 warps."""
    plan = fr.frame_plan(1, 16, 16, 4096, 64, 8)
    assert plan["pixel_bytes"] == 48 * 136 * 2 and plan["pixels_per_block"] == 2
    assert plan["grid"] == (2048, 4) and plan["threads"] == 256


def _flash_items(plan, b, sq, heads):
    """The (batch row, head, query tile) of every item that each block of a
    K5 plan walks, in ``csrc/flash_attention.cu``'s order (``walk_of``,
    ``item_of``; the short body's item covers a head group, walked in
    contiguous runs, query tile fastest, then group, then batch row):
    {(batch row, head, query tile): times taken}."""
    tr, grid, items = plan["tile_rows"], plan["grid"][0], plan["items"]
    qtiles = -(-sq // tr)
    taken = {}
    for x in range(grid):
        walk = (range(x * items // grid, (x + 1) * items // grid)
                if plan["resident"] else range(x, items, grid))
        for it in walk:
            if plan["body"] == "short":
                g, groups = plan["head_group"], -(-heads // plan["head_group"])
                row, grp, qt = (it // qtiles) // groups, (it // qtiles) % groups, it % qtiles
                keys = [(row, h, qt) for h in range(grp * g, min(heads, (grp + 1) * g))]
            elif plan["order"] == "batch":
                keys = [(it % b, (it // b) // qtiles, (it // b) % qtiles)]
            else:
                keys = [((it // qtiles) // heads, (it // qtiles) % heads, it % qtiles)]
            for key in keys:
                taken[key] = taken.get(key, 0) + 1
    return taken


# one field of a K5 plan changed: each must be refused (the fields a body has)
_FLASH_PLAN_EDITS = [
    ("tile_rows", lambda v: 192 - v), ("threads", lambda v: v + 128),
    ("q_stages", lambda v: v + 1), ("kv_stages", lambda v: v - 1),
    ("resident", lambda v: not v), ("order", lambda v: "batch" if v == "query" else "query"),
    ("items", lambda v: v + 1), ("grid", lambda v: (v[0] - 1 or 2,)),
    ("smem_bytes", lambda v: v + 16), ("bias_bytes_read", lambda v: v + 4),
    ("body", lambda v: "tiles" if v == "short" else "short"),
    ("store", lambda v: "tma" if v == "plain" else "plain"), ("key_tile", lambda v: v - 16),
    ("head_group", lambda v: v + 1), ("q_slots", lambda v: v - 1), ("q_chunks", lambda v: v + 1),
]


def _short_expected(b, sq, heads, dh, sk, sk2, bias, sms=_build.H100_SMS):
    """Whether the short body should take a call: unbiased, at most 80 keys,
    no context, a model's head width, and a head group of whole 64-channel
    chunks (or every head) whose K, V and a Q ring of an item for each
    consumer warpgroup fit and whose items give every consumer warpgroup of
    every block one."""
    if bias is not None or sk2 or not 0 < sk <= fl.SHORT_MAX_KEYS or dh not in fl.SHORT_HEAD_DIMS:
        return False
    unit = math.lcm(dh, 64) // dh
    for g in range(unit, unit * max(1, 320 // (unit * dh)) + 1, unit):
        g = min(g, heads)
        chunks = -(-g * dh // 64)
        if (fl.flash_short_bytes(-(-sk // 16) * 16, chunks, fl.SHORT_WGS * chunks) <= SMEM
                and -(-sq // 64) * -(-heads // g) * b >= fl.SHORT_WGS * sms):
            return True
    return False


def _check_short_plan(plan, b, sq, heads, dh, sk, sms):
    g, chunks, slots = plan["head_group"], plan["q_chunks"], plan["q_slots"]
    assert plan["store"] == "plain" and plan["tile_rows"] == fl.SHORT_ROWS
    assert plan["threads"] == 128 * (fl.SHORT_WGS + 1) and plan["resident"]
    assert plan["order"] == "query"
    assert plan["key_tile"] == -(-sk // 16) * 16 and plan["key_tile"] in fl.KEY_TILES
    assert 1 <= g <= heads and ((g * dh) % 64 == 0 or g == heads) and g * dh <= 320
    assert chunks == -(-g * dh // 64) and fl.SHORT_WGS * chunks <= slots <= fl.SHORT_SLOTS
    assert plan["items"] == -(-sq // 64) * -(-heads // g) * b
    assert plan["smem_bytes"] == fl.flash_short_bytes(plan["key_tile"], chunks, slots) <= SMEM
    # the largest slot count that fits; items for every warpgroup, two where
    # a group of whole chunks gives two
    assert slots == fl.SHORT_SLOTS or fl.flash_short_bytes(plan["key_tile"], chunks,
                                                            slots + 1) > SMEM
    assert plan["items"] >= fl.SHORT_WGS * sms
    unit = math.lcm(dh, 64) // dh
    if plan["items"] < 2 * fl.SHORT_WGS * sms:
        assert g == unit or g == heads or all(
            -(-sq // 64) * -(-heads // w) * b < 2 * fl.SHORT_WGS * sms
            for w in range(unit, g, unit))


def check_flash_walk(b, sq, heads, dh, sk, sk2=0, bias=None, sms=_build.H100_SMS):
    """K5's plan of one call, as the wrapper makes it: the persistent walk
    takes each (batch row, head, query tile) exactly once on at most one
    block per SM; the short body exactly where it should take the call (its
    own checks below); K/V is resident only where the whole key axis is one
    tile; 64-row items only where 128-row items would leave the card under
    one wave (or do not fit beside two K/V stages); the shared bytes are this
    layout's and one block can hold them; a bias shared by the batch comes
    from HBM once; a plan with any field changed is refused."""
    assert dh in fl.HEAD_DIMS
    plan = fl.flash_plan(b, sq, heads, dh, bias, sk, sk2=sk2, sms=sms)
    _build.check_plan("flash_attention", plan)
    tr, items = plan["tile_rows"], plan["items"]
    assert plan["grid"] == (min(items, sms),)
    taken = _flash_items(plan, b, sq, heads)
    assert len(taken) == -(-sq // tr) * heads * b and set(taken.values()) == {1}
    assert (plan["body"] == "short") == _short_expected(b, sq, heads, dh, sk, sk2, bias, sms)
    for key, edit in _FLASH_PLAN_EDITS:
        if key in plan:
            with pytest.raises(ValueError, match="no launch"):
                _build.check_plan("flash_attention", {**plan, key: edit(plan[key])})
    if plan["body"] == "short":
        _check_short_plan(plan, b, sq, heads, dh, sk, sms)
        return plan
    assert plan["store"] == "tma" and plan["key_tile"] == 128 and plan["head_group"] == 1
    assert tr in fl.TILE_ROWS and plan["threads"] == 128 * (tr // 64) + 32
    assert items == -(-sq // tr) * heads * b
    one_tile = 0 < sk <= fl.BLOCK_KEYS and sk2 == 0
    assert plan["resident"] == one_tile
    fits_128 = fl.flash_layout_bytes(dh, 128, 2, 1 if one_tile else 2) <= SMEM
    assert (tr == 64) == (-(-sq // 128) * heads * b < sms or not fits_128)
    qs, kvs = plan["q_stages"], plan["kv_stages"]
    assert 2 <= qs <= fl.MAX_STAGES and 1 <= kvs <= fl.MAX_STAGES and (kvs >= 2 or one_tile)
    assert plan["smem_bytes"] == fl.flash_layout_bytes(dh, tr, qs, kvs) <= SMEM
    assert plan["order"] == ("batch" if bias == "shared" and not one_tile else "query")
    if bias == "shared":
        assert plan["bias_bytes_read"] == heads * sq * sk * 4
    elif bias == "batch":
        assert plan["bias_bytes_read"] == b * heads * sq * sk * 4
    return plan


@pytest.mark.parametrize("dh", fl.HEAD_DIMS)
def test_flash_plan_fits_one_block(dh):
    """Every width at long and short key axes, self and split-KV, each with
    the walk and the layout checked."""
    for b, sq, heads, sk, sk2 in ((51, 4096, 5, 4096, 4096), (3, 17 * 4096, 8, 77, 0),
                                  (48, 64, 8, 64, 0), (6, 1000, 3, 999, 77), (2, 300, 2, 4, 0),
                                  (1, 16, 12, 273, 0)):
        plan = check_flash_walk(b, sq, heads, dh, sk, sk2)
        assert plan["grid"][0] <= GRID_X


def _chip_smoke_cases(*names):
    return [pytest.param(getattr(make, "shape", None), id=f"{name}: {label}")
            for name, label, make, *_ in chip_smoke._kernel_cases() if name in names]


@pytest.mark.parametrize("shape", [
    p for p in _chip_smoke_cases("flash_attention") if p.values[0] is not None])
def test_flash_plan_covers_each_chip_smoke_case(shape):
    """Each (query tile, head, batch row) of every K5 case (the split-KV
    ones with their context, the first-frame editors': 3 rows of 64 queries
    at dh 160, 4 keys, 16 queries) is walked exactly once, by a plan one
    H100 block can hold."""
    b, sq, sk, heads, dh = (shape[x] for x in ("b", "sq", "sk", "heads", "dh"))
    plan = check_flash_walk(b, sq, heads, dh, sk, shape.get("sk2", 0))
    assert plan["bias"] is None and plan["bias_bytes_read"] == 0


@pytest.mark.parametrize("shape", _chip_smoke_cases("flash_attention_bias"))
def test_flash_bias_plan_covers_each_chip_smoke_case(shape):
    """K5 with a bias: the tiles body, at the unbiased plan's tile, rings and
    shared bytes where that plan takes the tiles body too (each consumer
    thread reads its scores' bias from global memory), with the batch row
    fastest where a bias is shared and K/V not resident, so that the shared
    bias comes from HBM once; a per-row bias is read once."""
    b, sq, sk, heads, dh, form = (shape[x] for x in ("b", "sq", "sk", "heads", "dh", "bias"))
    assert form in ("shared", "batch")
    plan = check_flash_walk(b, sq, heads, dh, sk, bias=form)
    plain = fl.flash_plan(b, sq, heads, dh, None, sk)
    assert plan["body"] == "tiles" and plan["bias"] == form
    if plain["body"] == "tiles":
        for key in ("tile_rows", "q_stages", "kv_stages", "resident", "smem_bytes", "grid"):
            assert plan[key] == plain[key]


@pytest.mark.parametrize("dh", fl.SHORT_HEAD_DIMS)
@pytest.mark.parametrize("sk", [1, 4, 16, 17, 32, 33, 77, 80, 81, 112, 113, 128, 129])
def test_flash_short_body_at_its_key_widths(sk, dh):
    """The short body's key width is Sk rounded up to 16 (the score product's
    N, the softmax's width and P.V's depth), one instance per width of
    ``KEY_TILES``; past 128 keys, or where no head group fits beside a Q ring
    of an item for each consumer warpgroup (heads of 40 past 80 keys, of 160
    past 96), the tiles body takes the call (``check_flash_walk`` holds the
    rule); every plan walked and checked."""
    for b, sq, heads in ((3, 17 * 1024, 8), (13, 4100, 5), (13, 4100, 3)):
        plan = check_flash_walk(b, sq, heads, dh, sk)
        if sk > 128:
            assert plan["body"] == "tiles"
        elif sk <= 80 or plan["body"] == "short":
            assert plan["body"] == "short" and plan["key_tile"] == -(-sk // 16) * 16


@pytest.mark.parametrize("heads,dh,group", [
    (8, 40, 8), (3, 40, 3), (12, 40, 8), (8, 80, 4), (6, 80, 4), (8, 160, 2), (3, 160, 2),
    (5, 64, 5), (7, 64, 5), (20, 64, 5), (1, 64, 1)])
def test_flash_short_head_groups(heads, dh, group):
    """A head group is the most heads whose channels make whole 64-channel
    chunks, up to 320 channels (8 of 40, 4 of 80, 2 of 160, 5 of 64), or
    every head where there are fewer; the last group may be ragged. Where
    the items would not give every warpgroup of every block two (then one),
    the group shrinks, and below its fewest heads the tiles body takes the
    call."""
    plan = check_flash_walk(13, 4100, heads, dh, 77)
    assert plan["body"] == "short" and plan["head_group"] == group
    assert plan["q_chunks"] == -(-group * dh // 64)
    # the editors' calls: SDXL's L2 cross-attention and the IP adapter's take
    # one head an item; SD1.5's L0 cross-attention (8 heads of 40 an item,
    # 192 items) and its mid block's self-attention (24 items) the tiles body
    assert check_flash_walk(3, 1024, 20, 64, 77)["head_group"] == 1
    assert check_flash_walk(2, 1024, 20, 64, 4)["head_group"] == 1
    assert check_flash_walk(3, 4096, 8, 40, 77)["body"] == "tiles"
    assert check_flash_walk(3, 64, 8, 160, 64)["body"] == "tiles"


@pytest.mark.parametrize("arch,frames", _ARCH_FRAMES)
def test_flash_plan_walks_each_routed_shape(monkeypatch, arch, frames):
    """Every K5 call of a video forward (batch 3, every PnP flag on, shapes
    only on the ``meta`` device): ConsistI2V's split-KV self-attention with
    its context, its spatial and temporal cross-attention, SEINE's spatial
    self- and cross-attention; i2vgen-tiny's narrow heads."""
    seen = _routes(monkeypatch, arch, frames)
    calls = seen.get("flash_attention", set())
    ctx = {(q, k, h): (sk2, f) for q, k, h, sk2, f in seen.get("flash_attention_context", ())}
    assert (calls or arch.startswith("i2vgen")) and bool(ctx) == arch.startswith("consisti2v")
    for q, k, heads in calls:
        (b, sq, c), sk = q, k[1]
        sk2, f = ctx.get((q, k, heads), (0, 1))
        assert b % f == 0
        check_flash_walk(b, sq, heads, c // heads, sk, sk2)


@pytest.mark.parametrize("arch,size,batch", _EDITORS)
def test_flash_plan_walks_each_routed_editor_shape(monkeypatch, arch, size, batch):
    """Every K5 call of the first-frame editors at full and tiny width (the
    UNets, InstantStyle's ControlNet, IP attention and resampler)."""
    seen, _ = _editor_routes(monkeypatch, arch, size, batch)
    assert "flash_attention_context" not in seen
    for (b, sq, c), k, heads in seen.get("flash_attention", ()):
        check_flash_walk(b, sq, heads, c // heads, k[1])


def test_flash_plan_refuses_an_unknown_bias_form():
    with pytest.raises(ValueError, match="bias"):
        fl.flash_plan(2, 128, 2, 64, "rows", 128)


def test_flash_plan_holds_its_tiles():
    """The Q ring (the score depth padded to 16), the K and V ring of
    128-key tiles, the output's staging and the barriers: the depth pad
    appears at the odd multiples of 8 only (8, 24, 40, ...); a plan with
    unknown key lengths is never resident."""
    for dh in fl.HEAD_DIMS:
        for b, sq in ((1, 128), (64, 4096)):
            plan = fl.flash_plan(b, sq, 1, dh)
            tr, qs, kvs = plan["tile_rows"], plan["q_stages"], plan["kv_stages"]
            dp = -(-dh // 16) * 16
            assert (dp == dh) == (dh % 16 == 0) and not plan["resident"]
            tiles = qs * tr * dp * 2 + kvs * 128 * (dp + dh) * 2 + tr * dh * 2
            assert tiles < plan["smem_bytes"] <= tiles + fl.BARRIER_BYTES + fl.ALIGN_SLACK
            assert (tr == 64) == (b == 1 or dh == 160)


def test_plan_check_refuses_what_one_block_cannot_hold():
    """The wrappers' check: a plan past one block's shared memory or the grid
    limits raises instead of launching."""
    ok = {"smem_bytes": SMEM, "grid": (GRID_X, GRID_YZ, GRID_YZ)}
    _build.check_plan("k", ok)
    for bad in ({**ok, "smem_bytes": SMEM + 1}, {**ok, "grid": (GRID_X + 1, 1)},
                {**ok, "grid": (1, GRID_YZ + 1)}, {**ok, "grid": (1, 1, GRID_YZ + 1)}):
        with pytest.raises(ValueError, match="no launch"):
            _build.check_plan("k", bad)


def _check_short_folded_plan(plan, b, sq, sk, heads, dh):
    """K1's short-query plan (the mma.sync body, Sq <= 32)."""
    hb, rows, qt = plan["heads_per_block"], plan["rows_per_block"], plan["q_tiles"]
    assert heads % hb == 0 and hb * dh <= fa.GROUP_CHANNELS
    assert rows == 1 or (hb == heads and rows * hb * dh <= fa.GROUP_CHANNELS and rows <= b)
    width = rows * hb * dh
    ld = plan["row_stride"]
    assert ld >= width and (ld * 2 // 16) % 2 == 1
    # every (head, 16 queries) item of the block has a warp slot, and a block
    # with few items still takes one warp per item, up to MAX_WARPS
    per_warp = 64 // dh
    assert 1 <= plan["warps"] <= fa.MAX_WARPS and plan["warps"] * per_warp >= rows * hb * qt
    assert plan["warps"] == min(fa.MAX_WARPS, rows * hb * qt)
    assert plan["key_rows"] == min(fa.KEY_TILE, -(-sk // 16) * 16)
    smem = (16 * qt + fa.STAGES * 2 * plan["key_rows"]) * ld * 2
    assert plan["smem_bytes"] == smem
    assert 2 * smem <= SMEM   # two blocks share one SM
    n_q = -(-sq // (16 * qt))
    assert plan["grid"] == (n_q * -(-b // rows), heads // hb)
    assert plan["grid"][0] <= GRID_X and plan["grid"][1] <= GRID_YZ
    seen = {}
    for x, y in itertools.product(range(plan["grid"][0]), range(plan["grid"][1])):
        b0, q0 = (x // n_q) * rows, (x % n_q) * qt
        for r, h, t in itertools.product(range(rows), range(hb), range(qt)):
            if b0 + r < b and (q0 + t) * 16 < sq:
                key = (b0 + r, y * hb + h, q0 + t)
                seen[key] = seen.get(key, 0) + 1
    assert len(seen) == b * heads * -(-sq // 16) and set(seen.values()) == {1}


# one field of a K1 plan changed: each must be refused
_FOLDED_EDITS = {
    "hopper": [("body", lambda v: "short"), ("heads_per_block", lambda v: v * 2),
               ("q_tiles", lambda v: 1 if v > 1 else 2), ("units", lambda v: v + 1),
               ("q_stages", lambda v: v + 1), ("kv_stages", lambda v: v - 1),
               ("ntiles", lambda v: v + 1), ("items", lambda v: v + 1),
               ("threads", lambda v: v - 32), ("smem_bytes", lambda v: v + 16),
               ("grid", lambda v: (v[0] - 1 or 2,)), ("warpgroups", lambda v: v + 1),
               ("layout", lambda v: next(n for n in fa.LAYOUTS if n != v)),
               ("consumer_regs", lambda v: (v or 168) + 8)],
    "short": [("body", lambda v: "hopper"), ("heads_per_block", lambda v: v * 2),
              ("rows_per_block", lambda v: v + 1), ("q_tiles", lambda v: v + 1),
              ("warps", lambda v: v - 1), ("key_rows", lambda v: v + 16),
              ("smem_bytes", lambda v: v + 16), ("grid", lambda v: (v[0] + 1, v[1]))],
}


def _check_register_budget(plan):
    """One Hopper-body block's registers fit the SM's 65536: with a producer
    warpgroup, its count and each consumer warpgroup's after setmaxnreg, each
    a multiple of 8 in [24, 256], 128 threads apiece; with a producer warp (no
    setmaxnreg), the count ptxas gives every thread (a sub-partition's 16384
    over its warps, down to a multiple of 8: 168 at 288 threads)."""
    nwg, threads = plan["warpgroups"], plan["threads"]
    producer, consumer = plan["producer_regs"], plan["consumer_regs"]
    if producer is None:
        assert consumer is None and threads == 128 * nwg + 32
        per_thread = min(255, 16384 // (32 * -(-(threads // 32) // 4))) // 8 * 8
        assert per_thread == 168 and threads * per_thread <= 65536
        return
    assert threads == 128 * (nwg + 1)
    for count in (producer, consumer):
        assert count % 8 == 0 and 24 <= count <= 256
    assert producer < consumer and (producer + consumer * nwg) * 128 <= 65536


def check_folded_launch(b, sq, sk, heads, dh, sms=_build.H100_SMS):
    """K1's plan of one call, as the wrapper makes it: the body its class
    takes (the short body up to 32 queries, and up to ``SHORT_MAX_KEYS`` keys
    where its grid has a block for every SM; else the Hopper body); the
    shared bytes are the layout's and fit one block; the TMA boxes are
    within the limits; the persistent walk and the warpgroups' units take
    each (batch row, head, 64-row query tile) exactly once, within the
    registers' units; a plan with any field changed is refused."""
    assert dh in fa.HEAD_DIMS
    plan = fa.folded_plan(b, sq, sk, heads, dh, sms=sms)
    _build.check_plan("folded_attention", plan)
    short_grid = fa._short_plan(b, sq, sk, heads, dh)["grid"]
    short = sq <= fa.SHORT_MAX_QUERIES or (sk <= fa.SHORT_MAX_KEYS
                                           and short_grid[0] * short_grid[1] >= sms)
    assert plan["body"] == ("short" if short else "hopper")
    for key, edit in _FOLDED_EDITS[plan["body"]]:
        with pytest.raises(ValueError, match="no launch"):
            _build.check_plan("folded_attention", {**plan, key: edit(plan[key])})
    if plan["body"] == "short":
        _check_short_folded_plan(plan, b, sq, sk, heads, dh)
        return plan
    hb, qt, units = plan["heads_per_block"], plan["q_tiles"], plan["units"]
    lay = fa.LAYOUTS[plan["layout"]]
    nwg = lay["warpgroups"]
    wg3_items = fa._hopper_plan(b, sq, sk, heads, dh, sms, "wg3")["items"]
    pad = -(-sq // 192) * 192 / (-(-sq // 128) * 128)
    assert plan["layout"] == ("wg3" if dh == 8 and wg3_items >= fa.WG3_MIN_WAVES * sms
                              and pad <= fa.WG3_MAX_PAD else "warp2")
    assert plan["warpgroups"] == nwg
    assert plan["threads"] == 128 * nwg + lay["producer_threads"]
    assert (plan["producer_regs"], plan["consumer_regs"]) == (lay["producer_regs"],
                                                               lay["consumer_regs"])
    _check_register_budget(plan)
    assert qt == (nwg if sq > 64 else 1) and heads % hb == 0 and hb * dh <= fa.GROUP_CHANNELS
    assert units == -(-qt * hb // nwg) <= fa.UNITS[dh]
    assert hb == max(d for d in range(1, heads + 1) if heads % d == 0
                     and d <= fa.UNITS[dh] * (nwg // qt) and d * dh <= fa.GROUP_CHANNELS)
    assert plan["ntiles"] == -(-sk // fa.BLOCK_KEYS)
    kvs = plan["kv_stages"]
    staged = nwg * units if lay["staged"] else 0
    assert 2 <= kvs <= fa.KV_STAGES and (kvs == fa.KV_STAGES or fa.folded_layout_bytes(
        dh, hb, qt, staged, plan["q_stages"], kvs + 1) > SMEM)
    assert plan["smem_bytes"] == fa.folded_layout_bytes(
        dh, hb, qt, staged, plan["q_stages"], plan["kv_stages"]) <= SMEM
    c, g = heads * dh, hb * dh
    _check_tma([8, sq, c // 8, b], [c * 2, 16, sq * c * 2],
               [[8, 64 * qt, g // 8, 1]] + ([[8, 64, dh // 8, 1]] if lay["staged"] else []))
    _check_tma([8, sk, c // 8, b], [c * 2, 16, sk * c * 2], [[8, fa.BLOCK_KEYS, g // 8, 1]])
    # the walk (csrc item_of): block x takes items x, x + grid, ...; item it
    # is query pair it % nqp of head group (it // nqp) % ng of batch row
    # (it // nqp) // ng; warpgroup wg's units u = wg + nwg i (i < units) are
    # kept where u < q_tiles * hb: query tile u % q_tiles of head u // q_tiles
    ng, nqp = heads // hb, -(-sq // (64 * qt))
    items, grid = plan["items"], plan["grid"][0]
    assert items == b * ng * nqp and grid == max(1, min(items, sms)) <= GRID_X
    taken = {}
    for x in range(grid):
        for it in range(x, items, grid):
            r = it // nqp
            bb, hg, tile0 = r // ng, r % ng, (it % nqp) * qt
            for wg, i in itertools.product(range(nwg), range(units)):
                u = wg + nwg * i
                if u < qt * hb and (tile0 + u % qt) * 64 < sq:
                    key = (bb, hg * hb + u // qt, tile0 + u % qt)
                    taken[key] = taken.get(key, 0) + 1
    assert len(taken) == b * heads * -(-sq // 64) and set(taken.values()) == {1}
    return plan


@pytest.mark.parametrize("shape", _chip_smoke_cases("folded_attention",
                                                   "folded_attention_short"))
def test_folded_plan_covers_each_chip_smoke_case(shape):
    """Each (batch row, head, query tile) falls in exactly one block, on the
    body its class takes."""
    check_folded_launch(*(shape[x] for x in ("b", "sq", "sk", "heads", "dh")))


@pytest.mark.parametrize("shape", _chip_smoke_cases("frame_attention", "frame_attention_long"))
def test_frame_plan_covers_each_chip_smoke_case(shape):
    """Each (batch row, pixel, head group) falls in exactly one block (K2)
    or one item of the persistent walk (K2 long)."""
    b, s, sk, hw, heads, dh = (shape[x] for x in ("b", "s", "sk", "hw", "heads", "dh"))
    assert fr.takes(s, sk, dh) or fr.takes_long(s, sk, dh)
    if s > fr.MAX_FRAMES:
        check_frame_long_launch(b, s, sk, hw, heads, dh)
        return
    plan = fr.frame_plan(b, s, sk, hw, heads, dh)
    _check_frame_plan(plan, b, s, sk, hw, heads, dh)
    pixels, groups = plan["pixels_per_block"], plan["grid"][1]
    covered = sorted(x * pixels + p for x in range(plan["grid"][0]) for p in range(pixels)
                     if x * pixels + p < b * hw)
    assert covered == list(range(b * hw)) and groups * plan["heads_per_block"] == heads


@pytest.mark.parametrize("arch,frames", _ARCH_FRAMES)
def test_k1_and_k2_long_plans_at_each_routed_shape(monkeypatch, arch, frames):
    """Every K1 and K2 long call of the six archs' forwards (found on the meta
    device) gets a plan that passes the same checks as chip_smoke's cases."""
    seen = _routes(monkeypatch, arch, frames)
    for (b, sq, c), k, heads in seen.get("folded_attention", set()):
        check_folded_launch(b, sq, k[1], heads, c // heads)
    for q, k, heads in seen.get("frame_attention_long", set()):
        b, s, hw, c = q
        check_frame_long_launch(b, s, k[1], hw, heads, c // heads)


def _k1_instance(b, sq, sk, heads, dh):
    """The kernel instance a K1 call launches: its body and head width, and
    for the Hopper body its units a warpgroup and its layout (``csrc``
    template arguments)."""
    plan = fa.folded_plan(b, sq, sk, heads, dh)
    return (plan["body"], dh) + ((plan["units"], plan["layout"]) if plan["body"] == "hopper"
                                 else ())


@pytest.mark.parametrize("arch,frames", _ARCH_FRAMES)
def test_chip_smoke_holds_each_routed_k1_instance(monkeypatch, arch, frames):
    """K1's class rule reads the short body's grid, so the batch rows can
    decide the body: a chip_smoke case at a routed call's queries, keys,
    heads and head width takes the body that the call takes at the
    forward's row count, and at the full-width archs every kernel instance
    a forward launches is held by some chip_smoke case."""
    cases = [tuple(p.values[0][x] for x in ("b", "sq", "sk", "heads", "dh"))
             for p in _chip_smoke_cases("folded_attention", "folded_attention_short")]
    held = {_k1_instance(*case) for case in cases}
    seen = _routes(monkeypatch, arch, frames)
    for (b, sq, c), k, heads in seen.get("folded_attention", set()):
        routed = _k1_instance(b, sq, k[1], heads, c // heads)
        assert "tiny" in arch or routed in held, (arch, (b, sq, k[1], heads), routed)
        for case in cases:
            if case[1:] == (sq, k[1], heads, c // heads):
                assert _k1_instance(*case)[0] == routed[0], (case, b, routed)


_CLASS_BOUNDARIES = [
    # (batch rows, Sq, Sk, body): Sq on each side of 32 and of the query
    # tiles' 64, over 77 keys on 2 rows (a short-body grid of a few blocks)
    (2, 31, 77, "short"), (2, 32, 77, "short"), (2, 33, 77, "hopper"),
    (2, 64, 77, "hopper"), (2, 65, 77, "hopper"), (2, 100, 77, "hopper"),
    # Sk on each side of SHORT_MAX_KEYS where the short body's grid fills
    # the card (3 rows of 4096 queries: 192 blocks of 64 queries)
    (3, 4096, 191, "short"), (3, 4096, 192, "short"), (3, 4096, 193, "hopper"),
    # the short body's blocks on each side of one per SM (2 rows of 4096
    # queries: 128 blocks; one row of 132 or 131 tiles of 64 queries)
    (2, 4096, 191, "hopper"), (1, 132 * 64, 191, "short"), (1, 131 * 64, 191, "hopper"),
]


@pytest.mark.parametrize("b,sq,sk,body", _CLASS_BOUNDARIES, ids=[
    f"{sq}-{body}" if sk == 77 else f"b{b}-sq{sq}-sk{sk}-{body}"
    for b, sq, sk, body in _CLASS_BOUNDARIES])
def test_folded_body_at_the_class_boundaries(b, sq, sk, body):
    """The short body takes Sq <= 32, and Sk <= SHORT_MAX_KEYS where its
    grid has a block for every SM (132); the Hopper body the rest, with one
    64-row query tile an item up to 64 queries, one a warpgroup past it; at
    every head width."""
    assert fa.SHORT_MAX_KEYS == 192 and _build.H100_SMS == 132
    for dh in fa.HEAD_DIMS:
        plan = check_folded_launch(b, sq, sk, 128 // dh, dh)
        assert plan["body"] == body
        if body == "hopper":
            assert plan["q_tiles"] == (plan["warpgroups"] if sq > 64 else 1)


# every K1 call of i2vgen-xl's batch-3 forwards at 16 and 128 frames that
# takes the Hopper body: (batch rows, Sq, Sk, heads, head width)
_I2VGEN_HOPPER_K1 = [(3 * f, s, s, 64, dh) for f in (16, 128)
                     for s, dh in ((4096, 8), (1024, 16), (256, 32))]


@pytest.mark.parametrize("frames", (16, 128))
def test_the_i2vgen_hopper_k1_shapes_are_the_routed_ones(monkeypatch, frames):
    """The shapes below are exactly the K1 calls of the forward whose plan
    takes the Hopper body."""
    seen = _routes(monkeypatch, "i2vgen-xl", frames)
    routed = {(b, sq, k[1], heads, c // heads) for (b, sq, c), k, heads in seen["folded_attention"]
              if fa.folded_plan(b, sq, k[1], heads, c // heads)["body"] == "hopper"}
    assert routed == {s for s in _I2VGEN_HOPPER_K1 if s[0] == 3 * frames}


@pytest.mark.parametrize("shape", _I2VGEN_HOPPER_K1,
                         ids=[f"b{b}-s{sq}-dh{dh}" for b, sq, _, _, dh in _I2VGEN_HOPPER_K1])
def test_folded_register_budget_at_each_routed_hopper_shape(shape):
    """At every Hopper-body call of i2vgen-xl's forwards the block's
    setmaxnreg counts fit the register file, and its shared bytes (the
    layout's formula) fit one block."""
    b, sq, sk, heads, dh = shape
    plan = fa.folded_plan(b, sq, sk, heads, dh)
    assert plan["body"] == "hopper" and plan["layout"] == ("wg3" if dh == 8 else "warp2")
    _check_register_budget(plan)
    staged = plan["warpgroups"] * plan["units"] if fa.LAYOUTS[plan["layout"]]["staged"] else 0
    assert plan["smem_bytes"] == fa.folded_layout_bytes(
        dh, plan["heads_per_block"], plan["q_tiles"], staged, plan["q_stages"],
        plan["kv_stages"]) <= _build.SMEM_LIMIT


def test_check_plan_refuses_k1_and_k2_plans_one_block_cannot_hold(monkeypatch):
    """A K1 key stage too long for one SM even in a ring of two, or a
    frame-axis block past 128 frames (which neither K2 route takes), raises
    before any launch."""
    monkeypatch.setattr(fa, "BLOCK_KEYS", 2048)
    with pytest.raises(ValueError, match="no launch"):
        _build.check_plan("folded_attention", fa.folded_plan(2, 4096, 4096, 64, 16))
    with pytest.raises(ValueError, match="no launch"):
        _build.check_plan("frame_attention", fr.frame_plan(1, 256, 256, 64, 8, 160))


def _check_gemm_plan(plan, rows, cols, extra_bytes=0):
    """One launch on hopper.cuh's GEMM main loop: the ring (with the body's
    own bytes: staging, bias) fits one block, no cluster, the tiles cover the
    output, and the persistent walk takes each (row tile, column tile)
    exactly once over the grid and both consumer warpgroups: cooperative,
    block x's tiles x, x + grid, ... (both warpgroups on each); ping-pong,
    block x's units u = x, x + grid, ..., warpgroup w taking tile 2u + w,
    only where the tiles outnumber the SMs (the C entry pairs them exactly
    where they outnumber its grid)."""
    width, col_tiles = plan["width"], plan["col_tiles"]
    assert width in _build.GEMM_WIDTHS and plan["threads"] == 384
    assert col_tiles * width >= cols > (col_tiles - 1) * width
    stage = (128 + width) * 64 * 2
    assert plan["smem_bytes"] == (plan["stages"] * stage + extra_bytes + 2 * plan["stages"] * 8
                                  + 1024) <= SMEM
    assert plan["stages"] >= 4 and "cluster" not in plan
    _build.check_plan("gemm", plan)
    row_tiles = -(-rows // 128)
    assert plan["tiles"] == row_tiles * col_tiles
    pingpong = plan["schedule"] == "pingpong"
    grid = plan["grid"][0]
    assert plan["units"] == (-(-plan["tiles"] // 2) if pingpong else plan["tiles"])
    assert 1 <= grid <= min(plan["units"], _build.H100_SMS)
    assert not pingpong or plan["tiles"] > max(grid, _build.H100_SMS)
    taken = [0] * plan["tiles"]
    for x in range(grid):
        for u in range(x, plan["units"], grid):
            for tile in ((2 * u, 2 * u + 1) if pingpong else (u,)):
                if tile < plan["tiles"]:
                    taken[tile] += 1
    assert set(taken) == {1}
    # the same launch with a tile one step wider than the widest is refused
    wider = _build.gemm_plan(rows, col_tiles, _build.GEMM_WIDTHS[-1] + 64, plan["ksteps"],
                             extra_bytes, stages=plan["stages"], pingpong=pingpong)
    with pytest.raises(ValueError, match="no launch"):
        _build.check_plan("gemm", wider)


# K3 at the tiny archs' widths (C 32 and 64, inner 4C; rows of i2vgen-tiny
# and consisti2v-tiny forwards at batch 3) and K4 at theirs (C 16 and 32; P
# down to 1, so a 128-row tile spans frames and batch rows)
_TINY_FFN = [(6144, 64), (1536, 32), (96, 32), (1728, 32), (108, 32)]
_TINY_TCONV = [(3, 8, 256, 16, 16), (3, 8, 64, 32, 32), (3, 8, 4, 32, 32), (3, 9, 16, 32, 32),
               (3, 40, 256, 16, 16), (3, 8, 1, 32, 32)]


def _launch1_schedule(first, rows):
    """Launch 1's schedule: ping-pong (5 or 4 stages, each warpgroup's h
    staging of 128 rows) where its tiles outnumber the SMs, else cooperative
    (a stage more, 64 rows each); returns the staging bytes."""
    pingpong = first["tiles"] > _build.H100_SMS
    assert first["schedule"] == ("pingpong" if pingpong else "cooperative")
    assert first["tiles"] == -(-rows // 128) * first["col_tiles"]
    gelu = first["h_cols"] == 128
    assert first["stages"] == (4 if gelu else 5) + (0 if pingpong else 1)
    return 2 * (128 if pingpong else 64) * first["h_cols"] * 2


@pytest.mark.parametrize("shape", _chip_smoke_cases("ffn_geglu") + [
    pytest.param({"n": n, "c": c, "inner": 4 * c}, id=f"tiny rows {n} C{c}") for n, c in _TINY_FFN])
def test_ffn_plan_covers_each_case(shape):
    """Both of K3's launches, for every chunk of rows: launch 1 over tiles of
    128 rows by 64 h columns (v and g, 128 rows of W1), on the ping-pong
    schedule where its tiles outnumber the SMs and the cooperative one
    elsewhere, each consumer warpgroup's h staging and b1 beside its ring;
    launch 2 on the cooperative one over C, b2 beside its ring."""
    n, c, inner = shape["n"], shape["c"], shape["inner"]
    assert ffn.fits(c, inner)
    for i in range(0, n, ffn.CHUNK_ROWS):
        rows = min(ffn.CHUNK_ROWS, n - i)
        plan = ffn.ffn_plan(rows, c, inner)
        first = plan["geglu"]
        assert first["width"] == 128 and first["h_cols"] == 64 and first["ksteps"] == -(-c // 64)
        _check_gemm_plan(first, rows, 2 * inner,
                         _launch1_schedule(first, rows) + 2 * 2 * inner)
        assert first["col_tiles"] == inner // 64
        assert plan["out"]["ksteps"] == inner // 64 and plan["out"]["schedule"] == "cooperative"
        _check_gemm_plan(plan["out"], rows, c, 2 * c)


@pytest.mark.parametrize("shape", _chip_smoke_cases("ffn_gelu") + [
    pytest.param({"n": n, "c": c, "inner": 4 * c}, id=f"tiny rows {n} C{c}") for n, c in _TINY_FFN])
def test_ffn_gelu_plan_covers_each_case(shape):
    """K3's GELU form: launch 1 over tiles of 128 h columns from one box of
    W1 rows, its schedule as GEGLU's, a stage fewer beside twice the staging
    of GEGLU's and b1; launch 2 as GEGLU's."""
    n, c, inner = shape["n"], shape["c"], shape["inner"]
    assert ffn.fits(c, inner)
    for i in range(0, n, ffn.CHUNK_ROWS):
        rows = min(ffn.CHUNK_ROWS, n - i)
        plan = ffn.ffn_plan(rows, c, inner, activation="gelu")
        assert set(plan) == {"gelu", "out"}
        first = plan["gelu"]
        assert first["width"] == 128 and first["h_cols"] == 128 and first["ksteps"] == -(-c // 64)
        assert first["col_tiles"] == -(-inner // 128)
        _check_gemm_plan(first, rows, inner, _launch1_schedule(first, rows) + 2 * inner)
        assert plan["out"] == ffn.ffn_plan(rows, c, inner)["out"]
    with pytest.raises(ValueError, match="activation"):
        ffn.ffn_plan(n, c, inner, activation="relu")


@pytest.mark.parametrize("shape", _chip_smoke_cases("gn_silu_temporal_conv") + [
    pytest.param(dict(zip(("b", "f", "p", "c", "c_out"), s)), id=f"tiny {s}")
    for s in _TINY_TCONV])
def test_tconv_plan_covers_each_case(shape):
    """K4's GEMM: cooperative, K steps over 3 taps x 64-channel slices, A by
    TMA exactly where a 128-row tile is 128 pixels of one frame (P % 128 ==
    0); the prologue a kernel of its own, evaluated once per x element."""
    b, f, p, c, c_out = (shape[x] for x in ("b", "f", "p", "c", "c_out"))
    plan = tc.tconv_plan(b, f, p, c, c_out)
    assert plan["ksteps"] == 3 * -(-c // 64) and plan["schedule"] == "cooperative"
    assert plan["evaluations"] == 1
    assert plan["tma_a"] == (p % 128 == 0)
    if plan["tma_a"]:
        assert (f * p) % 128 == 0 and (b * f * p) % 128 == 0
    _check_gemm_plan(plan, b * f * p, c_out)


def test_tconv_plan_evaluations_at_the_unet_widths():
    """One evaluation per x element at C' 320, 640 and 1280 and at the tiny
    archs' widths (the prologue a kernel of its own; fused into 320-column
    tiles it took 3, 6 and 12, and 15, 30 and 60 into the 64-column tiles
    before)."""
    assert [tc.tconv_plan(3, 16, 256, c, c)["evaluations"] for c in (320, 640, 1280)] == [1, 1, 1]
    assert tc.tconv_plan(1, 16, 64, 1280, 1280)["evaluations"] == 1
    assert tc.tconv_plan(3, 8, 64, 32, 32)["evaluations"] == 1


def test_tconv_plan_fills_the_card_at_the_mid_block():
    """The mid block at batch 3 (3 x 16 x 64 rows, C' 1280): 320-column tiles
    would be 96 for 132 SMs; the plan takes 120 of 256 columns, one round,
    and keeps 320 wherever the rounds do not change."""
    plan = tc.tconv_plan(3, 16, 64, 1280, 1280)
    assert plan["width"] == 256 and plan["tiles"] == 120 and plan["grid"] == (120,)
    assert plan["tiles"] >= 0.9 * _build.H100_SMS
    assert tc.tconv_plan(3, 128, 16, 1280, 1280)["width"] == 256   # per rank of 4
    for shape in ((1, 16, 4096, 320), (3, 16, 1024, 640), (3, 16, 256, 1280), (3, 128, 64, 1280)):
        assert tc.tconv_plan(*shape, shape[-1])["width"] == 320


@pytest.mark.parametrize("c,c_out", [(36, 32), (32, 36), (4, 4), (320, 1284)])
def test_tconv_plan_refuses_widths_not_multiples_of_8(c, c_out):
    """The 16-byte gathers and the TMA strides need C and C' multiples of 8;
    the plan raises on anything else, and so does the wrapper before any
    launch."""
    with pytest.raises(ValueError, match="multiples of 8"):
        tc.tconv_plan(2, 5, 30, c, c_out)


def test_ffn_plan_refuses_more_rows_than_a_chunk():
    with pytest.raises(ValueError, match="rows"):
        ffn.ffn_plan(ffn.CHUNK_ROWS + 1, 320, 1280)
    with pytest.raises(ValueError, match="rows"):
        ffn.ffn_plan(0, 320, 1280)
