"""The port's frame sharding (``anyv2v_torch.parallel``) on a gloo group of 4
CPU processes, against the JAX package.

One group per test module: the module's cases (the functions named
``case_*``) run one after another on every rank of one spawn, each rank
writing its arrays to a file that the tests read. The JAX side runs in the
test process: its collectives under ``jax.shard_map`` on the 8-device CPU
mesh (``conftest.py``), its modules on one device.

- ``make_mesh``: shapes, its ValueError, and no mesh without a process group;
- the placement helpers: a rank's video block and frame share, the shares
  gathered back, a replicated copy and broadcast weights;
- each collective: rank i's block equals device i's of the JAX helper,
  exactly;
- the sharded ``TemporalTransformer`` and ``TemporalConvLayer`` against the
  JAX modules on one device, rtol 1e-4, atol 1e-5 (``tests/test_parallel.py``'s
  tolerance), in both branches: pixels that divide into shares of 8 (the
  all-to-all) and smaller grids (the gather); the JAX module with its norm
  over the clip's frames, as published (``jax_clip_norm.py``);
- the temporal transformer's norm over a clip split over the ranks against
  the same norm on one process;
- ``around_frame_op`` (the one resharding policy): each rank gets its frames
  of the op on the whole clip, in both branches, with and without a row
  every rank holds;
- the mock region on one process: per-rank shapes equal the gloo ranks',
  the mock all-to-all round trip is the identity, and a tiny UNet runs at
  per-rank shapes;
- ``AnyV2VRunner(mesh=...)``: the tiny clip's edit on 4 ranks equals the
  single-process runner's.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from anyv2v_torch.models import layers as tl
from anyv2v_torch.parallel import mesh as tm
from anyv2v_tpu.models import layers as jl
from anyv2v_tpu.parallel import mesh as jm
from anyv2v_tpu.utils import convert as C
from test_torch_unet import randomize
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

WORLD = 4
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SPAWN_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# the gloo group
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(module: str, rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank: join the gloo group, run every ``case_*`` of ``module`` in
    name order, write each case's arrays to ``<case>.<rank>.npz``."""
    import importlib

    import torch.distributed as dist

    torch.set_num_threads(1)
    mod = importlib.import_module(module)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        for name in sorted(n for n in dir(mod) if n.startswith("case_")):
            out = getattr(mod, name)(rank)
            np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(module: str, out_dir: str, world: int = WORLD) -> dict:
    """Run ``module``'s cases on ``world`` gloo ranks; returns ``{case:
    [rank 0's arrays, rank 1's, ...]}``."""
    port = _free_port()
    code = (f"import sys; sys.path[:0] = [{REPO!r}, {TESTS!r}]; import test_torch_parallel as p; "
            f"p.rank_main({module!r}, int(sys.argv[1]), {world}, {port}, {out_dir!r})")
    logs, procs = [], []
    for r in range(world):
        logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=REPO,
                                      stdout=logs[r], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        logs[failed[0]].seek(0)
        raise RuntimeError(f"gloo ranks {failed} failed (rc {procs[failed[0]].returncode}):\n"
                           + logs[failed[0]].read()[-6000:])
    for f in logs:
        f.close()
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".npz"):
            case, rank, _ = name.rsplit(".", 2)
            with np.load(os.path.join(out_dir, name)) as z:
                out.setdefault(case, [None] * world)[int(rank)] = dict(z)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("test_torch_parallel", str(tmp_path_factory.mktemp("gloo")))


def cpu_mesh(n_cfg: int = 1):
    return tm.make_mesh(n_cfg, device_type="cpu")


def frame_group(mesh):
    return mesh.get_group("frame"), tm.axis_size(mesh, "frame")


# ---------------------------------------------------------------------------
# make_mesh
# ---------------------------------------------------------------------------


def case_mesh(rank):
    meshes = [cpu_mesh(n) for n in (1, 2)]
    raised = []
    for kw in ({"n_cfg": 3, "device_type": "cpu"}, {"device_type": "cuda"}):
        try:
            tm.make_mesh(**kw)
            raised.append(False)
        except ValueError:
            raised.append(True)
    assert all(m.mesh_dim_names == ("cfg", "frame") for m in meshes)
    return {"shapes": np.array([tuple(m.shape) for m in meshes]), "raised": np.array(raised)}


def test_mesh_construction(ranks):
    for r in ranks["case_mesh"]:
        np.testing.assert_array_equal(r["shapes"], [[1, 4], [2, 2]])
        # 3 does not divide 4 ranks; a CUDA mesh on a gloo group
        assert r["raised"].all()


def test_make_mesh_needs_a_process_group():
    """No process group: no mesh (an entry point never runs single-device
    quietly)."""
    with pytest.raises(RuntimeError):
        tm.make_mesh(1, device_type="cpu")


def case_placement(rank):
    """The placement helpers on a (cfg 2, frame 2) mesh: each rank's block
    of a video, its share of a flat frame batch and the batch gathered back,
    rank 0's copy replicated, rank 0's weights broadcast."""
    mesh = cpu_mesh(2)
    video = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    frames = torch.arange(7 * 2, dtype=torch.float32).reshape(7, 2)   # 7 frames, 4 ranks
    share = tm.frames_sharding(frames, mesh)
    module = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(module.weight, float(rank))
    tm.shard_params(module, mesh)
    return {"video": tm.video_sharding(video, mesh).numpy(), "share": share.numpy(),
            "gathered": tm.gather_frame_shares(share, mesh, 7).numpy(),
            "replicated": tm.replicated(torch.full((3,), float(rank)), mesh).numpy(),
            "weight": module.weight.detach().numpy()}


def test_placement_helpers(ranks):
    video = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    frames = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    padded = np.concatenate([frames, frames[-1:]])    # 2 frames a rank, the last repeated
    for r, got in enumerate(ranks["case_placement"]):
        c, f = divmod(r, 2)   # the rank's (cfg, frame) coordinate
        np.testing.assert_array_equal(got["video"], video[c:c + 1, 2 * f:2 * f + 2])
        np.testing.assert_array_equal(got["share"], padded[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["gathered"], frames)
        np.testing.assert_array_equal(got["replicated"], np.zeros(3))
        np.testing.assert_array_equal(got["weight"], np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# the collectives against jax.shard_map
# ---------------------------------------------------------------------------

B, F_LOC, P_PIX, CH = 2, 2, 16, 3


def _global_x():
    return np.random.RandomState(0).randn(B, F_LOC * WORLD, P_PIX, CH).astype(np.float32)


def _collectives(x, group, n):
    """name -> this rank's output, the same helpers on either side."""
    f2p = tm.frames_to_pixels(x, group, 1, 2)
    return {
        "frames_to_pixels": f2p,
        "round_trip": tm.pixels_to_frames(f2p, group, 1, 2),
        "gather_frames": tm.gather_frames(x, group, 1),
        "gather_pixels": tm.gather_pixels(x, group, 2),
        "pmean": tm.pmean_axis(x, group),
        "local_pixel_slice": tm.local_pixel_slice(x, group, n, 2),
        "axis_index": torch.tensor(tm.axis_index(group)),
    }


def case_collectives(rank):
    group, n = frame_group(cpu_mesh())
    x = torch.from_numpy(_global_x()[:, rank * F_LOC:(rank + 1) * F_LOC])
    with tm.manual_axis(group, n):
        return {k: v.numpy() for k, v in _collectives(x, group, n).items()}


def _jax_blocks():
    """name -> [device i's output block] of the JAX helpers on a 4-device
    frame mesh."""
    mesh = jm.make_mesh(n_cfg=1, n_frame=WORLD, devices=jax.devices()[:WORLD])

    def local(x):
        with jm.manual_axis("frame", WORLD):
            f2p = jm.frames_to_pixels(x, "frame", 1, 2)
            out = {
                "frames_to_pixels": f2p,
                "round_trip": jm.pixels_to_frames(f2p, "frame", 1, 2),
                "gather_frames": jm.gather_frames(x, "frame", 1),
                "gather_pixels": jm.gather_pixels(x, "frame", 2),
                "pmean": jm.pmean_axis(x, "frame"),
                "local_pixel_slice": jm.local_pixel_slice(x, "frame", WORLD, 2),
                "axis_index": jm.axis_index("frame"),
            }
            return {k: v[None] for k, v in out.items()}   # device blocks stacked on axis 0

    with jax.set_mesh(mesh):
        out = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P(None, "frame"),
                                    out_specs=P("frame"), check_vma=False))(
            jnp.asarray(_global_x()))
    return {k: np.asarray(v) for k, v in out.items()}


def test_collectives_match_jax_shard_map(ranks):
    want = _jax_blocks()
    for r, got in enumerate(ranks["case_collectives"]):
        for name, block in want.items():
            np.testing.assert_array_equal(got[name], block[r], err_msg=f"{name}, rank {r}")


def test_mock_shapes_match_the_ranks(ranks):
    """Every mock helper's output has the shape of the real helper's on a
    rank; ``axis_index`` is 0 and ``pmean_axis`` the identity."""
    x = torch.from_numpy(_global_x()[:, :F_LOC])
    with tm.mock_manual_axis(WORLD):
        mock = _collectives(x, None, WORLD)
        assert tm.pmean_axis(x, None) is x
    for name, got in mock.items():
        assert tuple(got.shape) == ranks["case_collectives"][0][name].shape, name
    assert int(mock["axis_index"]) == 0


def test_mock_roundtrip_is_identity():
    x = torch.arange(2 * 2 * 8 * 3, dtype=torch.float32).reshape(2, 2, 8, 3)
    with tm.mock_manual_axis(4):
        y = tm.pixels_to_frames(tm.frames_to_pixels(x, None, 1, 2), None, 1, 2)
    torch.testing.assert_close(y, x, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the resharding policy: around_frame_op
# ---------------------------------------------------------------------------

AROUND_CASES = [(16, 0, "frames"), (16, 1, "frames"), (32, 0, "pixels"), (32, 1, "pixels")]


def _around_input(pixels):
    """A leading conditioning row, then F_LOC frames for every rank."""
    return np.random.RandomState(pixels).randn(B, 1 + F_LOC * WORLD, pixels, CH).astype(
        np.float32)


def _frame_coupled(x):
    return x.cumsum(dim=1)     # every output frame depends on every earlier one


def case_around_frame_op(rank):
    group, n = frame_group(cpu_mesh())
    out = {}
    with tm.manual_axis(group, n):
        for pixels, f0row, _ in AROUND_CASES:
            whole = torch.from_numpy(_around_input(pixels))
            x = torch.cat([whole[:, :f0row], whole[:, 1 + rank * F_LOC:1 + (rank + 1) * F_LOC]],
                          dim=1)
            modes = []

            def fn(t, mode):
                modes.append(mode)
                return _frame_coupled(t)

            out[f"{pixels} {f0row}"] = tm.around_frame_op(fn, (x,), f0row).numpy()
            out[f"{pixels} {f0row} mode"] = np.array(modes)
            out[f"{pixels} {f0row} no gather"] = tm.around_frame_op(
                lambda t, mode: t * 2 if mode is None else t, (x,), f0row, gather=False).numpy()
    return out


@pytest.mark.parametrize("pixels,f0row,mode", AROUND_CASES)
def test_around_frame_op_gives_every_frame(ranks, pixels, f0row, mode):
    """On 4 gloo ranks the op sees the whole clip (the rows every rank holds
    counted once) through the all-to-all where the pixels divide into shares
    of 8, else through a gather; each rank gets its frames of the op's
    result on the whole clip, and those rows whole."""
    whole = torch.from_numpy(_around_input(pixels))
    ref = _frame_coupled(torch.cat([whole[:, 1 - f0row:1], whole[:, 1:]], dim=1)).numpy()
    key = f"{pixels} {f0row}"
    for r, got in enumerate(ranks["case_around_frame_op"]):
        want = np.concatenate([ref[:, :f0row],
                               ref[:, f0row + r * F_LOC:f0row + (r + 1) * F_LOC]], axis=1)
        np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")
        assert list(got[key + " mode"]) == [mode]
        x = np.concatenate([whole[:, :f0row], whole[:, 1 + r * F_LOC:1 + (r + 1) * F_LOC]], 1)
        # gather=False: small grids reach fn as they are, mode None (its own ops
        # reshard themselves); the all-to-all and back is the identity
        np.testing.assert_array_equal(got[key + " no gather"], x * 2 if mode == "frames" else x)


def test_around_frame_op_outside_a_region():
    x = torch.ones(1, 2, 8, 3)
    assert tm.around_frame_op(lambda t, mode: (t, mode), (x,))[1] is None
    with tm.mock_manual_axis(1):        # one rank: no region either
        assert tm.around_frame_op(lambda t, mode: (t, mode), (x,))[1] is None


# ---------------------------------------------------------------------------
# the sharded temporal layers against the JAX modules
# ---------------------------------------------------------------------------

HEADS, HEAD_DIM, LAYER_C, LAYER_F = 4, 8, 32, 8
LAYER_CASES = [(4, False), (8, False), (8, True)]   # (side, inject): 16 pixels gather, 64 split


def _layer_input(side):
    return np.random.RandomState(side).randn(3, LAYER_F, side, side, LAYER_C).astype(np.float32)


def _layers():
    tt = tl.TemporalTransformer(LAYER_C, HEADS, HEAD_DIM, groups=8)
    tc = tl.TemporalConvLayer(LAYER_C, groups=8)
    return tt, randomize(tt, 6), tc, randomize(tc, 2)


def case_layers(rank):
    tt, _, tc, _ = _layers()
    group, n = frame_group(cpu_mesh())
    f = LAYER_F // n
    out = {}
    with torch.no_grad(), tm.manual_axis(group, n):
        for side, inject in LAYER_CASES:
            x = torch.from_numpy(_layer_input(side)[:, rank * f:(rank + 1) * f])
            out[f"tt{side}{inject}"] = tt(x, inject=inject).numpy()
            if not inject:
                out[f"tc{side}"] = tc(x).numpy()
    return out


@pytest.mark.parametrize("side,inject", LAYER_CASES)
def test_sharded_temporal_layers_match_jax(ranks, side, inject):
    _, tt_sd, _, tc_sd = _layers()
    x = jnp.asarray(_layer_input(side))
    pref = lambda sd: {f"m.{k}": v for k, v in sd.items()}   # noqa: E731
    want = {f"tt{side}{inject}": jl.TemporalTransformer(HEADS, HEAD_DIM, groups=8).apply(
        {"params": C._temporal_transformer(pref(tt_sd), "m", HEADS, HEAD_DIM)}, x,
        inject=inject if inject else None)}
    if not inject:
        want[f"tc{side}"] = jl.TemporalConvLayer(LAYER_C, groups=8).apply(
            {"params": C._temp_conv(pref(tc_sd), "m")}, x)
    for key, w in want.items():
        got = np.concatenate([r[key] for r in ranks["case_layers"]], axis=1)
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=key)


def case_clip_norm(rank):
    tt, _, _, _ = _layers()
    group, n = frame_group(cpu_mesh())
    f = LAYER_F // n
    with torch.no_grad(), tm.manual_axis(group, n):
        return {f"norm{side}": tl.clip_group_norm(
            torch.from_numpy(_layer_input(side)[:, rank * f:(rank + 1) * f]), tt.norm).numpy()
            for side in (4, 8)}


@pytest.mark.parametrize("side", [4, 8])
def test_sharded_clip_norm_is_the_unsharded_one(ranks, side):
    """The temporal transformer's norm over a clip whose frames are split
    over 4 ranks (each rank's partial moments gathered from every rank and
    merged) equals the norm of the whole clip on one process, to fp32
    rounding (rtol 1e-5, atol 1e-5: moments over 8 frames x 4 channels x 16
    or 64 pixels)."""
    tt, _, _, _ = _layers()
    with torch.no_grad():
        want = tl.clip_group_norm(torch.from_numpy(_layer_input(side)), tt.norm).numpy()
    got = np.concatenate([r[f"norm{side}"] for r in ranks["case_clip_norm"]], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the mock region on a whole UNet
# ---------------------------------------------------------------------------


def test_mock_region_runs_unet_at_shard_shapes():
    """i2vgen-tiny at per-rank shapes (2 of 8 frames, the image latents
    whole) under the mock region: the per-rank output shape, finite."""
    from anyv2v_torch.utils.model_zoo import build_modules

    unet = build_modules("i2vgen-tiny", torch.float32, device="cpu")["unet"]
    randomize(unet, 0)
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.2)   # noqa: E731
    with torch.no_grad(), tm.mock_manual_axis(4):
        out = unet(t(1, 2, 8, 8, 4), 500, t(1, 5, 32), 8, t(1, 8, 8, 8, 4), t(1, 1, 32))
    assert out.shape == (1, 2, 8, 8, 4)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the runner on a mesh
# ---------------------------------------------------------------------------

RUNNER = dict(arch="i2vgen-tiny", dtype="float32", seed=3, device="cpu")


def _runner_edit(runner):
    rng = np.random.RandomState(1)
    frames = rng.rand(8, 64, 64, 3).astype(np.float32)
    edited = np.ascontiguousarray(frames[0][:, ::-1])
    video, traj, _ = runner.edit_arrays(frames, edited, "a prompt", ddim_inversion_steps=4,
                                        num_inference_steps=2, guidance_scale=3.0)
    return {"video": video.numpy(), "traj": np.asarray(traj)}


def case_runner(rank):
    from anyv2v_torch.product.anyv2v import AnyV2VRunner

    runner = AnyV2VRunner(**RUNNER, mesh=cpu_mesh())
    with torch.no_grad():
        out = _runner_edit(runner)
    assert runner.pipeline().mesh is not None
    return out


def test_runner_on_a_mesh_edits_as_one_process(ranks):
    from anyv2v_torch.product.anyv2v import AnyV2VRunner

    with torch.no_grad():
        want = _runner_edit(AnyV2VRunner(**RUNNER))
    for got in ranks["case_runner"]:   # every rank returns the whole clip
        np.testing.assert_allclose(got["traj"], want["traj"], rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(got["video"], want["video"], rtol=1e-4, atol=5e-5)
