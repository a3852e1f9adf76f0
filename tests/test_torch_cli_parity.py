"""The i2vgen-xl group CLIs of the two packages on one input, on i2vgen-tiny,
fp32 on the CPU (the workspace of ``test_torch_cli.py``: the same frames,
edited first frame and JAX ``save_params`` weights, made once here).

- The port's inversion CLI writes the cache the JAX inversion CLI writes,
  every ``ddim_latents_{t}.npy`` within the pipeline tolerance (rtol = atol
  = 1e-4).
- Both edit CLIs read the JAX cache at ``random_ratio: 0`` and write the same
  frames: the PNGs differ by at most 1 of 255 (latents within 1e-4 can
  round to neighbouring 8-bit levels). The JAX edit runs with traced PnP
  flags (``ANYV2V_PNP_STATIC=0``: one compile per batch), as the pipeline
  tests run it.
"""

import os
import shutil

import numpy as np
import pytest

from anyv2v_tpu.cli import run_group_ddim_inversion as jax_inversion
from anyv2v_tpu.cli import run_group_pnp_edit as jax_edit
from anyv2v_torch.cli import run_group_ddim_inversion
from anyv2v_torch.utils.io import load_ddim_trajectory
from test_torch_cli import EDIT_TEMPLATE, N_FRAMES, SIZE, STEPS, _edit, _invert, _write
from test_torch_cli import workspace  # noqa: F401 (fixture)
from test_torch_consisti2v_cli import read_frames
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def caches(workspace):  # noqa: F811
    jax_dir, port_dir = str(workspace / "jax"), str(workspace / "port")
    return (jax_dir, _invert(workspace, jax_dir, jax_inversion),
            _invert(workspace, port_dir, run_group_ddim_inversion, ["--device", "cpu"]))


def test_port_inversion_cache_matches_jax(caches):
    _, jax_cache, port_cache = caches
    got, got_ts = load_ddim_trajectory(port_cache, per_step_files=True)
    want, want_ts = load_ddim_trajectory(jax_cache, per_step_files=True)
    np.testing.assert_array_equal(got_ts, want_ts)
    assert got.shape == (STEPS, 1, N_FRAMES, SIZE // 8, SIZE // 8, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_edit_clis_write_the_same_frames(workspace, caches, monkeypatch):  # noqa: F811
    data_dir = caches[0]
    port_out = _edit(workspace, data_dir)
    moved = port_out.rstrip("/") + "_port"
    shutil.move(port_out, moved)
    frames_dir = str(workspace / "demo" / "square" / "frames")
    args = _write(workspace, "edit_jax_cli", EDIT_TEMPLATE,
                  [{"video_name": "square", "video_frames_path": frames_dir,
                    "edited_video_name": "green_square",
                    "edited_first_frame_path": str(workspace / "edited_1st.png")}],
                  init=workspace / "tiny.npz", data_dir=data_dir, size=SIZE, frames=N_FRAMES,
                  steps=STEPS)
    monkeypatch.setenv("ANYV2V_PNP_STATIC", "0")
    jax_edit.main(args)
    stem = f"cfg_9.0_steps_{STEPS}_tidx_0_pnpf_0.2_pnps_0.2_pnpt_0.5_frames"
    got = read_frames(os.path.join(moved, stem))
    want = read_frames(os.path.join(port_out, stem))
    assert got.shape == want.shape == (N_FRAMES, SIZE, SIZE, 3)
    assert np.abs(got - want).max() <= 1
