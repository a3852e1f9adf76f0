"""The SEINE CLIs across packages on seine-tiny, fp32 on the CPU.

Both packages load the same weights: a JAX ``save_params`` ``.npz`` made from
seeded port weights through the JAX converters. The JAX inversion CLI writes
the ``ddim_latents_{t}.npy`` cache on the save grid; the port's edit CLI
reads those per-step files (the consolidated file is removed first) and
writes the JAX CLI's output names; the port's inversion CLI writes the same
cache within 1e-4, the same provenance files, and its reconstruction.
"""

import os

import numpy as np
import pytest
import yaml
from PIL import Image

from anyv2v_tpu.cli import seine_run_ddim_inversion as jax_inversion
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.cli import seine_run_ddim_inversion, seine_run_pnp_edit
from anyv2v_torch.utils.io import load_ddim_trajectory
from test_torch_seine import TOL, one_torch_thread, tiny_trees  # noqa: F401 (fixture)

F, HW, INV_STEPS, SAVE_STEPS, EDIT_STEPS = 2, 64, 8, 4, 4

SCHEDULE = """
beta_start: 0.0001
beta_end: 0.02
beta_schedule: "linear"
model: {{arch: "seine-tiny", init: "{init}", dtype: "float32", tokenizer_path: null}}
image_size: [{size}, {size}]
video_frames_path: "{frames}"
"""

INV_YAML = SCHEDULE + """
seed: 1
debug: False
exp_name: "tiny"
output_dir: "{root}/ddim-inversion/${{exp_name}}"
src_video_path: "ReplaceMe"
n_steps: {steps}
n_save_steps: {save}
n_frame_to_invert: {n}
inversion_prompt: ""
enable_recon: False
"""

EDIT_YAML = SCHEDULE + """
seed: 1
debug: False
output_dir: "{root}/edit"
src_video_path: "ReplaceMe"
ddim_inversion_dir: "{root}/ddim-inversion/tiny"
n_frames: {n}
edited_first_frame_path: "{root}/edited_1st.png"
sample_method: "ddpm"
cfg_scale: 4
n_steps: {edit_steps}
prompt: ""
negative_prompt: ""
inversion_prompt: ""
enable_pnp: True
pnp_f_t: 0.25
pnp_spatial_attn_t: 0.5
pnp_temp_attn_t: 0.5
pnp_cross_attn_t: 0.25
"""


@pytest.fixture(scope="module")
def cli_workspace(tmp_path_factory):
    """Demo frames, an edited first frame, the shared ``.npz`` weights, the
    two YAMLs and the JAX inversion CLI's cache."""
    root = tmp_path_factory.mktemp("seine_cli")
    frames_dir = root / "frames"
    frames_dir.mkdir()
    for i in range(F):
        img = np.zeros((HW, HW, 3), np.uint8)
        img[:, :, 2] = np.linspace(40, 200, HW, dtype=np.uint8)[None, :]
        img[20:36, 8 + 6 * i:20 + 6 * i, :2] = (230, 180)
        Image.fromarray(img).save(frames_dir / f"{i:05d}.png")
    first = np.asarray(Image.open(frames_dir / "00000.png")).copy()
    first[first[:, :, 0] > 200] = (40, 220, 60)
    Image.fromarray(first).save(root / "edited_1st.png")
    _, trees = tiny_trees(5)
    jzoo.save_params(str(root / "tiny.npz"), trees)
    fmt = dict(init=root / "tiny.npz", root=root, size=HW, frames=frames_dir, n=F,
               steps=INV_STEPS, save=SAVE_STEPS, edit_steps=EDIT_STEPS)
    (root / "inv.yaml").write_text(INV_YAML.format(**fmt))
    (root / "edit.yaml").write_text(EDIT_YAML.format(**fmt))
    jax_inversion.main(["--config", str(root / "inv.yaml")])
    return root


def test_jax_inversion_then_port_edit(cli_workspace):
    root = cli_workspace
    cache = root / "ddim-inversion" / "tiny"
    names = sorted(f for f in os.listdir(cache) if f.startswith("ddim_latents_"))
    assert names == sorted(f"ddim_latents_{1 + 250 * i}.npy" for i in range(SAVE_STEPS))
    os.remove(cache / "ddim_trajectory.npz")   # the port reads the per-step files
    seine_run_pnp_edit.main(["--config", str(root / "edit.yaml"), "--device", "cpu"])
    out = root / "edit"
    assert sorted(os.listdir(out)) == ["edited_video.gif", "edited_video.mp4", "frames"]
    assert len(os.listdir(out / "frames")) == F


def test_port_inversion_cli_writes_the_same_cache(cli_workspace):
    """The port's inversion CLI (with the reconstruction on) writes the cache
    the JAX CLI wrote, within the pipeline tolerance, and the same
    provenance files."""
    root = cli_workspace
    argv = ["--config", str(root / "inv.yaml"), "--device", "cpu", "exp_name=port",
            "enable_recon=true"]
    seine_run_ddim_inversion.main(argv)
    port_dir, jax_dir = root / "ddim-inversion" / "port", root / "ddim-inversion" / "tiny"
    traj, ts = load_ddim_trajectory(str(port_dir), per_step_files=True)
    want, want_ts = load_ddim_trajectory(str(jax_dir), per_step_files=True)
    np.testing.assert_array_equal(ts, want_ts)
    np.testing.assert_allclose(traj, want, **TOL)
    provenance = {"inversion_prompts.yaml", "config.yaml"}
    assert provenance <= set(os.listdir(jax_dir))
    assert set(os.listdir(port_dir)) == provenance | {
        "ddim_trajectory.npz", "meta.json", "ddim_reconstruction.mp4"} | {
        f"ddim_latents_{t}.npy" for t in want_ts}
    saved = yaml.safe_load((port_dir / "config.yaml").read_text())
    assert saved["output_dir"] == str(port_dir) and saved["n_save_steps"] == SAVE_STEPS
    with pytest.raises(RuntimeError, match="min_psnr"):
        seine_run_ddim_inversion.main(argv + ["min_psnr=1000"])
