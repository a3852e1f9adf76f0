"""The port's two group CLIs on i2vgen-tiny, across packages.

Both packages load the same weights: a JAX ``save_params`` ``.npz`` made from
seeded port weights through the JAX converters. The JAX inversion CLI writes
the ``ddim_latents_{t}.npy`` cache; the port's edit CLI reads those per-step
files (the consolidated file is removed first) and writes the JAX CLI's output
names. The port's own inversion CLI writes the same cache files.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from anyv2v_tpu.cli import run_group_ddim_inversion as jax_inversion
from anyv2v_tpu.utils.model_zoo import save_params
from anyv2v_torch.cli import run_group_ddim_inversion, run_group_pnp_edit
from test_torch_unet import tiny_models

N_FRAMES, SIZE, STEPS = 4, 64, 10

INV_TEMPLATE = """
seed: 8888
debug: False
model:
  arch: "i2vgen-tiny"
  init: "{init}"
  dtype: "float32"
  tokenizer_path: null
  scheduler: {{}}
data_dir: "{data_dir}"
model_name: "i2vgen-xl"
exp_name: "${{video_name}}"
output_dir: "${{data_dir}}/inversions/${{model_name}}/${{exp_name}}"
image_size: [{size}, {size}]
video_name: "ReplaceMe"
video_path: "ReplaceMe"
video_frames_path: "ReplaceMe"
n_frames: {frames}
inverse_config:
  image_size: ${{image_size}}
  n_frames: ${{n_frames}}
  cfg: 1.0
  target_fps: 8
  prompt: ""
  n_steps: {steps}
  output_dir: "${{output_dir}}/ddim_latents"
  inverse_static_video: False
  null_image_inversion: False
recon_config:
  enable_recon: False
"""

EDIT_TEMPLATE = """
seed: 8888
debug: False
model:
  arch: "i2vgen-tiny"
  init: "{init}"
  dtype: "float32"
  tokenizer_path: null
  scheduler: {{}}
data_dir: "{data_dir}"
model_name: "i2vgen-xl"
task_name: "Prompt-Based-Editing"
edited_video_name: "ReplaceMe"
output_dir: "${{data_dir}}/Results/${{task_name}}/${{model_name}}/${{video_name}}/${{edited_video_name}}/"
image_size: [{size}, {size}]
video_name: "ReplaceMe"
video_path: "ReplaceMe"
video_frames_path: "ReplaceMe"
edited_first_frame_path: "ReplaceMe"
ddim_latents_path: "${{data_dir}}/inversions/${{model_name}}/${{video_name}}/ddim_latents"
n_frames: {frames}
cfg: 9.0
target_fps: 8
editing_prompt: "a green square"
editing_negative_prompt: ""
n_steps: {steps}
ddim_init_latents_t_idx: 0
ddim_inv_prompt: ""
random_ratio: 0.0
pnp_f_t: 0.2
pnp_spatial_attn_t: 0.2
pnp_temp_attn_t: 0.5
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Demo frames, an edited first frame and the shared ``.npz`` weights."""
    root = tmp_path_factory.mktemp("cli")
    frames_dir = root / "demo" / "square" / "frames"
    frames_dir.mkdir(parents=True)
    for i in range(N_FRAMES):
        img = np.zeros((SIZE, SIZE, 3), np.uint8)
        img[:, :, 2] = np.linspace(40, 200, SIZE, dtype=np.uint8)[None, :]
        img[20:36, 8 + 6 * i:20 + 6 * i, :2] = (230, 180)
        Image.fromarray(img).save(frames_dir / f"{i:05d}.png")
    first = np.asarray(Image.open(frames_dir / "00000.png")).copy()
    first[first[:, :, 0] > 200] = (40, 220, 60)
    Image.fromarray(first).save(root / "edited_1st.png")
    _, _, trees = tiny_models(5, eps_scale=0.1)
    save_params(str(root / "tiny.npz"), trees)
    return root


def _write(root, name, text, entries, **fmt):
    (root / f"{name}.yaml").write_text(text.format(**fmt))
    with open(root / f"{name}.json", "w") as f:
        json.dump(entries, f)
    return ["--template_config", str(root / f"{name}.yaml"),
            "--configs_json", str(root / f"{name}.json")]


def _edit(root, data_dir):
    frames_dir = str(root / "demo" / "square" / "frames")
    args = _write(root, f"edit_{os.path.basename(data_dir)}", EDIT_TEMPLATE,
                  [{"video_name": "square", "video_frames_path": frames_dir,
                    "edited_video_name": "green_square",
                    "edited_first_frame_path": str(root / "edited_1st.png")}],
                  init=root / "tiny.npz", data_dir=data_dir, size=SIZE, frames=N_FRAMES,
                  steps=STEPS)
    run_group_pnp_edit.main(args + ["--device", "cpu"])
    out_dir = os.path.join(data_dir, "Results", "Prompt-Based-Editing", "i2vgen-xl",
                           "square", "green_square")
    stem = f"cfg_9.0_steps_{STEPS}_tidx_0_pnpf_0.2_pnps_0.2_pnpt_0.5"
    assert sorted(os.listdir(out_dir)) == [stem + ".gif", stem + ".mp4", stem + "_frames"]
    assert len(os.listdir(os.path.join(out_dir, stem + "_frames"))) == N_FRAMES
    return out_dir


def _invert(root, data_dir, module, extra=()):
    frames_dir = str(root / "demo" / "square" / "frames")
    args = _write(root, f"inv_{os.path.basename(data_dir)}", INV_TEMPLATE,
                  [{"video_name": "square", "video_frames_path": frames_dir}],
                  init=root / "tiny.npz", data_dir=data_dir, size=SIZE, frames=N_FRAMES,
                  steps=STEPS)
    module.main(args + list(extra))
    cache = os.path.join(data_dir, "inversions", "i2vgen-xl", "square", "ddim_latents")
    names = sorted(f for f in os.listdir(cache) if f.startswith("ddim_latents_"))
    assert names == sorted(f"ddim_latents_{1 + 100 * i}.npy" for i in range(STEPS))
    return cache


def test_jax_inversion_then_port_edit(workspace):
    data_dir = str(workspace / "cross")
    cache = _invert(workspace, data_dir, jax_inversion)
    os.remove(os.path.join(cache, "ddim_trajectory.npz"))   # read the per-step files
    _edit(workspace, data_dir)


def test_port_inversion_writes_the_same_cache(workspace):
    data_dir = str(workspace / "port")
    cache = _invert(workspace, data_dir, run_group_ddim_inversion, ["--device", "cpu"])
    traj = np.load(os.path.join(cache, "ddim_trajectory.npz"))
    assert traj["trajectory"].shape == (STEPS, 1, N_FRAMES, SIZE // 8, SIZE // 8, 4)
    np.testing.assert_array_equal(traj["trajectory"][3],
                                  np.load(os.path.join(cache, "ddim_latents_301.npy")))
    _edit(workspace, data_dir)
