"""The port's group inversion CLI with the host-resident trajectory: the same
template with ``inverse_config.traj_store: host`` and ``chunk_steps: 2``
writes the same ``ddim_latents_{t}.npy`` files, bit for bit, as with
``"device"`` (i2vgen-tiny, seeded random weights, 4 frames at 64x64, 5
inversion steps: chunks of 2, 2 and 1)."""

import json
import os

import numpy as np
from PIL import Image

from anyv2v_torch.cli import run_group_ddim_inversion
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)

N_FRAMES, SIZE, STEPS = 4, 64, 5

TEMPLATE = """
seed: 8888
debug: False
model:
  arch: "i2vgen-tiny"
  init: "random"
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
  chunk_steps: {chunk}
  traj_store: "{store}"
recon_config:
  enable_recon: False
"""


def _invert(root, store, chunk):
    frames_dir = root / "frames"
    if not frames_dir.exists():
        frames_dir.mkdir()
        for i in range(N_FRAMES):
            img = np.zeros((SIZE, SIZE, 3), np.uint8)
            img[:, :, 2] = np.linspace(40, 200, SIZE, dtype=np.uint8)[None, :]
            img[20:36, 8 + 6 * i:20 + 6 * i, :2] = (230, 180)
            Image.fromarray(img).save(frames_dir / f"{i:05d}.png")
    data_dir = root / store
    (root / f"{store}.yaml").write_text(TEMPLATE.format(
        data_dir=data_dir, size=SIZE, frames=N_FRAMES, steps=STEPS, chunk=chunk, store=store))
    with open(root / f"{store}.json", "w") as f:
        json.dump([{"video_name": "square", "video_frames_path": str(frames_dir)}], f)
    run_group_ddim_inversion.main(["--template_config", str(root / f"{store}.yaml"),
                                   "--configs_json", str(root / f"{store}.json"),
                                   "--device", "cpu"])
    cache = os.path.join(data_dir, "inversions", "i2vgen-xl", "square", "ddim_latents")
    return {name: np.load(os.path.join(cache, name)) for name in os.listdir(cache)
            if name.startswith("ddim_latents_")}


def test_host_store_writes_the_same_cache(tmp_path):
    device = _invert(tmp_path, "device", "null")
    host = _invert(tmp_path, "host", 2)
    assert sorted(host) == sorted(device) == sorted(
        f"ddim_latents_{1 + 200 * i}.npy" for i in range(STEPS))
    for name, row in device.items():
        assert row.shape == (1, N_FRAMES, SIZE // 8, SIZE // 8, 4)
        np.testing.assert_array_equal(host[name], row)
