"""The ConsistI2V CLIs across packages on consisti2v-tiny, fp32 on the CPU.

Both packages load the same weights: a JAX ``save_params`` ``.npz`` made from
seeded port weights through the JAX converters. The JAX inversion CLI writes
the ``ddim_latents_{t}.npy`` cache; the port's edit CLI reads those per-step
files (the consolidated file is removed first) and writes the JAX CLI's
output names; the port's inversion CLI writes the same cache within 1e-4.
Both edit CLIs on that cache (``blend_ratio: 0``) write the same frames: the
PNGs differ by at most 1 of 255 (latents within 1e-4 can round to
neighbouring 8-bit levels). The inversion CLI's reconstruction passes every
``recon_config`` knob, and with the cached start latent the pyoco and
FreeInit knobs change nothing, as in the JAX CLI.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from anyv2v_tpu.cli import consisti2v_run_ddim_inversion as jax_inversion
from anyv2v_tpu.cli import consisti2v_run_pnp_edit as jax_edit
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.cli import consisti2v_run_ddim_inversion, consisti2v_run_pnp_edit
from anyv2v_torch.pipelines.consisti2v import ConsistI2VPipeline
from anyv2v_torch.utils.io import load_ddim_trajectory
from test_torch_consisti2v import TOL, tiny_trees
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)

F, HW, INV_STEPS, EDIT_STEPS = 3, 64, 10, 5


INV_YAML = """
seed: 8888
debug: False
model: {{arch: "consisti2v-tiny", init: "{init}", dtype: "float32", tokenizer_path: null,
        scheduler: {{}}}}
exp_name: "square"
output_dir: "{root}/out"
image_size: [{size}, {size}]
video_name: "square"
video_path: "ReplaceMe"
video_frames_path: "{frames}"
n_frames: {n}
inverse_config:
  frame_stride: 3
  prompt: ""
  n_steps: {steps}
  output_dir: "{root}/ddim_latents"
recon_config:
  enable_recon: False
"""

EDIT_YAML = """
seed: 8888
debug: False
model: {{arch: "consisti2v-tiny", init: "{init}", dtype: "float32", tokenizer_path: null,
        scheduler: {{}}}}
output_dir: "{root}/edit"
image_size: [{size}, {size}]
video_name: "square"
video_path: "ReplaceMe"
video_frames_path: "{frames}"
edited_first_frame_path: "{root}/edited_1st.png"
n_frames: {n}
cfg_txt: 7.5
cfg_img: 1.0
frame_stride: 3
editing_prompt: ""
editing_negative_prompt: ""
n_steps: {edit_steps}
ddim_init_latents_t_idx: 0
ddim_inv_prompt: ""
ddim_latents_path: "{root}/ddim_latents"
pnp_f_t: 0.2
pnp_spatial_attn_t: 0.2
pnp_temp_attn_t: 0.5
blend_ratio: 0.0
"""


@pytest.fixture(scope="module")
def cli_workspace(tmp_path_factory):
    """Demo frames, an edited first frame, the shared ``.npz`` weights and the
    two YAMLs; the JAX inversion CLI's cache."""
    root = tmp_path_factory.mktemp("consisti2v_cli")
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
               steps=INV_STEPS, edit_steps=EDIT_STEPS)
    (root / "inv.yaml").write_text(INV_YAML.format(**fmt))
    (root / "edit.yaml").write_text(EDIT_YAML.format(**fmt))
    jax_inversion.main(["--config", str(root / "inv.yaml")])
    return root


def test_jax_inversion_then_port_edit(cli_workspace):
    root = cli_workspace
    cache = root / "ddim_latents"
    names = sorted(f for f in os.listdir(cache) if f.startswith("ddim_latents_"))
    assert names == sorted(f"ddim_latents_{1 + 100 * i}.npy" for i in range(INV_STEPS))
    os.remove(cache / "ddim_trajectory.npz")   # the port reads the per-step files
    consisti2v_run_pnp_edit.main(["--config", str(root / "edit.yaml"), "--device", "cpu",
                                  "seed=8888"])
    stem = f"cfgtxt_7.5_cfgimg_1.0_steps_{EDIT_STEPS}_tidx_0"
    out = root / "edit"
    assert sorted(os.listdir(out)) == [stem + ".gif", stem + ".mp4", stem + "_frames"]
    assert len(os.listdir(out / (stem + "_frames"))) == F


def test_port_inversion_cli_writes_the_same_cache(cli_workspace):
    """The port's inversion CLI (with the reconstruction on) writes the cache
    the JAX CLI wrote, within the pipeline tolerance."""
    root = cli_workspace
    consisti2v_run_ddim_inversion.main([
        "--config", str(root / "inv.yaml"), "--device", "cpu",
        f"inverse_config.output_dir={root}/port_latents", "recon_config.enable_recon=true",
        "recon_config.n_steps=5", f"output_dir={root}/port_out"])
    traj, ts = load_ddim_trajectory(str(root / "port_latents"), per_step_files=True)
    want, want_ts = load_ddim_trajectory(str(root / "ddim_latents"), per_step_files=True)
    np.testing.assert_array_equal(ts, want_ts)
    np.testing.assert_allclose(traj, want, **TOL)
    assert sorted(os.listdir(root / "port_out")) == ["ddim_reconstruction.gif",
                                                   "ddim_reconstruction.mp4"]


def read_frames(folder):
    """The PNG frames a CLI wrote, ``[F, H, W, 3]`` uint8 as int."""
    names = sorted(os.listdir(folder))
    return np.stack([np.asarray(Image.open(os.path.join(folder, n))) for n in names]).astype(int)


def test_edit_clis_write_the_same_frames(cli_workspace, monkeypatch):
    """Both edit CLIs on the JAX inversion cache at ``blend_ratio: 0``: the
    written frames differ by at most one 8-bit level. The JAX edit runs with
    traced PnP flags (one compile per batch), as the pipeline tests run it."""
    root = cli_workspace
    consisti2v_run_pnp_edit.main(["--config", str(root / "edit.yaml"), "--device", "cpu",
                                  f"output_dir={root}/port_edit"])
    monkeypatch.setenv("ANYV2V_PNP_STATIC", "0")
    jax_edit.main(["--config", str(root / "edit.yaml"), f"output_dir={root}/jax_edit"])
    stem = f"cfgtxt_7.5_cfgimg_1.0_steps_{EDIT_STEPS}_tidx_0_frames"
    got, want = read_frames(root / "port_edit" / stem), read_frames(root / "jax_edit" / stem)
    assert got.shape == want.shape == (F, HW, HW, 3)
    assert np.abs(got - want).max() <= 1


def test_reconstruction_passes_the_noise_knobs(cli_workspace, monkeypatch):
    """The inversion CLI's reconstruction hands ``noise_alpha`` and the
    FreeInit level to the pipeline (the port used to drop ``noise_alpha``
    and raise on pyoco and FreeInit), and, started from the cached latent,
    gives the vanilla reconstruction bit for bit."""
    root = cli_workspace
    calls = []
    orig = ConsistI2VPipeline.sample

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls.append((kw, out))
        return out

    monkeypatch.setattr(ConsistI2VPipeline, "sample", spy)
    base = ["--config", str(root / "inv.yaml"), "--device", "cpu",
            f"inverse_config.output_dir={root}/recon_latents", "recon_config.enable_recon=true",
            "recon_config.n_steps=5", "recon_config.cfg_img=1.5", "recon_config.cfg_txt=2.0"]
    consisti2v_run_ddim_inversion.main(base + [f"output_dir={root}/recon_vanilla"])
    consisti2v_run_ddim_inversion.main(base + [
        f"output_dir={root}/recon_knobs", "recon_config.noise_sampling_method=pyoco_progressive",
        "recon_config.noise_alpha=0.5", "recon_config.use_frameinit=true",
        "recon_config.frameinit_noise_level=900"])
    (vanilla_kw, vanilla), (knobs_kw, knobs) = calls
    assert vanilla_kw["noise_sampling_method"] == "vanilla" and vanilla_kw["noise_alpha"] == 1.0
    assert knobs_kw["noise_sampling_method"] == "pyoco_progressive"
    assert knobs_kw["noise_alpha"] == 0.5 and knobs_kw["use_frameinit"] is True
    assert knobs_kw["frameinit_noise_level"] == 900
    assert knobs_kw["init_latent"] is not None and np.isfinite(knobs.numpy()).all()
    assert torch.equal(vanilla, knobs)
