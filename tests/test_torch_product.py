"""The port's product layer (``anyv2v_torch.product``) against the JAX one
(``anyv2v_tpu.product``), fp32 on the CPU, on i2vgen-tiny.

Both packages run the same weights: seeded port modules, carried to JAX by
the converters and injected into the JAX runner's field ``_pipe``, so the
JAX package is used as it is and never initialised at random.

- The runner's array-level core (``edit_arrays``) against JAX
  ``perform_anyv2v`` on the same PNG frames and edited first frame, at
  ``random_ratio`` 0 and 0.3 with JAX's draw passed in as ``noise=``: the
  decoded video (as JAX hands it to ``save_video``) and the trajectory
  within rtol = atol = 1e-4.
- The file-level runner against JAX on a 4-frame 64x64 mp4: the frames each
  package hands to its mp4 writer, as 8-bit levels, differ by at most one
  (latents within 1e-4 can round to neighbouring levels).
- ``run_headless`` for the three demo variants, one build per runner, and
  the default device.

``Predictor.predict`` is held against JAX in ``test_torch_predictor.py``
(a file of its own, so that its JAX compiles run on another worker).

The random UNets' output convs are scaled by 0.1, so that guidance keeps the
latents of order one (see ``test_torch_pipeline.py``). JAX's PnP edit runs
with traced flags (``ANYV2V_PNP_STATIC=0``: one compile per batch).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from anyv2v_tpu.models.clip import CLIPTextModel as JCLIPText, CLIPVisionModel as JCLIPVision
from anyv2v_tpu.models.unet_i2vgen import I2VGenUNet as JUNet
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE
from anyv2v_tpu.pipelines.i2vgen import I2VGenPipeline as JPipeline
from anyv2v_tpu.product import anyv2v as janyv2v
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.utils import io as jio
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.pipelines.i2vgen import I2VGenPipeline
from anyv2v_torch.product import AnyV2VRunner, Predictor, run_headless
from anyv2v_torch.schedulers import make_schedule
from anyv2v_torch.utils import io as vio
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)
from test_torch_unet import jax_tiny_config, tiny_models
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
F, HW = 4, 64
RUN = dict(ddim_inversion_steps=10, num_inference_steps=5, guidance_scale=9.0,
           conv_inj=0.2, spatial_inj=0.2, temp_inj=0.5, seed=7)


def _source(seed=0):
    """A seeded moving square over a gradient, ``[F, HW, HW, 3]`` uint8."""
    video = np.zeros((F, HW, HW, 3), np.uint8)
    video[..., 2] = np.linspace(40, 200, HW, dtype=np.uint8)[None, None, :]
    for i in range(F):
        video[i, 20:36, 8 + 6 * i:20 + 6 * i, :2] = (230, 180)
    video[..., 1] += np.random.RandomState(seed).randint(0, 20, (F, HW, HW), dtype=np.uint8)
    return video


@pytest.fixture(scope="module")
def models():
    """(port video pipeline, JAX video pipeline) on the same weights."""
    modules, _, trees = tiny_models(3, eps_scale=0.1)
    port = I2VGenPipeline(unet=modules["unet"], vae=modules["vae"],
                          text_encoder=modules["text"], vision_encoder=modules["vision"],
                          schedule=make_schedule(), device=torch.device("cpu"),
                          dtype=torch.float32)
    jpipe = JPipeline(
        unet=JUNet(jax_tiny_config("unet")), vae=JVAE(jax_tiny_config("vae")),
        text_encoder=JCLIPText(jzoo.I2VGEN_TINY["text"]),
        vision_encoder=JCLIPVision(jzoo.I2VGEN_TINY["vision"]),
        schedule=jax_make_schedule(),
        params={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in trees.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANYV2V_PNP_STATIC", "0")
        yield port, jpipe


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The source as PNG frames and as an mp4, and an edited first frame."""
    root = tmp_path_factory.mktemp("product")
    video = _source()
    os.makedirs(root / "frames")
    for i, frame in enumerate(video):
        Image.fromarray(frame).save(root / "frames" / f"{i:05d}.png")
    vio.save_video(video / 255.0, str(root / "source.mp4"), fps=8)
    edited = video[0].copy()
    edited[edited[:, :, 0] > 200] = (40, 220, 60)
    Image.fromarray(edited).save(root / "edited.png")
    return root


def _runners(models):
    port, jpipe = models
    runner = AnyV2VRunner(arch="i2vgen-tiny", dtype="float32", device="cpu", _pipe=port)
    jrunner = janyv2v.AnyV2VRunner(arch="i2vgen-tiny", dtype="float32", _pipe=jpipe)
    return runner, jrunner


class _Written:
    """Records the frames a ``save_video`` receives, as the 8-bit levels it
    writes, and writes them."""

    def __init__(self, save_video):
        self.save_video, self.frames = save_video, []

    def __call__(self, frames01, path, fps=8):
        self.frames.append(np.asarray(frames01, np.float32))
        self.save_video(frames01, path, fps=fps)

    def levels(self):
        return (np.clip(self.frames[-1], 0, 1) * 255).astype(np.uint8).astype(np.int32)


@pytest.mark.parametrize("random_ratio", [0.0, 0.3])
def test_runner_core_matches_jax(models, files, tmp_path, monkeypatch, random_ratio):
    runner, jrunner = _runners(models)
    written = _Written(jio.save_video)
    monkeypatch.setattr(jio, "save_video", written)
    jrunner.perform_anyv2v(str(files / "frames"), "a green square", "",
                           str(files / "edited.png"), random_ratio=random_ratio,
                           out_dir=str(tmp_path), save_latents=True, **RUN)
    cache = np.load(tmp_path / "ddim_latents" / "ddim_trajectory.npz")

    frames01 = _source() / np.float32(255.0)
    edited01 = vio.image_to_array01(Image.open(files / "edited.png"))
    noise = None
    if random_ratio:
        shape = (1, F, HW // 8, HW // 8, 4)
        noise = np.array(jax.random.normal(jax.random.PRNGKey(RUN["seed"]), shape,
                                           jnp.float32))
    video, traj, inv_ts = runner.edit_arrays(frames01, edited01, "a green square", "",
                                             random_ratio=random_ratio, noise=noise, **RUN)
    assert traj.device.type == "cpu" and torch.is_tensor(traj)
    np.testing.assert_array_equal(inv_ts, cache["timesteps"])
    np.testing.assert_allclose(traj.numpy(), cache["trajectory"], **TOL)
    assert video.shape == (F, HW, HW, 3)
    np.testing.assert_allclose(video.numpy(), written.frames[-1], **TOL)


def test_file_level_runner_matches_jax(models, files, tmp_path, monkeypatch):
    runner, jrunner = _runners(models)
    jwritten, written = _Written(jio.save_video), _Written(vio.save_video)
    monkeypatch.setattr(jio, "save_video", jwritten)
    monkeypatch.setattr(vio, "save_video", written)
    mp4 = str(files / "source.mp4")
    want = jrunner.perform_anyv2v(mp4, "", "", str(files / "edited.png"),
                                  out_dir=str(tmp_path / "jax"), **RUN)
    got = runner.perform_anyv2v(mp4, "", "", str(files / "edited.png"),
                                out_dir=str(tmp_path / "port"), save_latents=True, **RUN)
    assert got == str(tmp_path / "port" / "edited_video.mp4") and os.path.exists(got)
    assert os.path.basename(want) == os.path.basename(got)
    assert len(os.listdir(tmp_path / "port" / "ddim_latents")) == RUN["ddim_inversion_steps"] + 2
    assert written.levels().shape == (F, HW, HW, 3)
    assert np.abs(written.levels() - jwritten.levels()).max() <= 1


@pytest.mark.parametrize("variant,editor", [("instructpix2pix", "instructpix2pix-tiny"),
                                            ("cosxl", "cosxl-tiny"),
                                            ("style", "instantstyle-tiny")])
def test_run_headless_variants(files, tmp_path, variant, editor):
    """The three demo stages (a preprocessing crop included) on tiny archs
    with random weights, for each variant."""
    out = run_headless(
        str(files / "source.mp4"), "a green square", "make it green", variant=variant,
        editor=editor, out_dir=str(tmp_path), device="cpu",
        preprocess=dict(width=64, height=64, n_frames=F, use_full_clip=True),
        runner_kwargs=dict(arch="i2vgen-tiny", dtype="float32"),
        ddim_inversion_steps=10, num_inference_steps=5, image_edit_steps=2)
    assert out == str(tmp_path / "edited_video.mp4") and os.path.exists(out)
    assert os.path.exists(tmp_path / "edited_first_frame.png")
    assert os.listdir(tmp_path / "preprocessed")


def test_runner_builds_once():
    runner = AnyV2VRunner(arch="i2vgen-tiny", dtype="float32", device="cpu")
    pipe = runner.pipeline()
    assert runner.pipeline() is pipe
    frames01 = _source()[:2] / np.float32(255.0)
    for seed in (1, 2):
        video, _, _ = runner.edit_arrays(frames01, frames01[0, ::-1], "", seed=seed,
                                         random_ratio=0.5, ddim_inversion_steps=2,
                                         num_inference_steps=2)
        assert runner._pipe is pipe and bool(torch.isfinite(video).all())


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA GPU")
    assert AnyV2VRunner().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        AnyV2VRunner(arch="i2vgen-tiny").pipeline()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Predictor().setup(arch="i2vgen-tiny", image_edit_arch="instructpix2pix-tiny")
