"""The port's ``Predictor`` against the JAX one (``anyv2v_tpu.product.predictor``),
fp32 on the CPU, on i2vgen-tiny and instructpix2pix-tiny with the weights of
``test_torch_product.py`` (seeded port modules carried to JAX by the
converters and injected into the JAX predictor's fields ``runner`` and
``image_editor``).

One JAX request (``predict`` on a 4-frame 64x64 mp4, 2 editor steps, the
Predictor's PnP thresholds 1.0 / 1.0 / 1.0) is the reference for both
levels of the port, whose editor takes JAX's draws:

- ``predict``: the written ``edited_first_frame.png`` and the frames handed
  to the mp4 writer within one 8-bit level of JAX's;
- ``predict_arrays``: the edited first frame within one 8-bit level of
  JAX's, and a finite video of the source's shape.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from anyv2v_tpu.models.clip import CLIPTextModel as JCLIPText
from anyv2v_tpu.models import unet_sd as jsd
from anyv2v_tpu.pipelines import image_edit as jedit
from anyv2v_tpu.product import predictor as jpredictor
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.utils import io as jio
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.pipelines.image_edit import InstructPix2PixPipeline
from anyv2v_torch.product import Predictor
from anyv2v_torch.schedulers import make_schedule
from anyv2v_torch.utils import io as vio
from anyv2v_torch.utils.model_zoo import ARCHS
from test_torch_image_edit import jax_vae
from test_torch_product import F, HW, _runners, _Written
from test_torch_product import files, models  # noqa: F401 (fixtures)
from test_torch_sd_unet import editor_models, jax_sd_config
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

EDITOR = "instructpix2pix-tiny"
STEPS, SEED = 2, 5
REQUEST = dict(num_inference_steps=5, ddim_inversion_steps=10, image_edit_steps=STEPS,
               seed=SEED)


def _jax_draws():
    """JAX's editor draws for ``SEED``: the unscaled initial latent, then one
    noise per step (``InstructPix2PixPipeline.edit``)."""
    k_init, k_steps = jax.random.split(jax.random.PRNGKey(SEED))
    shape = (1, HW // 8, HW // 8, 4)
    init = jax.random.normal(k_init, shape, jnp.float32)
    noises = jax.random.normal(k_steps, (STEPS, *shape), jnp.float32)
    return [torch.from_numpy(np.array(a)) for a in (init, *noises)]


@pytest.fixture(scope="module")
def predictors(models):  # noqa: F811
    """(port Predictor, JAX Predictor) on the same weights, without setup."""
    emods, _, etrees = editor_models(EDITOR, seed=20)
    editor = InstructPix2PixPipeline(unet=emods["unet"], vae=emods["vae"],
                                     text_encoder=emods["text"], schedule=make_schedule(),
                                     device=torch.device("cpu"), dtype=torch.float32)
    jeditor = jedit.InstructPix2PixPipeline(
        unet=jsd.SDUNet(jax_sd_config(ARCHS[EDITOR]["unet"])), vae=jax_vae(ARCHS[EDITOR]["vae"]),
        text_encoder=JCLIPText(jzoo.IMAGE_EDIT_ARCHS[EDITOR]["text"]),
        schedule=jax_make_schedule(), params=etrees)
    runner, jrunner = _runners(models)
    p, jp = Predictor(), jpredictor.Predictor()
    p.runner, p.image_editor, p.tokenizer = runner, editor, None
    jp.runner, jp.image_editor, jp.tokenizer = jrunner, jeditor, None
    return p, jp


@pytest.fixture(scope="module")
def jax_request(predictors, files, tmp_path_factory):  # noqa: F811
    """JAX's answer: (edited first frame, frames handed to the mp4 writer),
    both as 8-bit levels."""
    _, jp = predictors
    out = tmp_path_factory.mktemp("jax_predict")
    with pytest.MonkeyPatch.context() as mp:
        written = _Written(jio.save_video)
        mp.setattr(jio, "save_video", written)
        jp.predict(str(files / "source.mp4"), "make it green", "a green square",
                   out_dir=str(out), **REQUEST)
    return np.asarray(Image.open(out / "edited_first_frame.png"), np.int32), written.levels()


def _take_jax_draws(monkeypatch, editor):
    draws = iter(_jax_draws())
    monkeypatch.setattr(editor, "_noise", lambda shape, generator: next(draws))
    return draws


def test_predict_matches_jax(predictors, jax_request, files, tmp_path, monkeypatch):  # noqa: F811
    p, _ = predictors
    draws = _take_jax_draws(monkeypatch, p.image_editor)
    written = _Written(vio.save_video)
    monkeypatch.setattr(vio, "save_video", written)
    got = p.predict(str(files / "source.mp4"), "make it green", "a green square",
                    out_dir=str(tmp_path), **REQUEST)
    assert got == str(tmp_path / "edited_video.mp4") and os.path.exists(got)
    assert next(draws, None) is None   # the port's editor took every JAX draw
    png = np.asarray(Image.open(tmp_path / "edited_first_frame.png"), np.int32)
    want_png, want_video = jax_request
    assert png.shape == (HW, HW, 3) and np.abs(png - want_png).max() <= 1
    assert np.abs(written.levels() - want_video).max() <= 1


def test_predict_arrays_edits_the_first_frame_as_jax(predictors, jax_request, files,  # noqa: F811
                                                     monkeypatch):
    """The array-level request on the frames the mp4 decodes to: the edited
    first frame, kept in memory, within one 8-bit level of JAX's PNG; the
    runner's pipeline is the one built before."""
    from anyv2v_torch.product.anyv2v import read_frames01

    p, _ = predictors
    draws = _take_jax_draws(monkeypatch, p.image_editor)
    pipe = p.runner.pipeline()
    frames01 = read_frames01(str(files / "source.mp4"))
    video, edited01 = p.predict_arrays(frames01, "make it green", "a green square", **REQUEST)
    assert next(draws, None) is None
    levels = (edited01 * 255).astype(np.uint8).astype(np.int32)
    assert np.abs(levels - jax_request[0]).max() <= 1
    assert tuple(video.shape) == (F, HW, HW, 3) and bool(torch.isfinite(video).all())
    assert p.runner._pipe is pipe
