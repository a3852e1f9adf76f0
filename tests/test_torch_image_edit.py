"""The port's InstructPix2Pix and CosXL editors against the JAX package, fp32
on the CPU, and the behaviour of ``anyv2v_torch.cli.edit_image``.

- Both edit scans run 3 steps from JAX's initial latent (and, for the
  Euler-Ancestral scan, JAX's per-step noises) on the same weights; the
  posterior-mode encode and the decode are held against the JAX pipeline's
  ``_encode_mode`` and ``_decode``.
- The CLI writes ``<prompt>.png`` at the source size (with ``--force_512``
  too), keeps an existing result, and in ``--dict_file`` mode picks each
  entry's model.

Tolerances: rtol and atol 1e-4 for the scans and the encode, one 8-bit
level for decoded images.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from anyv2v_tpu.models import unet_sd as jsd
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from anyv2v_tpu.pipelines import image_edit as jedit
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.schedulers import euler as jeuler
from anyv2v_torch.cli import edit_image
from anyv2v_torch.pipelines.image_edit import CosXLEditPipeline, InstructPix2PixPipeline
from anyv2v_torch.schedulers import make_schedule
from anyv2v_torch.utils.model_zoo import ARCHS
from test_torch_sd_unet import editor_models, jax_sd_config
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)


def jax_vae(cfg):
    return JVAE(JVAEConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(JVAEConfig) if f.name != "dtype"},
                           dtype=jnp.float32))


@pytest.fixture(scope="module")
def ip2p():
    modules, _, trees = editor_models("instructpix2pix-tiny", seed=20)
    port = InstructPix2PixPipeline(unet=modules["unet"], vae=modules["vae"],
                                   text_encoder=modules["text"], schedule=make_schedule(),
                                   device=torch.device("cpu"), dtype=torch.float32)
    jax_pipe = jedit.InstructPix2PixPipeline(
        unet=jsd.SDUNet(jax_sd_config(ARCHS["instructpix2pix-tiny"]["unet"])),
        vae=jax_vae(ARCHS["instructpix2pix-tiny"]["vae"]), text_encoder=None,
        schedule=jax_make_schedule(), params=trees)
    return port, jax_pipe


@pytest.fixture(scope="module")
def cosxl():
    modules, _, trees = editor_models("cosxl-tiny", seed=30)
    port = CosXLEditPipeline(unet=modules["unet"], vae=modules["vae"], schedule=make_schedule(),
                             device=torch.device("cpu"), dtype=torch.float32)
    jax_pipe = jedit.CosXLEditPipeline(
        unet=jsd.SDUNet(jax_sd_config(ARCHS["cosxl-tiny"]["unet"])),
        vae=jax_vae(ARCHS["cosxl-tiny"]["vae"]), schedule=jax_make_schedule(), params=trees)
    return port, jax_pipe


def _image(seed, size=64):
    return np.random.RandomState(seed).rand(size, size, 3).astype(np.float32)


def test_ip2p_encode_and_decode_match_jax(ip2p):
    port, jp = ip2p
    img = _image(1)[None]
    want = jp._encode_mode(jp.params, jnp.asarray(img))
    got = port.encode_mode(img)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lat = np.random.RandomState(2).randn(1, 8, 8, 4).astype(np.float32)
    want = jp._decode(jp.params, jnp.asarray(lat))
    got = port.decode(lat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1 / 255)


def test_ip2p_edit_scan_matches_jax(ip2p):
    """Three Euler-Ancestral steps of a 3-step grid at guidance 7.5 / image
    guidance 1.5, JAX's initial latent and noises passed in."""
    port, jp = ip2p
    grid = jeuler.euler_ancestral_grid(jp.schedule, 3)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    init = jax.random.normal(k1, (1, 8, 8, 4)) * grid.init_noise_sigma
    noises = jax.random.normal(k2, (3, 1, 8, 8, 4))
    img_lat = jp._encode_mode(jp.params, jnp.asarray(_image(4)[None]))
    text3 = np.random.RandomState(5).randn(3, 7, 16).astype(np.float32)
    want = jp._edit_scan(jp.params, init, img_lat, jnp.asarray(text3), jnp.asarray(grid.sigmas),
                         noises, jnp.float32(7.5), jnp.float32(1.5))
    got = port.edit_scan(np.array(init), np.array(img_lat), text3, grid.sigmas, 7.5, 1.5,
                         noises=torch.from_numpy(np.array(noises)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want) - np.asarray(init)).max()) > 0.1


def test_cosxl_edit_scan_matches_jax(cosxl):
    """Three EDM v-prediction steps of a 3-step grid (sigma 120 -> 0.002 -> 0)
    at guidance 7 / image guidance 1.5, with SDXL's time ids and pooled
    embedding; JAX's initial latent passed in."""
    port, jp = cosxl
    grid = jeuler.edm_grid(3)
    init = jax.random.normal(jax.random.PRNGKey(6), (1, 8, 8, 4)) * grid.init_noise_sigma
    img_lat = jp._encode_mode(jp.params, jnp.asarray(_image(7)[None]))
    rng = np.random.RandomState(8)
    text3 = rng.randn(3, 7, 16).astype(np.float32)
    pooled3 = rng.randn(3, 16).astype(np.float32)
    ids3 = np.tile(np.float32([[64, 64, 0, 0, 64, 64]]), (3, 1))
    want = jp._edit_scan(jp.params, init, img_lat, jnp.asarray(text3), jnp.asarray(pooled3),
                         jnp.asarray(ids3), jnp.asarray(grid.sigmas), jnp.float32(7.0),
                         jnp.float32(1.5))
    got = port.edit_scan(np.array(init), np.array(img_lat), text3, pooled3, ids3,
                         grid.sigmas, 7.0, 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jp._decode(jp.params, want)
    np.testing.assert_allclose(port.decode(got).numpy(), np.asarray(want), rtol=0, atol=1 / 255)


def test_edit_is_seeded_and_finite(ip2p, cosxl):
    """``edit`` draws its initial latent and ancestral noise from the seed:
    the same seed gives the same image, another seed another."""
    port = ip2p[0]
    text3 = torch.randn(3, 7, 16, generator=torch.Generator().manual_seed(9))
    a, b = (port.edit(_image(10), text3, num_inference_steps=2, seed=s) for s in (1, 1))
    c = port.edit(_image(10), text3, num_inference_steps=2, seed=2)
    assert a.shape == (64, 64, 3) and torch.equal(a, b) and not torch.equal(a, c)
    out = cosxl[0].edit(_image(11, 32), torch.zeros(3, 7, 16), torch.zeros(3, 16),
                        num_inference_steps=2)
    assert out.shape == (32, 32, 3) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _video_dir(root, name, w, h, seed):
    d = os.path.join(root, name)
    os.makedirs(d)
    for i in range(2):
        Image.fromarray((np.random.RandomState(seed + i).rand(h, w, 3) * 255).astype(np.uint8)
                        ).save(os.path.join(d, f"{i:05d}.png"))
    return d


@pytest.mark.parametrize("model", ["instructpix2pix", "cosxl"])
def test_cli_writes_prompt_png_at_source_size(tmp_path, model):
    """``<prompt>.png`` at the frame's size (sides that the UNet's levels
    halve evenly); a second run keeps it."""
    video = _video_dir(str(tmp_path), "v", 128, 64, 12)
    out = str(tmp_path / "out")
    argv = ["--model", model, "--arch_suffix", "-tiny", "--device", "cpu", "--video_path", video,
            "--output_dir", out, "--prompt", "make it snow", "--num_inference_steps", "2"]
    edit_image.main(argv)
    path = os.path.join(out, "make it snow.png")
    with Image.open(path) as im:
        assert im.size == (128, 64)
    stamp = os.path.getmtime(path)
    os.utime(path, (stamp - 100, stamp - 100))
    edit_image.main(argv)
    assert os.path.getmtime(path) == stamp - 100


def test_cli_force_512_and_dict_file(tmp_path, monkeypatch):
    """``--force_512`` edits at 512x512 and resizes back; ``--dict_file``
    builds each entry's model and skips entries without an instruction."""
    root = str(tmp_path)
    _video_dir(root, "a", 64, 128, 13)
    _video_dir(root, "b", 32, 32, 14)
    spec = {"a": [{"image_model": "cosxl", "instruction": "cosxl edit"},
                  {"image_model": "magicbrush", "target_caption": "brush edit"}],
            "b": [{"image_model": "instructpix2pix"}]}
    with open(os.path.join(root, "d.json"), "w") as f:
        json.dump(spec, f)
    sizes, built = [], []
    edit = edit_image.edit_frame
    build = edit_image.build_model

    def spy_edit(model, image01, *args, **kw):
        sizes.append(image01.shape[:2])
        return edit(model, image01, *args, **kw)

    def spy_build(name, *args, **kw):
        built.append(name)
        return build(name, *args, **kw)

    monkeypatch.setattr(edit_image, "edit_frame", spy_edit)
    monkeypatch.setattr(edit_image, "build_model", spy_build)
    edit_image.main(["--dict_file", os.path.join(root, "d.json"), "--input_dir", root,
                     "--arch_suffix", "-tiny", "--device", "cpu", "--num_inference_steps", "1"])
    assert built == ["cosxl", "magicbrush"]
    for name in ("cosxl edit", "brush edit"):
        with Image.open(os.path.join(root, f"{name}.png")) as im:
            assert im.size == (64, 128)
    assert not [f for f in os.listdir(root) if f.endswith(".png")][2:]
    video = os.path.join(root, "a")
    edit_image.main(["--model", "instructpix2pix", "--arch_suffix", "-tiny", "--device", "cpu",
                     "--video_path", video, "--prompt", "big", "--force_512",
                     "--num_inference_steps", "1"])
    assert sizes[-1] == (512, 512)
    with Image.open(os.path.join(root, "big.png")) as im:
        assert im.size == (64, 128)
