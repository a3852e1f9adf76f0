"""The scheduler options and the small public helpers of the port against the
JAX package: the cosine and trained betas, ``clip_sample`` in the DDIM and
DDPM steps, the Frechet distance, the per-t cache loader, the bilinear
resize, the ``seq_pos`` rotary and the VAE's posterior draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from anyv2v_torch.models.vae import sample_from_moments
from anyv2v_torch.ops import rotary as trot
from anyv2v_torch.schedulers import ddim_step, ddpm_step, make_schedule
from anyv2v_torch.utils import io as tio
from anyv2v_torch.utils import metrics as tmet
from anyv2v_tpu.models import vae as jvae
from anyv2v_tpu.ops import rotary as jrot
from anyv2v_tpu.schedulers import ddim as jddim
from anyv2v_tpu.schedulers import ddpm as jddpm
from anyv2v_tpu.schedulers import schedules as jsched
from anyv2v_tpu.utils import io as jio
from anyv2v_tpu.utils import metrics as jmet


def test_cosine_betas_match_jax_exactly():
    np.testing.assert_array_equal(
        make_schedule(beta_schedule="squaredcos_cap_v2").alphas_cumprod.numpy(),
        np.asarray(jsched.make_schedule(beta_schedule="squaredcos_cap_v2").alphas_cumprod))


def test_trained_betas_match_jax_exactly():
    betas = np.linspace(1e-4, 0.03, 1000) ** 1.5
    np.testing.assert_array_equal(make_schedule(trained_betas=betas).alphas_cumprod.numpy(),
                                  np.asarray(jsched.make_schedule(trained_betas=betas)
                                             .alphas_cumprod))


def test_thresholding_is_stored():
    assert make_schedule(thresholding=True).thresholding
    assert not make_schedule().clip_sample


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_clip_sample_steps_match_jax(sampler, prediction_type):
    """Outputs large enough that x0 leaves [-0.5, 0.5]: the clipped steps
    differ from the unclipped ones and must equal JAX's within 1e-6."""
    kw = dict(clip_sample=True, clip_sample_range=0.5, prediction_type=prediction_type)
    ts, js = make_schedule(**kw), jsched.make_schedule(**kw)
    rng = np.random.RandomState(3)
    x, eps, noise = (rng.randn(1, 2, 4, 4, 4).astype(np.float32) for _ in range(3))
    for t, t_prev in ((981, 961), (501, 481), (21, 1)):
        if sampler == "ddim":
            got = ddim_step(ts, torch.from_numpy(x), torch.from_numpy(eps), t, t_prev)
            want = jddim.ddim_step(js, jnp.asarray(x), jnp.asarray(eps), t, t_prev)
            free = ddim_step(make_schedule(prediction_type=prediction_type),
                             torch.from_numpy(x), torch.from_numpy(eps), t, t_prev)
        else:
            got = ddpm_step(ts, torch.from_numpy(x), torch.from_numpy(eps), t, t_prev,
                            torch.from_numpy(noise))
            want = jddpm.ddpm_step(js, jnp.asarray(x), jnp.asarray(eps), t, t_prev,
                                   jnp.asarray(noise))
            free = ddpm_step(make_schedule(prediction_type=prediction_type),
                             torch.from_numpy(x), torch.from_numpy(eps), t, t_prev,
                             torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        assert (got - free).abs().max() > 1e-3


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(64, 6), rng.randn(64, 6) * 1.3 + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    assert tmet.frechet_distance(*args) == pytest.approx(jmet.frechet_distance(*args), rel=1e-12)
    assert tmet.frechet_distance(args[0], args[1], args[0], args[1]) == pytest.approx(0, abs=1e-8)


def test_load_ddim_latents_at_t_matches_jax(tmp_path):
    traj = np.random.RandomState(1).randn(3, 1, 2, 4, 4, 4).astype(np.float32)
    tio.save_ddim_trajectory(str(tmp_path), traj, np.array([1, 21, 41]))
    np.testing.assert_array_equal(tio.load_ddim_latents_at_t(21, str(tmp_path)),
                                  jio.load_ddim_latents_at_t(21, str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        tio.load_ddim_latents_at_t(7, str(tmp_path))


def test_resize_bilinear_matches_jax():
    img = Image.fromarray((np.random.RandomState(2).rand(24, 40, 3) * 255).astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(tio.resize_bilinear(img, (16, 12))),
                                  np.asarray(jio.resize_bilinear(img, (16, 12))))


@pytest.mark.parametrize("seq_pos", [None, np.array([0, 1, 2, 0, 0], np.float32)])
def test_rotate_queries_or_keys_matches_jax(seq_pos):
    x = np.random.RandomState(4).randn(2, 3, 5, 16).astype(np.float32)
    freqs = trot.rotary_freqs(16)
    got = trot.rotate_queries_or_keys(torch.from_numpy(x), freqs,
                                      None if seq_pos is None else torch.from_numpy(seq_pos))
    want = jrot.rotate_queries_or_keys(jnp.asarray(x), jnp.asarray(jrot.rotary_freqs(16)),
                                       None if seq_pos is None else jnp.asarray(seq_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sample_from_moments_matches_jax():
    """The draw is passed in: JAX's ``jax.random.normal`` of the key."""
    moments = np.random.RandomState(5).randn(2, 4, 4, 8).astype(np.float32)
    key = jax.random.PRNGKey(9)
    draw = np.array(jax.random.normal(key, (2, 4, 4, 4), jnp.float32))
    got = sample_from_moments(torch.from_numpy(moments), noise=torch.from_numpy(draw))
    want = jvae.sample_from_moments(jnp.asarray(moments), key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    mode = sample_from_moments(torch.from_numpy(moments))
    np.testing.assert_array_equal(mode.numpy(), moments[..., :4])
    g1, g2 = (torch.Generator().manual_seed(0) for _ in range(2))
    torch.testing.assert_close(sample_from_moments(torch.from_numpy(moments), g1),
                               sample_from_moments(torch.from_numpy(moments), g2))


def test_vae_forward_matches_jax():
    """``AutoencoderKL.forward``: encode, the posterior draw, decode."""
    from test_torch_unet import jax_tiny_config, tiny_models

    modules, _, trees = tiny_models(0)
    vae = jvae.AutoencoderKL(jax_tiny_config("vae"))
    params = jax.tree_util.tree_map(jnp.asarray, trees["vae"])
    x = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(3)
    draw = np.array(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    with torch.no_grad():
        got = modules["vae"](torch.from_numpy(x), noise=torch.from_numpy(draw))
    want = vae.apply(params, jnp.asarray(x), key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=5e-5)
