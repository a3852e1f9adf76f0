"""The port's Euler-family schedulers (``anyv2v_torch/schedulers/euler.py``)
against the JAX package on the CPU: the three grids, the scale factors, the
three steps and the sigma -> timestep map.

The grids are host numpy in both packages and must be equal; the steps run
the same fp32 arithmetic, within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.pipelines.image_edit import _sigma_to_t as jax_sigma_to_t
from anyv2v_tpu.schedulers import euler as J
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_torch.schedulers import euler as T
from anyv2v_torch.schedulers import make_schedule

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps", [3, 30, 100])
def test_grids_match_jax(steps):
    js, ts = jax_make_schedule(), make_schedule()
    for jgrid, tgrid in ((J.euler_ancestral_grid(js, steps), T.euler_ancestral_grid(ts, steps)),
                         (J.euler_discrete_grid(js, steps), T.euler_discrete_grid(ts, steps)),
                         (J.euler_discrete_grid(js, steps, spacing="linspace"),
                          T.euler_discrete_grid(ts, steps, spacing="linspace"))):
        np.testing.assert_array_equal(tgrid.sigmas, jgrid.sigmas)
        np.testing.assert_array_equal(tgrid.timesteps, jgrid.timesteps)
        assert tgrid.init_noise_sigma == jgrid.init_noise_sigma
    jg, tg = J.edm_grid(steps), T.edm_grid(steps)
    np.testing.assert_array_equal(tg.sigmas, jg.sigmas)
    assert tg.init_noise_sigma == jg.init_noise_sigma
    assert tg.sigmas[0] == np.float32(120.0) and tg.sigmas[-1] == 0.0


def test_sigma_to_t_matches_jax():
    """Every sigma of the Euler grids, the ends of the train range and
    sigmas past them (clamped)."""
    js, ts = jax_make_schedule(), make_schedule()
    sigmas = np.concatenate([T.euler_ancestral_grid(ts, 100).sigmas[:-1],
                             T.euler_discrete_grid(ts, 30).sigmas[:-1],
                             np.float32([1e-3, 0.0292, 14.6, 20.0])])
    got = T.sigma_to_t(ts, sigmas)
    want = np.asarray([jax_sigma_to_t(js, jnp.float32(s)) for s in sigmas])
    np.testing.assert_allclose(got, want, **TOL)
    assert got.dtype == np.float32


def _draws(seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 4, 4, 4).astype(np.float32) * s for s in (14.0, 1.0, 1.0)[:n]]


@pytest.mark.parametrize("sigma_from,sigma_to", [(14.6146, 13.2), (0.52, 0.0292), (0.0292, 0.0)])
def test_euler_ancestral_and_discrete_steps_match_jax(sigma_from, sigma_to):
    x, eps, noise = _draws(int(sigma_from * 100))
    sf, st = np.float32(sigma_from), np.float32(sigma_to)
    want = J.euler_ancestral_step(jnp.asarray(x), jnp.asarray(eps), jnp.float32(sf),
                                  jnp.float32(st), jnp.asarray(noise))
    got = T.euler_ancestral_step(torch.from_numpy(x), torch.from_numpy(eps), float(sf), float(st),
                                 torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = J.euler_discrete_step(jnp.asarray(x), jnp.asarray(eps), jnp.float32(sf),
                                 jnp.float32(st))
    got = T.euler_discrete_step(torch.from_numpy(x), torch.from_numpy(eps), float(sf), float(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = J.euler_scale_model_input(jnp.asarray(x), jnp.float32(sf))
    got = T.euler_scale_model_input(torch.from_numpy(x), float(sf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sigma_from,sigma_to", [(120.0, 37.1), (1.3, 0.4), (0.002, 0.0)])
def test_edm_step_and_scale_match_jax(sigma_from, sigma_to):
    x, v = _draws(int(sigma_from * 10), n=2)
    sf, st = np.float32(sigma_from), np.float32(sigma_to)
    want = J.edm_step_v(jnp.asarray(x), jnp.asarray(v), jnp.float32(sf), jnp.float32(st))
    got = T.edm_step_v(torch.from_numpy(x), torch.from_numpy(v), float(sf), float(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = J.edm_scale_model_input(jnp.asarray(x), jnp.float32(sf))
    got = T.edm_scale_model_input(torch.from_numpy(x), float(sf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_t = J.EDMGrid(sigmas=np.float32([sf, 0.0])).timestep(jnp.float32(sf))
    assert T.EDMGrid.timestep(float(sf)) == pytest.approx(float(want_t), abs=1e-7)


def test_steps_keep_latents_fp32():
    """A bf16 model output steps an fp32 latent in fp32; the scaled model
    input keeps the latent's dtype."""
    x = torch.randn(1, 4, 4, 4)
    eps = torch.randn(1, 4, 4, 4).bfloat16()
    for out in (T.euler_ancestral_step(x, eps, 1.0, 0.5, torch.zeros_like(x)),
                T.euler_discrete_step(x, eps, 1.0, 0.5), T.edm_step_v(x, eps, 1.0, 0.5)):
        assert out.dtype == torch.float32
    assert T.euler_scale_model_input(x.bfloat16(), 3.0).dtype == torch.bfloat16
