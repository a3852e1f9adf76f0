"""ConsistI2V's generation knobs in the port against the JAX package, fp32 on
the CPU: FreeInit (``anyv2v_torch/ops/freeinit.py``), ``add_noise``, pyoco
noise (``sample_video_noise``), ``apply_frameinit`` and plain generation
(``ConsistI2VPipeline.sample``) from noise on consisti2v-tiny.

``torch.Generator`` cannot reproduce ``jax.random``, so the port's noise
takes the JAX draws: ``jax.random.split(key)`` gives the two keys and each
standard-normal draw is passed in (``draws=``). Tolerances: the filters
bit-equal (the same numpy); ``freq_mix_3d`` and ``apply_frameinit`` atol
1e-5 (two FFT libraries in fp32); the noise 1e-6; ``add_noise`` 1e-6;
``sample`` rtol = atol = 1e-4, as the pipeline tests. The JAX pipeline is
built once for the module from converted port weights, and its plain
sampler compiles once (one guidance mode, one shape).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import unet_videoldm as jv
from anyv2v_tpu.models.clip import CLIPTextModel as JCLIPText
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE
from anyv2v_tpu.ops import freeinit as jfi
from anyv2v_tpu.pipelines import consisti2v as jc
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.schedulers.schedules import add_noise as jax_add_noise
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.ops import freeinit as tfi
from anyv2v_torch.pipelines.consisti2v import ConsistI2VPipeline, sample_video_noise
from anyv2v_torch.schedulers import add_noise, make_schedule
from test_torch_consisti2v import TOL, tiny_trees
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)

FFT_ATOL = 1e-5
NOISE_TOL = dict(rtol=1e-6, atol=1e-6)
F, HW = 3, 64


# every filter at the sizes FreeInit meets, plus a zero cutoff (the ideal
# filter has no zero-cutoff branch in either package: it divides by it)
_FILTER_CASES = [(name, shape, d_s, d_t) for name in sorted(jfi.FILTERS)
                 for shape, d_s, d_t in [((16, 64, 64), 0.25, 0.25), ((1, 8, 8), 0.25, 0.25),
                                         ((5, 12, 10), 0.4, 0.1), ((4, 8, 8), 0.0, 0.25)]
                 if not (name == "ideal" and d_s == 0.0)]


@pytest.mark.parametrize("name,shape,d_s,d_t", _FILTER_CASES)
def test_filters_bit_equal(name, shape, d_s, d_t):
    np.testing.assert_array_equal(tfi.FILTERS[name](shape, d_s=d_s, d_t=d_t),
                                  jfi.FILTERS[name](shape, d_s=d_s, d_t=d_t))


def test_butterworth_order_bit_equal():
    for n in (1, 2, 4, 7):
        np.testing.assert_array_equal(tfi.butterworth_low_pass_filter((6, 16, 16), n=n),
                                      jfi.butterworth_low_pass_filter((6, 16, 16), n=n))


@pytest.mark.parametrize("name", sorted(jfi.FILTERS))
def test_freq_mix_3d_matches_jax(name):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 8, 6, 4).astype(np.float32)
    noise = rng.randn(2, 5, 8, 6, 4).astype(np.float32)
    lpf = jfi.FILTERS[name]((5, 8, 6), d_s=0.5, d_t=0.5)
    want = jfi.freq_mix_3d(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(lpf))
    got = tfi.freq_mix_3d(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(lpf))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FFT_ATOL)


@pytest.mark.parametrize("t", [0, 250, 999])
def test_add_noise_matches_jax(t):
    rng = np.random.RandomState(t)
    x0, noise = (rng.randn(1, 3, 4, 4, 4).astype(np.float32) for _ in range(2))
    want = jax_add_noise(jax_make_schedule(), jnp.asarray(x0), jnp.asarray(noise), jnp.int32(t))
    got = add_noise(make_schedule(), torch.from_numpy(x0), torch.from_numpy(noise), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NOISE_TOL)


def _jax_draws(key, shape, method):
    """The two standard-normal draws of the JAX ``sample_video_noise``."""
    k1, k2 = jax.random.split(key)
    b, f, h, w, c = shape
    first = (b, 1, h, w, c) if method == "pyoco_mixed" else shape
    return (np.array(jax.random.normal(k1, first, jnp.float32)),
            np.array(jax.random.normal(k2, shape, jnp.float32)))


@pytest.mark.parametrize("method", ["vanilla", "pyoco_mixed", "pyoco_progressive"])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_sample_video_noise_matches_jax(method, alpha):
    key, shape = jax.random.PRNGKey(7), (1, 5, 4, 6, 4)
    want = jc.sample_video_noise(key, shape, method, alpha)
    got = sample_video_noise(shape, method, alpha, draws=_jax_draws(key, shape, method))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NOISE_TOL)


def test_sample_video_noise_from_a_generator():
    """Without draws, the noise comes from the given generator: the same seed
    gives the same noise, and pyoco_mixed shares its base frame."""
    shape = (1, 4, 3, 3, 4)
    a, b = (sample_video_noise(shape, "pyoco_mixed", 1.0,
                               generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a, b) and tuple(a.shape) == shape
    with pytest.raises(ValueError, match="noise_sampling_method"):
        sample_video_noise(shape, "pyoco", 1.0, generator=torch.Generator())


@pytest.fixture(scope="module")
def pipes():
    modules, trees = tiny_trees(3)
    port = ConsistI2VPipeline(unet=modules["unet"], vae=modules["vae"],
                              text_encoder=modules["text"], schedule=make_schedule(),
                              device=torch.device("cpu"), dtype=torch.float32)
    jpipe = jc.ConsistI2VPipeline(
        unet=jv.VideoLDMUNet(dataclasses.replace(jzoo.CONSISTI2V_TINY["unet"], dtype=jnp.float32)),
        vae=JVAE(dataclasses.replace(jzoo.CONSISTI2V_TINY["vae"], dtype=jnp.float32)),
        text_encoder=JCLIPText(jzoo.CONSISTI2V_TINY["text"]), schedule=jax_make_schedule(),
        params={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in trees.items()})
    frames = np.random.RandomState(0).rand(1, HW, HW, 3).astype(np.float32)
    ids = np.zeros((1, 77), np.int64)
    ids_edit = ids.copy()
    ids_edit[0, :5] = [49406, 320, 1929, 49407, 49407]
    with torch.no_grad():
        ff = port.encode_video(frames)
        text = torch.cat([port.encode_text(i) for i in (ids, ids, ids_edit)])
    jff = jpipe.encode_video(jnp.asarray(frames))
    jtext = jnp.concatenate([jpipe.encode_text(jnp.asarray(i)) for i in (ids, ids, ids_edit)])
    return dict(port=port, jpipe=jpipe, ff=ff, text=text, jff=jff, jtext=jtext)


@pytest.mark.parametrize("filter_type", sorted(jfi.FILTERS))
def test_apply_frameinit_matches_jax(pipes, filter_type):
    rng = np.random.RandomState(5)
    noise = rng.randn(1, F, HW // 8, HW // 8, 4).astype(np.float32)
    kw = dict(noise_level=999 if filter_type == "butterworth" else 600,
              filter_type=filter_type, d_s=0.3, d_t=0.5)
    want = pipes["jpipe"].apply_frameinit(jnp.asarray(noise), pipes["jff"], **kw)
    got = pipes["port"].apply_frameinit(torch.from_numpy(noise), pipes["ff"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FFT_ATOL)


@pytest.mark.parametrize("method,frameinit", [("pyoco_mixed", False), ("pyoco_progressive", False),
                                              ("vanilla", True), ("pyoco_progressive", True)])
def test_sample_from_noise_matches_jax(pipes, method, frameinit):
    """``init_latent=None``: noise from the JAX draws (alpha 0.5), FreeInit
    at level 999, guidance "both" (batch 3), the last 3 steps of a 50-step
    schedule; the clean first-frame latent in front."""
    port, jpipe = pipes["port"], pipes["jpipe"]
    key = jax.random.PRNGKey(11)
    kw = dict(num_frames=F, num_inference_steps=50, cfg_txt=7.5, cfg_img=1.5, frame_stride=3,
              noise_sampling_method=method, noise_alpha=0.5, use_frameinit=frameinit,
              frameinit_noise_level=999, t_idx=47)
    with torch.no_grad():
        got = port.sample(pipes["ff"], pipes["text"],
                          draws=_jax_draws(key, (1, F, HW // 8, HW // 8, 4), method), **kw)
    want = jpipe.sample(pipes["jff"], pipes["jtext"], key=key, **kw)
    assert tuple(got.shape) == (1, F, HW // 8, HW // 8, 4) and np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got.numpy()[:, :1], pipes["ff"].numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_given_start_latent_bypasses_noise_and_frameinit(pipes):
    """With ``init_latent`` the noise method and FreeInit do nothing, as in
    the JAX package (the inversion CLI's reconstruction relies on it)."""
    port = pipes["port"]
    init = torch.from_numpy(np.random.RandomState(6).randn(1, F, HW // 8, HW // 8, 4)
                            .astype(np.float32))
    kw = dict(num_frames=F, num_inference_steps=50, cfg_txt=7.5, cfg_img=1.0, t_idx=48,
              init_latent=init)
    with torch.no_grad():
        plain = port.sample(pipes["ff"], pipes["text"][1:], **kw)
        knobs = port.sample(pipes["ff"], pipes["text"][1:], noise_sampling_method="pyoco_mixed",
                            noise_alpha=0.3, use_frameinit=True, **kw)
    assert torch.equal(plain, knobs)
