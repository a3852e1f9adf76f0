"""The port's InstantStyle pieces against the JAX package, fp32 on the CPU:
the IP-Adapter projections (``ImageProjModel``, ``MLPProjModel``,
``Resampler``) and ``ip_image_embeds`` for the base, plus and full variants,
the canny control map, the generation scan (2 steps, JAX's initial latent
passed in) and the attention-map helpers; the projections' weights bridge
both ways.

Tolerances: rtol and atol 1e-4 for modules and the scan, exact for the canny
map and the weights bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import controlnet as jcn
from anyv2v_tpu.models import unet_sd as jsd
from anyv2v_tpu.models.clip import CLIPVisionConfig as JVisionConfig, CLIPVisionModel as JVision
from anyv2v_tpu.ops import attn_maps as jmaps
from anyv2v_tpu.pipelines import instantstyle as jis
from anyv2v_tpu.schedulers import euler as jeuler
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.utils import convert as C
from anyv2v_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
from anyv2v_torch.ops import attn_maps
from anyv2v_torch.pipelines import instantstyle as tis
from anyv2v_torch.schedulers import make_schedule
from anyv2v_torch.utils.model_zoo import ARCHS
from anyv2v_torch.utils.weights import mlp_proj_state_dict, resampler_state_dict
from test_torch_image_edit import jax_vae
from test_torch_sd_unet import editor_models, jax_sd_config
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)
from test_torch_unet import randomize

TOL = dict(rtol=1e-4, atol=1e-4)
RESAMPLER = dict(dim=16, depth=2, heads=2, head_dim=8, num_queries=4, embedding_dim=12,
                 output_dim=16, ff_mult=2)


def _resampler():
    port = tis.Resampler(**RESAMPLER)
    sd = randomize(port, 40)
    return port, sd, jis.Resampler(**RESAMPLER, dtype=jnp.float32), C.convert_resampler(sd, 2)


def _mlp():
    port = tis.MLPProjModel(16, 12)
    sd = randomize(port, 41)
    return port, sd, jis.MLPProjModel(16, dtype=jnp.float32), C.convert_mlp_proj(sd)


def _image_proj():
    port = tis.ImageProjModel(16, 12, num_tokens=4)
    sd = randomize(port, 42)
    tree = {"params": {"proj": C.t_linear(sd, "proj"), "norm": C.t_norm(sd, "norm")}}
    return port, sd, jis.ImageProjModel(16, num_tokens=4, dtype=jnp.float32), tree


@pytest.mark.parametrize("make,shape", [(_image_proj, (2, 12)), (_mlp, (2, 5, 12)),
                                        (_resampler, (2, 9, 12))])
def test_projections_match_jax(make, shape):
    port, _, jmod, tree = make()
    x = np.random.RandomState(43).randn(*shape).astype(np.float32)
    want = jmod.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_projection_weights_round_trip_exactly():
    """The inverses of ``convert_resampler`` (``to_kv`` fused again) and
    ``convert_mlp_proj`` give back the checkpoint keys, bit for bit."""
    for make, inverse in ((_resampler, resampler_state_dict), (_mlp, mlp_proj_state_dict)):
        port, sd, _, tree = make()
        back = inverse(tree)
        assert set(back) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        port.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()}, strict=True)


@pytest.mark.parametrize("variant", ["xl", "plus", "full"])
def test_ip_image_embeds_match_jax(variant):
    """base: the pooled projection and a zero embedding; plus / full: the
    penultimate hidden states of the image and of a zero image."""
    cfg = dict(hidden_size=12, intermediate_size=24, num_layers=2, num_heads=2, image_size=32,
               patch_size=16, projection_dim=12)
    vision = CLIPVisionModel(CLIPVisionConfig(**cfg))
    vtree = {"params": C.convert_clip_vision(randomize(vision, 44), num_layers=2)}
    jvision = JVision(JVisionConfig(**cfg))
    port, _, jproj, ptree = {"xl": _image_proj, "plus": _resampler, "full": _mlp}[variant]()
    img = np.random.RandomState(45).randn(1, 32, 32, 3).astype(np.float32)
    want = jis.ip_image_embeds(jvision, vtree, jproj, ptree, jnp.asarray(img), variant)
    got = tis.ip_image_embeds(vision, port, torch.from_numpy(img), variant)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError):
        tis.ip_image_embeds(vision, port, torch.from_numpy(img), "face")


def test_canny_map_equals_jax():
    img = np.random.RandomState(46).rand(40, 56, 3).astype(np.float32)
    img[10:30, 20:40] = 0.9
    got, want = tis.canny_map(img), jis.canny_map(img)
    assert got.shape == (40, 56, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0


def test_generate_scan_matches_jax():
    """Two Euler-Discrete steps of a 30-step "leading" grid on
    instantstyle-tiny: ControlNet residuals at scale 0.6, the IP tokens of
    [a zero embedding, the style] at scale 1 on ``up_0_attn_1``, guidance 5."""
    arch = "instantstyle-tiny"
    modules, _, trees = editor_models(arch, seed=50)
    spec = ARCHS[arch]
    port = tis.InstantStylePipeline(unet=modules["unet"], controlnet=modules["controlnet"],
                                    vae=modules["vae"], image_proj=modules["image_proj"],
                                    schedule=make_schedule(), device=torch.device("cpu"),
                                    dtype=torch.float32)
    jp = jis.InstantStylePipeline(
        unet=jsd.SDUNet(jax_sd_config(spec["unet"])),
        controlnet=jcn.ControlNet(jax_sd_config(spec["controlnet"])),
        vae=jax_vae(spec["vae"]), image_proj=jis.ImageProjModel(16, dtype=jnp.float32),
        schedule=jax_make_schedule(), params=trees)
    rng = np.random.RandomState(51)
    style = rng.randn(1, 16).astype(np.float32)
    ip2 = jnp.concatenate([jp.image_proj.apply(trees["image_proj"], jnp.zeros((1, 16))),
                           jp.image_proj.apply(trees["image_proj"], jnp.asarray(style))])
    np.testing.assert_allclose(port.style_tokens(style).numpy(), np.asarray(ip2), **TOL)
    grid = jeuler.euler_discrete_grid(jp.schedule, 30)
    sigmas = grid.sigmas[:3]
    init = jax.random.normal(jax.random.PRNGKey(52), (1, 8, 8, 4)) * grid.init_noise_sigma
    text2 = rng.randn(2, 7, 16).astype(np.float32)
    pooled2 = rng.randn(2, 16).astype(np.float32)
    ids2 = np.tile(np.float32([[64, 64, 0, 0, 64, 64]]), (2, 1))
    cond = tis.canny_map(rng.rand(64, 64, 3).astype(np.float32))
    want = jp._generate_scan(jp.params, init, jnp.asarray(text2), jnp.asarray(pooled2),
                             jnp.asarray(ids2), ip2, jnp.asarray(cond), jnp.asarray(sigmas),
                             jnp.float32(5.0), jnp.float32(0.6), 1.0)
    got = port.generate_scan(np.array(init), text2, pooled2, ids2, np.array(ip2), cond,
                             sigmas, 5.0, 0.6, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    out = port.generate(cond, style, text2, pooled2, num_inference_steps=2)
    assert out.shape == (64, 64, 3) and bool(torch.isfinite(out).all())


def test_attention_maps_match_jax():
    rng = np.random.RandomState(53)
    q = rng.randn(2, 12, 3 * 8).astype(np.float32)
    k = rng.randn(2, 5, 3 * 8).astype(np.float32)
    want = jmaps.attention_probs(jnp.asarray(q), jnp.asarray(k), heads=3)
    got = attn_maps.attention_probs(torch.from_numpy(q), torch.from_numpy(k), heads=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(attn_maps.attn_map_grid(got, 3, 4, token_idx=2).numpy(),
                               np.asarray(jmaps.attn_map_grid(want, 3, 4, token_idx=2)),
                               rtol=1e-5, atol=1e-6)
    got = attn_maps.attention_probs(torch.from_numpy(q), torch.from_numpy(k), heads=3, scale=0.5)
    want = jmaps.attention_probs(jnp.asarray(q), jnp.asarray(k), heads=3, scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
