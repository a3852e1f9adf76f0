"""The port's schedulers, PnP helpers and UNet blocks against the JAX package.

Blocks carry seeded random weights in the port's (diffusers-keyed) state
dict; the JAX block gets the same weights through the converter's block maps
(``anyv2v_tpu/utils/convert.py``), both run fp32 on the CPU on the same
channels-last inputs. Tolerance rtol 1e-4, atol 2e-5 as the block goldens in
tests/test_convert_golden.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import layers as jl
from anyv2v_tpu.ops import pnp as jpnp
from anyv2v_tpu.pipelines.common import group_constant_runs as jax_group_constant_runs
from anyv2v_tpu.schedulers import ddim as jddim
from anyv2v_tpu.schedulers import schedules as jsched
from anyv2v_tpu.utils import convert as C
from anyv2v_torch.models import layers as tl
from anyv2v_torch.ops.pnp import inject_source_rows, injection_step_mask
from anyv2v_torch.pipelines.common import group_constant_runs
from anyv2v_torch.schedulers import (
    ddim_inverse_step,
    ddim_step,
    inversion_timesteps,
    make_schedule,
    sampling_timesteps,
)
from test_torch_unet import randomize as randomize_port
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=2e-5)


def randomize(module: torch.nn.Module, seed: int) -> dict:
    """Seeded random weights into ``module``; its state dict as numpy under a
    ``m.`` prefix, the form the converter's block maps take."""
    return {f"m.{k}": v for k, v in randomize_port(module, seed).items()}


def jparams(tree):
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def check(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# schedulers and PnP data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spacing", ["leading", "linspace", "trailing"])
@pytest.mark.parametrize("steps", [10, 50, 500])
def test_timestep_grids_match(steps, spacing):
    js = jsched.make_schedule(timestep_spacing=spacing)
    ts = make_schedule(timestep_spacing=spacing)
    np.testing.assert_array_equal(sampling_timesteps(ts, steps),
                                  jsched.sampling_timesteps(js, steps))
    np.testing.assert_array_equal(inversion_timesteps(ts, steps),
                                  jsched.inversion_timesteps(js, steps))
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))


@pytest.mark.parametrize("kwargs", [
    {},
    {"rescale_betas_zero_snr": True, "prediction_type": "v_prediction"},
    {"beta_schedule": "linear", "beta_start": 1e-4, "beta_end": 0.02,
     "prediction_type": "sample"},
])
def test_ddim_steps_match(kwargs):
    js, ts = jsched.make_schedule(**kwargs), make_schedule(**kwargs)
    rng = np.random.RandomState(0)
    x, eps = rand(rng, 1, 2, 4, 4, 4), rand(rng, 1, 2, 4, 4, 4)
    for t, t_prev in ((981, 961), (21, 1), (1, -19)):
        check(ddim_step(ts, torch.from_numpy(x), torch.from_numpy(eps), t, t_prev),
              jddim.ddim_step(js, jnp.asarray(x), jnp.asarray(eps), t, t_prev))
    for t in (1, 501, 999):
        check(ddim_inverse_step(ts, torch.from_numpy(x), torch.from_numpy(eps), t, 50),
              jddim.ddim_inverse_step(js, jnp.asarray(x), jnp.asarray(eps), t, 50))


@pytest.mark.parametrize("thr", [0.0, 0.2, 0.5, 1.0])
def test_injection_masks_and_runs_match(thr):
    ts = sampling_timesteps(make_schedule(), 50)
    got = injection_step_mask(ts, thr, 50)
    np.testing.assert_array_equal(got, jpnp.injection_step_mask(ts, thr, 50))
    masks = (injection_step_mask(ts, 0.2, 50), got, injection_step_mask(ts, 0.5, 50))
    assert group_constant_runs(masks, 40) == jax_group_constant_runs(masks, 40)


def test_inject_source_rows_matches():
    x = np.arange(3 * 2 * 5, dtype=np.float32).reshape(6, 5)
    for flag in (True, False):
        check(inject_source_rows(torch.from_numpy(x), flag, 3),
              jpnp.inject_source_rows(jnp.asarray(x), flag, 3))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_sinusoidal_and_timestep_embedding():
    ts = np.array([1, 501, 981])
    check(tl.sinusoidal_embedding(torch.from_numpy(ts), 32),
          jl.sinusoidal_embedding(jnp.asarray(ts), 32))
    m = tl.TimestepEmbedding(32, 64)
    sd = randomize(m, 0)
    x = rand(np.random.RandomState(0), 3, 32)
    want = jl.TimestepEmbedding(64).apply(
        jparams({"linear_1": C.t_linear(sd, "m.linear_1"),
                 "linear_2": C.t_linear(sd, "m.linear_2")}), jnp.asarray(x))
    check(m(torch.from_numpy(x)), want)


@pytest.mark.parametrize("cin,cout,inject", [(16, 32, False), (32, 32, True)])
def test_resnet_block(cin, cout, inject):
    m = tl.ResnetBlock2D(cin, cout, temb_dim=24, groups=8)
    sd = randomize(m, 1)
    rng = np.random.RandomState(1)
    x, temb = rand(rng, 3, 6, 6, cin), rand(rng, 3, 24)
    want = jl.ResnetBlock2D(cout, groups=8).apply(
        jparams(C._resnet(sd, "m")), jnp.asarray(x), jnp.asarray(temb),
        inject=inject if inject else None)
    check(m(torch.from_numpy(x), torch.from_numpy(temb), inject=inject), want)


def test_temporal_conv_layer():
    m = tl.TemporalConvLayer(32, groups=8)
    sd = randomize(m, 2)
    x = rand(np.random.RandomState(2), 2, 5, 4, 6, 32)
    want = jl.TemporalConvLayer(32, groups=8).apply(jparams(C._temp_conv(sd, "m")),
                                                    jnp.asarray(x))
    check(m(torch.from_numpy(x)), want)


@pytest.mark.parametrize("heads,head_dim,ctx_dim", [(8, 5, 12), (4, 8, None), (2, 20, 16)])
def test_attention_padded_heads(heads, head_dim, ctx_dim):
    """True head widths in the state dict, padded storage inside, true-width
    softmax scale; the JAX side pads through the converter."""
    dim = 24
    m = tl.Attention(dim, heads, head_dim, cross_attention_dim=ctx_dim)
    sd = randomize(m, 3)
    assert sd["m.to_q.weight"].shape == (heads * head_dim, dim)
    assert m.to_q.weight.shape[0] == heads * tl.padded_head_dim(head_dim)
    rng = np.random.RandomState(3)
    x = rand(rng, 3, 10, dim)
    ctx = rand(rng, 3, 7, ctx_dim) if ctx_dim else None
    want = jl.Attention(heads, head_dim, cross_attention_dim=ctx_dim).apply(
        jparams(C._attn(sd, "m", heads, head_dim)), jnp.asarray(x),
        context=None if ctx is None else jnp.asarray(ctx))
    check(m(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx)), want)
    # the stored padding is exactly zero and round-trips through state_dict
    assert all(np.array_equal(v.numpy(), sd[f"m.{k}"]) for k, v in m.state_dict().items())


@pytest.mark.parametrize("dim", [32, 24])
def test_feed_forward(dim):
    """dim 32 takes the K3 route (its plain version on CPU), 24 the unfused path."""
    m = tl.FeedForward(dim)
    sd = randomize(m, 4)
    x = rand(np.random.RandomState(4), 2, 9, dim)
    want = jl.FeedForward().apply(jparams(C._ff(sd, "m")), jnp.asarray(x))
    check(m(torch.from_numpy(x)), want)


@pytest.mark.parametrize("inject", [False, True])
def test_spatial_transformer(inject):
    heads, hd, c = 8, 5, 32   # unaligned head width: padded storage
    m = tl.SpatialTransformer(c, heads, hd, cross_attention_dim=12, groups=8)
    sd = randomize(m, 5)
    rng = np.random.RandomState(5)
    x, ctx = rand(rng, 3, 4, 4, c), rand(rng, 3, 6, 12)
    want = jl.SpatialTransformer(heads, hd, cross_attention_dim=12, groups=8).apply(
        jparams(C._spatial_transformer(sd, "m", heads, hd)), jnp.asarray(x),
        context=jnp.asarray(ctx), inject=inject if inject else None)
    check(m(torch.from_numpy(x), torch.from_numpy(ctx), inject=inject), want)


@pytest.mark.parametrize("inject", [False, True])
def test_temporal_transformer(inject):
    heads, hd, c = 4, 8, 32
    m = tl.TemporalTransformer(c, heads, hd, groups=8)
    sd = randomize(m, 6)
    x = rand(np.random.RandomState(6), 3, 5, 4, 4, c)
    want = jl.TemporalTransformer(heads, hd, groups=8).apply(
        jparams(C._temporal_transformer(sd, "m", heads, hd)), jnp.asarray(x),
        inject=inject if inject else None)
    check(m(torch.from_numpy(x), inject=inject), want)


@pytest.mark.parametrize("asym", [False, True])
def test_downsample_and_upsample(asym):
    rng = np.random.RandomState(7)
    x = rand(rng, 2, 8, 8, 16)
    down = tl.Downsample2D(16, asymmetric_pad=asym)
    sd = randomize(down, 7)
    want = jl.Downsample2D(16, asymmetric_pad=asym).apply(
        jparams({"conv": C.t_conv(sd, "m.conv")}), jnp.asarray(x))
    check(down(torch.from_numpy(x)), want)
    up = tl.Upsample2D(16)
    sd = randomize(up, 8)
    want = jl.Upsample2D(16).apply(jparams({"conv": C.t_conv(sd, "m.conv")}), jnp.asarray(x))
    check(up(torch.from_numpy(x)), want)


@pytest.mark.parametrize("hw,out", [(64, 32), (8, 32), (12, 32)])
def test_adaptive_avg_pool(hw, out):
    x = rand(np.random.RandomState(8), 2, hw, hw, 4)
    check(tl.adaptive_avg_pool_2d(torch.from_numpy(x), (out, out)),
          jl.adaptive_avg_pool_2d(jnp.asarray(x), (out, out)))
