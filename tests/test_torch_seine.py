"""The port's SEINE modules against the JAX package, fp32 on the CPU.

- the T5 relative-position buckets and bias, the DDPM step in its three
  variance types, the DDPM grid and the frame mask;
- the transformer block (spatial, cross and temporal attention with rotary
  and the bias), PnP injection on and off, padded and unpadded heads;
- the seine-tiny UNet through ``state_dict_from_jax`` with no PnP flag and
  with each family alone; the weights bridge both ways, the arch numbers and
  the full-size key layout against the JAX converter.

The pipeline and the CLIs are in ``test_torch_seine_pipeline.py`` and
``test_torch_seine_cli.py`` (separate files, so that their JAX compiles
spread over the test workers). Every JAX side gets its parameters from the
port's seeded state dicts through ``anyv2v_tpu.utils.convert`` (numpy only):
no Flax init runs here.

Tolerances: exact for the buckets and the bias (a gather), 1e-6 for the DDPM
step (the same fp32 arithmetic), rtol and atol 1e-4 for blocks and the UNet,
as the other port tests.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import unet_seine as js
from anyv2v_tpu.ops import relpos as jrel
from anyv2v_tpu.pipelines import seine as jpipe
from anyv2v_tpu.schedulers import ddpm_step as jax_ddpm_step, make_schedule as jax_make_schedule
from anyv2v_tpu.utils import convert as C
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.models import unet_seine as ts
from anyv2v_torch.ops import relpos as trel
from anyv2v_torch.pipelines import seine as tpipe
from anyv2v_torch.schedulers import ddpm_step, make_schedule
from anyv2v_torch.utils.model_zoo import ARCHS, SEINE_SCHEDULER, build_modules
from anyv2v_torch.utils.weights import state_dict_from_jax
from test_torch_unet import randomize

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = ARCHS["seine-tiny"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny torch ops here run on one thread: with several pytest
    workers on the machine's cores, torch's default one thread per core
    oversubscribes the CPU and spends its time spinning."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ops, scheduler and pipeline helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_len,k_len,buckets,max_distance", [(16, 16, 32, 32), (40, 40, 32, 128),
                                                              (5, 9, 8, 16)])
def test_relpos_matches_jax(q_len, k_len, buckets, max_distance):
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    np.testing.assert_array_equal(trel.relative_position_bucket(rel, buckets, max_distance),
                                  jrel.relative_position_bucket(rel, buckets, max_distance))
    table = np.random.RandomState(q_len).randn(buckets, 3).astype(np.float32)
    want = jrel.relative_position_bias(jnp.asarray(table), q_len, k_len, buckets, max_distance)
    got = trel.relative_position_bias(torch.from_numpy(table), q_len, k_len, buckets, max_distance)
    assert got.shape == (3, q_len, k_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_relpos_bucket_index_made_once_per_shape():
    """The bucket table is built once per (lengths, device) and reused, so a
    forward copies nothing from host memory; the bias follows the table's
    current values."""
    trel._bucket_index.cache_clear()
    table = torch.randn(32, 2)
    first = trel.relative_position_bias(table, 16, 16, 32, 32)
    second = trel.relative_position_bias(2 * table, 16, 16, 32, 32)
    info = trel._bucket_index.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    torch.testing.assert_close(second, 2 * first)


def test_relpos_index_made_in_inference_mode_serves_autograd():
    """A bucket table first built under ``torch.inference_mode`` is a normal
    tensor: a later gather from a table that needs gradients works."""
    trel._bucket_index.cache_clear()
    table = torch.randn(8, 2, requires_grad=True)
    with torch.inference_mode():
        trel.relative_position_bias(table.detach(), 5, 5, 8, 16)
    trel.relative_position_bias(table, 5, 5, 8, 16).sum().backward()
    assert table.grad is not None and table.grad.abs().sum() > 0


@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_small_log", "fixed_large"])
@pytest.mark.parametrize("t,t_prev", [(980, 960), (20, 0), (0, -20)])
def test_ddpm_step_matches_jax(variance_type, t, t_prev):
    """The same noise on both sides; the final step (t_prev < 0) adds none."""
    rng = np.random.RandomState(t)
    x, eps, noise = (rng.randn(1, 2, 4, 4, 4).astype(np.float32) for _ in range(3))
    want = jax_ddpm_step(jax_make_schedule(**SEINE_SCHEDULER), jnp.asarray(x), jnp.asarray(eps),
                         jnp.int32(t), jnp.int32(t_prev), jnp.asarray(noise), variance_type)
    got = ddpm_step(make_schedule(**SEINE_SCHEDULER), torch.from_numpy(x), torch.from_numpy(eps),
                    t, t_prev, torch.from_numpy(noise), variance_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ddpm_step_bf16_latent_computes_in_fp32():
    rng = np.random.RandomState(3)
    x, eps, noise = (torch.from_numpy(rng.randn(2, 8).astype(np.float32)) for _ in range(3))
    sched = make_schedule(**SEINE_SCHEDULER)
    got = ddpm_step(sched, x.bfloat16(), eps, 500, 480, noise)
    want = ddpm_step(sched, x.bfloat16().float(), eps, 500, 480, noise)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("steps", [50, 10, 3])
def test_ddpm_grid_matches_jax(steps):
    sched = make_schedule(**SEINE_SCHEDULER)
    np.testing.assert_array_equal(tpipe.ddpm_grid(sched, steps),
                                  jpipe.ddpm_grid(jax_make_schedule(**SEINE_SCHEDULER), steps))


@pytest.mark.parametrize("mask_type,frames", [("first1", 4), ("first2", 5), ("all", 3),
                                              ("onelast1", 5)])
def test_frame_mask_matches_jax(mask_type, frames):
    got = tpipe.seine_frame_mask(mask_type, frames, 3, 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpipe.seine_frame_mask(mask_type, frames, 3, 2)))


# ---------------------------------------------------------------------------
# the transformer block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim,inject", [(8, (False, False, False)), (8, (True, True, True)),
                                             (4, (False, True, True))])
def test_transformer_block_matches_jax(head_dim, inject):
    """Spatial, cross and temporal attention (rotary on min(32, dh) channels
    per head, the T5 bias), Q/K injection over 3 CFG rows; head width 4 is
    stored padded to 8 in the port."""
    heads, frames, ctx_dim = 2, 5, 12
    dim = heads * head_dim
    m = ts.SeineTransformerBlock(dim, heads, head_dim, ctx_dim)
    sd = randomize(m, 30 + head_dim)
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, C._seine_block({f"m.{k}": v for k, v in sd.items()}, "m"))}
    rng = np.random.RandomState(head_dim)
    x = rng.randn(3 * frames, 6, dim).astype(np.float32)
    ctx = rng.randn(3 * frames, 7, ctx_dim).astype(np.float32)
    flags = [jnp.bool_(True) if f else None for f in inject]
    want = js._SeineTransformerBlock(heads, head_dim, ctx_dim, frames, 32, 32, jnp.float32, 3
                                     ).apply(params, jnp.asarray(x), jnp.asarray(ctx), *flags)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(ctx), frames, inject)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the UNet and its weights
# ---------------------------------------------------------------------------


def tiny_unet(seed: int, eps_scale: float = 1.0):
    """(port UNet fp32 on CPU, its state dict, the JAX tree)."""
    cfg = dataclasses.replace(TINY["unet"], dtype=torch.float32)
    with torch.device("cpu"):
        unet = ts.SeineUNet(cfg)
    sd = randomize(unet, seed)
    for k in ("conv_out.weight", "conv_out.bias"):
        sd[k] = sd[k] * np.float32(eps_scale)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return unet, sd, C.convert_unet_seine(sd, cfg.block_out_channels, cfg.layers_per_block)


@pytest.fixture(scope="module")
def unet_pair():
    unet, _, tree = tiny_unet(1)
    junet = js.SeineUNet(jzoo.SEINE_TINY["unet"])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    fn = jax.jit(lambda x, ctx, flags: junet.apply(
        params, sample=x, timestep=jnp.int32(501), encoder_hidden_states=ctx,
        pnp=js.SeinePnPFlags(*flags)))
    return unet, lambda x, ctx, flags: fn(jnp.asarray(x), jnp.asarray(ctx),
                                          tuple(jnp.bool_(f) for f in flags))


@pytest.mark.parametrize("pnp", [None, (True, False, False, False), (False, True, False, False),
                                 (False, False, True, False), (False, False, False, True)])
def test_tiny_unet_matches_jax(unet_pair, pnp):
    """At the edit batch [src, cond, uncond], 9 input channels, 4 frames;
    ``None`` is every flag off, the others one family (conv, spatial, cross,
    temporal) alone."""
    unet, jax_fn = unet_pair
    rng = np.random.RandomState(7)
    x = rng.randn(3, 4, 8, 8, 9).astype(np.float32)
    ctx = rng.randn(3, 7, 16).astype(np.float32)
    want = jax_fn(x, ctx, pnp or (False,) * 4)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), 501, torch.from_numpy(ctx), pnp=pnp)
    assert got.shape == (3, 4, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tiny_unet_timestep_forms_agree(unet_pair):
    """A Python or numpy number (filled on the device) and a tensor
    timestep, one per row or shared, give the same eps."""
    unet, _ = unet_pair
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(3, 2, 8, 8, 9).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(3, 7, 16).astype(np.float32))
    with torch.no_grad():
        outs = [unet(x, t, ctx) for t in (501, np.int64(501), torch.tensor(501),
                                          torch.tensor([501, 501, 501]))]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_weights_round_trip_is_exact():
    """convert(state_dict_from_jax(p)) == p, and state_dict_from_jax inverts
    the converter on the port's keys exactly."""
    unet, sd, tree = tiny_unet(2)
    back = state_dict_from_jax({"unet": tree}, "seine-tiny")["unet"]
    assert set(back) == set(sd) == set(unet.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)
    again = C.convert_unet_seine(back, TINY["unet"].block_out_channels,
                                 TINY["unet"].layers_per_block)
    assert C.tree_shapes(again) == C.tree_shapes(tree)


def test_arch_numbers_match_jax_zoo():
    for arch in ("seine", "seine-tiny"):
        assert set(ARCHS[arch]) == set(jzoo.SEINE_ARCHS[arch])
        for name in ARCHS[arch]:
            mine = dataclasses.asdict(ARCHS[arch][name])
            ref = dataclasses.asdict(jzoo.SEINE_ARCHS[arch][name])
            mine.pop("dtype"), ref.pop("dtype")
            assert mine == ref, (arch, name)
    assert SEINE_SCHEDULER == jzoo.SEINE_SCHEDULER


def test_full_size_state_dict_matches_converter():
    """Full-width seine on the meta device: the port's UNet state dict
    converts through convert_unet_seine into exactly the JAX init tree (keys
    and shapes, both ways), and carries the reference checkpoint's key names
    (which add only the rotary modules' ``freqs`` buffers)."""
    unet = build_modules("seine", torch.bfloat16)["unet"]
    shapes = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    zeros = {k: np.broadcast_to(np.zeros((), np.int8), s) for k, s in shapes.items()}
    cfg = ARCHS["seine"]["unet"]
    converted = C.convert_unet_seine(zeros, cfg.block_out_channels, cfg.layers_per_block)
    junet = js.SeineUNet(dataclasses.replace(jzoo.SEINE["unet"], dtype=jnp.float32))
    expected = jax.eval_shape(lambda: junet.init(
        jax.random.PRNGKey(0), sample=jnp.zeros((1, 2, 16, 16, 9)), timestep=jnp.int32(0),
        encoder_hidden_states=jnp.zeros((1, 4, 768))))
    C.assert_params_match(expected, converted)
    ref_keys = os.path.join(os.path.dirname(__file__), "fixtures", "seine_unet_keys.json")
    with open(ref_keys) as f:
        reference = {k: tuple(v) for k, v in json.load(f).items()}
    for k, s in shapes.items():
        assert reference.get(k) == s, k
    assert all(k.endswith("rotary_emb.freqs") for k in set(reference) - set(shapes))


def tiny_trees(seed: int):
    """(port modules fp32 on CPU, JAX trees) for seine-tiny with the UNet's
    output conv scaled by 0.01. Under SEINE's linear betas the x0 estimate at
    t = 751 divides by sqrt(alpha_bar) = 0.06, and cfg 4 weighs the eps rows
    by up to 9, so a random UNet's full-size eps would drive the edit to
    latents of order ten and its fp32 rounding past 1e-4; the scaled eps keeps
    the edit's latents of order one."""
    unet, _, utree = tiny_unet(seed, eps_scale=0.01)
    modules = build_modules("seine-tiny", torch.float32, device="cpu")
    modules["unet"] = unet
    trees = {"unet": utree}
    sd = randomize(modules["vae"], seed + 1)
    trees["vae"] = C.convert_vae(sd, TINY["vae"].block_out_channels, TINY["vae"].layers_per_block)
    sd = randomize(modules["text"], seed + 2)
    trees["text"] = {"params": C.convert_clip_text(sd, TINY["text"].num_layers)}
    return modules, trees
