"""The port's ConsistI2V modules against the JAX package, fp32 on the CPU.

- rotary embeddings, the sinusoidal PE and the first-frame 8-neighbourhood;
- the blocks: the alpha-gated temporal resnet, the spatial transformer (split-KV
  first-frame K/V) and the temporal transformer, PnP injection on and off;
- the consisti2v-tiny VideoLDM UNet through ``state_dict_from_jax``: rotary
  + augmented keys with first-frame concat, and sinusoidal PE without
  augmentation in conv2d mode, PnP flags on and off; the weights bridge both
  ways, and the full-size key layout against the JAX converter.

The pipeline and the CLIs are in ``test_torch_consisti2v_pipeline.py`` and
``test_torch_consisti2v_cli.py`` (separate files, so that their JAX compiles
spread over the test workers).

Tolerances: rtol 1e-4 with atol 2e-5 for ops and 1e-4 for blocks and the
UNet, as the i2vgen port tests.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import unet_videoldm as jv
from anyv2v_tpu.models.unet_i2vgen import PnPFlags
from anyv2v_tpu.ops import rotary as jrot
from anyv2v_tpu.utils import convert as C
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.models import unet_videoldm as tv
from anyv2v_torch.ops import rotary as trot
from anyv2v_torch.utils.model_zoo import ARCHS, build_modules
from anyv2v_torch.utils.weights import state_dict_from_jax
from test_torch_unet import randomize

OPS_TOL = dict(rtol=1e-4, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
TINY = ARCHS["consisti2v-tiny"]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inner,frames,extra", [(16, 4, 0), (80, 17, 8), (32, 5, 8)])
def test_rotary_matches_jax(inner, frames, extra):
    """Rotation of the first inner // 2 channels at frame positions, the
    augmented keys at position 0."""
    rng = np.random.RandomState(inner)
    x = rng.randn(2, frames + extra, 3, inner).astype(np.float32)
    pos = np.concatenate([np.arange(frames), np.zeros(extra)]).astype(np.float32)
    rot = inner // 2
    np.testing.assert_allclose(trot.rotary_freqs(rot), jrot.rotary_freqs(rot), rtol=0, atol=0)
    want = jrot.apply_rotary_partial(
        jnp.asarray(x), jrot.rotary_angles(jnp.asarray(pos), jnp.asarray(jrot.rotary_freqs(rot)))
        [None, :, None, :], rot)
    got = trot.apply_rotary_partial(
        torch.from_numpy(x), trot.rotary_angles(torch.from_numpy(pos), trot.rotary_freqs(rot))
        [None, :, None, :], rot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


def test_positional_encoding_matches_jax():
    np.testing.assert_array_equal(tv.videoldm_positional_encoding(17, 40),
                                  jv.videoldm_positional_encoding(17, 40))


@pytest.mark.parametrize("h,w", [(4, 4), (3, 5)])
def test_first_frame_adjacent_slices_matches_jax(h, w):
    x = np.random.RandomState(h * w).randn(2, h * w, 6).astype(np.float32)
    want = jv._first_frame_adjacent_slices(jnp.asarray(x), h, w)
    got = tv._first_frame_adjacent_slices(torch.from_numpy(x), h, w)
    assert got.shape == (2, 8, h * w, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _block_params(module: torch.nn.Module, convert, seed: int):
    """Seeded weights into a port block; the JAX block's params through the
    JAX converter's map for it (prefix ``m``)."""
    sd = randomize(module, seed)
    for k in (k for k in sd if k.endswith("alpha")):
        sd[k] = np.full((1,), 0.3, np.float32)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return {"params": jax.tree_util.tree_map(
        jnp.asarray, convert({f"m.{k}": v for k, v in sd.items()}, "m"))}


def test_alpha_temporal_resnet_matches_jax():
    m = tv.AlphaTemporalResnet(16, groups=4)
    params = _block_params(m, C._alpha_temporal_resnet, 20)
    x = np.random.RandomState(20).randn(2, 5, 4, 4, 16).astype(np.float32)
    want = jv.AlphaTemporalResnet(16, groups=4).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cond,inject", [(True, False), (True, True), (False, True)])
def test_spatial_transformer_matches_jax(cond, inject):
    """First-frame K/V through split-KV (or plain self-attention), PnP
    injection of Q, K and the first-frame K over 3 CFG rows."""
    heads, hd, frames = 2, 8, 3
    m = tv.VideoLDMSpatialTransformer(16, heads, hd, 12, cond, groups=4)
    params = _block_params(m, C._videoldm_spatial_transformer, 21)
    rng = np.random.RandomState(21)
    x = rng.randn(3 * frames, 4, 4, 16).astype(np.float32)
    ctx = rng.randn(3, 5, 12).astype(np.float32)
    want = jv.VideoLDMSpatialTransformer(heads, hd, 12, frames, cond, groups=4, pnp_chunks=3
                                         ).apply(params, jnp.asarray(x), jnp.asarray(ctx),
                                                 inject=jnp.bool_(True) if inject else None)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(ctx), frames, inject=inject, pnp_chunks=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rotary,augment,inject", [(True, True, False), (True, True, True),
                                                   (False, False, True)])
def test_temporal_transformer_matches_jax(rotary, augment, inject):
    """Frame-axis self-attention with rotary or sinusoidal positions, the
    augmented first-frame keys, injection before rotation, and the
    cross-attention over [B, F*HW, C] with the query rotated."""
    heads, hd, frames = 2, 8, 4
    m = tv.VideoLDMTemporalTransformer(16, heads, hd, 12, augment, rotary, groups=4)
    params = _block_params(m, C._videoldm_temporal_transformer, 22)
    rng = np.random.RandomState(22)
    x = rng.randn(3 * frames, 4, 4, 16).astype(np.float32)
    ctx = rng.randn(3, 5, 12).astype(np.float32)
    want = jv.VideoLDMTemporalTransformer(heads, hd, 12, frames, augment, rotary, groups=4,
                                          pnp_chunks=3).apply(
        params, jnp.asarray(x), jnp.asarray(ctx), inject=jnp.bool_(True) if inject else None)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(ctx), frames, inject=inject, pnp_chunks=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the UNet and its weights
# ---------------------------------------------------------------------------

VARIANTS = {
    "rotary-augment-concat": {},
    "sinusoidal-plain-conv2d": dict(temp_pos_embedding="sinusoidal",
                                    augment_temporal_attention=False,
                                    first_frame_condition_mode="conv2d"),
}


def tiny_unet(variant: str, seed: int, eps_scale: float = 1.0):
    """(port UNet fp32 on CPU, its state dict, the JAX tree, the JAX config)."""
    cfg = dataclasses.replace(TINY["unet"], dtype=torch.float32, **VARIANTS[variant])
    with torch.device("cpu"):
        unet = tv.VideoLDMUNet(cfg)
    sd = randomize(unet, seed)
    for k in (k for k in sd if k.endswith("alpha")):
        sd[k] = np.full((1,), 0.3, np.float32)   # both gate branches count
    for k in ("conv_out.weight", "conv_out.bias"):
        sd[k] = sd[k] * np.float32(eps_scale)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jcfg = dataclasses.replace(jzoo.CONSISTI2V_TINY["unet"], dtype=jnp.float32,
                               **VARIANTS[variant])
    tree = C.convert_unet_videoldm(sd, cfg.block_out_channels, cfg.layers_per_block)
    return unet, sd, tree, jcfg


def _unet_inputs(batch: int):
    rng = np.random.RandomState(7)
    return dict(sample=rng.randn(batch, 4, 8, 8, 4).astype(np.float32), timestep=501,
                encoder_hidden_states=rng.randn(batch, 7, 32).astype(np.float32),
                first_frame_latents=rng.randn(batch, 1, 8, 8, 4).astype(np.float32),
                frame_stride=3)


@pytest.fixture(scope="module", params=list(VARIANTS))
def unet_pair(request):
    unet, _, tree, jcfg = tiny_unet(request.param, 1)
    junet = jv.VideoLDMUNet(dataclasses.replace(jcfg, pnp_chunks=3))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    fn = jax.jit(lambda inp, flags: junet.apply(params, **inp, pnp=PnPFlags(*flags)))
    return unet, lambda inp, flags: fn(inp, tuple(jnp.bool_(f) for f in flags))


@pytest.mark.parametrize("pnp", [None, (True, True, True), (False, False, True)])
def test_tiny_unet_matches_jax(unet_pair, pnp):
    """At the "text" edit batch [src, uncond, cond]; ``None`` is all flags off."""
    unet, jax_fn = unet_pair
    inp = _unet_inputs(3)
    want = jax_fn({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                   for k, v in inp.items()}, pnp or (False, False, False))
    with torch.no_grad():
        got = unet(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                      for k, v in inp.items()}, pnp=pnp, pnp_chunks=3)
    assert got.shape == (3, 4, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_weights_round_trip_is_exact(variant):
    """convert(state_dict_from_jax(p)) == p, and state_dict_from_jax inverts
    the converter on the port's keys exactly."""
    unet, sd, tree, _ = tiny_unet(variant, 2)
    back = state_dict_from_jax({"unet": tree}, "consisti2v-tiny")["unet"]
    assert set(back) == set(sd) == set(unet.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)
    again = C.convert_unet_videoldm(back, TINY["unet"].block_out_channels,
                                    TINY["unet"].layers_per_block)
    assert C.tree_shapes(again) == C.tree_shapes(tree)


def test_arch_numbers_match_jax_zoo():
    for arch in ("consisti2v", "consisti2v-tiny"):
        assert set(ARCHS[arch]) == set(jzoo.CONSISTI2V_ARCHS[arch])
        for name in ARCHS[arch]:
            mine = dataclasses.asdict(ARCHS[arch][name])
            ref = dataclasses.asdict(jzoo.CONSISTI2V_ARCHS[arch][name])
            mine.pop("dtype"), ref.pop("dtype")
            assert mine == ref, (arch, name)


def test_full_size_state_dict_matches_converter():
    """Full-width consisti2v on the meta device: the port's UNet state dict
    converts through convert_unet_videoldm into exactly the JAX init tree
    (keys and shapes, both ways), and carries the reference checkpoint's
    key names."""
    unet = build_modules("consisti2v", torch.bfloat16)["unet"]
    shapes = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    zeros = {k: np.broadcast_to(np.zeros((), np.int8), s) for k, s in shapes.items()}
    cfg = ARCHS["consisti2v"]["unet"]
    converted = C.convert_unet_videoldm(zeros, cfg.block_out_channels, cfg.layers_per_block)
    junet = jv.VideoLDMUNet(dataclasses.replace(jzoo.CONSISTI2V["unet"], dtype=jnp.float32))
    expected = jax.eval_shape(lambda: junet.init(
        jax.random.PRNGKey(0), sample=jnp.zeros((1, 2, 16, 16, 4)), timestep=jnp.int32(0),
        encoder_hidden_states=jnp.zeros((1, 4, 1024)),
        first_frame_latents=jnp.zeros((1, 1, 16, 16, 4)), frame_stride=jnp.int32(3)))
    C.assert_params_match(expected, converted)
    ref_keys = os.path.join(os.path.dirname(__file__), "fixtures", "consisti2v_unet_keys.json")
    with open(ref_keys) as f:
        reference = {k: tuple(v) for k, v in json.load(f).items()}
    for k, s in shapes.items():
        assert reference.get(k) == s, k


def tiny_trees(seed: int):
    """(port modules fp32 on CPU, JAX trees) for consisti2v-tiny with the
    UNet's output conv scaled by 0.1."""
    unet, _, utree, _ = tiny_unet("rotary-augment-concat", seed, eps_scale=0.1)
    modules = build_modules("consisti2v-tiny", torch.float32, device="cpu")
    modules["unet"] = unet
    trees = {"unet": utree}
    for i, name in enumerate(("vae", "text")):
        sd = randomize(modules[name], seed + 1 + i)
        if name == "vae":
            v = TINY["vae"]
            trees[name] = C.convert_vae(sd, v.block_out_channels, v.layers_per_block)
        else:
            trees[name] = {"params": C.convert_clip_text(sd, TINY["text"].num_layers)}
    return modules, trees
