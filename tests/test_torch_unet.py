"""The port's i2vgen UNet, VAE and CLIP encoders against the JAX package, and
the weights bridge between the two.

Weights are seeded random values in the port's diffusers-keyed state dicts;
the JAX side gets them through ``anyv2v_tpu.utils.convert`` (which pads
attention heads with zeros), and :func:`anyv2v_torch.utils.weights.
state_dict_from_jax` must invert that conversion exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models.clip import CLIPTextModel as JCLIPText, CLIPVisionModel as JCLIPVision
from anyv2v_tpu.models.unet_i2vgen import I2VGenUNet as JUNet, PnPFlags
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE
from anyv2v_tpu.utils import convert as C
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.utils.model_zoo import ARCHS, I2VGEN_XL, build_modules
from anyv2v_torch.utils.weights import state_dict_from_jax
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

TINY = ARCHS["i2vgen-tiny"]


def randomize(module: torch.nn.Module, seed: int) -> dict:
    """Seeded random weights into ``module`` (fan-in scaled matrices, norm
    scales near 1, small biases); returns its state dict as numpy."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        r = torch.randn(v.shape, generator=g)
        if k.endswith("weight") and v.dim() == 1:
            sd[k] = 1.0 + 0.1 * r
        elif v.dim() <= 1:
            sd[k] = 0.1 * r
        else:
            sd[k] = r * float(np.prod(v.shape[1:])) ** -0.5
    module.load_state_dict(sd)
    module.eval()
    return {k: v.numpy() for k, v in sd.items()}


def jax_tree_from_port(name: str, sd: dict) -> dict:
    """The JAX param tree of one i2vgen-tiny component, through the JAX
    package's own converters."""
    if name == "unet":
        u = TINY["unet"]
        return C.convert_unet_i2vgen(sd, u.block_out_channels, u.layers_per_block,
                                     u.num_attention_heads, u.attention_head_dim)
    if name == "vae":
        v = TINY["vae"]
        return C.convert_vae(sd, v.block_out_channels, v.layers_per_block)
    if name == "text":
        return {"params": C.convert_clip_text(sd, TINY["text"].num_layers)}
    return {"params": C.convert_clip_vision(sd, TINY["vision"].num_layers)}


def tiny_models(seed: int = 0, eps_scale: float = 1.0):
    """(port modules fp32 on CPU, their state dicts, JAX trees) for
    i2vgen-tiny; ``eps_scale`` scales the UNet's output conv."""
    modules = build_modules("i2vgen-tiny", torch.float32, device="cpu")
    sds = {name: randomize(m, seed + i) for i, (name, m) in enumerate(modules.items())}
    if eps_scale != 1.0:
        for k in ("conv_out.weight", "conv_out.bias"):
            sds["unet"][k] = sds["unet"][k] * np.float32(eps_scale)
        modules["unet"].load_state_dict({k: torch.from_numpy(v) for k, v in sds["unet"].items()})
    trees = {name: jax_tree_from_port(name, sd) for name, sd in sds.items()}
    return modules, sds, trees


def jax_tiny_config(name: str):
    return dataclasses.replace(jzoo.I2VGEN_TINY[name], dtype=jnp.float32)


@pytest.fixture(scope="module")
def tiny():
    return tiny_models(0)


def _unet_inputs(batch: int, frames: int = 4, hw: int = 8):
    rng = np.random.RandomState(11)
    return dict(
        sample=rng.randn(batch, frames, hw, hw, 4).astype(np.float32),
        timestep=501,
        encoder_hidden_states=rng.randn(batch, 77, 32).astype(np.float32),
        fps=8,
        image_latents=rng.randn(batch, frames, hw, hw, 4).astype(np.float32),
        image_embeddings=rng.randn(batch, 1, 32).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_unet(tiny):
    """The JAX tiny UNet, jitted once with the PnP flags as traced operands."""
    _, _, trees = tiny
    unet = JUNet(jax_tiny_config("unet"))
    params = jax.tree_util.tree_map(jnp.asarray, trees["unet"])
    fn = jax.jit(lambda inp, flags: unet.apply(params, **inp, pnp=PnPFlags(*flags)))
    return lambda inp, flags: fn(inp, tuple(jnp.bool_(f) for f in flags))


@pytest.mark.parametrize("pnp", [None, (True, True, True), (False, False, True)])
def test_tiny_unet_forward_matches_jax(tiny, jax_unet, pnp):
    """At the edit batch [src, uncond, cond]; ``None`` (no PnP machinery) is
    the same function as all flags off."""
    modules = tiny[0]
    inp = _unet_inputs(3)
    want = jax_unet({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                     for k, v in inp.items()}, pnp or (False, False, False))
    with torch.no_grad():
        got = modules["unet"](**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                 for k, v in inp.items()}, pnp=pnp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_tiny_vae_matches_jax(tiny):
    modules, _, trees = tiny
    vae = JVAE(jax_tiny_config("vae"))
    params = jax.tree_util.tree_map(jnp.asarray, trees["vae"])
    rng = np.random.RandomState(12)
    x = rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    z = rng.randn(2, 8, 8, 4).astype(np.float32)
    with torch.no_grad():
        moments = modules["vae"].encode_moments(torch.from_numpy(x))
        img = modules["vae"].decode(torch.from_numpy(z))
    np.testing.assert_allclose(moments.numpy(), np.asarray(
        vae.apply(params, jnp.asarray(x), method="encode_moments")), rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(
        vae.apply(params, jnp.asarray(z), method="decode")), rtol=1e-4, atol=3e-5)


def test_tiny_clip_matches_jax(tiny):
    modules, _, trees = tiny
    rng = np.random.RandomState(13)
    ids = rng.randint(0, 49407, size=(2, 77))
    ids[:, 9] = 49407   # EOS
    hidden, pooled = JCLIPText(jzoo.I2VGEN_TINY["text"]).apply(
        jax.tree_util.tree_map(jnp.asarray, trees["text"]), jnp.asarray(ids))
    img = rng.randn(1, 224, 224, 3).astype(np.float32)
    _, embeds = JCLIPVision(jzoo.I2VGEN_TINY["vision"]).apply(
        jax.tree_util.tree_map(jnp.asarray, trees["vision"]), jnp.asarray(img))
    with torch.no_grad():
        got_h, got_p = modules["text"](torch.from_numpy(ids))
        _, got_e = modules["vision"](torch.from_numpy(img))
    for got, want in ((got_h, hidden), (got_p, pooled), (got_e, embeds)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["unet", "vae", "text", "vision"])
def test_weights_round_trip_is_exact(tiny, name):
    """convert(state_dict_from_jax(p)) == p exactly, and the port's modules
    load and give back the same state dict."""
    modules, _, trees = tiny
    sd = state_dict_from_jax({name: trees[name]}, "i2vgen-tiny")[name]
    again = jax_tree_from_port(name, sd)
    want, got = C.tree_shapes(trees[name]), C.tree_shapes(again)
    assert want == got
    flat_want = jax.tree_util.tree_leaves_with_path(trees[name])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(again))
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(leaf))
    m = build_modules("i2vgen-tiny", torch.float32, device="cpu")[name]
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    back = m.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_padded_heads_must_be_zero(tiny):
    _, _, trees = tiny
    bad = jax.tree_util.tree_map(np.array, trees["unet"])
    q = bad["params"]["image_latents_temporal_encoder"]["attn1"]["to_q"]["kernel"]
    q[:, -1] = 1.0   # a pad column of the second head (dh 4 stored as 8)
    with pytest.raises(ValueError, match="not zero"):
        state_dict_from_jax({"unet": bad}, "i2vgen-tiny")


def test_arch_numbers_match_jax_zoo():
    for arch in ("i2vgen-xl", "i2vgen-tiny"):
        for name in ("unet", "vae", "text", "vision"):
            mine = dataclasses.asdict(ARCHS[arch][name])
            ref = dataclasses.asdict(jzoo.ARCHS[arch][name])
            mine.pop("dtype"), ref.pop("dtype")
            assert mine == ref, (arch, name)


def test_xl_state_dict_matches_converter():
    """Full-width i2vgen-xl, built on the meta device: the port's UNet state
    dict has exactly the keys and (true-width) shapes convert_unet_i2vgen
    turns into the JAX module's init tree."""
    unet = build_modules("i2vgen-xl", torch.bfloat16)["unet"]
    shapes = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    zeros = {k: np.broadcast_to(np.zeros((), np.int8), s) for k, s in shapes.items()}
    cfg = I2VGEN_XL["unet"]
    converted = C.convert_unet_i2vgen(zeros, cfg.block_out_channels, cfg.layers_per_block,
                                      cfg.num_attention_heads, cfg.attention_head_dim)
    junet = JUNet(dataclasses.replace(jzoo.I2VGEN_XL["unet"], dtype=jnp.float32))
    expected = jax.eval_shape(lambda: junet.init(
        jax.random.PRNGKey(0), sample=jnp.zeros((1, 2, 16, 16, 4)), timestep=jnp.int32(0),
        encoder_hidden_states=jnp.zeros((1, 4, 1024)), fps=jnp.int32(8),
        image_latents=jnp.zeros((1, 2, 16, 16, 4)), image_embeddings=jnp.zeros((1, 1, 1024))))
    C.assert_params_match(expected, converted)
    # the head widths are the checkpoint's: 64 heads of 5 at level 0
    assert shapes["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"] == (320, 320)
    assert unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q.weight.shape == (512, 320)
