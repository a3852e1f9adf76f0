"""The port's first-frame editor modules against the JAX package, fp32 on the
CPU: the SD UNet (InstructPix2Pix and CosXL shapes, with IP-Adapter tokens
on a target block and with ControlNet residuals), the ControlNet, CLIP's
penultimate outputs, and the weights bridge both ways at tiny and full
width.

Every JAX side gets its parameters from the port's seeded state dicts
through ``anyv2v_tpu.utils.convert`` (numpy only): no Flax init runs here.
Tolerances: rtol and atol 1e-4 for modules, exact for the weights bridge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import controlnet as jcn
from anyv2v_tpu.models import unet_sd as jsd
from anyv2v_tpu.models.clip import CLIPTextConfig as JTextConfig, CLIPTextModel as JCLIPText
from anyv2v_tpu.models.clip import CLIPVisionConfig as JVisionConfig, CLIPVisionModel as JCLIPVision
from anyv2v_tpu.utils import convert as C
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.models import unet_sd
from anyv2v_torch.models.clip import CLIPTextModel, CLIPVisionModel
from anyv2v_torch.models.layers import Attention
from anyv2v_torch.utils.model_zoo import ARCHS, build_modules
from anyv2v_torch.utils.weights import state_dict_from_jax
from test_torch_seine import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_unet import randomize

TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# helpers shared by the editor test files
# ---------------------------------------------------------------------------


def jax_sd_config(cfg, **changes):
    """The JAX ``SDUNetConfig`` of a port config (fp32)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(jsd.SDUNetConfig)
              if f.name != "dtype"}
    fields.update(changes)
    return jsd.SDUNetConfig(**fields, dtype=jnp.float32)


def ip_blocks(sd: dict, cfg) -> dict:
    """The IP-Adapter weights of a port UNet state dict as
    ``merge_ip_adapter_into_unet``'s per-block trees."""
    out = {}
    for name in cfg.ip_adapter_targets:
        kind, i, _, j = name.split("_")
        prefix = f"{kind}_blocks.{i}.attentions.{j}.transformer_blocks."
        for k, v in sd.items():
            if k.startswith(prefix) and ".attn2.to_" in k and "_ip." in k:
                blk, proj = k[len(prefix):].split(".")[0], k.split(".")[-2]
                out.setdefault(name, {}).setdefault(f"blocks_{blk}", {"attn2": {}})[
                    "attn2"][proj] = {"kernel": np.ascontiguousarray(v.T)}
    return out


def jax_unet_tree(sd: dict, cfg) -> dict:
    """The JAX SDUNet params of a port state dict (``convert_unet_sd`` with
    the IP-Adapter weights merged in)."""
    tree = C.convert_unet_sd(sd, cfg.block_out_channels, cfg.layers_per_block,
                             cfg.cross_attn_blocks, cfg.transformer_depth, cfg.addition_embed,
                             cfg.num_attention_heads)
    blocks = ip_blocks(sd, cfg)
    return C.merge_ip_adapter_into_unet(tree, blocks) if blocks else tree


def jax_controlnet_tree(sd: dict, cfg) -> dict:
    return C.convert_controlnet(sd, cfg.block_out_channels, cfg.layers_per_block,
                                cfg.cross_attn_blocks, cfg.transformer_depth)


def editor_models(arch: str, seed: int = 0, eps_scale: float = 0.1):
    """(port modules fp32 on the CPU with seeded weights, their state dicts,
    the JAX param trees of the same weights) for every component of an
    editor ``arch``. ``eps_scale`` scales the UNet's output conv, so that a
    random UNet's prediction has about a trained one's unit scale and the
    guidance (7.5 x a difference of predictions) does not blow the latent
    up over a few steps."""
    spec = ARCHS[arch]
    modules = build_modules(arch, torch.float32, device="cpu")
    sds = {name: randomize(m, seed + i) for i, (name, m) in enumerate(modules.items())}
    for k in ("conv_out.weight", "conv_out.bias"):
        sds["unet"][k] = sds["unet"][k] * np.float32(eps_scale)
    modules["unet"].load_state_dict({k: torch.from_numpy(v) for k, v in sds["unet"].items()})
    trees = {}
    for name, sd in sds.items():
        cfg = spec[name]
        if name == "unet":
            trees[name] = jax_unet_tree(sd, cfg)
        elif name == "controlnet":
            trees[name] = jax_controlnet_tree(sd, cfg)
        elif name == "vae":
            trees[name] = C.convert_vae(sd, cfg.block_out_channels, cfg.layers_per_block)
        elif name == "text":
            trees[name] = {"params": C.convert_clip_text(sd, cfg.num_layers)}
        else:
            trees[name] = {"params": {"proj": C.t_linear(sd, "proj"), "norm": C.t_norm(sd, "norm")}}
    return modules, sds, trees


def sdxl_kwargs(cfg, b, rng):
    """SDXL's addition-embedding inputs, or nothing for SD1.5."""
    if cfg.addition_embed != "sdxl":
        return {}
    pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    return {"added_text_embeds": rng.randn(b, pooled).astype(np.float32),
            "added_time_ids": np.tile(np.float32([[64, 48, 0, 0, 64, 48]]), (b, 1))}


def _to_jax(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                else tuple(jnp.asarray(r) for r in v) if isinstance(v, tuple) else v)
            for k, v in kw.items()}


def _to_torch(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                else tuple(torch.from_numpy(r) for r in v) if isinstance(v, tuple) else v)
            for k, v in kw.items()}


# ---------------------------------------------------------------------------
# the UNet and the ControlNet against JAX
# ---------------------------------------------------------------------------


def _residuals(cfg, b, h, rng):
    """ControlNet-shaped residuals: one per skip, and the mid one."""
    shapes = [(h, cfg.block_out_channels[0])]
    n = len(cfg.block_out_channels)
    for i, ch in enumerate(cfg.block_out_channels):
        shapes += [(h, ch)] * cfg.layers_per_block
        if i < n - 1:
            h //= 2
            shapes.append((h, ch))
    down = tuple(0.5 * rng.randn(b, s, s, c).astype(np.float32) for s, c in shapes)
    mid = 0.5 * rng.randn(b, h, h, cfg.block_out_channels[-1]).astype(np.float32)
    return down, mid


@pytest.mark.parametrize("arch,extra", [("instructpix2pix-tiny", None), ("cosxl-tiny", None),
                                        ("instantstyle-tiny", "ip"),
                                        ("instantstyle-tiny", "ip+controlnet")])
def test_sd_unet_matches_jax(arch, extra):
    """One forward at batch 2 on a 16x16 latent with a float timestep
    (EDM's negative ``0.25 ln sigma`` for CosXL): the IP tokens reach only
    ``up_0_attn_1``; ControlNet residuals go to the skips and after the mid
    block."""
    cfg = ARCHS[arch]["unet"]
    unet = build_modules(arch, torch.float32, device="cpu")["unet"]
    sd = randomize(unet, 3)
    rng = np.random.RandomState(4)
    b, h = 2, 16
    t = -1.37 if arch.startswith("cosxl") else 612.25
    kw = {"sample": rng.randn(b, h, h, cfg.in_channels).astype(np.float32),
          "timestep": t,
          "encoder_hidden_states": rng.randn(b, 7, cfg.cross_attention_dim).astype(np.float32),
          **sdxl_kwargs(cfg, b, rng)}
    if extra:
        kw.update(ip_tokens=rng.randn(b, 4, cfg.cross_attention_dim).astype(np.float32),
                  ip_scale=0.7)
    if extra == "ip+controlnet":
        kw["down_block_residuals"], kw["mid_block_residual"] = _residuals(cfg, b, h, rng)
    junet = jsd.SDUNet(jax_sd_config(cfg))
    want = junet.apply(jax_unet_tree(sd, cfg), **_to_jax(kw))
    with torch.no_grad():
        got = unet(**_to_torch(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if extra:   # the IP branch is live: without the tokens the output moves
        with torch.no_grad():
            plain = unet(**_to_torch({k: v for k, v in kw.items() if k != "ip_tokens"}))
        assert float((plain - got).abs().max()) > 1e-3


def test_controlnet_matches_jax():
    """instantstyle-tiny's ControlNet: the conditioning pyramid on a 128x128
    control image, residuals per skip and the mid residual, at scale 0.6."""
    cfg = ARCHS["instantstyle-tiny"]["controlnet"]
    cn = build_modules("instantstyle-tiny", torch.float32, device="cpu")["controlnet"]
    sd = randomize(cn, 5)
    rng = np.random.RandomState(6)
    b = 2
    kw = {"sample": rng.randn(b, 16, 16, 4).astype(np.float32), "timestep": 401.5,
          "encoder_hidden_states": rng.randn(b, 7, 16).astype(np.float32),
          "controlnet_cond": rng.rand(b, 128, 128, 3).astype(np.float32),
          "conditioning_scale": 0.6, **sdxl_kwargs(cfg, b, rng)}
    jmod = jcn.ControlNet(jax_sd_config(cfg))
    want_down, want_mid = jmod.apply(jax_controlnet_tree(sd, cfg), **_to_jax(kw))
    with torch.no_grad():
        got_down, got_mid = cn(**_to_torch(kw))
    assert len(got_down) == len(want_down) == 1 + 3 * 1 + 2
    for g, w in zip(got_down, want_down):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(want_mid), **TOL)


@pytest.mark.parametrize("which", ["text", "vision"])
def test_clip_penultimate_matches_jax(which):
    """``penultimate=True``: the hidden state before the last layer, no final
    norm; the pooled output still from the whole stack."""
    from anyv2v_torch.models.clip import CLIPTextConfig, CLIPVisionConfig

    if which == "text":
        cfg = CLIPTextConfig(vocab_size=100, hidden_size=16, intermediate_size=32, num_layers=3,
                             num_heads=2, eos_token_id=99, projection_dim=16)
        model = CLIPTextModel(cfg)
        ids = np.random.RandomState(7).randint(0, 98, (2, 9))
        ids[:, 6] = 99
        x_t, x_j = torch.from_numpy(ids), jnp.asarray(ids)
        jmod = JCLIPText(JTextConfig(vocab_size=100, hidden_size=16, intermediate_size=32,
                                             num_layers=3, num_heads=2, eos_token_id=99,
                                             projection_dim=16))
        tree = {"params": C.convert_clip_text(randomize(model, 8), num_layers=3)}
    else:
        cfg = CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_layers=3, num_heads=2,
                               image_size=32, patch_size=16, projection_dim=8)
        model = CLIPVisionModel(cfg)
        px = np.random.RandomState(9).randn(2, 32, 32, 3).astype(np.float32)
        x_t, x_j = torch.from_numpy(px), jnp.asarray(px)

        jmod = JCLIPVision(JVisionConfig(hidden_size=16, intermediate_size=32, num_layers=3,
                                         num_heads=2, image_size=32, patch_size=16,
                                         projection_dim=8))
        tree = {"params": C.convert_clip_vision(randomize(model, 10), num_layers=3)}
    for pen in (False, True):
        want_h, want_p = jmod.apply(tree, x_j, penultimate=pen)
        with torch.no_grad():
            got_h, got_p = model(x_t, penultimate=pen)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


# ---------------------------------------------------------------------------
# the weights bridge
# ---------------------------------------------------------------------------


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("arch", ["instructpix2pix-tiny", "cosxl-tiny", "instantstyle-tiny"])
def test_jax_params_round_trip_exactly(arch):
    """JAX params -> ``state_dict_from_jax`` -> the port's modules -> their
    state dicts -> the JAX converters give back the same trees, bit for bit
    (instructpix2pix-tiny's 4-wide heads padded by both packages;
    instantstyle-tiny with its IP-Adapter weights and ControlNet)."""
    spec = ARCHS[arch]
    modules = build_modules(arch, torch.float32, device="cpu")
    sds = {name: randomize(m, 11 + i) for i, (name, m) in enumerate(modules.items())}
    cfg = spec["unet"]
    params = {"unet": jax_unet_tree(sds["unet"], cfg)}
    if "controlnet" in spec:
        params["controlnet"] = jax_controlnet_tree(sds["controlnet"], spec["controlnet"])
    back = state_dict_from_jax(params, arch)
    for name in params:
        modules[name].load_state_dict({k: torch.from_numpy(v) for k, v in back[name].items()},
                                      strict=True)
        again = {k: v.numpy() for k, v in modules[name].state_dict().items()}
        tree = (jax_unet_tree(again, cfg) if name == "unet"
                else jax_controlnet_tree(again, spec["controlnet"]))
        _assert_trees_equal(tree, params[name])


def test_ip_projection_heads_pad_and_strip():
    """A padded head split (4 wide, stored 8) pads and strips ``to_k_ip`` /
    ``to_v_ip`` as it does ``to_k`` / ``to_v``."""
    attn = Attention(8, heads=2, head_dim=4, cross_attention_dim=6, ip=True)
    assert attn.to_k_ip.weight.shape == (16, 6)
    sd = randomize(attn, 12)
    assert sd["to_k_ip.weight"].shape == (8, 6)
    w = attn.to_v_ip.weight.detach().reshape(2, 8, 6)
    assert torch.equal(w[:, 4:], torch.zeros(2, 4, 6))
    np.testing.assert_array_equal(w[:, :4].reshape(8, 6).numpy(), sd["to_v_ip.weight"])


def _jax_init_shapes(kind, cfg):
    jcfg = jax_sd_config(cfg)
    b, hw = 1, 16
    pooled = jcfg.projection_class_embeddings_input_dim - 6 * jcfg.addition_time_embed_dim
    kw = dict(sample=jnp.zeros((b, hw, hw, cfg.in_channels)), timestep=jnp.float32(1.0),
              encoder_hidden_states=jnp.zeros((b, 4, cfg.cross_attention_dim)))
    if cfg.addition_embed == "sdxl":
        kw.update(added_text_embeds=jnp.zeros((b, pooled)), added_time_ids=jnp.zeros((b, 6)))
    if kind == "controlnet":
        module = jcn.ControlNet(jcfg)
        kw["controlnet_cond"] = jnp.zeros((b, 8 * hw, 8 * hw, 3))
    else:
        module = jsd.SDUNet(jcfg)
        if cfg.ip_adapter_targets:
            kw["ip_tokens"] = jnp.zeros((b, 4, cfg.cross_attention_dim))
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), **kw))


@pytest.mark.parametrize("arch,kind", [("instructpix2pix", "unet"), ("cosxl", "unet"),
                                       ("instantstyle", "controlnet")])
def test_full_width_state_dict_matches_jax_init(arch, kind):
    """Full-width modules built on the meta device: the port's state dict
    has exactly the keys and shapes the JAX converters turn into the JAX
    module's init tree, and that tree carried back by
    ``state_dict_from_jax`` loads into the port's module with strict keys."""
    cfg = ARCHS[arch][kind]
    module = build_modules(arch, torch.bfloat16)[kind]
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    zeros = {k: np.broadcast_to(np.zeros((), np.int8), s) for k, s in shapes.items()}
    converted = (jax_unet_tree(zeros, cfg) if kind == "unet" else jax_controlnet_tree(zeros, cfg))
    expected = _jax_init_shapes(kind, cfg)
    C.assert_params_match(expected, converted)
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.int8), expected)
    back = state_dict_from_jax({kind: tree}, arch)[kind]
    module.load_state_dict({k: torch.from_numpy(v).to("meta") for k, v in back.items()},
                           strict=True)
    assert {k: v.shape for k, v in back.items()} == shapes


def test_arch_numbers_match_jax():
    """The port's editor configurations are the JAX package's, field for
    field (the port's ``linear_projection`` is a storage choice the JAX
    converter reads either way)."""
    for arch in ("instructpix2pix", "magicbrush", "cosxl", "instructpix2pix-tiny",
                 "magicbrush-tiny", "cosxl-tiny"):
        want = jzoo.IMAGE_EDIT_ARCHS[arch]
        assert jax_sd_config(ARCHS[arch]["unet"]) == dataclasses.replace(
            want["unet"], dtype=jnp.float32), arch
        for f in ("block_out_channels", "layers_per_block", "norm_num_groups",
                  "scaling_factor", "latent_channels"):
            assert getattr(ARCHS[arch]["vae"], f) == getattr(want["vae"], f), (arch, f)
        if want["text"] is not None:
            for f in ("hidden_size", "intermediate_size", "num_layers", "num_heads",
                      "hidden_act", "projection_dim"):
                assert getattr(ARCHS[arch]["text"], f) == getattr(want["text"], f), (arch, f)
    assert unet_sd.SDXL_COSXL.linear_projection and not unet_sd.SD15_IP2P.linear_projection


def test_sdxl_prompt_encoding_matches_jax():
    """SDXL's two text encoders (tiny): both penultimate hidden states
    concatenated on the feature axis, and the second encoder's projected
    pooled output, against the JAX ``encode_sdxl_prompt`` on the same
    weights."""
    from anyv2v_torch.utils.model_zoo import (SDXL_TEXT_1_TINY, SDXL_TEXT_2_TINY,
                                              build_sdxl_text_encoders, encode_sdxl_prompt)

    enc1, enc2 = build_sdxl_text_encoders(device="cpu", tiny=True, seed=3, dtype=torch.float32)
    jencs = []
    for cfg, enc in ((SDXL_TEXT_1_TINY, enc1), (SDXL_TEXT_2_TINY, enc2)):
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JTextConfig)
                  if f.name != "dtype"}
        sd = {k: v.numpy() for k, v in enc.state_dict().items()}
        jencs += [JCLIPText(JTextConfig(**fields)),
                  {"params": C.convert_clip_text(sd, cfg.num_layers)}]
    assert SDXL_TEXT_2_TINY.projection_dim == jzoo.SDXL_TEXT_2_TINY.projection_dim
    ids = np.random.RandomState(13).randint(0, 49000, (2, 77))
    ids[:, 9] = 49407
    want_h, want_p = jzoo.encode_sdxl_prompt(*jencs, jnp.asarray(ids), jnp.asarray(ids))
    got_h, got_p = encode_sdxl_prompt(enc1, enc2, torch.from_numpy(ids), torch.from_numpy(ids))
    assert got_h.shape == (2, 77, 32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
