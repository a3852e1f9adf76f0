"""Checkpoint folders in the port (``anyv2v_torch/utils/checkpoint.py``,
``cli/convert_checkpoint.py``, ``model_zoo``'s ``init``) against the JAX
converters, on the CPU.

- The port's safetensors reader returns what the ``safetensors`` package
  reads, bit for bit, for fp32, fp16, bf16 and int64 across two shards; the
  folder writer of ``chip_smoke.py`` (used here and on the card) writes
  files that package reads back exactly.
- Tiny i2vgen-xl (heads of 4 and 8 wide, padded at load), ConsistI2V and
  SEINE folders (SEINE: an SD1.4-style folder plus a ``seine.pt`` holding
  an ``ema`` dict) are written from seeded port weights. The JAX converters
  on the same folder, then ``state_dict_from_jax``, give the folder's
  tensors exactly, and the architecture the port derives from the
  ``config.json`` files is the JAX converters'.
- The port's CLI output loads through ``init`` into modules built from
  that architecture with strict keys, every tensor equal to the folder's
  (in fp16 too, in the checkpoint's dtype); a JAX ``save_params`` file still
  loads.
- A ``config.json`` field the port's modules cannot take raises and names
  the field; a missing tensor fails the strict validation.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

import chip_smoke
from anyv2v_tpu.utils import convert as jconvert
from anyv2v_tpu.utils.model_zoo import save_params
from anyv2v_torch.cli import convert_checkpoint
from anyv2v_torch.utils import checkpoint
from anyv2v_torch.utils.model_zoo import (_MODULES, ARCHS, build_consisti2v_pipeline,
                                          build_i2vgen_pipeline, build_seine_pipeline,
                                          random_state_dict)
from anyv2v_torch.utils.weights import state_dict_from_jax

# i2vgen-tiny with one head count (the diffusers rule): 4 heads of 4 and 8
I2VGEN_SPEC = dict(ARCHS["i2vgen-tiny"],
                   unet=dataclasses.replace(ARCHS["i2vgen-tiny"]["unet"], num_attention_heads=4))
SPECS = {"i2vgen-xl": ("i2vgen-tiny", I2VGEN_SPEC),
         "consisti2v": ("consisti2v-tiny", ARCHS["consisti2v-tiny"]),
         "seine": ("seine-tiny", ARCHS["seine-tiny"])}
BUILD = {"i2vgen-xl": build_i2vgen_pipeline, "consisti2v": build_consisti2v_pipeline,
         "seine": build_seine_pipeline}


# ---------------------------------------------------------------------------
# reading and writing safetensors
# ---------------------------------------------------------------------------


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w32": torch.randn(3, 5, generator=g),
            "w16": torch.randn(7, generator=g).half(),
            "wbf": torch.randn(2, 3, 4, generator=g).bfloat16(),
            "idx": torch.randint(-9, 2**40, (4,), generator=g),
            "scalar": torch.tensor(2.5)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_reader_matches_safetensors_across_shards(tmp_path):
    shards = [_tensors(0), {f"b.{k}": v for k, v in _tensors(1).items()}]
    for i, sd in enumerate(shards):
        safetensors.torch.save_file(sd, str(tmp_path / f"model-{i + 1:05d}-of-00002.safetensors"))
    got = checkpoint.load_folder_state_dict(str(tmp_path))
    want = {}
    for i in range(2):
        want.update(safetensors.torch.load_file(
            str(tmp_path / f"model-{i + 1:05d}-of-00002.safetensors")))
    assert set(got) == set(want) and len(got) == 10
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    # the numpy reader of the package agrees on every dtype numpy has
    plain = {k: v for k, v in _tensors(2).items() if v.dtype != torch.bfloat16}
    safetensors.numpy.save_file({k: v.numpy() for k, v in plain.items()},
                                str(tmp_path / "np.safetensors"))
    np_want = safetensors.numpy.load_file(str(tmp_path / "np.safetensors"))
    for k, v in checkpoint.read_safetensors(str(tmp_path / "np.safetensors")).items():
        np.testing.assert_array_equal(v.numpy(), np_want[k])
        assert v.numpy().dtype == np_want[k].dtype


def test_writer_is_read_back_by_safetensors(tmp_path):
    sd = _tensors(3)
    chip_smoke.write_safetensors(str(tmp_path / "w.safetensors"), sd)
    back = safetensors.torch.load_file(str(tmp_path / "w.safetensors"))
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(_bits(back[k]), _bits(sd[k]))


def test_pickles_unwrap_ema_then_state_dict(tmp_path):
    sd = _tensors(4)
    torch.save({"ema": sd, "other": {"step": 3}}, str(tmp_path / "seine.pt"))
    torch.save({"state_dict": sd}, str(tmp_path / "model.ckpt"))
    for name in ("seine.pt", "model.ckpt"):
        got = checkpoint.load_torch_state_dict(str(tmp_path / name))
        assert set(got) == set(sd) and all(torch.equal(_bits(got[k]), _bits(sd[k])) for k in sd)
    folder = tmp_path / "bin"
    folder.mkdir()
    torch.save(sd, str(folder / "pytorch_model.bin"))
    assert set(checkpoint.load_folder_state_dict(str(folder))) == set(sd)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_folder_state_dict(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# tiny folders of the three backbones
# ---------------------------------------------------------------------------


def _seeded(spec, seed, dtype):
    """Seeded port weights for the components of ``spec``, in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, cfg in spec.items():
        with torch.device("meta"):
            m = _MODULES[type(cfg)](cfg)
        out[name] = {k: v.to(dtype) for k, v in
                     random_state_dict(m, g, torch.device("cpu")).items()}
    return out


def _write(root, backbone, dtype=torch.float32, seed=0):
    """(folder, seine.pt or None, the state dicts written) of a tiny
    ``backbone``."""
    _, spec = SPECS[backbone]
    states = _seeded(spec, seed, dtype)
    src = os.path.join(root, backbone)
    if backbone == "seine":
        chip_smoke.write_snapshot(src, {"unet": (spec["unet"], None),
                                        "vae": (spec["vae"], states["vae"]),
                                        "text": (spec["text"], states["text"])})
        ckpt = os.path.join(root, "seine.pt")
        torch.save({"ema": states["unet"], "opt": {"lr": 1e-4}}, ckpt)
        return src, ckpt, states
    chip_smoke.write_snapshot(src, {n: (spec[n], states[n]) for n in spec},
                              shards={"unet": 2})
    return src, None, states


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("folders"))
    return {b: _write(root, b) for b in SPECS}


def _jax_convert(backbone, src, ckpt):
    if backbone == "i2vgen-xl":
        return jconvert.convert_i2vgen_pipeline_dir(src)
    if backbone == "consisti2v":
        return jconvert.convert_consisti2v_dir(src)
    unet = ARCHS["seine-tiny"]["unet"]
    return jconvert.convert_seine_checkpoint(src, ckpt,
                                             block_out_channels=unet.block_out_channels,
                                             layers_per_block=unet.layers_per_block)


@pytest.mark.parametrize("backbone", sorted(SPECS))
def test_jax_converters_read_the_folder_tensors(folders, backbone):
    """The JAX converters on the folder, carried back by ``state_dict_from_jax``,
    equal the tensors written (the heads padded by the JAX converter are
    unpadded), and the port reads the same tensors from the folder."""
    src, ckpt, written = folders[backbone]
    params, _ = _jax_convert(backbone, src, ckpt)
    _, spec = SPECS[backbone]
    back = state_dict_from_jax(params, spec)
    states, _ = convert_checkpoint.convert(backbone, src, ckpt)
    assert set(back) == set(written) == set(states)
    for name in written:
        assert set(back[name]) == set(written[name]) == set(states[name]), name
        for k, v in written[name].items():
            np.testing.assert_array_equal(back[name][k], v.numpy(), err_msg=f"{name} {k}")
            assert torch.equal(states[name][k], v), f"{name} {k}"


@pytest.mark.parametrize("backbone", sorted(SPECS))
def test_architecture_from_config_json(folders, backbone):
    """The port's fields are the tiny architecture the folder was written
    from, and i2vgen-xl's head count and context tokens are the JAX
    converter's."""
    src, ckpt, _ = folders[backbone]
    _, meta = convert_checkpoint.convert(backbone, src, ckpt)
    _, spec = SPECS[backbone]
    for name, fields in checkpoint.config_overrides(meta).items():
        for k, v in fields.items():
            assert getattr(spec[name], k) == v, (name, k)
    if backbone == "i2vgen-xl":
        _, jmeta = _jax_convert(backbone, src, ckpt)
        for k, v in jmeta["unet"].items():
            assert meta["arch"]["unet"][k] == v, k
        with open(os.path.join(src, "unet", "config.json")) as f:
            cfg = json.load(f)
        # the head count stands under attention_head_dim, as in the checkpoint
        assert cfg["num_attention_heads"] is None and cfg["attention_head_dim"] == 4


@pytest.mark.parametrize("cfg", [{"attention_head_dim": 64}, {"num_attention_heads": None,
                                                               "attention_head_dim": 10},
                                 {"num_attention_heads": 5, "attention_head_dim": 64}, {}])
def test_head_rule_matches_jax(cfg):
    assert checkpoint.resolve_i2vgen_heads(cfg) == jconvert.resolve_i2vgen_heads(cfg)


@pytest.mark.parametrize("backbone", sorted(SPECS))
def test_cli_output_loads_through_init(folders, tmp_path, backbone):
    src, ckpt, written = folders[backbone]
    out = str(tmp_path / "out.npz")
    argv = ["--backbone", backbone, "--src", src, "--out", out]
    convert_checkpoint.main(argv + (["--ckpt", ckpt] if ckpt else []))
    arch, _ = SPECS[backbone]
    pipe = BUILD[backbone](arch, device="cpu", init=out, dtype=torch.float32)
    modules = {"unet": pipe.unet, "vae": pipe.vae, "text": pipe.text_encoder}
    if backbone == "i2vgen-xl":
        modules["vision"] = pipe.vision_encoder
        assert pipe.unet.config.num_attention_heads == 4
    for name, m in modules.items():
        got = m.state_dict()
        assert set(got) == set(written[name]), name
        for k, v in written[name].items():
            assert torch.equal(got[k], v), f"{name} {k}"


def test_fp16_folder_keeps_its_dtype(tmp_path):
    src, _, written = _write(str(tmp_path), "consisti2v", dtype=torch.float16, seed=1)
    out = str(tmp_path / "half.npz")
    convert_checkpoint.main(["--backbone", "consisti2v", "--src", src, "--out", out])
    states, meta = checkpoint.load_checkpoint(out)
    assert meta["backbone"] == "consisti2v" and meta["layout"] == checkpoint.LAYOUT
    assert all(v.dtype == torch.float16 and torch.equal(v, written[n][k])
               for n in written for k, v in states[n].items())
    pipe = build_consisti2v_pipeline("consisti2v-tiny", device="cpu", init=out,
                                     dtype=torch.bfloat16)
    got = pipe.unet.state_dict()
    assert all(torch.equal(got[k], v.to(torch.bfloat16)) for k, v in written["unet"].items())
    # bf16 tensors are kept as their bits
    states["text"] = {k: v.bfloat16() for k, v in states["text"].items()}
    checkpoint.save_checkpoint(str(tmp_path / "bf.npz"), states, meta)
    back, _ = checkpoint.load_checkpoint(str(tmp_path / "bf.npz"))
    assert all(back["text"][k].dtype == torch.bfloat16
               and torch.equal(_bits(back["text"][k]), _bits(v)) for k, v in states["text"].items())


def test_a_jax_save_params_file_still_loads(folders, tmp_path):
    src, _, written = folders["consisti2v"]
    params, meta = jconvert.convert_consisti2v_dir(src)
    out = str(tmp_path / "jax.npz")
    save_params(out, params, meta=meta)
    assert not checkpoint.is_port_checkpoint(checkpoint.read_meta(out))
    pipe = build_consisti2v_pipeline("consisti2v-tiny", device="cpu", init=out,
                                     dtype=torch.float32)
    got = pipe.unet.state_dict()
    assert all(torch.equal(got[k], v) for k, v in written["unet"].items())


def test_a_checkpoint_of_another_backbone_is_refused(folders, tmp_path):
    src, _, _ = folders["consisti2v"]
    out = str(tmp_path / "c.npz")
    convert_checkpoint.main(["--backbone", "consisti2v", "--src", src, "--out", out])
    with pytest.raises(ValueError, match="consisti2v checkpoint"):
        build_seine_pipeline("seine-tiny", device="cpu", init=out, dtype=torch.float32)


def _edited(tmp_path, folders, backbone, sub, **fields):
    src = str(tmp_path / backbone)
    shutil.copytree(folders[backbone][0], src)
    path = os.path.join(src, sub, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(fields)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return src


@pytest.mark.parametrize("backbone,sub,fields,named", [
    ("consisti2v", "text_encoder", {"hidden_act": "relu"}, "hidden_act"),
    ("consisti2v", "unet", {"first_frame_condition_mode": "cross"}, "first_frame_condition_mode"),
    ("consisti2v", "unet", {"temp_pos_embedding": "learned"}, "temp_pos_embedding"),
    ("consisti2v", "unet", {"attention_head_dim": [2, 2, 4, 4]}, "attention_head_dim"),
    ("consisti2v", "unet", {"down_block_types": ["DownBlock2D"] * 4}, "down_block_types"),
    ("i2vgen-xl", "unet", {"attention_head_dim": 3}, "num_attention_heads"),
    ("i2vgen-xl", "unet", {"norm_num_groups": 5}, "norm_num_groups"),
    ("i2vgen-xl", "image_encoder", {"hidden_act": "silu"}, "hidden_act"),
])
def test_a_field_the_port_cannot_take_is_named(folders, tmp_path, backbone, sub, fields, named):
    src = _edited(tmp_path, folders, backbone, sub, **fields)
    with pytest.raises(ValueError, match=named):
        convert_checkpoint.convert(backbone, src)


def test_validation_is_strict(folders):
    src, _, _ = folders["consisti2v"]
    states, meta = checkpoint.convert_consisti2v_dir(src)
    checkpoint.validate(states, meta, "consisti2v")
    states["unet"].pop("conv_in.weight")
    with pytest.raises(RuntimeError, match="conv_in.weight"):
        checkpoint.validate(states, meta, "consisti2v")


def test_editors_and_seine_without_ckpt_are_refused(folders, editor_folders):
    """An SD1.5 editor folder is not a CosXL checkpoint, nor the reverse;
    SEINE needs its ``seine.pt``."""
    with pytest.raises(ValueError, match="not a cosxl"):
        convert_checkpoint.convert("cosxl", editor_folders["instructpix2pix"][0])
    with pytest.raises(ValueError, match="not a instructpix2pix"):
        convert_checkpoint.convert("instructpix2pix", editor_folders["cosxl"][0])
    with pytest.raises(ValueError, match="--ckpt"):
        convert_checkpoint.convert("seine", folders["seine"][0])


# ---------------------------------------------------------------------------
# the first-frame editors' folders and the IP-Adapter file
# ---------------------------------------------------------------------------

EDITOR_SPECS = {"instructpix2pix": "instructpix2pix-tiny", "cosxl": "cosxl-tiny"}


@pytest.fixture(scope="module")
def editor_folders(tmp_path_factory):
    """Tiny SD1.5-layout (ip2p: 4-wide heads at level 0, padded at load) and
    SDXL-layout (CosXL: per-level heads and depths, text_time addition
    embedding, linear projections) folders from seeded port weights."""
    root = str(tmp_path_factory.mktemp("editors"))
    out = {}
    for i, (backbone, arch) in enumerate(EDITOR_SPECS.items()):
        spec = ARCHS[arch]
        states = _seeded(spec, 60 + i, torch.float32)
        src = os.path.join(root, backbone)
        chip_smoke.write_snapshot(src, {n: (spec[n], states[n]) for n in spec},
                                  shards={"unet": 2})
        out[backbone] = (src, arch, states)
    return out


@pytest.mark.parametrize("backbone", sorted(EDITOR_SPECS))
def test_editor_folders_match_jax_converter(editor_folders, backbone):
    """``--backbone instructpix2pix|cosxl``: the port reads the folder's
    tensors as written, the JAX ``convert_sd_editor_dir`` on the same folder
    carried back by ``state_dict_from_jax`` gives them exactly, and the
    architecture from ``config.json`` is the tiny arch the folder came from."""
    src, arch, written = editor_folders[backbone]
    states, meta = convert_checkpoint.convert(backbone, src)
    params, jmeta = jconvert.convert_sd_editor_dir(src, backbone)
    assert jmeta["sdxl"] == (backbone == "cosxl") and meta["backbone"] == backbone
    back = state_dict_from_jax(params, ARCHS[arch])
    assert set(back) == set(states) == set(written)
    for name in written:
        assert set(back[name]) == set(states[name]) == set(written[name]), name
        for k, v in written[name].items():
            np.testing.assert_array_equal(back[name][k], v.numpy(), err_msg=f"{name} {k}")
            assert torch.equal(states[name][k], v), f"{name} {k}"
    for name, fields in checkpoint.config_overrides(meta).items():
        for k, v in fields.items():
            assert getattr(ARCHS[arch][name], k) == v, (name, k)


@pytest.mark.parametrize("backbone", sorted(EDITOR_SPECS))
def test_editor_cli_output_loads_through_init(editor_folders, tmp_path, backbone):
    from anyv2v_torch.utils.model_zoo import build_image_edit_pipeline

    src, arch, written = editor_folders[backbone]
    out = str(tmp_path / "out.npz")
    convert_checkpoint.main(["--backbone", backbone, "--src", src, "--out", out])
    pipe = build_image_edit_pipeline(arch, device="cpu", init=out, dtype=torch.float32)
    for name, sd in written.items():
        got = getattr(pipe, {"text": "text_encoder"}.get(name, name)).state_dict()
        assert set(got) == set(sd) and all(torch.equal(got[k], v) for k, v in sd.items()), name


def test_ip_adapter_reader_matches_jax(tmp_path):
    """A synthetic ``ip-adapter_sdxl.bin`` at instantstyle-tiny's widths (as
    ``test_convert_golden.py`` builds one: every attn2's weights filled with
    its position): the port's reader and the JAX ``convert_ip_adapter`` pick
    the same weights for ``up_0_attn_1``, and they load into the UNet."""
    from anyv2v_torch.utils.model_zoo import build_modules
    from anyv2v_torch.utils.weights import image_proj_state_dict

    cfg = ARCHS["instantstyle-tiny"]["unet"]
    ch, ctx = cfg.block_out_channels, cfg.cross_attention_dim
    order = jconvert.sdxl_attn2_order(ch, cfg.layers_per_block, cfg.cross_attn_blocks,
                                      cfg.transformer_depth)
    assert checkpoint.sdxl_attn2_order(cfg) == order
    g = torch.Generator().manual_seed(70)
    ip = {"image_proj": {"proj.weight": torch.randn(4 * ctx, 16, generator=g),
                         "proj.bias": torch.randn(4 * ctx, generator=g),
                         "norm.weight": torch.randn(ctx, generator=g),
                         "norm.bias": torch.randn(ctx, generator=g)},
          "ip_adapter": {}}
    for pos, (kind, i, _, _) in enumerate(order):
        c = ch[-1] if kind == "mid" else ch[i] if kind == "down" else ch[::-1][i]
        for proj in ("to_k_ip", "to_v_ip"):
            ip["ip_adapter"][f"{2 * pos + 1}.{proj}.weight"] = torch.full(
                (c, ctx), float(pos)) + torch.randn(c, ctx, generator=g)
    path = str(tmp_path / "ip-adapter_sdxl.bin")
    torch.save(ip, path)
    proj, unet_keys = checkpoint.read_ip_adapter(path, cfg)
    jproj, per_block = jconvert.convert_ip_adapter(
        {part: {k: v.numpy() for k, v in sd.items()} for part, sd in ip.items()},
        cfg.ip_adapter_targets, ch, cfg.layers_per_block, cfg.cross_attn_blocks,
        cfg.transformer_depth)
    back = image_proj_state_dict(jproj)
    assert set(back) == set(proj)
    for k, v in proj.items():
        np.testing.assert_array_equal(back[k], v.numpy())
    want = {f"up_blocks.0.attentions.1.transformer_blocks.{b[len('blocks_'):]}.attn2.{p}.weight":
            t["attn2"][p]["kernel"].T
            for b, t in per_block["up_0_attn_1"].items() for p in ("to_k_ip", "to_v_ip")}
    assert set(want) == set(unet_keys) and len(want) == 2 * cfg.depth_for(2)
    for k, v in unet_keys.items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    unet = build_modules("instantstyle-tiny", torch.float32, device="cpu")["unet"]
    missing, unexpected = unet.load_state_dict(unet_keys, strict=False)
    assert not unexpected and not set(unet_keys) & set(missing)
