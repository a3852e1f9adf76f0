"""The reference against the program at tiny sizes on the CPU, in float32:
the same weights (the reference's key list loads into the program's modules
with every key checked) give the same outputs; and a tiny run of each
backbone adapter comes out correct.

The i2vgen-xl program takes its temporal transformer's group norm per frame,
where the published modules (and the reference) take it over the clip's
frames: its runs here have that norm set as published
(``published_norm.py``), so that they test the reference, the adapter and
the harness; ``test_v2vbench_faults.py`` holds the per-frame norm as a fault
the check catches."""

from __future__ import annotations

import json
import os

import pytest
import torch

from v2vbench import weights
from v2vbench.cell import as_tuples, load_module
from v2vbench.reference import spec, unet_i2vgen, unet_videoldm, vae as ref_vae
from v2vbench.reference.nn import Params
from v2vbench.tests.helpers import HERE, run_cell, tiny_copy
from v2vbench.tests.published_norm import temporal_norm


def conf(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def gap(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pnp", [None, (True, True, True), (False, False, True)])
@pytest.mark.parametrize("name", ["i2vgen-tiny", "consisti2v-tiny"])
def test_unet_matches_the_program(name, pnp):
    from anyv2v_torch.models.unet_i2vgen import I2VGenUNet, I2VGenUNetConfig
    from anyv2v_torch.models.unet_videoldm import VideoLDMUNet, VideoLDMUNetConfig

    c = conf(name)
    kind = "i2vgen" if c["backbone"] == "i2vgen" else "videoldm"
    state = {k: v.float() for k, v in
             weights.draw(spec.unet_spec(kind, c["unet"]), 1, 1, "cpu").items()}
    cls, ccls = ((I2VGenUNet, I2VGenUNetConfig) if kind == "i2vgen"
                 else (VideoLDMUNet, VideoLDMUNetConfig))
    prog = load_module(cls, ccls(**as_tuples(c["unet"]), dtype=torch.float32), state, "cpu",
                       torch.float32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 3, 32, 32, 4, generator=g)
    text = torch.randn(3, 4, c["unet"]["cross_attention_dim"], generator=g)
    with torch.inference_mode():
        if kind == "i2vgen":
            il = torch.randn(3, 3, 32, 32, 4, generator=g)
            ie = torch.randn(3, 1, c["unet"]["cross_attention_dim"], generator=g)
            undo = temporal_norm()
            try:
                got = prog(x, 501, text, 8, il, ie, pnp=pnp)
            finally:
                undo()
            want = unet_i2vgen.unet(Params(state), c["unet"], x, 501, text, 8, il, ie, pnp=pnp)
        else:
            ff = torch.randn(3, 1, 32, 32, 4, generator=g)
            got = prog(x, 501, text, ff, 3, pnp=pnp, pnp_chunks=3)
            want = unet_videoldm.unet(Params(state), c["unet"], x, 501, text, ff, 3, pnp=pnp)
    assert gap(got, want) < 1e-4


def test_temporal_norm_is_the_published_one(monkeypatch):
    """The reference's temporal transformer normalises as diffusers'
    ``TransformerTemporalModel`` does: ``nn.GroupNorm`` on ``[B, C, F, H, W]``,
    statistics over each group's channels, frames and pixels."""
    from v2vbench.reference import nn as ref_nn

    seen = []

    def group_norm(P, name, x, groups, eps):
        seen.append(tuple(x.shape))
        return ref_nn.group_norm(P, name, x, groups, eps)

    monkeypatch.setattr(unet_i2vgen, "group_norm", group_norm)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 4, 3, 8, generator=g)
    state = {"t.norm.weight": 1 + torch.randn(8, generator=g), "t.norm.bias": torch.randn(8, generator=g)}
    state.update({f"t.proj_in.{k}": v for k, v in
                  (("weight", torch.randn(8, 8, generator=g)), ("bias", torch.zeros(8)))})
    P = Params(state)
    with pytest.raises(KeyError):     # the norm runs first; the block's weights are not given
        unet_i2vgen.temporal_transformer(P, "t", x, 8, 2, 4, 4)
    assert seen == [(2, 5, 4, 3, 8)]
    ours = ref_nn.group_norm(P, "t.norm", x, 4, 1e-6)
    theirs = torch.nn.functional.group_norm(x.permute(0, 4, 1, 2, 3), 4, state["t.norm.weight"],
                                            state["t.norm.bias"], 1e-6).permute(0, 2, 3, 4, 1)
    assert gap(ours, theirs) < 1e-6


def test_vae_matches_the_program():
    from anyv2v_torch.models.vae import AutoencoderKL, VAEConfig, mode_from_moments

    v = conf("i2vgen-tiny")["vae"]
    state = {k: t.float() for k, t in weights.draw(spec.vae_spec(v), 1, 2, "cpu").items()}
    prog = load_module(AutoencoderKL, VAEConfig(**as_tuples(v), dtype=torch.float32), state,
                       "cpu", torch.float32)
    img = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        z = mode_from_moments(prog.encode_moments(img * 2 - 1)) * v["scaling_factor"]
        assert gap(z, ref_vae.encode(Params(state), v, img)) < 1e-5
        video = torch.clamp(prog.decode(z / v["scaling_factor"]).float() / 2 + 0.5, 0, 1)
        assert gap(video, ref_vae.decode(Params(state), v, z)) < 1e-5


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("v2vbench")))


@pytest.mark.parametrize("cell", ["i2vgen-tiny.edit2", "consisti2v-tiny.edit2",
                                  "i2vgen-tiny.invert2", "consisti2v-tiny.invert2",
                                  "i2vgen-tiny.invert2host"])
def test_adapter_runs_correct(copy, cell):
    """The bf16 program on the CPU (the kernels' plain versions) against the
    float32 reference, at the tiny cells' limits."""
    module = "v2vbench.tests.published_norm" if cell.startswith("i2vgen") else "v2vbench.run"
    rc, result, err = run_cell(copy, cell, seed=2 ** 31 + 11, module=module)
    assert rc == 0 and result is not None, err[-3000:]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
