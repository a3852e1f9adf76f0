"""ConsistI2V frame-sharded on a gloo group of 4 CPU processes
(``test_torch_parallel.spawn``) against the JAX package on one device,
consisti2v-tiny in fp32 with the same weights (the JAX converters).

- the two-phase run in concat mode (9 frames: the conditioning frame rides
  every rank, the 8 denoised frames split 2 per rank; 8 inversion steps,
  then a 4-step PnP edit from t_idx 1 at cfg_txt 35, the "text" batch of 3
  with an unconditional text row of its own, and guidance rescale 0.5,
  whose standard deviations span every rank's frames): rtol 3e-4, atol
  5e-5 (``tests/test_parallel.py``'s tolerance);
- one UNet forward in first-frame mode "none" (global frame 0's tokens
  gathered for the augmented keys) and one in the sinusoidal / conv2d
  variant (global positions of the sinusoidal table), 8 frames at the
  batch of 3 with every PnP flag on: the same tolerance.

The latent's 8x8 grid splits into shares of 16 pixels at the first level
(the all-to-all) and gathers the frames below. The JAX edit runs with traced
flags and no split tail (one compile).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_torch.parallel import mesh as tm
from anyv2v_torch.pipelines.consisti2v import ConsistI2VPipeline
from anyv2v_torch.pipelines.i2vgen import PnPConfig
from anyv2v_torch.schedulers import make_schedule
from anyv2v_tpu.models import unet_videoldm as jv
from anyv2v_tpu.models.unet_i2vgen import PnPFlags
from anyv2v_tpu.pipelines.consisti2v import ConsistI2VPipeline as JPipeline
from anyv2v_tpu.pipelines.i2vgen import PnPConfig as JPnP
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from test_torch_consisti2v import VARIANTS, tiny_unet
from test_torch_parallel import cpu_mesh, frame_group, spawn

F, HW = 9, 8
TOL = dict(rtol=3e-4, atol=5e-5)
UNET_CASES = {"none": ("rotary-augment-concat", dict(first_frame_condition_mode="none")),
              "conv2d": ("sinusoidal-plain-conv2d", {})}
EDIT = dict(num_inference_steps=4, t_idx=1, cfg_txt=35.0, cfg_img=1.0, guidance_rescale=0.5)


def _data():
    rng = np.random.RandomState(3)
    r = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)   # noqa: E731
    return dict(latents=r(1, F, HW, HW, 4), text=r(1, 5, 32) / 2, edited_ff=r(1, 1, HW, HW, 4),
                uncond=r(1, 5, 32) / 2)


def _two_phase(p, cat, d, pnp, **kw):
    traj, inv_ts = p.invert(d["latents"], d["text"], num_inversion_steps=8)
    out = p.sample_with_pnp(traj, inv_ts, cat([d["text"], d["uncond"], d["text"]]),
                            d["edited_ff"], d["latents"][:, :1], pnp=pnp, **EDIT, **kw)
    return traj, out


def case_two_phase(rank):
    unet = tiny_unet("rotary-augment-concat", 3, eps_scale=0.1)[0]
    p = ConsistI2VPipeline(unet=unet, vae=None, text_encoder=None, schedule=make_schedule(),
                           device=torch.device("cpu"), dtype=torch.float32, mesh=cpu_mesh())
    d = {k: torch.from_numpy(v) for k, v in _data().items()}
    with torch.no_grad():
        traj, out = _two_phase(p, torch.cat, d, PnPConfig(0.2, 0.2, 0.5))
    return {"traj": traj.numpy(), "out": out.numpy()}


def _unet(case):
    variant, extra = UNET_CASES[case]
    unet, _, tree, jcfg = tiny_unet(variant, 5)
    if extra:
        cfg = dataclasses.replace(unet.config, **extra)
        sd = unet.state_dict()
        unet = type(unet)(cfg)
        unet.load_state_dict(sd)
        jcfg = dataclasses.replace(jcfg, **extra)
    return unet.eval(), tree, dataclasses.replace(jcfg, pnp_chunks=3)


def _unet_inputs(frames):
    rng = np.random.RandomState(11)
    return dict(sample=rng.randn(3, frames, HW, HW, 4).astype(np.float32) * 0.2,
                encoder_hidden_states=rng.randn(3, 5, 32).astype(np.float32) * 0.1,
                first_frame_latents=rng.randn(3, 1, HW, HW, 4).astype(np.float32) * 0.2)


def case_unet(rank):
    group, n = frame_group(cpu_mesh())
    out = {}
    for case in UNET_CASES:
        unet = _unet(case)[0]
        inp = {k: torch.from_numpy(v) for k, v in _unet_inputs(8).items()}
        inp["sample"] = inp["sample"][:, 2 * rank:2 * rank + 2]
        with torch.no_grad(), tm.manual_axis(group, n):
            out[case] = unet(timestep=501, frame_stride=3, pnp=(True, True, True), pnp_chunks=3,
                             **inp).numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("test_torch_parallel_consisti2v", str(tmp_path_factory.mktemp("gloo")))


def test_two_phase_concat_sharded_matches_jax(ranks, monkeypatch):
    monkeypatch.setenv("ANYV2V_PNP_STATIC", "0")
    _, _, tree, jcfg = tiny_unet("rotary-augment-concat", 3, eps_scale=0.1)
    jpipe = JPipeline(unet=jv.VideoLDMUNet(jcfg), vae=None, text_encoder=None,
                      schedule=jax_make_schedule(),
                      params={"unet": jax.tree_util.tree_map(jnp.asarray, tree)})
    d = {k: jnp.asarray(v) for k, v in _data().items()}
    traj, out = _two_phase(jpipe, jnp.concatenate, d, JPnP(0.2, 0.2, 0.5), split_scan=False)
    for got in ranks["case_two_phase"]:
        np.testing.assert_allclose(got["traj"], np.asarray(traj), **TOL)
        np.testing.assert_allclose(got["out"], np.asarray(out), **TOL)


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_sharded_matches_jax(ranks, case):
    _, tree, jcfg = _unet(case)
    inp = {k: jnp.asarray(v) for k, v in _unet_inputs(8).items()}
    unet = jv.VideoLDMUNet(jcfg)
    want = jax.jit(lambda params, inp: unet.apply(
        params, **inp, timestep=jnp.int32(501), frame_stride=jnp.int32(3),
        pnp=PnPFlags(True, True, True)))(jax.tree_util.tree_map(jnp.asarray, tree), inp)
    got = np.concatenate([r[case] for r in ranks["case_unet"]], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_variants_cover_both_positional_tables():
    assert {VARIANTS[v].get("temp_pos_embedding", "rotary") for v, _ in UNET_CASES.values()} \
        == {"rotary", "sinusoidal"}
