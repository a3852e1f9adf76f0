"""SEINE frame-sharded on a gloo group of 4 CPU processes
(``test_torch_parallel.spawn``) against the JAX ``SeinePipeline`` on one
device, seine-tiny in fp32 with the same weights (the JAX converters).

8 frames, 2 per rank, at a 16x16 latent (shares of 64 pixels at the first
level, the all-to-all; the frames gathered at the 4x4 and 2x2 levels):
8 inversion steps keeping the 4-step save grid, then a 4-step DDPM PnP edit
at cfg 4 (text rows [inversion, cond, uncond], the cond row of its own)
with JAX's noise passed to the port. Tolerances are
``tests/test_parallel.py``'s for its sharded SEINE run: trajectory rtol
3e-4, atol 1e-3; edit rtol 3e-3, atol 2e-2. The JAX edit runs with traced
flags and no split tail (one compile).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_torch.pipelines.seine import SeinePipeline, SeinePnPConfig
from anyv2v_torch.schedulers import make_schedule
from anyv2v_torch.utils.model_zoo import SEINE_SCHEDULER
from anyv2v_tpu.models.unet_seine import SeineUNet as JUNet
from anyv2v_tpu.pipelines.seine import SeinePipeline as JPipeline, SeinePnPConfig as JPnP
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.utils import model_zoo as jzoo
from test_torch_parallel import cpu_mesh, spawn
from test_torch_seine import tiny_unet

F, HW, STEPS = 8, 16, 4
THRESHOLDS = dict(conv=0.25, spatial=0.5, temporal=0.5, cross=0.25)


def _data():
    rng = np.random.RandomState(4)
    r = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)   # noqa: E731
    mask = np.concatenate([np.zeros((1, 1, HW, HW, 1)), np.ones((1, F - 1, HW, HW, 1))],
                          axis=1).astype(np.float32)
    noises = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (STEPS, 1, F, HW, HW, 4)))
    return dict(latents=r(1, F, HW, HW, 4), text=r(1, 5, 16) / 2, mask=mask,
                masked=r(1, F, HW, HW, 4), noises=np.array(noises), cond=r(1, 5, 16) / 2)


def _two_phase(p, cat, d, pnp, **kw):
    traj, traj_ts = p.invert(d["latents"], d["mask"], d["masked"], d["text"],
                             num_inversion_steps=8, num_save_steps=4)
    out = p.sample_with_pnp(traj, traj_ts, cat([d["text"], d["cond"], d["text"]]), d["mask"],
                            d["masked"] * 1.1,
                            d["masked"], num_inference_steps=STEPS, cfg_scale=4.0,
                            sampler="ddpm", pnp=pnp, **kw)
    return traj, out


def case_two_phase(rank):
    unet = tiny_unet(3, eps_scale=0.01)[0]
    p = SeinePipeline(unet=unet, vae=None, text_encoder=None,
                      schedule=make_schedule(**SEINE_SCHEDULER), device=torch.device("cpu"),
                      dtype=torch.float32, mesh=cpu_mesh())
    d = {k: torch.from_numpy(v) for k, v in _data().items()}
    with torch.no_grad():
        traj, out = _two_phase(p, torch.cat, d, SeinePnPConfig(**THRESHOLDS), noises=d["noises"])
    return {"traj": traj.numpy(), "out": out.numpy()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("test_torch_parallel_seine", str(tmp_path_factory.mktemp("gloo")))


def test_two_phase_sharded_matches_jax(ranks, monkeypatch):
    monkeypatch.setenv("ANYV2V_PNP_STATIC", "0")
    _, _, tree = tiny_unet(3, eps_scale=0.01)
    jpipe = JPipeline(unet=JUNet(dataclasses.replace(jzoo.SEINE_TINY["unet"],
                                                     dtype=jnp.float32)),
                      vae=None, text_encoder=None,
                      schedule=jax_make_schedule(**SEINE_SCHEDULER),
                      params={"unet": jax.tree_util.tree_map(jnp.asarray, tree)})
    d = {k: jnp.asarray(v) for k, v in _data().items()}
    traj, out = _two_phase(jpipe, jnp.concatenate, d, JPnP(**THRESHOLDS),
                           key=jax.random.PRNGKey(7), split_scan=False)
    for got in ranks["case_two_phase"]:
        np.testing.assert_allclose(got["traj"], np.asarray(traj), rtol=3e-4, atol=1e-3)
        np.testing.assert_allclose(got["out"], np.asarray(out), rtol=3e-3, atol=2e-2)
