"""The SEINE pipeline in the port against the JAX ``SeinePipeline`` on
seine-tiny, fp32 on the CPU, with the same weights (carried by the JAX
converters, no Flax init), frames and edited first frame.

2 frames at 64x64. Invert 8 steps keeping the 4-step save grid, then a 4-step
edit at cfg 4 under DDIM and under DDPM (JAX's noise passed to the port as
``noises``) with thresholds conv 0.25, spatial 0.5, cross 0.25, temporal 0.5:
one step with every family, one with spatial and temporal, then the batch-2
tail. The port runs its static segments and the split tail; the JAX pipeline
runs with traced flags and without the split (``ANYV2V_PNP_STATIC=0``,
``split_scan=False``), one compile per sampler. Tolerance 1e-4 (rtol and
atol), as the other pipeline tests. The random UNet's output conv is scaled
by 0.01 so guided latents stay of order one (``tiny_trees`` says why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models.clip import CLIPTextModel as JCLIPText
from anyv2v_tpu.models.unet_seine import SeineUNet as JUNet
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE
from anyv2v_tpu.pipelines.seine import SeinePipeline as JPipeline, SeinePnPConfig as JPnP
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.pipelines.common import HostTrajectory
from anyv2v_torch.pipelines.seine import SeinePipeline, SeinePnPConfig
from anyv2v_torch.schedulers import make_schedule
from anyv2v_torch.utils.model_zoo import SEINE_SCHEDULER
from test_torch_seine import TOL, one_torch_thread, tiny_trees  # noqa: F401 (fixture)

F, HW, INV_STEPS, SAVE_STEPS, EDIT_STEPS = 2, 64, 8, 4, 4
THRESHOLDS = dict(conv=0.25, spatial=0.5, temporal=0.5, cross=0.25)


def _jax_pipeline(trees):
    spec = jzoo.SEINE_TINY
    return JPipeline(
        unet=JUNet(spec["unet"]), vae=JVAE(dataclasses.replace(spec["vae"], dtype=jnp.float32)),
        text_encoder=JCLIPText(spec["text"]), schedule=jax_make_schedule(**SEINE_SCHEDULER),
        params={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in trees.items()})


@pytest.fixture(scope="module")
def runs():
    modules, trees = tiny_trees(3)
    port = SeinePipeline(unet=modules["unet"], vae=modules["vae"], text_encoder=modules["text"],
                         schedule=make_schedule(**SEINE_SCHEDULER), device=torch.device("cpu"),
                         dtype=torch.float32)
    jpipe = _jax_pipeline(trees)
    rng = np.random.RandomState(0)
    frames = rng.rand(F, HW, HW, 3).astype(np.float32)
    edited = np.ascontiguousarray(frames[0][:, ::-1])
    ids = np.zeros((1, 77), np.int64)
    ids_edit = ids.copy()
    ids_edit[0, :5] = [49406, 320, 1929, 49407, 49407]
    with torch.no_grad():
        lat = port.encode_video(frames)
        mask, masked = port.build_masked_inputs(frames[0], F)
        _, masked_edit = port.build_masked_inputs(edited, F)
        text = port.encode_text(ids)
        traj, traj_ts = port.invert(lat, mask, masked, text, num_inversion_steps=INV_STEPS,
                                    num_save_steps=SAVE_STEPS)
    jlat = jpipe.encode_video(jnp.asarray(frames))
    jmask, jmasked = jpipe.build_masked_inputs(jnp.asarray(frames[0]), F)
    _, jmasked_edit = jpipe.build_masked_inputs(jnp.asarray(edited), F)
    jtext = jpipe.encode_text(jnp.asarray(ids))
    jtraj, jtraj_ts = jpipe.invert(jlat, jmask, jmasked, jtext, num_inversion_steps=INV_STEPS,
                                   num_save_steps=SAVE_STEPS)
    return dict(port=port, jpipe=jpipe, ids=ids, ids_edit=ids_edit, lat=lat, mask=mask,
                masked=masked, masked_edit=masked_edit, traj=traj, traj_ts=traj_ts,
                jlat=np.asarray(jlat), jmask=jmask, jmasked=jmasked, jmasked_edit=jmasked_edit,
                jtraj=np.asarray(jtraj), jtraj_ts=jtraj_ts)


def test_masked_inputs_match_jax(runs):
    """Frame 0 the encoded first frame (mask 0), the rest an encoded
    mid-grey frame (mask 1)."""
    mask, masked = runs["mask"].numpy(), runs["masked"].numpy()
    assert mask.shape == (1, F, HW // 8, HW // 8, 1) and masked.shape == (1, F, HW // 8, HW // 8, 4)
    assert mask[0, 0].max() == 0.0 and mask[0, 1:].min() == 1.0
    np.testing.assert_array_equal(mask, np.asarray(runs["jmask"]))
    for got, want in ((masked, runs["jmasked"]), (runs["masked_edit"].numpy(),
                                                  runs["jmasked_edit"])):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_invert_matches_jax(runs):
    np.testing.assert_allclose(runs["lat"].numpy(), runs["jlat"], **TOL)
    np.testing.assert_array_equal(runs["traj_ts"], runs["jtraj_ts"])
    np.testing.assert_array_equal(runs["traj_ts"], [1, 251, 501, 751])
    traj = runs["traj"].numpy()
    assert traj.shape == (SAVE_STEPS, 1, F, HW // 8, HW // 8, 4)
    np.testing.assert_allclose(traj, runs["jtraj"], **TOL)


def test_invert_refuses_the_host_trajectory(runs):
    """Only "device" and "host" are trajectory stores; "host" is taken."""
    port = runs["port"]
    args = (runs["lat"], runs["mask"], runs["masked"], torch.zeros(1, 77, 16))
    with pytest.raises(ValueError, match="traj_store"):
        port.invert(*args, num_inversion_steps=2, num_save_steps=2, traj_store="disk")
    store, _ = port.invert(*args, num_inversion_steps=2, num_save_steps=2, traj_store="host")
    assert isinstance(store, HostTrajectory) and len(store) == 2


def test_host_trajectory_equals_device(runs, monkeypatch):
    """``traj_store="host"`` (chunks of 3 steps) keeps the same save-grid rows
    bit for bit, and a DDPM edit from the host store reads only the rows of
    its injection steps and equals the edit from the device trajectory."""
    port = runs["port"]
    with torch.no_grad():
        text = port.encode_text(runs["ids"])
        store, ts = port.invert(runs["lat"], runs["mask"], runs["masked"], text,
                                num_inversion_steps=INV_STEPS, num_save_steps=SAVE_STEPS,
                                chunk_steps=3, traj_store="host")
    np.testing.assert_array_equal(ts, runs["traj_ts"])
    np.testing.assert_array_equal(np.asarray(store), runs["traj"].numpy())
    gathered = []
    orig = HostTrajectory.gather_rows
    monkeypatch.setattr(HostTrajectory, "gather_rows",
                        lambda self, rows: gathered.append(list(rows)) or orig(self, rows))
    with torch.no_grad():
        text_all = _text_rows(port, torch.cat, runs["ids"], runs["ids_edit"])
        kw = dict(num_inference_steps=EDIT_STEPS, cfg_scale=4.0, sampler="ddpm",
                  pnp=SeinePnPConfig(**THRESHOLDS), seed=3)
        rest = (text_all, runs["mask"], runs["masked_edit"], runs["masked"])
        from_host = port.sample_with_pnp(store, ts, *rest, **kw)
        from_device = port.sample_with_pnp(runs["traj"], ts, *rest, **kw)
    # 2 injection steps at t 750 and 500 read the cache at t + 1: rows 3 and 2
    assert gathered == [[2, 3]]
    np.testing.assert_array_equal(from_host.numpy(), from_device.numpy())


def _text_rows(p, cat, ids, ids_edit):
    """[inv, cond, uncond]."""
    return cat([p.encode_text(i) for i in (ids, ids_edit, ids)])


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_pnp_edit_matches_jax(runs, sampler, monkeypatch):
    port, jpipe = runs["port"], runs["jpipe"]
    key = jax.random.PRNGKey(5)
    shape = (1, F, HW // 8, HW // 8, 4)
    noises = np.asarray(jax.random.normal(key, (EDIT_STEPS,) + shape, jnp.float32))
    kw = dict(num_inference_steps=EDIT_STEPS, cfg_scale=4.0, sampler=sampler)
    with torch.no_grad():
        text_all = _text_rows(port, torch.cat, runs["ids"], runs["ids_edit"])
        args = (runs["traj"], runs["traj_ts"], text_all, runs["mask"], runs["masked_edit"],
                runs["masked"])
        got = port.sample_with_pnp(*args, pnp=SeinePnPConfig(**THRESHOLDS), noises=noises, **kw)
        mono = port.sample_with_pnp(*args, pnp=SeinePnPConfig(**THRESHOLDS), noises=noises,
                                    split_scan=False, **kw)
    monkeypatch.setenv("ANYV2V_PNP_STATIC", "0")
    want = jpipe.sample_with_pnp(
        jnp.asarray(runs["jtraj"]), runs["jtraj_ts"],
        _text_rows(jpipe, jnp.concatenate, *(jnp.asarray(runs[k]) for k in ("ids", "ids_edit"))),
        runs["jmask"], runs["jmasked_edit"], runs["jmasked"], pnp=JPnP(**THRESHOLDS), key=key,
        split_scan=False, **kw)
    assert got.shape == shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the source-free tail (2 of the 4 steps here) gives the monolithic result
    np.testing.assert_allclose(mono.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_ddpm_edit_draws_seeded_noise(runs):
    """Without ``noises`` the DDPM draw comes from the seeded generator: the
    same seed repeats the edit, another seed changes it."""
    port = runs["port"]
    with torch.no_grad():
        text_all = _text_rows(port, torch.cat, runs["ids"], runs["ids_edit"])
        args = (runs["traj"], runs["traj_ts"], text_all, runs["mask"], runs["masked_edit"],
                runs["masked"])
        kw = dict(num_inference_steps=EDIT_STEPS, pnp=SeinePnPConfig(0.0, 0.0, 0.0, 0.0))
        a, b, c = (port.sample_with_pnp(*args, seed=s, **kw) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
