"""The ConsistI2V pipeline in the port against the JAX ``ConsistI2VPipeline``
on consisti2v-tiny, fp32 on the CPU, with the same weights (carried by the
JAX converters), frames and edited first frame.

Invert 10 steps, then a 5-step dual-CFG PnP edit from t_idx 0 with
thresholds 0.2/0.2/0.5 in guidance modes None, "text" and "both" (batch 2,
3 and 4): one step with every flag, one with temporal injection only, then
the source-free tail. Tolerance 1e-4 (rtol and atol), as the i2vgen pipeline
test. The random UNet's output conv is scaled by 0.1 so guided latents stay
of order one (see tests/test_torch_pipeline.py). The JAX pipeline runs its
edit with traced PnP flags and without the split tail
(``ANYV2V_PNP_STATIC=0``, ``split_scan=False``): one compile per mode, and
the port's split tail is also held against its own monolithic run. The
host trajectory store is held against the device trajectory bit for bit.
The port's torch ops run on one thread (``one_torch_thread``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import unet_videoldm as jv
from anyv2v_tpu.models.clip import CLIPTextModel as JCLIPText
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE
from anyv2v_tpu.pipelines.consisti2v import ConsistI2VPipeline as JPipeline
from anyv2v_tpu.pipelines.i2vgen import PnPConfig as JPnP
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.pipelines.common import HostTrajectory
from anyv2v_torch.pipelines.consisti2v import ConsistI2VPipeline
from anyv2v_torch.pipelines.i2vgen import PnPConfig
from anyv2v_torch.schedulers import make_schedule
from test_torch_consisti2v import TOL, tiny_trees
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)

F, HW, INV_STEPS, EDIT_STEPS = 3, 64, 10, 5
MODES = {None: (1.0, 1.0), "text": (7.5, 1.0), "both": (7.5, 1.5)}   # (cfg_txt, cfg_img)


def _jax_pipeline(trees):
    return JPipeline(
        unet=jv.VideoLDMUNet(dataclasses.replace(jzoo.CONSISTI2V_TINY["unet"], dtype=jnp.float32)),
        vae=JVAE(dataclasses.replace(jzoo.CONSISTI2V_TINY["vae"], dtype=jnp.float32)),
        text_encoder=JCLIPText(jzoo.CONSISTI2V_TINY["text"]), schedule=jax_make_schedule(),
        params={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in trees.items()})


@pytest.fixture(scope="module")
def runs():
    modules, trees = tiny_trees(3)
    port = ConsistI2VPipeline(unet=modules["unet"], vae=modules["vae"],
                              text_encoder=modules["text"], schedule=make_schedule(),
                              device=torch.device("cpu"), dtype=torch.float32)
    jpipe = _jax_pipeline(trees)
    rng = np.random.RandomState(0)
    frames = rng.rand(F, HW, HW, 3).astype(np.float32)
    edited = np.ascontiguousarray(frames[0][:, ::-1])
    ids = np.zeros((1, 77), np.int64)
    ids_edit = ids.copy()
    ids_edit[0, :5] = [49406, 320, 1929, 49407, 49407]
    with torch.no_grad():
        lat = port.encode_video(frames)
        traj, inv_ts = port.invert(lat, port.encode_text(ids), num_inversion_steps=INV_STEPS)
    jlat = jpipe.encode_video(jnp.asarray(frames))
    jtraj, jinv_ts = jpipe.invert(jlat, jpipe.encode_text(jnp.asarray(ids)),
                                  num_inversion_steps=INV_STEPS)
    return dict(port=port, jpipe=jpipe, frames=frames, edited=edited, ids=ids,
                ids_edit=ids_edit, lat=lat, traj=traj, inv_ts=inv_ts,
                jlat=np.asarray(jlat), jtraj=np.asarray(jtraj), jinv_ts=jinv_ts)


def test_invert_matches_jax(runs):
    np.testing.assert_allclose(runs["lat"].numpy(), runs["jlat"], **TOL)
    np.testing.assert_array_equal(runs["inv_ts"], runs["jinv_ts"])
    traj = runs["traj"].numpy()
    assert traj.shape == (INV_STEPS, 1, F, HW // 8, HW // 8, 4)
    # every cached row carries the clean frame 0
    np.testing.assert_array_equal(traj[:, :, :1], np.broadcast_to(
        runs["lat"].numpy()[:, :1], traj[:, :, :1].shape))
    np.testing.assert_allclose(traj, runs["jtraj"], **TOL)


def _text_rows(p, cat, ids, ids_edit, mode):
    inv, neg, text = (p.encode_text(i) for i in (ids, ids, ids_edit))
    return cat({None: [inv, text], "text": [inv, neg, text],
                "both": [inv, neg, neg, text]}[mode])


@pytest.mark.parametrize("mode", list(MODES))
def test_pnp_edit_matches_jax(runs, mode, monkeypatch):
    cfg_txt, cfg_img = MODES[mode]
    port, jpipe = runs["port"], runs["jpipe"]
    kw = dict(num_inference_steps=EDIT_STEPS, t_idx=0, cfg_txt=cfg_txt, cfg_img=cfg_img,
              frame_stride=3)
    with torch.no_grad():
        src_ff = port.encode_video(runs["frames"][:1])
        edit_ff = port.encode_video(runs["edited"][None])
        got = port.sample_with_pnp(
            runs["traj"], runs["inv_ts"],
            _text_rows(port, torch.cat, runs["ids"], runs["ids_edit"], mode),
            edit_ff, src_ff, pnp=PnPConfig(0.2, 0.2, 0.5), **kw)
        mono = port.sample_with_pnp(
            runs["traj"], runs["inv_ts"],
            _text_rows(port, torch.cat, runs["ids"], runs["ids_edit"], mode),
            edit_ff, src_ff, pnp=PnPConfig(0.2, 0.2, 0.5), split_scan=False, **kw)
    monkeypatch.setenv("ANYV2V_PNP_STATIC", "0")
    want = jpipe.sample_with_pnp(
        jnp.asarray(runs["jtraj"]), runs["jinv_ts"],
        _text_rows(jpipe, jnp.concatenate, jnp.asarray(runs["ids"]),
                   jnp.asarray(runs["ids_edit"]), mode),
        edited_ff_latent=jpipe.encode_video(jnp.asarray(runs["edited"][None])),
        src_ff_latent=jpipe.encode_video(jnp.asarray(runs["frames"][:1])),
        pnp=JPnP(0.2, 0.2, 0.5), split_scan=False, **kw)
    assert got.shape == (1, F, HW // 8, HW // 8, 4) and np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got.numpy()[:, :1], edit_ff.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the source-free tail (2 of the 5 steps here) gives the monolithic result
    np.testing.assert_allclose(mono.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_host_trajectory_equals_device(runs, monkeypatch):
    """``traj_store="host"`` (chunks of 4 steps) keeps the same rows, clean
    frame 0 included, bit for bit; an edit from the host store reads only
    the rows of its injection steps and equals the edit from the device
    trajectory."""
    port = runs["port"]
    with torch.no_grad():
        store, ts = port.invert(runs["lat"], port.encode_text(runs["ids"]),
                                num_inversion_steps=INV_STEPS, chunk_steps=4, traj_store="host")
    assert isinstance(store, HostTrajectory) and len(store) == INV_STEPS
    np.testing.assert_array_equal(ts, runs["inv_ts"])
    np.testing.assert_array_equal(np.asarray(store), runs["traj"].numpy())
    gathered = []
    orig = HostTrajectory.gather_rows
    monkeypatch.setattr(HostTrajectory, "gather_rows",
                        lambda self, rows: gathered.append(list(rows)) or orig(self, rows))
    kw = dict(num_inference_steps=EDIT_STEPS, t_idx=0, cfg_txt=7.5, cfg_img=1.0,
              frame_stride=3, pnp=PnPConfig(0.2, 0.2, 0.5))
    with torch.no_grad():
        text_all = _text_rows(port, torch.cat, runs["ids"], runs["ids_edit"], "text")
        ffs = (port.encode_video(runs["edited"][None]), port.encode_video(runs["frames"][:1]))
        from_host = port.sample_with_pnp(store, ts, text_all, *ffs, **kw)
        from_device = port.sample_with_pnp(runs["traj"], ts, text_all, *ffs, **kw)
    # 2 injection steps, t 801 and 601: rows 8 and 6 of the 10-step grid
    assert gathered == [[6, 8]]
    np.testing.assert_array_equal(from_host.numpy(), from_device.numpy())


def test_plain_sample_matches_jax(runs):
    """Plain generation from a given start latent (frame 0 the noisy
    image-uncond row), guidance "text" with the guidance rescale on."""
    port, jpipe = runs["port"], runs["jpipe"]
    init = np.random.RandomState(6).randn(1, F, HW // 8, HW // 8, 4).astype(np.float32)
    kw = dict(num_frames=F, num_inference_steps=4, cfg_txt=7.5, cfg_img=1.0,
              guidance_rescale=0.7, frame_stride=3, t_idx=1)
    ids = (runs["ids"], runs["ids_edit"])
    with torch.no_grad():
        ff = port.encode_video(runs["edited"][None])
        got = port.sample(ff, torch.cat([port.encode_text(i) for i in ids]),
                          init_latent=torch.from_numpy(init), **kw)
    want = jpipe.sample(jpipe.encode_video(jnp.asarray(runs["edited"][None])),
                        jnp.concatenate([jpipe.encode_text(jnp.asarray(i)) for i in ids]),
                        init_latent=jnp.asarray(init), **kw)
    assert got.shape == (1, F, HW // 8, HW // 8, 4)
    np.testing.assert_array_equal(got.numpy()[:, :1], ff.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_sample_refuses_unported_noise(runs):
    """Every noise method and filter of the JAX package is ported; a name
    outside them is refused, as the JAX package refuses it."""
    port = runs["port"]
    ff = torch.zeros(1, 1, 8, 8, 4)
    with pytest.raises(ValueError, match="noise_sampling_method"):
        port.sample(ff, torch.zeros(1, 77, 32), noise_sampling_method="pyoco_unknown")
    with pytest.raises(ValueError, match="filter_type"):
        port.apply_frameinit(torch.zeros(1, 3, 8, 8, 4), ff, filter_type="unknown")


