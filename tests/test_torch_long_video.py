"""The long-video slice on i2vgen-tiny at 40 frames: past 32 frames every
temporal attention takes the port's long route (K2 long's plain version here)
and the trajectory may live in host memory.

- The port's invert + PnP edit against the JAX ``I2VGenPipeline`` with the
  same weights (carried by the JAX converters), frames and edited first
  frame: invert 4 steps, then a 4-step edit from t_idx 0 with thresholds
  0.25/0.25/0.5 (one step with every flag, one with temporal injection only,
  then the batch-2 tail; the JAX edit runs with traced flags and without the
  split, one compile). Tolerance 1e-4 (rtol and atol), as
  ``tests/test_torch_pipeline.py``, whose scaled output conv this reuses.
- ``traj_store="host"`` (chunks of 3 steps) equals ``"device"`` bit for bit,
  for the inversion and for the edit, which moves to the device only the
  rows of its injection steps.
- ``num_save_steps`` keeps exactly the rows of the save grid.

The port's torch ops run on one thread (``one_torch_thread``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models.clip import CLIPTextModel as JCLIPText, CLIPVisionModel as JCLIPVision
from anyv2v_tpu.models.unet_i2vgen import I2VGenUNet as JUNet
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE
from anyv2v_tpu.pipelines.i2vgen import I2VGenPipeline as JPipeline, PnPConfig as JPnP
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from anyv2v_tpu.utils import model_zoo as jzoo
from anyv2v_torch.ops import attention
from anyv2v_torch.pipelines.common import HostTrajectory
from anyv2v_torch.pipelines.i2vgen import I2VGenPipeline, PnPConfig
from anyv2v_torch.schedulers import make_schedule
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)
from test_torch_unet import jax_tiny_config, tiny_models
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
F, HW, STEPS = 40, 64, 4
PNP = (0.25, 0.25, 0.5)


@pytest.fixture(scope="module")
def runs():
    modules, _, trees = tiny_models(4, eps_scale=0.1)
    port = I2VGenPipeline(unet=modules["unet"], vae=modules["vae"],
                          text_encoder=modules["text"], vision_encoder=modules["vision"],
                          schedule=make_schedule(), device=torch.device("cpu"),
                          dtype=torch.float32)
    jpipe = JPipeline(
        unet=JUNet(jax_tiny_config("unet")), vae=JVAE(jax_tiny_config("vae")),
        text_encoder=JCLIPText(jzoo.I2VGEN_TINY["text"]),
        vision_encoder=JCLIPVision(jzoo.I2VGEN_TINY["vision"]),
        schedule=jax_make_schedule(),
        params={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in trees.items()})

    rng = np.random.RandomState(0)
    frames = rng.rand(F, HW, HW, 3).astype(np.float32)
    edited = np.ascontiguousarray(frames[0][:, ::-1])
    clip_src = rng.randn(1, 224, 224, 3).astype(np.float32)
    clip_edit = rng.randn(1, 224, 224, 3).astype(np.float32)
    ids = np.zeros((1, 77), np.int64)
    ids_edit = ids.copy()
    ids_edit[0, :5] = [49406, 320, 1929, 49407, 49407]

    def conditioning(p, cat):
        text = p.encode_text(ids)
        lat_src = p.prepare_image_latents(frames[0], F)
        emb_src = p.encode_image_clip(clip_src)
        lat_edit = p.prepare_image_latents(edited, F)
        emb_edit = p.encode_image_clip(clip_edit)
        edit_args = (cat([text, p.encode_text(ids), p.encode_text(ids_edit)]),
                     cat([lat_src, lat_edit, lat_edit]), cat([emb_src, emb_edit, emb_edit]))
        return p.encode_video(frames), (text, lat_src, emb_src), edit_args

    routes = {"frame_attention": 0, "frame_attention_long": 0}
    saved = {name: getattr(attention, name) for name in routes}

    def counted(name):
        def call(*a):
            routes[name] += 1
            return saved[name](*a)
        return call

    with torch.no_grad():
        for name in routes:
            setattr(attention, name, counted(name))
        try:
            latents, inv_args, edit_args = conditioning(port, torch.cat)
            traj, inv_ts = port.invert(latents, *inv_args, num_inversion_steps=STEPS, fps=8)
            out = port.sample_with_pnp(traj, inv_ts, *edit_args, num_inference_steps=STEPS,
                                       t_idx=0, guidance_scale=9.0, pnp=PnPConfig(*PNP), fps=8)
        finally:
            for name, fn in saved.items():
                setattr(attention, name, fn)
    jlatents, jinv_args, jedit_args = conditioning(jpipe, jnp.concatenate)
    jtraj, jinv_ts = jpipe.invert(jlatents, *jinv_args, num_inversion_steps=STEPS, fps=8)
    # one JAX compile for the edit: traced flags, no split tail
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANYV2V_PNP_STATIC", "0")
        jout = jpipe.sample_with_pnp(jtraj, jinv_ts, *jedit_args, num_inference_steps=STEPS,
                                     t_idx=0, guidance_scale=9.0, pnp=JPnP(*PNP), fps=8,
                                     split_scan=False)
    return dict(port=port, latents=latents, inv_args=inv_args, edit_args=edit_args,
                traj=traj, inv_ts=inv_ts, out=out, routes=routes, jtraj=np.asarray(jtraj),
                jinv_ts=jinv_ts, jout=np.asarray(jout))


def test_every_temporal_attention_takes_the_long_route(runs):
    assert runs["routes"]["frame_attention"] == 0
    assert runs["routes"]["frame_attention_long"] > 0


def test_inversion_matches_jax(runs):
    np.testing.assert_array_equal(runs["inv_ts"], runs["jinv_ts"])
    assert runs["traj"].shape == (STEPS, 1, F, HW // 8, HW // 8, 4)
    np.testing.assert_allclose(runs["traj"].numpy(), runs["jtraj"], **TOL)


def test_pnp_edit_matches_jax(runs):
    out = runs["out"].numpy()
    assert out.shape == (1, F, HW // 8, HW // 8, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, runs["jout"], **TOL)


def test_host_store_equals_device(runs, monkeypatch):
    port = runs["port"]
    with torch.no_grad():
        store, ts = port.invert(runs["latents"], *runs["inv_args"], num_inversion_steps=STEPS,
                                fps=8, chunk_steps=3, traj_store="host")
    assert isinstance(store, HostTrajectory) and store.shape == tuple(runs["traj"].shape)
    np.testing.assert_array_equal(ts, runs["inv_ts"])
    np.testing.assert_array_equal(np.asarray(store), runs["traj"].numpy())
    gathered = []
    orig = HostTrajectory.gather_rows
    monkeypatch.setattr(HostTrajectory, "gather_rows",
                        lambda self, rows: gathered.append(list(rows)) or orig(self, rows))
    with torch.no_grad():
        out = port.sample_with_pnp(store, ts, *runs["edit_args"], num_inference_steps=STEPS,
                                   t_idx=0, guidance_scale=9.0, pnp=PnPConfig(*PNP), fps=8)
    # the two injection steps (t 751 and 501) read rows 3 and 2; the tail none
    assert gathered == [[2, 3]]
    np.testing.assert_array_equal(out.numpy(), runs["out"].numpy())


def test_num_save_steps_keeps_the_save_grid(runs):
    """4 inversion steps on the 2-step save grid: the kept rows are those of
    the full 4-step run at the save grid's timesteps, on the device and in
    the host store (chunks of 3 steps, which cut the grid unevenly)."""
    port = runs["port"]
    with torch.no_grad():
        kept = [port.invert(runs["latents"], *runs["inv_args"], num_inversion_steps=STEPS,
                            fps=8, num_save_steps=2, chunk_steps=3, traj_store=store)
                for store in ("device", "host")]
    np.testing.assert_array_equal(runs["inv_ts"], [1, 251, 501, 751])
    for traj, ts in kept:
        np.testing.assert_array_equal(ts, [1, 501])
        np.testing.assert_array_equal(np.asarray(traj), runs["traj"].numpy()[[0, 2]])
