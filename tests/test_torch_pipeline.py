"""The slice end to end on i2vgen-tiny: the port's pipeline against the JAX
``I2VGenPipeline`` with the same weights (carried by the JAX converters), the
same frames and the same edited first frame.

Invert 10 steps, then a 10-step PnP edit from t_idx 0 with thresholds
0.2/0.2/0.5, so the edit runs two injection segments (all flags, then
temporal only) and a batch-2 tail. The edit starts from the cached latent at
the sampling grid's first timestep. Tolerance 1e-4 (rtol and atol), as the
JAX package's own round-trip test (tests/test_pipeline_i2vgen.py). Also:
the port's batch-2 tail gives the batch-3 result (split == monolithic).

The random UNet's output conv is scaled by 0.1 so the guided edit keeps the
latents of order one: unscaled, guidance 9 drives them to magnitudes near
20, where the two frameworks' fp32 rounding alone exceeds the absolute
tolerance.
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
from anyv2v_torch.pipelines.i2vgen import I2VGenPipeline, PnPConfig
from anyv2v_torch.schedulers import make_schedule
from test_torch_unet import jax_tiny_config, tiny_models
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
F, HW, STEPS = 4, 64, 10


@pytest.fixture(scope="module")
def runs():
    modules, _, trees = tiny_models(3, eps_scale=0.1)
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
    pnp = (0.2, 0.2, 0.5)

    def flow(p, cat, to_np, pnp_cfg, **edit_kw):
        latents = p.encode_video(frames)
        text = p.encode_text(ids)
        lat_src = p.prepare_image_latents(frames[0], F)
        emb_src = p.encode_image_clip(clip_src)
        traj, inv_ts = p.invert(latents, text, lat_src, emb_src, num_inversion_steps=STEPS, fps=8)
        lat_edit = p.prepare_image_latents(edited, F)
        emb_edit = p.encode_image_clip(clip_edit)
        text_all = cat([text, p.encode_text(ids), p.encode_text(ids_edit)])
        out = p.sample_with_pnp(traj, inv_ts, text_all, cat([lat_src, lat_edit, lat_edit]),
                                cat([emb_src, emb_edit, emb_edit]),
                                num_inference_steps=STEPS, t_idx=0, guidance_scale=9.0,
                                pnp=pnp_cfg, fps=8, **edit_kw)
        return {"latents": to_np(latents), "traj": to_np(traj), "inv_ts": inv_ts,
                "out": to_np(out), "traj_t": traj, "inv_ts_t": inv_ts}

    with torch.no_grad():
        mine = flow(port, torch.cat, lambda t: t.numpy(), PnPConfig(*pnp))
    ref = flow(jpipe, jnp.concatenate, np.asarray, JPnP(*pnp))
    return port, mine, ref, (ids, ids_edit, frames, edited, clip_src, clip_edit)


def test_video_latents_match(runs):
    _, mine, ref, _ = runs
    np.testing.assert_allclose(mine["latents"], ref["latents"], **TOL)


def test_inversion_trajectory_matches(runs):
    _, mine, ref, _ = runs
    np.testing.assert_array_equal(mine["inv_ts"], ref["inv_ts"])
    assert mine["traj"].shape == (STEPS, 1, F, HW // 8, HW // 8, 4)
    np.testing.assert_allclose(mine["traj"], ref["traj"], **TOL)


def test_pnp_edit_matches(runs):
    _, mine, ref, _ = runs
    assert np.isfinite(mine["out"]).all()
    np.testing.assert_allclose(mine["out"], ref["out"], **TOL)


def test_split_equals_monolithic(runs):
    """The batch-2 tail (split_scan) equals keeping the source row for all
    steps; with these thresholds the split path ran a tail of 5 steps."""
    port, mine, _, (ids, ids_edit, frames, edited, clip_src, clip_edit) = runs
    with torch.no_grad():
        text = port.encode_text(ids)
        text_all = torch.cat([text, text, port.encode_text(ids_edit)])
        lat = torch.cat([port.prepare_image_latents(frames[0], F)]
                        + [port.prepare_image_latents(edited, F)] * 2)
        emb = torch.cat([port.encode_image_clip(clip_src)]
                        + [port.encode_image_clip(clip_edit)] * 2)
        mono = port.sample_with_pnp(mine["traj_t"], mine["inv_ts_t"], text_all, lat, emb,
                                    num_inference_steps=STEPS, t_idx=0, guidance_scale=9.0,
                                    pnp=PnPConfig(0.2, 0.2, 0.5), fps=8, split_scan=False)
    np.testing.assert_allclose(mono.numpy(), mine["out"], rtol=1e-5, atol=1e-5)
