"""The i2vgen-xl pipeline frame-sharded on a gloo group of 4 CPU processes
(``test_torch_parallel.spawn``) against the JAX ``I2VGenPipeline`` on one
device, i2vgen-tiny in fp32 with the same weights (the JAX converters).

- the two-phase run (8 inversion steps, then a 4-step PnP edit from t_idx 1,
  its CFG rows [src, negative, edit] each of its own) at 8 frames, 2 per
  rank: rtol 1e-4, atol 5e-5 (``tests/test_parallel.py``'s
  tolerance for its sharded two-phase run); the latent's 8x8 grid splits
  into shares of 16 pixels at the first level (the all-to-all) and gathers
  the frames below;
- plain CFG sampling (2 rows, [negative, edit]) on a (cfg 2, frame 2) mesh,
  the rows split over "cfg": rtol 1e-4, atol 1e-5 (the JAX test's, scaled from its 2x4 mesh);
- the trajectory in host memory on the mesh: the same rows and edit as on
  the device;
- the VAE's sharded encode and decode (8 frames, and 6, whose shares are
  padded): rtol 1e-4, atol 1e-4, as ``tests/test_torch_pipeline.py``.

The JAX edit runs with traced flags and without the split tail
(``ANYV2V_PNP_STATIC=0``, ``split_scan=False``: one compile), the port with
its static segments and split tail (the same function,
``test_torch_pipeline.py::test_split_equals_monolithic``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_torch.pipelines.i2vgen import I2VGenPipeline
from anyv2v_torch.schedulers import make_schedule
from anyv2v_tpu.models.unet_i2vgen import I2VGenUNet as JUNet
from anyv2v_tpu.models.vae import AutoencoderKL as JVAE
from anyv2v_tpu.pipelines.i2vgen import I2VGenPipeline as JPipeline
from anyv2v_tpu.schedulers import make_schedule as jax_make_schedule
from test_torch_parallel import cpu_mesh, spawn
from test_torch_unet import jax_tiny_config, tiny_models
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

F, HW = 8, 8
VAE_FRAMES = (8, 6)


def _data():
    rng = np.random.RandomState(0)
    r = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)   # noqa: E731
    return dict(latents=r(1, F, HW, HW, 4), text=r(1, 77, 32) / 2, img_lat=r(1, F, HW, HW, 4),
                img_emb=r(1, 1, 32) / 2, uncond=r(1, 77, 32) / 2, img_lat_edit=r(1, F, HW, HW, 4),
                img_emb_edit=r(1, 1, 32) / 2,
                frames=rng.rand(max(VAE_FRAMES), 8 * HW, 8 * HW, 3).astype(np.float32))


def _edit_rows(cat, d):
    """The edit's CFG rows [src, negative, edit], each of its own."""
    return (cat([d["text"], d["uncond"], d["text"]]),
            cat([d["img_lat"], d["img_lat_edit"], d["img_lat_edit"]]),
            cat([d["img_emb"], d["img_emb_edit"], d["img_emb_edit"]]))


def _two_phase(p, cat, d, **edit_kw):
    traj, inv_ts = p.invert(d["latents"], d["text"], d["img_lat"], d["img_emb"],
                            num_inversion_steps=8)
    out = p.sample_with_pnp(traj, inv_ts, *_edit_rows(cat, d), num_inference_steps=4, t_idx=1,
                            **edit_kw)
    return traj, out


def _cfg_sample(p, cat, d):
    return p.sample(d["latents"], *(rows[1:] for rows in _edit_rows(cat, d)),
                    num_inference_steps=4, guidance_scale=9.0)


def _port(mesh):
    modules, _, _ = tiny_models(3, eps_scale=0.1)
    return I2VGenPipeline(unet=modules["unet"], vae=modules["vae"], text_encoder=None,
                          vision_encoder=None, schedule=make_schedule(),
                          device=torch.device("cpu"), dtype=torch.float32, mesh=mesh)


def case_two_phase(rank):
    d = {k: torch.from_numpy(v) for k, v in _data().items()}
    with torch.no_grad():
        traj, out = _two_phase(_port(cpu_mesh()), torch.cat, d)
    return {"traj": traj.numpy(), "out": out.numpy()}


def case_host_store(rank):
    """The two-phase run with the trajectory in host memory (2 chunks)."""
    d = {k: torch.from_numpy(v) for k, v in _data().items()}
    p = _port(cpu_mesh())
    with torch.no_grad():
        traj, inv_ts = p.invert(d["latents"], d["text"], d["img_lat"], d["img_emb"],
                                num_inversion_steps=8, traj_store="host", chunk_steps=4)
        out = p.sample_with_pnp(traj, inv_ts, *_edit_rows(torch.cat, d), num_inference_steps=4,
                                t_idx=1)
    return {"traj": np.asarray(traj), "out": out.numpy(), "chunks": np.array(len(traj._chunks))}


def case_cfg_rows(rank):
    d = {k: torch.from_numpy(v) for k, v in _data().items()}
    with torch.no_grad():
        return {"out": _cfg_sample(_port(cpu_mesh(2)), torch.cat, d).numpy()}


def case_vae(rank):
    p = _port(cpu_mesh())
    frames = _data()["frames"]
    out = {}
    with torch.no_grad():
        for n in VAE_FRAMES:
            z = p.encode_video(frames[:n])
            out[f"z{n}"] = z.numpy()
            out[f"video{n}"] = p.decode_latents(z).numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("test_torch_parallel_pipeline", str(tmp_path_factory.mktemp("gloo")))


@pytest.fixture(scope="module")
def jpipe():
    _, _, trees = tiny_models(3, eps_scale=0.1)
    return JPipeline(unet=JUNet(jax_tiny_config("unet")), vae=JVAE(jax_tiny_config("vae")),
                     text_encoder=None, vision_encoder=None, schedule=jax_make_schedule(),
                     params={k: jax.tree_util.tree_map(jnp.asarray, trees[k])
                             for k in ("unet", "vae")})


def test_two_phase_sharded_matches_jax(ranks, jpipe, monkeypatch):
    monkeypatch.setenv("ANYV2V_PNP_STATIC", "0")
    d = {k: jnp.asarray(v) for k, v in _data().items()}
    traj, out = _two_phase(jpipe, jnp.concatenate, d, split_scan=False)
    for got in ranks["case_two_phase"]:   # every rank holds the whole clip
        np.testing.assert_allclose(got["traj"], np.asarray(traj), rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(got["out"], np.asarray(out), rtol=1e-4, atol=5e-5)


def test_host_store_equals_device_store(ranks):
    """On the mesh the host-resident trajectory holds the whole clip, and the
    edit from it (only the injection rows moved back) is the device one's."""
    for host, device in zip(ranks["case_host_store"], ranks["case_two_phase"]):
        assert int(host["chunks"]) == 2
        np.testing.assert_array_equal(host["traj"], device["traj"])
        np.testing.assert_allclose(host["out"], device["out"], rtol=1e-6, atol=1e-6)


def test_cfg_axis_two_row_sampling(ranks, jpipe):
    d = {k: jnp.asarray(v) for k, v in _data().items()}
    want = np.asarray(_cfg_sample(jpipe, jnp.concatenate, d))
    for got in ranks["case_cfg_rows"]:
        np.testing.assert_allclose(got["out"], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", VAE_FRAMES)
def test_vae_shares_match_jax(ranks, jpipe, n):
    frames = jnp.asarray(_data()["frames"][:n])
    z = jpipe.encode_video(frames)
    video = jpipe.decode_latents(z)
    for got in ranks["case_vae"]:
        np.testing.assert_allclose(got[f"z{n}"], np.asarray(z), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[f"video{n}"], np.asarray(video), rtol=1e-4, atol=1e-4)
