"""SEINE AnyV2V pipeline: masked-video-conditioned DDIM inversion and the
DDPM (or DDIM) PnP edit (counterpart of ``anyv2v_tpu/pipelines/seine.py``).

As the reference ``SEINEDDIMInversionPipeline`` / ``SEINEPnPPipeline``:

- conditioning: the "first1" frame mask (0 keeps frame 0, 1 generates the
  rest) and the VAE-encoded masked video (frame 0 the real first frame,
  frames 1.. an encoded mid-grey frame); the UNet input is the 9-channel
  concat ``[x, mask, masked_latent]``;
- inversion over the ascending grid with x0 taken at the previous level
  (:func:`~anyv2v_torch.schedulers.ddim_inverse_step`); only the rows on the
  ``num_save_steps`` sampling grid are kept;
- the edit: per step the batch ``[src, cond, uncond]``, the source row the
  cached latent with the masked SOURCE latent, the edit rows with the masked
  EDITED latent, text rows ``[inv, cond, uncond]``, eps = uncond + s (cond -
  uncond). The default sampler is DDPM on the grid 980, 960, ..., 0 with the
  cache read at t + 1 (the 250-step save grid 997, ..., 5, 1).

The JAX ``lax.scan`` programs become Python step loops: static segments of
constant PnP flags (``group_constant_runs``) and, once the last injection has
expired, a source-free tail at batch 2, since the source row's eps is
discarded by the CFG combine. The carries and the trajectory are fp32; the
UNet computes in its configured dtype (bf16 on the GPU).

``traj_store="host"`` keeps the save-grid rows in host memory, chunk by
chunk (as ``I2VGenPipeline.invert``); the edit then moves only the rows it
reads.

``mesh``: the frames, with their mask and masked-latent channels, split over
the "frame" ranks where they divide (:mod:`anyv2v_torch.pipelines.common`);
the DDPM noise is drawn whole on every rank and each takes its window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.pnp import injection_step_mask
from ..schedulers import (
    DiffusionSchedule,
    ddim_inverse_step,
    ddim_step,
    ddpm_step,
    inversion_timesteps,
    sampling_timesteps,
)
from .common import (HostTrajectory, LatentCodecMixin, device_rows_for_scan,
                     group_constant_runs, run_inversion)


@dataclasses.dataclass
class SeinePnPConfig:
    """pnp_f_t / spatial / temporal / cross thresholds (the reference's
    defaults 0.2 / 0.2 / 0.5 / 0.0)."""

    conv: float = 0.2
    spatial: float = 0.2
    temporal: float = 0.5
    cross: float = 0.0


def ddpm_grid(schedule: DiffusionSchedule, num_inference_steps: int) -> np.ndarray:
    """DDPMScheduler's grid: leading spacing without steps_offset ([980, 960,
    ..., 0] for 50 steps), hence the t + 1 cache lookup."""
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)


def seine_frame_mask(mask_type: str, num_frames: int, h: int, w: int) -> torch.Tensor:
    """The reference frame mask, channels-last ``[1, F, h, w, 1]``: 0 keeps a
    conditioning frame, 1 generates. "firstN": the first N frames kept;
    "all": every frame generated; "onelastN": N kept at each end. AnyV2V uses
    "first1"."""
    if mask_type.startswith("first"):
        num = int(mask_type.split("first")[-1])
        per_frame = np.concatenate([np.zeros(num), np.ones(num_frames - num)])
    elif mask_type.startswith("all"):
        per_frame = np.ones(num_frames)
    elif mask_type.startswith("onelast"):
        num = int(mask_type.split("onelast")[-1])
        per_frame = np.concatenate([np.zeros(num), np.ones(num_frames - 2 * num), np.zeros(num)])
    else:
        raise ValueError(f"Invalid mask type: {mask_type}")
    per_frame = torch.from_numpy(per_frame.astype(np.float32))
    return per_frame[None, :, None, None, None].expand(1, num_frames, h, w, 1).contiguous()


@dataclasses.dataclass
class SeinePipeline(LatentCodecMixin):
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_encoder: torch.nn.Module
    schedule: DiffusionSchedule
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    mesh: object = None

    def build_masked_inputs(self, first_frame01, num_frames: int):
        """(mask ``[1, F, h, w, 1]``, masked latent ``[1, F, h, w, 4]``), fp32:
        frame 0 the encoded first frame ``[H, W, 3]`` in [0, 1] (mask 0),
        frames 1.. an encoded mid-grey frame, pixel 0 in [-1, 1] (mask 1)."""
        ff = self._tensor(first_frame01)[None]
        f0 = self._encode_frames(ff)
        z0 = self._encode_frames(torch.full_like(ff, 0.5))
        h, w = f0.shape[1:3]
        masked = torch.cat([f0[None], z0[None].expand(1, num_frames - 1, h, w, 4)], dim=1)
        mask = seine_frame_mask("first1", num_frames, h, w).to(self.device)
        return mask, masked

    @staticmethod
    def _nine_channel(x, mask, masked):
        return torch.cat([x, mask.to(x.dtype), masked.to(x.dtype)], dim=-1)

    @torch.inference_mode()
    def _eps(self, sample, t: int, text, pnp=None) -> torch.Tensor:
        return self.unet(sample, t, text, pnp=pnp).float()

    # ------------------------------------------------------------------
    # inversion
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def invert(self, video_latents, mask, masked_latent, text_embeds,
               num_inversion_steps: int = 500, num_save_steps: int = 250,
               chunk_steps: Optional[int] = None, traj_store: str = "device"):
        """Inversion of ``[1, F, h, w, 4]`` latents. Returns (trajectory at the
        save grid ``[n, 1, F, h, w, 4]`` fp32, its ascending timesteps
        ``[n]``): a device tensor, or with ``traj_store="host"`` a
        :class:`HostTrajectory` filled one chunk of ``chunk_steps`` steps at
        a time."""
        inv_ts = inversion_timesteps(self.schedule, num_inversion_steps)
        keep = np.isin(inv_ts, sampling_timesteps(self.schedule, num_save_steps))
        x = self._tensor(video_latents)
        row_shape = x.shape
        text = self._tensor(text_embeds)
        plan = self._frame_plan(x.shape[1])
        x, mask, masked = (plan.local(self._tensor(a)) for a in (x, mask, masked_latent))

        def step(i):
            nonlocal x
            t = int(inv_ts[i])
            with plan.region():
                eps = self._eps(self._nine_channel(x, mask, masked), t, text)
            x = ddim_inverse_step(self.schedule, x, eps, t, num_inversion_steps)
            return plan.gather(x)

        traj = run_inversion(step, keep, row_shape, self.device, traj_store, chunk_steps)
        return traj, inv_ts[keep]

    # ------------------------------------------------------------------
    # PnP edit
    # ------------------------------------------------------------------

    def _step(self, sampler, x, eps, t, t_prev, noise):
        if sampler == "ddpm":
            return ddpm_step(self.schedule, x, eps, int(t), int(t_prev), noise)
        return ddim_step(self.schedule, x, eps, int(t), int(t_prev))

    @torch.inference_mode()
    def sample_with_pnp(self, traj, traj_ts: np.ndarray, text_embeds_all, mask,
                        masked_edit_latent, masked_src_latent, num_inference_steps: int = 50,
                        cfg_scale: float = 4.0, sampler: str = "ddpm",
                        pnp: Optional[SeinePnPConfig] = None, seed: int = 0,
                        noises=None, init_latent=None, split_scan: bool = True) -> torch.Tensor:
        """Edited latents ``[1, F, h, w, 4]``. ``text_embeds_all``: the rows
        ``[inv, cond, uncond]``. The DDPM noise is drawn from a
        ``torch.Generator`` on the pipeline's device seeded with ``seed``: it
        is not the JAX package's ``jax.random`` draw, so the same seed gives
        another edit. ``noises [steps, 1, F, h, w, 4]`` replaces the draw
        (the parity tests pass JAX's). ``split_scan``: once every injection
        has expired, run without the source row (the same result)."""
        if sampler not in ("ddpm", "ddim"):
            raise ValueError(f"unknown sampler: {sampler}")
        pnp = pnp or SeinePnPConfig()
        if sampler == "ddpm":
            ts = ddpm_grid(self.schedule, num_inference_steps)
            lookup = ts + 1
        else:
            ts = sampling_timesteps(self.schedule, num_inference_steps)
            lookup = ts
        ts_prev = ts - self.schedule.num_train_timesteps // num_inference_steps
        # pattern order (conv, spatial, cross, temporal): the UNet's pnp tuple
        masks = tuple(injection_step_mask(ts, thr, num_inference_steps)
                      for thr in (pnp.conv, pnp.spatial, pnp.cross, pnp.temporal))
        t_to_row = {int(t): i for i, t in enumerate(traj_ts)}
        missing = [int(t) for t in lookup if int(t) not in t_to_row]
        if missing:
            raise ValueError(f"timestep {missing[0]} not in the saved trajectory grid")
        cache_idx = [t_to_row[int(t)] for t in lookup]

        if not isinstance(traj, HostTrajectory):
            traj = self._tensor(traj)
        x = traj[cache_idx[0]] if init_latent is None else self._tensor(init_latent)
        if noises is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            noises = torch.randn((len(ts),) + tuple(x.shape), generator=gen, device=self.device)
        else:
            noises = self._tensor(noises)
        plan = self._frame_plan(x.shape[1])
        x, noises = plan.local(x), plan.local(noises, axis=2)
        text_all = self._tensor(text_embeds_all)
        mask, m_edit, m_src = (plan.local(self._tensor(a)) for a in
                               (mask, masked_edit_latent, masked_src_latent))
        do_cfg = cfg_scale > 1.0

        def guided(eps_cond, eps_uncond):
            return eps_uncond + cfg_scale * (eps_cond - eps_uncond) if do_cfg else eps_cond

        m_any = np.logical_or.reduce(masks)
        k_inj = int(np.max(np.nonzero(m_any)[0])) + 1 if m_any.any() else 0
        if not split_scan:
            k_inj = len(ts)
        # a host store: only the rows of the injection steps go to the device
        traj, cache_idx = device_rows_for_scan(traj, cache_idx, k_inj)
        for start, pat, stop in group_constant_runs(masks, k_inj):
            for i in range(start, stop):
                x_in = self._nine_channel(x, mask, m_edit)
                inp = torch.cat([self._nine_channel(plan.local(traj[cache_idx[i]]), mask, m_src),
                                 x_in, x_in], dim=0)
                with plan.region():
                    _, e_cond, e_uncond = self._eps(inp, int(ts[i]), text_all, pnp=pat).chunk(3)
                x = self._step(sampler, x, guided(e_cond, e_uncond), ts[i], ts_prev[i],
                               noises[i])
        for i in range(k_inj, len(ts)):
            x_in = self._nine_channel(x, mask, m_edit)
            with plan.region():
                e_cond, e_uncond = self._eps(torch.cat([x_in, x_in], dim=0), int(ts[i]),
                                             text_all[1:]).chunk(2)
            x = self._step(sampler, x, guided(e_cond, e_uncond), ts[i], ts_prev[i], noises[i])
        return plan.gather(x)
