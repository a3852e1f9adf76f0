"""I2VGen-XL AnyV2V pipeline: DDIM inversion and the PnP edit (counterpart of
``anyv2v_tpu/pipelines/i2vgen.py``).

The JAX package's ``lax.scan`` programs become Python step loops:

- inversion writes every step's latent (or, with ``num_save_steps``, those on
  the coarser save grid) into a preallocated fp32 trajectory tensor on the
  device, ``[n, 1, F, h, w, 4]`` in ascending-t order; with
  ``traj_store="host"`` it fills one chunk of ``chunk_steps`` steps at a time
  and moves each to a :class:`~anyv2v_torch.pipelines.common.HostTrajectory`
  (the long-video route: the edit then moves back only the rows it reads);
- the edit runs the CFG batch ``[src, uncond, cond]`` (src row re-read from
  the trajectory each step) in static segments of constant injection flags,
  then drops to a batch of 2 ``[uncond, cond]`` once the last injection has
  expired, since the source row's eps is discarded by the CFG combine.

Precision: the scan carries and the trajectory are fp32; the UNet computes in
its configured dtype (bf16 on the GPU).

``mesh`` (:func:`anyv2v_torch.parallel.mesh.make_mesh`): the frames split
over its "frame" ranks when they divide the frames and its "cfg" axis is one
rank; else every rank runs the
plain program, the rows of plain CFG sampling split over "cfg"
(:mod:`anyv2v_torch.pipelines.common`). The image latents ride every rank
whole: the UNet's temporal encoder attends over all their frames.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.pnp import injection_step_mask
from ..schedulers import (
    DiffusionSchedule,
    ddim_inverse_step,
    ddim_step,
    inversion_timesteps,
    sampling_timesteps,
)
from ..utils.profiling import span, spanned
from .common import (FramePlan, HostTrajectory, LatentCodecMixin, device_rows_for_scan,
                     group_constant_runs, run_inversion)


@dataclasses.dataclass
class PnPConfig:
    """pnp_f_t / pnp_spatial_attn_t / pnp_temp_attn_t thresholds."""

    conv: float = 0.2
    spatial: float = 0.2
    temporal: float = 0.5


@dataclasses.dataclass
class I2VGenPipeline(LatentCodecMixin):
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_encoder: torch.nn.Module
    vision_encoder: torch.nn.Module
    schedule: DiffusionSchedule
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    mesh: object = None

    # ------------------------------------------------------------------
    # conditioning
    # ------------------------------------------------------------------

    @spanned("pipe.encode")
    def prepare_image_latents(self, image01, num_frames: int) -> torch.Tensor:
        """Conditioning-frame latent plus (F-1) position-mask frames of value
        (i+1)/(F-1). ``[H, W, 3]`` -> ``[1, F, h, w, 4]`` fp32."""
        z = self._encode_frames(self._tensor(image01)[None])[0]
        masks = [torch.full_like(z, (i + 1) / (num_frames - 1)) for i in range(num_frames - 1)]
        return torch.stack([z, *masks], dim=0)[None]

    @torch.inference_mode()
    def encode_image_clip(self, image_clip) -> torch.Tensor:
        """CLIP-normalised ``[1, 224, 224, 3]`` -> ``[1, 1, proj_dim]``."""
        _, embeds = self.vision_encoder(self._tensor(image_clip))
        return embeds[:, None, :]

    @torch.inference_mode()
    def _eps(self, sample, t: int, text, fps: int, image_latents, image_embeds,
             pnp: Optional[Tuple[bool, bool, bool]] = None) -> torch.Tensor:
        """One UNet forward, fp32 out. Without PnP (whose injection couples
        the rows) the rows split over a mesh's "cfg" ranks."""
        if pnp is not None:
            return self.unet(sample, t, text, fps, image_latents, image_embeds, pnp=pnp).float()
        return self._cfg_split(lambda x, tx, il, ie: self.unet(x, t, tx, fps, il, ie).float(),
                               sample, text, image_latents, image_embeds)

    # ------------------------------------------------------------------
    # inversion
    # ------------------------------------------------------------------

    @torch.inference_mode()
    @spanned("pipe.invert")
    def invert(self, video_latents, text_embeds, image_latents, image_embeds,
               num_inversion_steps: int = 500, fps: int = 8,
               chunk_steps: Optional[int] = None, num_save_steps: Optional[int] = None,
               traj_store: str = "device"):
        """Returns (trajectory ``[n, 1, F, h, w, 4]`` fp32, its ascending
        timesteps ``[n]``).

        ``num_save_steps``: keep only the rows whose timesteps lie on the
        ``num_save_steps`` inversion grid (a 50-step edit grid nests in any
        save grid that is a multiple of 50). ``traj_store="host"``: the rows
        go to a :class:`HostTrajectory`, one copy per chunk of
        ``chunk_steps`` steps (:func:`resolve_chunk_steps`), so the device
        holds one chunk at a time; ``"device"`` returns a device tensor."""
        inv_ts = inversion_timesteps(self.schedule, num_inversion_steps)
        keep = np.ones(len(inv_ts), bool)
        if num_save_steps is not None and num_save_steps < num_inversion_steps:
            keep = np.isin(inv_ts, inversion_timesteps(self.schedule, num_save_steps))
        x = self._tensor(video_latents)
        row_shape = x.shape
        text, il, ie = (self._tensor(a) for a in (text_embeds, image_latents, image_embeds))
        plan = self._frame_plan(x.shape[1])
        x = plan.local(x)

        @spanned("pipe.step")
        def step(i):
            nonlocal x
            t = int(inv_ts[i])
            with plan.region():
                eps = self._eps(x, t, text, fps, il, ie)
            with span("pipe.guide"):
                x = ddim_inverse_step(self.schedule, x, eps, t, num_inversion_steps)
            return plan.gather(x)

        traj = run_inversion(step, keep, row_shape, self.device, traj_store, chunk_steps)
        return traj, inv_ts[keep]

    # ------------------------------------------------------------------
    # PnP edit / plain sampling
    # ------------------------------------------------------------------

    @torch.inference_mode()
    @spanned("pipe.edit")
    def sample_with_pnp(self, traj, inv_ts: np.ndarray, text_embeds_all, image_latents_all,
                        image_embeds_all, num_inference_steps: int = 50, t_idx: int = 0,
                        guidance_scale: float = 9.0, pnp: Optional[PnPConfig] = None,
                        fps: int = 8, init_latent=None, split_scan: bool = True) -> torch.Tensor:
        """PnP editing loop from the cached inverted latent at
        ``timesteps[t_idx]`` (or ``init_latent``) over ``timesteps[t_idx:]``.
        ``traj``: a trajectory tensor or array (moved to the device whole),
        or a :class:`HostTrajectory`, from which only the rows the injection
        steps read reach the device (the batch-2 tail reads none).

        ``split_scan`` (default): once every injection schedule has expired
        the remaining steps run at batch 2 without the source row — the same
        result as keeping the batch of 3 throughout (``split_scan=False``)."""
        pnp = pnp or PnPConfig()
        ts = sampling_timesteps(self.schedule, num_inference_steps)
        masks = tuple(injection_step_mask(ts, thr, num_inference_steps)[t_idx:]
                      for thr in (pnp.conv, pnp.spatial, pnp.temporal))
        ts_run = ts[t_idx:]
        ts_prev = ts_run - self.schedule.num_train_timesteps // num_inference_steps

        t_to_row = {int(t): i for i, t in enumerate(inv_ts)}
        missing = [int(t) for t in ts_run if int(t) not in t_to_row]
        if missing:
            raise ValueError(
                f"sampling timestep {missing[0]} not on the inversion grid; invert with "
                f"a step count that is a multiple of {num_inference_steps}")
        cache_idx = [t_to_row[int(t)] for t in ts_run]

        if not isinstance(traj, HostTrajectory):
            traj = self._tensor(traj)
        plan = self._frame_plan(traj.shape[2])
        x = plan.local(traj[cache_idx[0]] if init_latent is None else self._tensor(init_latent))
        text3, il3, ie3 = (self._tensor(a) for a in
                           (text_embeds_all, image_latents_all, image_embeds_all))

        m_any = masks[0] | masks[1] | masks[2]
        n_run = len(ts_run)
        k_inj = int(np.max(np.nonzero(m_any)[0])) + 1 if m_any.any() else 0
        if not split_scan:
            k_inj = n_run
        # a host store: only the rows of the injection steps go to the device
        traj, cache_idx = device_rows_for_scan(traj, cache_idx, k_inj)
        # static segments: each run of steps has one Python-bool flag pattern
        for start, pat, stop in group_constant_runs(masks, k_inj):
            with span("pipe.segment"):
                for i in range(start, stop):
                    with span("pipe.step"):
                        inp = torch.cat([plan.local(traj[cache_idx[i]]), x, x], dim=0)
                        with plan.region():
                            eps3 = self._eps(inp, int(ts_run[i]), text3, fps, il3, ie3, pnp=pat)
                        with span("pipe.guide"):
                            _eps_src, eps_neg, eps_edit = eps3.chunk(3, dim=0)
                            eps = eps_neg + guidance_scale * (eps_edit - eps_neg)
                            x = ddim_step(self.schedule, x, eps, int(ts_run[i]), int(ts_prev[i]))
        if k_inj < n_run:
            with span("pipe.segment"):
                x = self._sample_loop(x, text3[1:], il3[1:], ie3[1:], ts_run[k_inj:],
                                      ts_prev[k_inj:], guidance_scale, fps, do_cfg=True,
                                      plan=plan)
        return plan.gather(x)

    @torch.inference_mode()
    def _sample_loop(self, x, text_all, il_all, ie_all, ts, ts_prev, guidance_scale,
                     fps, do_cfg: bool, plan: FramePlan = FramePlan()):
        """Guided DDIM steps on ``x``, this rank's frames under ``plan``."""
        for t, t_prev in zip(ts, ts_prev):
            with span("pipe.step"):
                inp = torch.cat([x, x], dim=0) if do_cfg else x
                with plan.region():
                    eps = self._eps(inp, int(t), text_all, fps, il_all, ie_all)
                with span("pipe.guide"):
                    if do_cfg:
                        eps_neg, eps_cond = eps.chunk(2, dim=0)
                        eps = eps_neg + guidance_scale * (eps_cond - eps_neg)
                    x = ddim_step(self.schedule, x, eps, int(t), int(t_prev))
        return x

    def sample(self, init_latent, text_embeds_all, image_latents_all, image_embeds_all,
               num_inference_steps: int = 50, t_idx: int = 0, guidance_scale: float = 9.0,
               fps: int = 8) -> torch.Tensor:
        """Vanilla DDIM sampling (the reconstruction check)."""
        ts = sampling_timesteps(self.schedule, num_inference_steps)[t_idx:]
        ts_prev = ts - self.schedule.num_train_timesteps // num_inference_steps
        x = self._tensor(init_latent)
        plan = self._frame_plan(x.shape[1])
        x = self._sample_loop(
            plan.local(x), self._tensor(text_embeds_all), self._tensor(image_latents_all),
            self._tensor(image_embeds_all), ts, ts_prev, guidance_scale, fps,
            do_cfg=guidance_scale > 1.0, plan=plan)
        return plan.gather(x)
