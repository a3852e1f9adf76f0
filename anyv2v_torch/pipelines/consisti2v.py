"""ConsistI2V AnyV2V pipeline: DDIM inversion and the dual-CFG PnP edit
(counterpart of ``anyv2v_tpu/pipelines/consisti2v.py``).

As the reference ``ConditionalVideoEditingPipeline``
(``consisti2v/consisti2v/pipelines/pipeline_video_editing.py``):

- the video's frame 0 is the clean conditioning latent; the denoised state
  is frames 1..F-1, and each cached trajectory row carries the clean frame 0
  in front (``:932-941``);
- dual CFG: guidance mode None / "text" / "both" from (cfg_txt, cfg_img), the
  batch ``[src, x]``, ``[src, x, x]`` or ``[src, x, x, x]`` with text rows
  ``[inv, text]``, ``[inv, uncond, text]``, ``[inv, uncond, uncond, text]``
  and first-frame rows ``[src_ff, edit_ff]``, ``[src_ff, edit_ff, edit_ff]``,
  ``[src_ff, cache_ff, edit_ff, edit_ff]`` (``:1516-1524``);
- eps = uncond + s_img (img - uncond) + s_txt (both - img), with optional
  guidance rescale in text mode (arXiv:2305.08891);
- output frame 0 is the edited image latent, copied.

The JAX ``lax.scan`` programs become Python step loops: the edit runs in
static segments of constant PnP flags (``group_constant_runs``) and, once the
last injection has expired, drops the source row (one UNet row less), as its
eps is discarded by the CFG combine. The carries and the trajectory are fp32;
the UNet computes in its configured dtype (bf16 on the GPU).

``traj_store="host"`` keeps the trajectory in host memory, chunk by chunk
(as ``I2VGenPipeline.invert``); the edit then moves only the rows it reads.

``mesh``: the denoised frames (frames 1..F-1) split over the "frame" ranks
where they divide (:mod:`anyv2v_torch.pipelines.common`); the conditioning
frame rides every rank whole, and each cached row keeps the whole clip.

Plain generation (:meth:`ConsistI2VPipeline.sample`) draws vanilla or pyoco
noise (:func:`sample_video_noise`) and optionally re-initialises it with
FreeInit (:meth:`ConsistI2VPipeline.apply_frameinit`), both only when no
start latent is given, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.freeinit import FILTERS, freq_mix_3d
from ..ops.pnp import injection_step_mask
from ..schedulers import (
    DiffusionSchedule,
    add_noise,
    ddim_inverse_step,
    ddim_step,
    inversion_timesteps,
    sampling_timesteps,
)
from ..utils.profiling import span, spanned
from .common import (FramePlan, HostTrajectory, LatentCodecMixin, device_rows_for_scan,
                     group_constant_runs, run_inversion)
from .i2vgen import PnPConfig

_UNCOND_ROWS = {None: 1, "text": 2, "both": 3}   # CFG rows besides the source


def guidance_mode(cfg_txt: float, cfg_img: float) -> Optional[str]:
    """Reference ``pipeline_video_editing.py:1321-1326``."""
    mode = None
    if cfg_txt > 1.0:
        mode = "text"
    if cfg_img > 1.0:
        mode = "both"
    return mode


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float) -> torch.Tensor:
    """Guidance rescale (reference ``:50-61``, arXiv:2305.08891 §3.4)."""
    dims = tuple(range(1, noise_pred_text.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def combine_guidance(eps_rows: torch.Tensor, mode: Optional[str], cfg_txt: float,
                     cfg_img: float, guidance_rescale: float = 0.0,
                     plan: FramePlan = FramePlan()) -> torch.Tensor:
    """The guided eps from the non-source rows ``[uncond?, img?, cond]``
    (this rank's frames under ``plan``)."""
    if mode is None:
        return eps_rows
    if mode == "text":
        e_u, e_t = eps_rows.chunk(2, dim=0)
        eps = e_u + cfg_txt * (e_t - e_u)
        if guidance_rescale > 0.0:
            # the rescale's standard deviations are over the whole clip
            eps = plan.local(rescale_noise_cfg(plan.gather(eps), plan.gather(e_t),
                                               guidance_rescale))
        return eps
    e_u, e_i, e_b = eps_rows.chunk(3, dim=0)
    return e_u + cfg_img * (e_i - e_u) + cfg_txt * (e_b - e_i)


def _first_frame_rows(mode: Optional[str], ff_uncond: torch.Tensor,
                      ff_cond: torch.Tensor) -> list:
    """First-frame latents of the non-source rows; the image-uncond row of
    mode "both" takes ``ff_uncond``."""
    return {None: [ff_cond], "text": [ff_cond, ff_cond],
            "both": [ff_uncond, ff_cond, ff_cond]}[mode]


@dataclasses.dataclass
class ConsistI2VPipeline(LatentCodecMixin):
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_encoder: torch.nn.Module
    schedule: DiffusionSchedule
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    mesh: object = None

    @torch.inference_mode()
    def _eps(self, sample, t: int, text, first_frame, frame_stride: int,
             pnp=None, pnp_chunks: Optional[int] = None) -> torch.Tensor:
        return self.unet(sample, t, text, first_frame, frame_stride, pnp=pnp,
                         pnp_chunks=pnp_chunks).float()

    # ------------------------------------------------------------------
    # inversion
    # ------------------------------------------------------------------

    @torch.inference_mode()
    @spanned("pipe.invert")
    def invert(self, video_latents, text_embeds, num_inversion_steps: int = 500,
               frame_stride: int = 3, chunk_steps: Optional[int] = None,
               traj_store: str = "device"):
        """cfg_txt = cfg_img = 1 inversion of ``[1, F, h, w, 4]`` latents (frame
        0 included). Returns (trajectory ``[n, 1, F, h, w, 4]`` fp32, every
        row with the clean frame 0 in front; ascending timesteps ``[n]``): a
        device tensor, or with ``traj_store="host"`` a :class:`HostTrajectory`
        filled one chunk of ``chunk_steps`` steps at a time."""
        inv_ts = inversion_timesteps(self.schedule, num_inversion_steps)
        lat = self._tensor(video_latents)
        ff, x = lat[:, :1], lat[:, 1:]
        text = self._tensor(text_embeds)
        plan = self._frame_plan(x.shape[1])
        x = plan.local(x)

        @spanned("pipe.step")
        def step(i):
            nonlocal x
            t = int(inv_ts[i])
            with plan.region():
                eps = self._eps(x, t, text, ff, frame_stride)
            with span("pipe.guide"):
                x = ddim_inverse_step(self.schedule, x, eps, t, num_inversion_steps)
            return torch.cat([ff, plan.gather(x)], dim=1)

        traj = run_inversion(step, np.ones(len(inv_ts), bool), lat.shape, self.device,
                             traj_store, chunk_steps)
        return traj, inv_ts

    # ------------------------------------------------------------------
    # PnP edit
    # ------------------------------------------------------------------

    @torch.inference_mode()
    @spanned("pipe.edit")
    def sample_with_pnp(self, traj, inv_ts: np.ndarray, text_embeds_all, edited_ff_latent,
                        src_ff_latent, num_inference_steps: int = 50, t_idx: int = 4,
                        cfg_txt: float = 35.0, cfg_img: float = 1.0,
                        guidance_rescale: float = 0.0, pnp: Optional[PnPConfig] = None,
                        frame_stride: int = 3, init_latent=None,
                        split_scan: bool = True) -> torch.Tensor:
        """Edited latents ``[1, F, h, w, 4]`` with frame 0 the edited image
        latent. ``text_embeds_all``: the rows of the guidance mode (module
        doc). ``split_scan``: once every injection has expired, run without
        the source row (the same result as keeping it)."""
        pnp = pnp or PnPConfig(0.2, 0.2, 0.5)
        mode = guidance_mode(cfg_txt, cfg_img)
        ts = sampling_timesteps(self.schedule, num_inference_steps)
        masks = tuple(injection_step_mask(ts, thr, num_inference_steps)[t_idx:]
                      for thr in (pnp.conv, pnp.spatial, pnp.temporal))
        ts_run = ts[t_idx:]
        ts_prev = ts_run - self.schedule.num_train_timesteps // num_inference_steps
        t_to_row = {int(t): i for i, t in enumerate(inv_ts)}
        missing = [int(t) for t in ts_run if int(t) not in t_to_row]
        if missing:
            raise ValueError(f"timestep {missing[0]} not on the inversion grid")
        cache_idx = [t_to_row[int(t)] for t in ts_run]

        if not isinstance(traj, HostTrajectory):
            traj = self._tensor(traj)
        init_row = traj[cache_idx[0]]
        cache_ff = init_row[:, :1]
        plan = self._frame_plan(init_row.shape[1] - 1)
        x = plan.local(init_row[:, 1:] if init_latent is None else self._tensor(init_latent))
        text_all = self._tensor(text_embeds_all)
        ff_src, ff_edit = self._tensor(src_ff_latent), self._tensor(edited_ff_latent)
        ff_rows = _first_frame_rows(mode, cache_ff, ff_edit)
        n_rows = _UNCOND_ROWS[mode]

        m_any = masks[0] | masks[1] | masks[2]
        n_run = len(ts_run)
        k_inj = int(np.max(np.nonzero(m_any)[0])) + 1 if m_any.any() else 0
        if not split_scan:
            k_inj = n_run
        # a host store: only the rows of the injection steps go to the device
        traj, cache_idx = device_rows_for_scan(traj, cache_idx, k_inj)
        ffl = torch.cat([ff_src] + ff_rows, dim=0)
        for start, pat, stop in group_constant_runs(masks, k_inj):
            with span("pipe.segment"):
                for i in range(start, stop):
                    with span("pipe.step"):
                        inp = torch.cat([plan.local(traj[cache_idx[i]][:, 1:])] + [x] * n_rows,
                                        dim=0)
                        with plan.region():
                            eps = self._eps(inp, int(ts_run[i]), text_all, ffl, frame_stride,
                                            pnp=pat, pnp_chunks=n_rows + 1)
                        with span("pipe.guide"):
                            eps = combine_guidance(eps[1:], mode, cfg_txt, cfg_img,
                                                   guidance_rescale, plan)
                            x = ddim_step(self.schedule, x, eps, int(ts_run[i]), int(ts_prev[i]))
        if k_inj < n_run:
            with span("pipe.segment"):
                x = self._guided_loop(x, text_all[1:], torch.cat(ff_rows, dim=0), ts_run[k_inj:],
                                      ts_prev[k_inj:], mode, cfg_txt, cfg_img, guidance_rescale,
                                      frame_stride, plan)
        return torch.cat([ff_edit, plan.gather(x)], dim=1)

    @torch.inference_mode()
    def _guided_loop(self, x, text_rows, ff_rows, ts, ts_prev, mode, cfg_txt, cfg_img,
                     guidance_rescale, frame_stride, plan: FramePlan = FramePlan()):
        """Guided DDIM steps on ``x``, this rank's frames under ``plan``."""
        n_rows = _UNCOND_ROWS[mode]
        for t, t_prev in zip(ts, ts_prev):
            with span("pipe.step"):
                with plan.region():
                    eps = self._eps(torch.cat([x] * n_rows, dim=0), int(t), text_rows, ff_rows,
                                    frame_stride)
                with span("pipe.guide"):
                    eps = combine_guidance(eps, mode, cfg_txt, cfg_img, guidance_rescale, plan)
                    x = ddim_step(self.schedule, x, eps, int(t), int(t_prev))
        return x

    # ------------------------------------------------------------------
    # plain generation (reference __call__, :469-700)
    # ------------------------------------------------------------------

    def sample(self, first_frame_latent, text_embeds_all, num_frames: int = 16,
               num_inference_steps: int = 50, cfg_txt: float = 7.5, cfg_img: float = 1.0,
               guidance_rescale: float = 0.0, frame_stride: int = 3, seed: int = 0,
               noise_sampling_method: str = "vanilla", noise_alpha: float = 1.0,
               use_frameinit: bool = False, frameinit_noise_level: int = 999,
               init_latent=None, t_idx: int = 0, draws=None) -> torch.Tensor:
        """Image-to-video generation from ``first_frame_latent [1, 1, h, w, 4]``
        (clean). The start latent ``[1, num_frames, h, w, 4]`` is
        ``init_latent`` when given (``noise_sampling_method`` and FreeInit
        then do nothing); else noise from :func:`sample_video_noise`
        (``draws`` or a ``torch.Generator`` seeded with ``seed``, which
        cannot reproduce ``jax.random``), re-initialised by
        :meth:`apply_frameinit` with ``use_frameinit``. Its frame 0 is the
        noisy frame of the image-uncond row, frames 1.. the state; the clean
        first-frame latent is put back in front."""
        ff = self._tensor(first_frame_latent)
        if init_latent is None:
            gen = None if draws is not None else torch.Generator(
                device=self.device).manual_seed(int(seed))
            init_latent = sample_video_noise((1, num_frames) + tuple(ff.shape[2:]),
                                             noise_sampling_method, noise_alpha,
                                             generator=gen, device=self.device, draws=draws)
            if use_frameinit:
                init_latent = self.apply_frameinit(init_latent, ff,
                                                   noise_level=frameinit_noise_level)
        init_latent = self._tensor(init_latent)
        mode = guidance_mode(cfg_txt, cfg_img)
        ts = sampling_timesteps(self.schedule, num_inference_steps)[t_idx:]
        ts_prev = ts - self.schedule.num_train_timesteps // num_inference_steps
        plan = self._frame_plan(init_latent.shape[1] - 1)
        out = self._guided_loop(plan.local(init_latent[:, 1:]), self._tensor(text_embeds_all),
                                torch.cat(_first_frame_rows(mode, init_latent[:, :1], ff), dim=0),
                                ts, ts_prev, mode, cfg_txt, cfg_img, guidance_rescale,
                                frame_stride, plan)
        return torch.cat([ff, plan.gather(out)], dim=1)

    # ------------------------------------------------------------------
    # FreeInit (reference :208-227, applied at :623-633)
    # ------------------------------------------------------------------

    def apply_frameinit(self, latents, first_frame_latent, noise_level: int = 999,
                        filter_type: str = "butterworth", filter_order: int = 4,
                        d_s: float = 0.25, d_t: float = 0.25) -> torch.Tensor:
        """Diffuse the static first-frame video to ``noise_level`` and keep
        its low frequencies and the noise ``latents``' high frequencies.
        ``latents [1, F, h, w, 4]``, ``first_frame_latent [1, 1, h, w, 4]``
        clean; fp32 out."""
        latents = self._tensor(latents)
        f, h, w = latents.shape[1:4]
        static_vid = self._tensor(first_frame_latent).expand(-1, f, -1, -1, -1)
        z_t = add_noise(self.schedule, static_vid, latents, int(noise_level))
        if filter_type not in FILTERS:
            raise ValueError(f"unknown filter_type: {filter_type}")
        if filter_type == "butterworth":
            lpf = FILTERS[filter_type]((f, h, w), n=filter_order, d_s=d_s, d_t=d_t)
        else:
            lpf = FILTERS[filter_type]((f, h, w), d_s=d_s, d_t=d_t)
        return freq_mix_3d(z_t, latents, torch.from_numpy(lpf))


# ---------------------------------------------------------------------------
# pyoco correlated video noise (reference prepare_latents, :408-458)
# ---------------------------------------------------------------------------

NOISE_METHODS = ("vanilla", "pyoco_mixed", "pyoco_progressive")


def sample_video_noise(shape, method: str = "vanilla", noise_alpha: float = 1.0, *,
                       generator: Optional[torch.Generator] = None, device=None,
                       draws=None) -> torch.Tensor:
    """Video noise ``shape = [B, F, h, w, C]``, fp32 (reference
    ``prepare_latents``, ``pipeline_video_editing.py:408-458``): vanilla =
    one standard-normal draw; pyoco_mixed = a base frame shared by every
    frame plus per-frame noise; pyoco_progressive = an AR(1) chain over
    frames with coefficient sqrt(a^2 / (1 + a^2)), frame 0 the first draw's.

    The two standard-normal draws come from ``generator`` on ``device``, or
    are given as ``draws = (d1, d2)`` (``d1`` of shape ``[B, 1, h, w, C]``
    for pyoco_mixed, else ``shape``; ``d2`` of ``shape``, unused by
    vanilla), as the JAX function draws them from its two split keys."""
    if method not in NOISE_METHODS:
        raise ValueError(f"unknown noise_sampling_method: {method}")
    b, f, h, w, c = shape
    a2 = noise_alpha ** 2
    first_shape = (b, 1, h, w, c) if method == "pyoco_mixed" else tuple(shape)
    if draws is None:
        d1 = torch.randn(first_shape, generator=generator, device=device)
        d2 = None if method == "vanilla" else torch.randn(tuple(shape), generator=generator,
                                                          device=device)
    else:
        d1, d2 = (None if d is None else torch.as_tensor(d, dtype=torch.float32, device=device)
                  for d in draws)
    if method == "vanilla":
        return d1
    ind = d2 * float(np.sqrt(1 / (1 + a2)))
    coef = float(np.sqrt(a2 / (1 + a2)))
    if method == "pyoco_mixed":
        return d1 * coef + ind
    frames = [d1[:, 0]]
    for j in range(1, f):
        frames.append(frames[-1] * coef + ind[:, j])
    return torch.stack(frames, dim=1)
