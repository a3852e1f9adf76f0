"""ConsistI2V: the dual-CFG PnP edit and the DDIM inversion of
``anyv2v_torch``'s ``ConsistI2VPipeline``, called as its CLIs call them
(``cli/consisti2v_run_pnp_edit.py::edit_video`` without the text encoder,
whose embeddings are seeded inputs; ``cli/consisti2v_run_ddim_inversion.py``).

The clip is ``frames`` + 1 frames: frame 0 is the clean conditioning latent,
in front of every cached trajectory row; the UNet denoises the ``frames``
after it.

- ``edit``: the source and edited first frames encoded, the edit from
  ``t_idx`` on the cached trajectory (handed over as a host array, which the
  CLI moves to the device whole), the decode of the ``frames`` + 1 latents.
- ``invert``: one call of ``invert`` over ``steps_per_call`` steps of batch 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..benchguard import hard_sync
from ..cell import Cell as BaseCell, Record, UNetCalls, as_tuples, load_module, segments_of
from ..reference import diffusion, spec as ref_spec, unet_videoldm, vae as ref_vae

MODES = {"first_frame_condition_mode": "concat", "temp_pos_embedding": "rotary",
         "augment_temporal_attention": True, "use_frame_stride_condition": True,
         "use_temporal": True}


def _program():
    from anyv2v_torch.models.unet_videoldm import VideoLDMUNet, VideoLDMUNetConfig
    from anyv2v_torch.models.vae import AutoencoderKL, VAEConfig
    from anyv2v_torch.pipelines.consisti2v import ConsistI2VPipeline
    from anyv2v_torch.pipelines.i2vgen import PnPConfig
    from anyv2v_torch.schedulers import make_schedule

    return VideoLDMUNet, VideoLDMUNetConfig, AutoencoderKL, VAEConfig, ConsistI2VPipeline, \
        PnPConfig, make_schedule


class Cell(BaseCell):
    reference_unet_kind = "videoldm"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        modes = {k: config["unet"].get(k) for k in MODES}
        if modes != MODES:
            raise ValueError(f"the reference covers {MODES}, the configuration states {modes}")
        (Unet, UnetConfig, Vae, VaeConfig, Pipeline, self.PnPConfig,
         make_schedule) = _program()
        dt = torch.bfloat16
        unet = load_module(Unet, UnetConfig(**as_tuples(config["unet"]), dtype=dt),
                           self.state("unet"), self.device, dt)
        vae = load_module(Vae, VaeConfig(**as_tuples(config["vae"]), dtype=dt),
                          self.state("vae"), self.device, dt)
        self.unet = UNetCalls(unet)
        self.pipe = Pipeline(unet=self.unet, vae=vae, text_encoder=None,
                             schedule=make_schedule(**config["scheduler"], device=self.device),
                             device=self.device, dtype=dt)
        self.vae = vae
        d, n_text = config["unet"]["cross_attention_dim"], config["text_tokens"]
        if self.kind == "edit":
            self._edit_inputs(d, n_text)
        elif self.kind == "invert":
            self._invert_inputs(d, n_text)
        else:
            raise ValueError(f"consisti2v has no request {self.kind!r}")

    # -- edit -----------------------------------------------------------------

    def _edit_inputs(self, d, n_text):
        cfg, e, F = self.config, self.config["edit"], self.frames
        if diffusion_mode(e) != "text":
            raise ValueError("the reference covers the text guidance mode (cfg_img 1)")
        sched = cfg["scheduler"]
        self.plan = diffusion.edit_plan(sched, e["steps"], e["t_idx"], e["pnp"])
        self.inv_ts = diffusion.inversion_timesteps(sched, e["steps"])
        clean = self.normal(1, F + 1, self.h, self.w, 4)
        self.traj = torch.stack([torch.cat([clean[:, :1], diffusion.add_noise(
            sched, clean[:, 1:], self.normal(1, F, self.h, self.w, 4), int(t))], dim=1)
            for t in self.inv_ts]).cpu().numpy()
        self.src01 = self.host_image()
        inv, neg = self.normal(1, n_text, d), self.normal(1, n_text, d)
        self.pool = [{"edited01": self.host_image(),
                      "text": torch.cat([inv, neg, self.normal(1, n_text, d)])}
                     for _ in range(int(self.traffic["pool"]))]
        self.keep = self.sampled_steps(segments_of(self.plan),
                                       int(self.traffic["check"]["steps_per_segment"]))

    def _edit(self, item, t_idx=None, thresholds=None):
        """The body of the CLI's ``edit_video`` on embeddings."""
        pipe, e = self.pipe, self.config["edit"]
        src_ff = pipe.encode_video(np.asarray(self.src01, np.float32)[None])
        edited_ff = pipe.encode_video(np.asarray(item["edited01"], np.float32)[None])
        traj = torch.as_tensor(self.traj, dtype=torch.float32, device=pipe.device)
        latents = pipe.sample_with_pnp(
            traj, self.inv_ts, item["text"], edited_ff, src_ff, num_inference_steps=e["steps"],
            t_idx=e["t_idx"] if t_idx is None else t_idx, cfg_txt=e["cfg_txt"],
            cfg_img=e["cfg_img"], pnp=self.PnPConfig(*(thresholds or e["pnp"])),
            frame_stride=e["frame_stride"])
        return {"encode": [src_ff, edited_ff], "latents": latents,
                "video": pipe.decode_latents(latents)}

    # -- invert ---------------------------------------------------------------

    def _invert_inputs(self, d, n_text):
        self.clip01 = self.uniform(self.frames + 1, self.config["height"], self.config["width"], 3)
        self.latents = self.pipe.encode_video(self.clip01)
        self.text = self.normal(1, n_text, d)
        n = int(self.traffic["steps_per_call"])
        self.keep = sorted(int(i) for i in self.rng.choice(
            n, size=min(n, int(self.traffic["check"]["steps"])), replace=False))

    def _invert(self, steps):
        traj, ts = self.pipe.invert(self.latents, self.text, num_inversion_steps=steps,
                                    frame_stride=self.config["invert"]["frame_stride"],
                                    traj_store=self.traffic["traj_store"])
        return {"traj": traj, "ts": ts}

    # -- the cell's interface ---------------------------------------------------

    def warm(self) -> None:
        """One short request on every shape of the window's (as i2vgen's)."""
        self.unet.start(())
        if self.kind == "edit":
            out = self._edit(self.pool[0], t_idx=self.config["edit"]["steps"] - 3,
                             thresholds=(0.96, 0.96, 0.96))
        else:
            out = self._invert(2)
        hard_sync([out[k] for k in out if k != "ts"])

    def request(self, index: int) -> Record:
        if self.kind == "edit":
            item = self.pool[index % len(self.pool)]
            self.unet.start(self.keep + [i + 1 for i in self.keep])
            out = self._edit(item)
            hard_sync([out["latents"], out["video"]])
            return Record(index, len(self.plan), out, self.unet.saved)
        steps = int(self.traffic["steps_per_call"])
        self.unet.start(self.keep)
        out = self._invert(steps)
        hard_sync(out["traj"])
        return Record(index, steps, out, self.unet.saved)

    def request_flops(self) -> int:
        c, F, n_text = self.config, self.frames, self.config["text_tokens"]
        unet = lambda b: ref_spec.unet_flops("videoldm", c["unet"], b, F, self.h, self.w, n_text)
        if self.kind == "invert":
            return int(self.traffic["steps_per_call"]) * unet(1)
        n3 = sum(1 for _, _, flags in self.plan if flags is not None)
        return (n3 * unet(3) + (len(self.plan) - n3) * unet(2)
                + 2 * ref_spec.vae_flops(c["vae"], "encode", 1, c["height"], c["width"])
                + ref_spec.vae_flops(c["vae"], "decode", F + 1, c["height"], c["width"]))

    def program_outputs(self, record: Record) -> dict:
        out = record.outputs
        if self.kind == "invert":
            return {"encode": [self.latents],
                    "unet": [record.saved[i][1] for i in self.keep],
                    "x": [self.latents[:, 1:] if i == 0 else out["traj"][i - 1][:, 1:]
                          for i in self.keep],
                    "next": [out["traj"][i][:, 1:] for i in self.keep]}
        xs, nexts, rows = [], [], []
        for i in self.keep:
            sample = record.saved[i][0]
            xs.append(sample[1:2] if self.plan[i][2] is not None else sample[0:1])
            if self.plan[i][2] is not None:
                rows.append(sample[0:1])
            if i + 1 < len(self.plan):
                nxt = record.saved[i + 1][0]
                nexts.append(nxt[1:2] if self.plan[i + 1][2] is not None else nxt[0:1])
            else:
                nexts.append(out["latents"][:, 1:])
        return {"encode": out["encode"], "decode": [out["video"]], "x": xs, "next": nexts,
                "unet": [record.saved[i][1] for i in self.keep], "traj_row": rows}

    def reference_outputs(self, record: Record, program: dict, fp8: bool = False) -> dict:
        c = self.config
        Pu, Pv = self.reference_params("unet", fp8), self.reference_params("vae", fp8)

        def encode(frames01):
            return ref_vae.encode(Pv, c["vae"], torch.as_tensor(frames01, device=self.device))[None]

        if self.kind == "invert":
            lat = encode(self.clip01)
            steps = int(self.traffic["steps_per_call"])
            ts = diffusion.inversion_timesteps(c["scheduler"], steps)
            eps, nxt = [], []
            for i, x in zip(self.keep, program["x"]):
                e = unet_videoldm.unet(Pu, c["unet"], x, int(ts[i]), self.text, lat[:, :1],
                                       c["invert"]["frame_stride"])
                eps.append(e)
                nxt.append(diffusion.ddim_inverse_step(c["scheduler"], x, e, int(ts[i]), steps))
            return {"encode": [lat], "unet": eps, "next": nxt, "x": program["x"]}

        e = c["edit"]
        item = self.pool[record.index % len(self.pool)]
        ff_src, ff_edit = encode(self.src01[None]), encode(item["edited01"][None])
        ffl = torch.cat([ff_src, ff_edit, ff_edit])
        row_of = {int(t): r for r, t in enumerate(self.inv_ts)}
        eps, nxt, rows = [], [], []
        for i, x in zip(self.keep, program["x"]):
            t, t_prev, flags = self.plan[i]
            sel = slice(0, 3) if flags is not None else slice(1, 3)
            inp = [x, x]
            if flags is not None:
                src = torch.as_tensor(self.traj[row_of[t]][:, 1:], device=self.device)
                rows.append(src)
                inp = [src] + inp
            out = unet_videoldm.unet(Pu, c["unet"], torch.cat(inp), t, item["text"][sel],
                                     ffl[sel], e["frame_stride"], pnp=flags, chunks=3)
            eps.append(out)
            e_u, e_t = out[-2:-1], out[-1:]
            nxt.append(diffusion.ddim_step(c["scheduler"], x, e_u + e["cfg_txt"] * (e_t - e_u),
                                           t, t_prev))
        return {"encode": [ff_src, ff_edit], "unet": eps, "next": nxt, "x": program["x"],
                "traj_row": rows,
                "decode": [ref_vae.decode(Pv, c["vae"], record.outputs["latents"][0])]}


def diffusion_mode(e: dict):
    """ConsistI2V's guidance mode from (cfg_txt, cfg_img)."""
    mode = None
    if e["cfg_txt"] > 1.0:
        mode = "text"
    if e["cfg_img"] > 1.0:
        mode = "both"
    return mode
