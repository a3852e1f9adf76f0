"""i2vgen-xl: the PnP edit and the DDIM inversion of ``anyv2v_torch``'s
``I2VGenPipeline``, called as the group CLIs call them
(``cli/run_group_pnp_edit.py::edit_video`` without the text and CLIP
encoders, whose embeddings are seeded inputs; ``cli/run_group_ddim_inversion.py``).

- ``edit``: the source and edited first frames to image latents, the PnP
  edit from ``t_idx`` on a cached trajectory handed over as a host array (a
  cache read from disk), the decode of the edited latents.
- ``invert``: one call of ``invert`` over ``steps_per_call`` steps of batch 1
  on the clip's latents, encoded in set-up.
"""

from __future__ import annotations

import numpy as np
import torch

from ..benchguard import hard_sync
from ..cell import Cell as BaseCell, Record, UNetCalls, as_tuples, load_module, segments_of
from ..reference import diffusion, spec as ref_spec, unet_i2vgen, vae as ref_vae


def _program():
    from anyv2v_torch.models.unet_i2vgen import I2VGenUNet, I2VGenUNetConfig
    from anyv2v_torch.models.vae import AutoencoderKL, VAEConfig
    from anyv2v_torch.pipelines.i2vgen import I2VGenPipeline, PnPConfig
    from anyv2v_torch.schedulers import make_schedule

    return I2VGenUNet, I2VGenUNetConfig, AutoencoderKL, VAEConfig, I2VGenPipeline, PnPConfig, \
        make_schedule


class Cell(BaseCell):
    reference_unet_kind = "i2vgen"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        (Unet, UnetConfig, Vae, VaeConfig, Pipeline, self.PnPConfig,
         make_schedule) = _program()
        dt = torch.bfloat16
        unet = load_module(Unet, UnetConfig(**as_tuples(config["unet"]), dtype=dt),
                           self.state("unet"), self.device, dt)
        vae = load_module(Vae, VaeConfig(**as_tuples(config["vae"]), dtype=dt),
                          self.state("vae"), self.device, dt)
        self.unet = UNetCalls(unet)
        self.pipe = Pipeline(unet=self.unet, vae=vae, text_encoder=None, vision_encoder=None,
                             schedule=make_schedule(**config["scheduler"], device=self.device),
                             device=self.device, dtype=dt)
        self.vae = vae
        d, n_text = config["unet"]["cross_attention_dim"], config["text_tokens"]
        if self.kind == "edit":
            self._edit_inputs(d, n_text)
        elif self.kind == "invert":
            self._invert_inputs(d, n_text)
        else:
            raise ValueError(f"i2vgen has no request {self.kind!r}")

    # -- edit -----------------------------------------------------------------

    def _edit_inputs(self, d, n_text):
        cfg, e, F = self.config, self.config["edit"], self.frames
        sched = cfg["scheduler"]
        self.plan = diffusion.edit_plan(sched, e["steps"], e["t_idx"], e["pnp"])
        self.inv_ts = diffusion.inversion_timesteps(sched, e["steps"])
        # the cached trajectory: the seeded clean latents noised to each row's timestep
        clean = self.normal(1, F, self.h, self.w, 4)
        self.traj = torch.stack([diffusion.add_noise(sched, clean, self.normal(*clean.shape),
                                                     int(t)) for t in self.inv_ts]).cpu().numpy()
        self.src01 = self.host_image()
        inv, neg, emb_src = self.normal(1, n_text, d), self.normal(1, n_text, d), self.normal(1, 1, d)
        self.pool = []
        for _ in range(int(self.traffic["pool"])):
            emb = self.normal(1, 1, d)
            self.pool.append({"edited01": self.host_image(),
                              "text": torch.cat([inv, neg, self.normal(1, n_text, d)]),
                              "image_embeds": torch.cat([emb_src, emb, emb])})
        per = int(self.traffic["check"]["steps_per_segment"])
        self.keep = self.sampled_steps(segments_of(self.plan), per)

    def _edit(self, item, t_idx=None, thresholds=None):
        """The body of the CLI's ``edit_video`` on embeddings."""
        from anyv2v_torch.pipelines.common import HostTrajectory

        pipe, e = self.pipe, self.config["edit"]
        t_idx = e["t_idx"] if t_idx is None else t_idx
        lat_src = pipe.prepare_image_latents(self.src01, self.frames)
        lat_edit = pipe.prepare_image_latents(item["edited01"], self.frames)
        traj = HostTrajectory.from_array(self.traj, pipe.device)
        start_t = int(diffusion.sampling_timesteps(self.config["scheduler"], e["steps"])[t_idx])
        init_latent = traj[int(np.where(self.inv_ts == start_t)[0][0])]
        latents = pipe.sample_with_pnp(
            traj, self.inv_ts, item["text"], torch.cat([lat_src, lat_edit, lat_edit]),
            item["image_embeds"], num_inference_steps=e["steps"], t_idx=t_idx,
            guidance_scale=e["guidance_scale"],
            pnp=self.PnPConfig(*(thresholds or e["pnp"])), fps=e["fps"], init_latent=init_latent)
        return {"encode": [lat_src, lat_edit], "latents": latents,
                "video": pipe.decode_latents(latents)}

    # -- invert ---------------------------------------------------------------

    def _invert_inputs(self, d, n_text):
        clip01 = self.uniform(self.frames, self.config["height"], self.config["width"], 3)
        self.clip01 = clip01
        self.latents = self.pipe.encode_video(clip01)
        self.image_latents = self.pipe.prepare_image_latents(clip01[0], self.frames)
        self.text, self.image_embeds = self.normal(1, n_text, d), self.normal(1, 1, d)
        n = int(self.traffic["steps_per_call"])
        self.keep = sorted(int(i) for i in self.rng.choice(
            n, size=min(n, int(self.traffic["check"]["steps"])), replace=False))

    def _invert(self, steps):
        traj, ts = self.pipe.invert(self.latents, self.text, self.image_latents,
                                    self.image_embeds, num_inversion_steps=steps,
                                    fps=self.config["invert"]["fps"],
                                    traj_store=self.traffic["traj_store"])
        return {"traj": traj, "ts": ts}

    # -- the cell's interface ---------------------------------------------------

    def warm(self) -> None:
        """One short request on every shape of the window's: an edit from the
        third-last step with every injection on its first step (batch 3),
        then two steps at batch 2, and the decode; or a two-step inversion."""
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
        unet = lambda b: ref_spec.unet_flops("i2vgen", c["unet"], b, F, self.h, self.w, n_text)
        if self.kind == "invert":
            return int(self.traffic["steps_per_call"]) * unet(1)
        n3 = sum(1 for _, _, flags in self.plan if flags is not None)
        return (n3 * unet(3) + (len(self.plan) - n3) * unet(2)
                + 2 * ref_spec.vae_flops(c["vae"], "encode", 1, c["height"], c["width"])
                + ref_spec.vae_flops(c["vae"], "decode", F, c["height"], c["width"]))

    def program_outputs(self, record: Record) -> dict:
        out = record.outputs
        if self.kind == "invert":
            rows = [out["traj"][i] for i in self.keep]
            prev = [self.latents if i == 0 else out["traj"][i - 1] for i in self.keep]
            return {"encode": [self.latents, self.image_latents],
                    "unet": [record.saved[i][1] for i in self.keep], "x": prev, "next": rows}
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
                nexts.append(out["latents"])
        return {"encode": out["encode"], "decode": [out["video"]], "x": xs, "next": nexts,
                "unet": [record.saved[i][1] for i in self.keep], "traj_row": rows}

    def reference_outputs(self, record: Record, program: dict, fp8: bool = False) -> dict:
        c = self.config
        Pu, Pv = self.reference_params("unet", fp8), self.reference_params("vae", fp8)

        def image_latents(img01):
            z = ref_vae.encode(Pv, c["vae"], torch.as_tensor(img01, device=self.device)[None])[0]
            masks = [torch.full_like(z, (i + 1) / (self.frames - 1)) for i in range(self.frames - 1)]
            return torch.stack([z, *masks])[None]

        if self.kind == "invert":
            lat = ref_vae.encode(Pv, c["vae"], self.clip01)[None]
            il = image_latents(self.clip01[0])
            steps = int(self.traffic["steps_per_call"])
            ts = diffusion.inversion_timesteps(c["scheduler"], steps)
            eps, nxt = [], []
            for i, x in zip(self.keep, program["x"]):
                e = unet_i2vgen.unet(Pu, c["unet"], x, int(ts[i]), self.text, c["invert"]["fps"],
                                     il, self.image_embeds)
                eps.append(e)
                nxt.append(diffusion.ddim_inverse_step(c["scheduler"], x, e, int(ts[i]), steps))
            return {"encode": [lat, il], "unet": eps, "next": nxt, "x": program["x"]}

        e = c["edit"]
        item = self.pool[record.index % len(self.pool)]
        il3 = torch.cat([image_latents(self.src01), *[image_latents(item["edited01"])] * 2])
        row_of = {int(t): r for r, t in enumerate(self.inv_ts)}
        eps, nxt, rows = [], [], []
        for i, x in zip(self.keep, program["x"]):
            t, t_prev, flags = self.plan[i]
            sel = slice(0, 3) if flags is not None else slice(1, 3)
            inp = [x, x]
            if flags is not None:
                src = torch.as_tensor(self.traj[row_of[t]], device=self.device)
                rows.append(src)
                inp = [src] + inp
            out = unet_i2vgen.unet(Pu, c["unet"], torch.cat(inp), t, item["text"][sel], e["fps"],
                                   il3[sel], item["image_embeds"][sel], pnp=flags, chunks=3)
            eps.append(out)
            e_u, e_c = out[-2:-1], out[-1:]
            nxt.append(diffusion.ddim_step(c["scheduler"], x, e_u + e["guidance_scale"] *
                                           (e_c - e_u), t, t_prev))
        return {"encode": [il3[0:1], il3[1:2]], "unet": eps, "next": nxt, "x": program["x"],
                "traj_row": rows,
                "decode": [ref_vae.decode(Pv, c["vae"], record.outputs["latents"][0])]}
