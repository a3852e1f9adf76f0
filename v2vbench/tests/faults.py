"""A run of the benchmark with the timed path broken underneath, for the
check's own test: ``python -m v2vbench.tests.faults <fault> <run args>``.

- ``stale_step``: every DDIM step (and inverse step) returns its state
  unchanged;
- ``half_batch``: the UNet's output for the second half of the frames
  replaced by the mean over the first half (half the batch left out);
- ``altered_answer``: the answer altered where it is produced: the decoded
  frames of an edit shifted by 0.05 on one frame, each row of an inversion's
  trajectory moved by seeded noise of std 0.05 (the latents' is about 1);
- ``per_frame_norm``: the temporal transformer's group norm taken per frame,
  not over the clip's frames as the published modules take it.

(A cell on one chip has no exchange between chips to leave out.)

Each other fault is planted in the program with its temporal transformer's
norm as the published modules take it (``published_norm.py``), so that the
planted fault alone separates it from the reference.
"""

from __future__ import annotations

import sys

import torch


def stale_step():
    from anyv2v_torch.pipelines import consisti2v, i2vgen

    for mod in (i2vgen, consisti2v):
        mod.ddim_step = lambda schedule, sample, *a, **k: sample
        mod.ddim_inverse_step = lambda schedule, sample, *a, **k: sample


def half_batch():
    from anyv2v_torch.models.unet_i2vgen import I2VGenUNet
    from anyv2v_torch.models.unet_videoldm import VideoLDMUNet

    for cls in (I2VGenUNet, VideoLDMUNet):
        orig = cls.forward

        def forward(self, *args, _orig=orig, **kwargs):
            out = _orig(self, *args, **kwargs).clone()
            f = out.shape[1]
            out[:, f - f // 2:] = out[:, :f - f // 2].mean(dim=1, keepdim=True)
            return out

        cls.forward = forward


def altered_answer():
    from anyv2v_torch.pipelines import common, consisti2v, i2vgen

    decode = common.LatentCodecMixin.decode_latents

    def decode_latents(self, *args, **kwargs):
        video = decode(self, *args, **kwargs).clone()
        video[0] += 0.05
        return video

    common.LatentCodecMixin.decode_latents = decode_latents
    for mod in (i2vgen, consisti2v):
        run = mod.run_inversion

        def run_inversion(*args, _run=run, **kwargs):
            traj = _run(*args, **kwargs)
            g = torch.Generator().manual_seed(0)
            chunks = traj._chunks if hasattr(traj, "_chunks") else [traj]
            for c in chunks:
                c += 0.05 * torch.randn(c.shape, generator=g).to(c.device)
            return traj

        mod.run_inversion = run_inversion


FAULTS = {"stale_step": stale_step, "half_batch": half_batch, "altered_answer": altered_answer,
          "per_frame_norm": lambda: None}


def main() -> int:
    from v2vbench import run

    from v2vbench.tests.published_norm import temporal_norm

    temporal_norm(per_frame=sys.argv[1] == "per_frame_norm")
    FAULTS[sys.argv[1]]()
    return run.main(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
