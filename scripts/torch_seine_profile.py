"""Profiles one SEINE (or ConsistI2V, or i2vgen-xl at 16 or 128 frames, or
one rank's program of the 128-frame forward split over 4 ranks) UNet
forward at full width on one NVIDIA GPU, at batch 1 (inversion) and batch 3
(edit, every PnP flag on), twice; or one first-frame editor's forward at
its CFG batch (InstructPix2Pix at 512^2 and CosXL at 1024^2, batch 3;
InstantStyle's ControlNet and UNet at 1024^2, batch 2), as ``chip_smoke.py``
profiles it, twice.

    python3 scripts/torch_seine_profile.py [TREE] [consisti2v | i2vgen | i2vgen128 | i2vgen128rank
        | instructpix2pix | cosxl | instantstyle]

``anyv2v_torch`` is imported from TREE (default: this checkout) and the
profiler from this checkout's ``chip_smoke.py``, so two trees can be
compared in one call: run it once per tree, in the order parent, change,
change, parent. Each line gives wall time, device busy share, device time
by kernel group, the number of device ops, the host's waits on the
device and the forward's peak device memory. Weights are seeded random
bf16, as in ``chip_smoke.py``. ``i2vgen128rank`` runs the rank's program as
``chip_smoke.py``'s phase 13 does (``mock_manual_axis(4)``: every collective
a local copy of its shape).
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    backbone = sys.argv[2] if len(sys.argv) > 2 else "seine"
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import anyv2v_torch
    from anyv2v_torch.ops import _build
    from anyv2v_torch.utils.model_zoo import (build_consisti2v_pipeline, build_i2vgen_pipeline,
                                              build_seine_pipeline)

    if not anyv2v_torch.__file__.startswith(tree):
        raise RuntimeError(f"anyv2v_torch came from {anyv2v_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    editors = {"instructpix2pix": (512, 3), "cosxl": (1024, 3), "instantstyle": (1024, 2)}
    if backbone in editors:
        from anyv2v_torch.utils.model_zoo import build_image_edit_pipeline

        pipe = build_image_edit_pipeline(backbone, device="cuda", seed=0, dtype=torch.bfloat16)
        print(f"anyv2v_torch from {tree}")
        for _ in range(2):
            smoke._editor_profile(pipe, backbone, *editors[backbone])
        return 0
    forward = None
    if backbone.startswith("i2vgen"):
        frames = 16 if backbone == "i2vgen" else smoke.LONG_FRAMES
        # a rank's share of the frames; the image latents stay whole
        f_loc = frames // smoke.SHARD_RANKS if backbone == "i2vgen128rank" else frames
        pipe = build_i2vgen_pipeline("i2vgen-xl", device="cuda", seed=0, dtype=torch.bfloat16)
        if backbone == "i2vgen128rank":
            forward = smoke._mocked(pipe.unet)

        def make_args(batch, g):   # chip_smoke.py's i2vgen-xl forward at `frames` frames
            def rn(*shape, scale=1.0):
                return torch.randn(*shape, generator=g, device="cuda") * scale
            kw = {"pnp": (True, True, True)} if batch == 3 else {}
            return (rn(batch, f_loc, 64, 64, 4), 501, rn(batch, 77, 1024, scale=0.1), 8,
                    rn(batch, frames, 64, 64, 4), rn(batch, 1, 1024, scale=0.1)), kw
    elif backbone == "consisti2v":
        pipe = build_consisti2v_pipeline("consisti2v", device="cuda", seed=0,
                                         dtype=torch.bfloat16)
        def make_args(batch, g):
            return smoke.consisti2v_rank_args(batch, g, 16)
    else:
        pipe = build_seine_pipeline("seine", device="cuda", seed=0, dtype=torch.bfloat16)
        make_args = smoke.seine_forward_args

    print(f"anyv2v_torch from {tree}")
    for _ in range(2):
        smoke.phase_profile(pipe, backbone, make_args, forward=forward)
    return 0


if __name__ == "__main__":
    sys.exit(main())
