"""AnyV2V end to end, the reference ``i2vgen-xl/demo.ipynb`` as a script
(counterpart of ``examples/demo_walkthrough.py``; cells: a source video,
the first-frame edit, then inversion and the PnP edit in one call):

    python -m anyv2v_torch.product.walkthrough [workdir] [--device cuda]
        [--arch i2vgen-tiny] [--editor instructpix2pix-tiny] [--init random]

Tiny architectures with random weights by default (no checkpoint needed);
``--arch i2vgen-xl --editor instructpix2pix`` with converted checkpoints
(``--init``) for real use.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("workdir", nargs="?", default="demo_out")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--arch", default="i2vgen-tiny")
    parser.add_argument("--editor", default="instructpix2pix-tiny")
    parser.add_argument("--init", default="random", help="'random' or a converted .npz")
    args = parser.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    tiny = args.arch.endswith("-tiny")

    # --- cell 1: a source video (synthetic here; demo.ipynb loads demo/) ----
    from ..utils.io import save_video

    rng = np.random.RandomState(0)
    size = 64 if tiny else 512
    frames01 = rng.rand(4 if tiny else 16, size, size, 3).astype(np.float32)
    video_path = os.path.join(args.workdir, "source.mp4")
    save_video(frames01, video_path, fps=8)
    print("source video:", video_path)

    # --- cell 2: first-frame edit (InstructPix2Pix, demo.ipynb cell 4) -----
    from PIL import Image

    from ..cli.edit_image import build_model, edit_frame

    editor = build_model(args.editor, "", args.init, 0, args.device)
    edited = edit_frame(editor, frames01[0], "", num_inference_steps=3 if tiny else 100)
    edited_path = os.path.join(args.workdir, "edited_first_frame.png")
    Image.fromarray((edited * 255).astype(np.uint8)).save(edited_path)
    print("edited first frame:", edited_path)

    # --- cells 9-13: inversion + PnP edit in one call ------------------------
    from . import AnyV2VRunner

    runner = AnyV2VRunner(arch=args.arch, init=args.init,
                          dtype="float32" if tiny else "bfloat16", device=args.device)
    out = runner.perform_anyv2v(
        video_path=video_path, video_prompt="a stylized video", video_negative_prompt="",
        edited_first_frame_path=edited_path,
        ddim_inversion_steps=10 if tiny else 500, num_inference_steps=5 if tiny else 50,
        guidance_scale=9.0, conv_inj=0.2, spatial_inj=0.2, temp_inj=0.5,
        out_dir=args.workdir)
    print("edited video:", out)
    return out


if __name__ == "__main__":
    main()
