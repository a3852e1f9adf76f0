"""AnyV2V gradio demo entry point (counterpart of ``anyv2v_tpu/cli/gradio_demo.py``
and its ``_cosxl`` / ``_style`` clones; the reference's ``gradio_demo.py``,
``gradio_demo_cosxl.py`` and ``gradio_demo_style.py`` in one):

    python -m anyv2v_torch.cli.gradio_demo --variant {instructpix2pix,cosxl,style} \\
        [--headless --video_path V --prompt P --instruct_prompt I | --web [--tiny]] \\
        [--device cuda]

``--headless`` runs the three stages (preprocess, first-frame edit, AnyV2V)
from the command line and prints the edited video's path; ``--web`` serves
the stdlib web demo; otherwise the gradio app launches (gradio needed).
"""

from __future__ import annotations

import argparse

from ..product.gradio_app import EDITOR_FOR_VARIANT


def main(argv=None, variant=None) -> None:
    """``variant`` fixes the demo variant (the per-variant aliases) in place
    of ``--variant``."""
    parser = argparse.ArgumentParser()
    if variant is None:
        parser.add_argument("--variant", default="instructpix2pix",
                            choices=sorted(EDITOR_FOR_VARIANT))
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--web", action="store_true",
                        help="stdlib http.server UI (no gradio needed)")
    parser.add_argument("--tiny", action="store_true",
                        help="random tiny pipelines on the CPU (with --web)")
    parser.add_argument("--video_path", type=str, default=None)
    parser.add_argument("--prompt", type=str, default="")
    parser.add_argument("--instruct_prompt", type=str, default="")
    parser.add_argument("--negative_prompt", type=str, default="")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--arch", type=str, default="i2vgen-xl")
    parser.add_argument("--init", type=str, default="random")
    parser.add_argument("--editor_arch_suffix", type=str, default="")
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--ddim_inversion_steps", type=int, default=500)
    parser.add_argument("--server_port", type=int, default=7860)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)
    variant = variant or args.variant

    from ..product import gradio_app

    runner_kwargs = dict(arch=args.arch, init=args.init,
                         dtype="float32" if args.arch.endswith("-tiny") else "bfloat16")
    if args.headless:
        out = gradio_app.run_headless(
            args.video_path, args.prompt, args.instruct_prompt,
            variant=variant, negative_prompt=args.negative_prompt,
            out_dir=args.out_dir, runner_kwargs=runner_kwargs,
            editor=EDITOR_FOR_VARIANT[variant] + args.editor_arch_suffix,
            device=args.device,
            num_inference_steps=args.num_inference_steps,
            ddim_inversion_steps=args.ddim_inversion_steps,
        )
        print(out)
        return
    if args.web:
        from ..product import web_demo

        web_demo.serve(variant, port=args.server_port, tiny=args.tiny, device=args.device)
        return
    gradio_app.build_demo(variant, runner_kwargs=runner_kwargs,
                          device=args.device).launch(server_port=args.server_port)


if __name__ == "__main__":
    main()
