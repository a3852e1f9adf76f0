"""Checkpoint conversion CLI (counterpart of
``anyv2v_tpu/cli/convert_checkpoint.py``): a diffusers snapshot folder ->
one ``.npz`` that every ``build_*_pipeline`` loads through ``model.init``.

    python -m anyv2v_torch.cli.convert_checkpoint \\
        --backbone i2vgen-xl --src /path/to/ali-vilab-i2vgen-xl --out i2v.npz
    python -m anyv2v_torch.cli.convert_checkpoint \\
        --backbone consisti2v --src /path/to/TIGER-Lab-ConsistI2V --out consisti2v.npz
    python -m anyv2v_torch.cli.convert_checkpoint \\
        --backbone seine --src /path/to/stable-diffusion-v1-4 \\
        --ckpt /path/to/seine.pt --out seine.npz
    python -m anyv2v_torch.cli.convert_checkpoint \
        --backbone instructpix2pix --src /path/to/timbrooks-instruct-pix2pix --out ip2p.npz

The file holds every component's state dict in the checkpoint's dtype and
the architecture read from the folder's ``config.json`` files
(:mod:`anyv2v_torch.utils.checkpoint`). Before it is written, every
component is loaded with strict keys into modules of that architecture built
on the ``meta`` device, so a folder the port cannot build fails here, not at
run time.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("anyv2v_torch.convert")

BACKBONES = ("i2vgen-xl", "consisti2v", "seine",
             "instructpix2pix", "magicbrush", "cosxl")


def convert(backbone: str, src: str, ckpt: str | None = None):
    """(state dicts by component, meta) of a snapshot folder."""
    from ..utils import checkpoint as C

    if backbone == "i2vgen-xl":
        return C.convert_i2vgen_pipeline_dir(src)
    if backbone == "consisti2v":
        return C.convert_consisti2v_dir(src)
    if backbone == "seine":
        if not ckpt:
            raise ValueError("--backbone seine requires --ckpt seine.pt")
        return C.convert_seine_checkpoint(src, ckpt)
    return C.convert_sd_editor_dir(src, backbone)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="diffusers snapshot folder -> npz")
    parser.add_argument("--backbone", required=True, choices=BACKBONES)
    parser.add_argument("--src", required=True, help="snapshot dir (diffusers layout)")
    parser.add_argument("--ckpt", default=None,
                        help="extra checkpoint file (seine.pt for --backbone seine)")
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument("--no_validate", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..utils.checkpoint import save_checkpoint, validate

    states, meta = convert(args.backbone, args.src, args.ckpt)
    if not args.no_validate:
        validate(states, meta, args.backbone)
        logger.info("%s validated: %d tensors", args.backbone,
                    sum(len(sd) for sd in states.values()))
    save_checkpoint(args.out, states, meta)
    logger.info("saved %s (%s)", args.out, meta["arch"])


if __name__ == "__main__":
    main()
