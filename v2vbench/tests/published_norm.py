"""A run of the benchmark with the program's temporal transformer taking its
group norm over every frame of a clip, as the published I2VGen-XL modules do
(diffusers ``TransformerTemporalModel`` normalises ``[B, C, F, H, W]``); the
program takes it per frame. Everything else is the program's own:

    python -m v2vbench.tests.published_norm [v2vbench.controls] --workload <cell> ...

The witness that an i2vgen-xl cell's gap to the reference comes from that
norm alone: this run comes out correct where the program's own does not.
"""

from __future__ import annotations

import sys


def temporal_norm(per_frame: bool = False):
    """Sets the program's temporal transformer to take its group norm over
    every frame of a clip, or per frame; returns what undoes it."""
    from anyv2v_torch.models import layers

    forward, plain = layers.TemporalTransformer.forward, layers.group_norm

    def patched(self, x, *args, **kwargs):
        b, f = x.shape[:2]
        rows = b * f if per_frame else b

        def norm(y, module):
            if module is self.norm:      # statistics over each row's frames and pixels
                return plain(y.reshape(rows, -1, y.shape[-1]), module).reshape(y.shape)
            return plain(y, module)

        layers.group_norm = norm
        try:
            return forward(self, x, *args, **kwargs)
        finally:
            layers.group_norm = plain

    layers.TemporalTransformer.forward = patched

    def undo():
        layers.TemporalTransformer.forward = forward

    return undo


def main() -> int:
    """Runs ``v2vbench.run`` (or the module named first, such as
    ``v2vbench.controls``) with the arguments that follow."""
    import importlib

    args = sys.argv[1:]
    module = args.pop(0) if args and not args[0].startswith("-") else "v2vbench.run"
    temporal_norm()
    return importlib.import_module(module).main(args)


if __name__ == "__main__":
    sys.exit(main())
