"""KR, the partial rotary of ConsistI2V's and SEINE's temporal attention
(``csrc/rotary.cu``). Memory-bound: no operations are counted.

An entry point that the program lacks (one older than the kernel) is left
out of ``WRAP``, so the family loads against it and reads nothing there."""

import importlib

from v2vbench.roofline import nbytes

NAME = "KR"
PATTERNS = (r"\bkr_rotary_kernel\b",)
ENTRIES = (("anyv2v_torch.ops.rotary", "rotate_partial"),)


def present(entries):
    """The (module, name) entries that the program has."""
    out = []
    for mod, attr in entries:
        try:
            module = importlib.import_module(mod)
        except ImportError:
            continue
        if hasattr(module, attr):
            out.append((mod, attr))
    return tuple(out)


WRAP = present(ENTRIES)


def cost(x, positions, rot, *args, **kwargs):
    """x read once, the output (x's shape and dtype) written once, the
    positions and the fp32 frequency table (``rot / 2`` entries) read."""
    return 0, 2 * nbytes(x) + nbytes(positions) + 4 * (rot // 2)
