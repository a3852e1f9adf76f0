"""KN, the norms (``csrc/norm.cu``): the group norm's statistics and apply,
SiLU fused where the caller applies one; K4's group statistics (``s, t``);
the layer norm. Memory-bound: no operations are counted.

Entry points that the program lacks (one older than these kernels) are left
out of ``WRAP``, so the family loads against it and reads nothing there."""

import importlib

import torch

from v2vbench.roofline import nbytes

NAME = "KN"
PATTERNS = (r"\bkn_(group_stats|group_apply|group_finalize|layer_norm)_kernel\b",)
ENTRIES = (("anyv2v_torch.ops.norm", "group_norm"), ("anyv2v_torch.ops.norm", "layer_norm"),
           ("anyv2v_torch.ops.norm", "group_scale_shift"))


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


def cost(x, weight, bias, *args, **kwargs):
    """x read once, the affine parameters read, the output written once: x's
    shape in the dtype the call names (``group_norm``, ``layer_norm``) or,
    where it names none (``group_scale_shift``), ``s`` and ``t`` ``[N, C]``
    in fp32."""
    out = next((a for a in (*args, *kwargs.values()) if isinstance(a, torch.dtype)), None)
    if out is None:
        written = 2 * x.shape[0] * x.shape[-1] * 4
    else:
        written = x.numel() * torch.finfo(out).bits // 8
    return 0, nbytes(x) + written + nbytes(weight) + nbytes(bias)
