"""Seeded random weights, drawn on the device in a few large calls.

The init rule follows the program's random init (``model_zoo.random_state_dict``,
frozen here), with three changes so that the comparison sees every operand:
biases are drawn (std :data:`BIAS_STD`) and norm scales are ``1 + N(0,
NORM_STD)`` where the zoo puts zeros and ones, and the last conv of each
i2vgen-xl temporal conv layer is drawn where the zoo zeroes it (a zero conv
makes the layer an identity, and its kernel would go unchecked). Matrices and
kernels are normal with std ``fan_in ** -0.5``; ConsistI2V's temporal gates
``alpha`` are 0.5.

All normal draws of one module come from one ``torch.randn`` in the served
dtype; each leaf is a view of it, scaled in place.
"""

from __future__ import annotations

import math

import torch

BIAS_STD = 0.1
NORM_STD = 0.1


def _rule(name: str, shape) -> tuple:
    """(kind, std): kind "normal" (std), "norm_scale" or "const" (value)."""
    if name.endswith("alpha"):
        return "const", 0.5
    if name.endswith("bias"):
        return "normal", BIAS_STD
    if name.endswith("weight") and len(shape) == 1:
        return "norm_scale", NORM_STD
    return "normal", math.prod(shape[1:]) ** -0.5


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + salt) % 2 ** 63)


def draw(spec: dict, seed: int, salt: int, device, dtype=torch.bfloat16) -> dict:
    """A state dict for ``spec`` (key -> shape), the same for the same
    ``(seed, salt)``: one normal draw of every element, sliced into leaves."""
    total = sum(math.prod(s) for s in spec.values())
    flat = torch.randn(total, generator=generator(seed, salt, device), device=device, dtype=dtype)
    out, off = {}, 0
    for name in sorted(spec):
        shape = spec[name]
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        kind, value = _rule(name, shape)
        if kind == "normal":
            leaf.mul_(value)
        elif kind == "norm_scale":
            leaf.mul_(value).add_(1.0)
        else:
            leaf.fill_(value)
        out[name] = leaf
    return out
