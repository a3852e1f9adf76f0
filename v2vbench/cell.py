"""What every backbone adapter shares: the program's modules built from a
configuration file and loaded with the benchmark's weights, the UNet
wrapper that captures the sampled steps, the record of one request, and the
comparison of the program's outputs with the reference's.

An adapter (``v2vbench/backbones/<backbone>.py``) subclasses :class:`Cell`
and gives, for each request kind its traffic files name (``edit``,
``invert``): the set-up of its inputs, the request itself (the program's
calls as its CLI makes them), the shapes whose operations a request costs,
and the reference's outputs for a finished request.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import weights
from .reference import spec as ref_spec
from .reference.nn import Params

UNET_SALT, VAE_SALT, INPUT_SALT = 1, 2, 3


def as_tuples(d: dict) -> dict:
    """A configuration object's lists as the tuples the program's frozen
    dataclasses hold (pairs of lists as tuples of tuples)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        out[k] = v
    return out


def load_module(cls, config, state: dict, device, dtype):
    """A module of the program built on meta, moved to ``device`` in ``dtype``
    and loaded, every key checked, with ``state``."""
    with torch.device("meta"):
        module = cls(config)
    module.to_empty(device=device)
    module.to(dtype)
    module.load_state_dict(state)
    return module.eval().requires_grad_(False)


def frame_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 gap over the leading rows and frames of
    ``[B, F, ...]`` (or ``[N, ...]``) tensors: ``|got - want| / |want|`` per
    frame, the worst frame."""
    lead = 2 if want.dim() == 5 else 1
    g = got.float().reshape(math.prod(got.shape[:lead]), -1)
    w = want.float().reshape(math.prod(want.shape[:lead]), -1).to(g.device)
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)).max())


class UNetCalls:
    """The pipeline's UNet, wrapped on the pipeline's instance: it counts the
    calls of a request, keeps a copy of the input and output of the calls in
    :attr:`keep`, and when :attr:`span` is set puts a profiler span around
    each forward."""

    def __init__(self, unet):
        self.unet, self.config = unet, unet.config
        self.keep: frozenset = frozenset()
        self.calls, self.saved = 0, {}
        self.span = None

    def start(self, keep) -> None:
        self.keep, self.calls, self.saved = frozenset(keep), 0, {}

    def __call__(self, sample, *args, **kwargs):
        i = self.calls
        self.calls += 1
        if self.span is not None:
            with self.span("unet.forward"):
                out = self.unet(sample, *args, **kwargs)
        else:
            out = self.unet(sample, *args, **kwargs)
        if i in self.keep:
            self.saved[i] = (sample.detach().clone(), out.detach().clone())
        return out


@dataclasses.dataclass
class Record:
    """One finished request: its index, its UNet steps, the program's outputs
    that the check reads, and the captured calls."""

    index: int
    steps: int
    outputs: dict
    saved: dict


class Cell:
    """One configuration under one traffic mix, on one device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.kind = traffic["request"]
        self.frames = int(traffic["frames"])
        self.h, self.w = config["height"] // 8, config["width"] // 8
        self.rng = np.random.default_rng([self.seed, 4])
        self.gen = weights.generator(self.seed, INPUT_SALT, self.device)

    # -- seeded inputs --------------------------------------------------------

    def normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def uniform(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def host_image(self, frames=None) -> np.ndarray:
        """A seeded frame (or clip) in [0, 1], as a host array: what the CLI
        reads from disk."""
        shape = (self.config["height"], self.config["width"], 3)
        return self.uniform(*(((frames,) if frames else ()) + shape)).cpu().numpy()

    # -- weights --------------------------------------------------------------

    def unet_spec(self) -> dict:
        return ref_spec.unet_spec(self.reference_unet_kind, self.config["unet"])

    def state(self, part: str, dtype=torch.bfloat16) -> dict:
        """The seeded weights of ``part`` ("unet" or "vae")."""
        if part == "unet":
            return weights.draw(self.unet_spec(), self.seed, UNET_SALT, self.device, dtype)
        return weights.draw(ref_spec.vae_spec(self.config["vae"]), self.seed, VAE_SALT,
                            self.device, dtype)

    def reference_params(self, part: str, fp8: bool = False) -> Params:
        """The same weights in float32 for the reference (``fp8``: for the
        control), drawn again from the seed."""
        return Params({k: v.float() for k, v in self.state(part).items()}, fp8=fp8)

    # -- what a subclass gives --------------------------------------------------

    reference_unet_kind = ""

    def warm(self) -> None:
        raise NotImplementedError

    def request(self, index: int) -> Record:
        raise NotImplementedError

    def request_flops(self) -> int:
        raise NotImplementedError

    def program_outputs(self, record: Record) -> dict:
        """What :func:`compare` reads of the program's request: its encodes,
        the sampled steps' states ``x``, next states and UNet outputs, the
        trajectory rows it read, its decoded frames."""
        raise NotImplementedError

    def reference_outputs(self, record: Record, program: dict, fp8: bool = False) -> dict:
        """The reference's outputs for ``record``, from the program's states
        at the sampled steps and its edited latents; with ``fp8``, the
        control's."""
        raise NotImplementedError

    def release(self) -> None:
        """Free the program's modules and state before the reference runs."""
        for name in ("pipe", "unet", "vae"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- shared pieces ------------------------------------------------------------

    def sampled_steps(self, segments, per_segment: int) -> list:
        """``per_segment`` steps drawn from each segment (a list of step
        indices), sorted."""
        out = []
        for seg in segments:
            k = min(per_segment, len(seg))
            out += [int(i) for i in self.rng.choice(seg, size=k, replace=False)]
        return sorted(out)


def segments_of(plan) -> list:
    """Runs of consecutive steps with the same injection flags."""
    runs = []
    for i, (_, _, flags) in enumerate(plan):
        if runs and plan[runs[-1][-1]][2] == flags:
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


def compare(program: dict, reference: dict) -> dict:
    """The numbers of a check: for each output the reference gives, the
    program's gap from it. ``encode``, ``decode``: :func:`frame_gap` of the
    latents and frames. ``unet``: the worst :func:`frame_gap` of a sampled
    step's UNet output. ``step``: the gap of the sampled steps' updates
    ``x_next - x`` taken together, ``|next - next_ref| / |next_ref - x|`` over
    every sampled step and frame (a step whose update is small, as the last
    step of an edit's, would swing a per-step ratio). ``traj_row``: the
    largest absolute difference of a cached trajectory row as the program
    read it (exact)."""
    out = {}
    for name in ("encode", "decode"):
        if name in reference:
            out[name] = max(frame_gap(p, r) for p, r in zip(program[name], reference[name]))
    if "unet" in reference:
        out["unet"] = max(frame_gap(p, r) for p, r in zip(program["unet"], reference["unet"]))
        err = sum(float((pn.float() - rn.float()).square().sum())
                  for pn, rn in zip(program["next"], reference["next"]))
        size = sum(float((rn.float() - x.float()).square().sum())
                   for rn, x in zip(reference["next"], program["x"]))
        out["step"] = (err / max(size, 1e-30)) ** 0.5
    if reference.get("traj_row"):
        out["traj_row"] = max(float((p.float() - r.to(p.device)).abs().max())
                              for p, r in zip(program["traj_row"], reference["traj_row"]))
    return out
