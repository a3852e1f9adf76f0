"""The traced request: spans put by the harness around the calls into each
layer, the shapes of each kernel family's calls, and ``torch.profiler``'s
device timeline, reduced in memory to what the per-layer readers read.

Spans (``record_function``): ``request``; ``unet.forward`` (the pipeline's
UNet, wrapped on its instance); ``vae.encode`` and ``vae.decode`` (the VAE's
methods, wrapped on its instance); ``traj.append`` (``HostTrajectory.append``).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import re

import torch
from torch.autograd.profiler import record_function

from . import roofline

SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}
SPANS = ("request", "unet.forward", "vae.encode", "vae.decode", "traj.append")
TOP = 10


def port_kernel_names() -> set:
    """The ``__global__`` functions of the program's CUDA sources."""
    import anyv2v_torch

    csrc = os.path.join(os.path.dirname(anyv2v_torch.__file__), "csrc")
    names = set()
    for f in os.listdir(csrc):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                                        r"(\w+)\s*\(", fh.read()))
    return names


class Shapes:
    """Wraps each kernel family's entry points for the traced request and
    sums the calls and their least time."""

    def __init__(self, families: dict):
        self.families = families
        self.ideal = {n: 0.0 for n in families}
        self.calls = {n: 0 for n in families}
        self._undo = []

    def __enter__(self):
        for name, fam in self.families.items():
            for mod_name, attr in fam.WRAP:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
                setattr(mod, attr, self._wrap(name, fam.cost, orig))
                self._undo.append((mod, attr, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._undo):
            # an entry point that counts its launches on its own name counted
            # on the wrapper meanwhile: the counts go back to it
            orig.__dict__.update({k: v for k, v in getattr(mod, attr).__dict__.items()
                                  if k != "__wrapped__"})
            setattr(mod, attr, orig)
        self._undo = []

    def _wrap(self, name, cost, orig):
        def wrapper(*args, **kwargs):
            self.ideal[name] += roofline.ideal_seconds(*cost(*args, **kwargs))
            self.calls[name] += 1
            return orig(*args, **kwargs)
        return functools.update_wrapper(wrapper, orig)


@contextlib.contextmanager
def spans(cell):
    """Spans around the UNet's forwards, the VAE's calls and the host
    trajectory's appends, for the traced request."""
    from anyv2v_torch.pipelines.common import HostTrajectory

    vae = cell.pipe.vae
    originals = {m: getattr(vae, m) for m in ("encode_moments", "decode")}

    def spanned(label, fn):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call

    vae.encode_moments = spanned("vae.encode", originals["encode_moments"])
    vae.decode = spanned("vae.decode", originals["decode"])
    append = HostTrajectory.append
    HostTrajectory.append = spanned("traj.append", append)
    cell.unet.span = record_function
    try:
        yield
    finally:
        cell.unet.span = None
        HostTrajectory.append = append
        for m in originals:
            delattr(vae, m)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The traced request reduced: device busy time and idle gaps, time by
    kernel family, host syncs inside UNet forwards, device time launched
    inside VAE calls; with the untraced window's requests and seconds."""

    def __init__(self, events, shapes: Shapes, request_flops: int, window: tuple):
        fams = shapes.families
        pats = {n: re.compile("|".join(f.PATTERNS)) for n, f in fams.items()}
        port = port_kernel_names()
        dev, spans_, syncs, launch = [], {s: [] for s in SPANS}, [], {}
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name, s = e.name(), e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == cuda:
                # the spans' copies on the device timeline are no device work
                annotation = name in spans_ or (hasattr(e, "is_user_annotation")
                                                and e.is_user_annotation())
                if not annotation:
                    dev.append((name, s, end, e.correlation_id()))
            elif name in spans_:
                spans_[name].append((s, end))
            elif name in SYNCS:
                syncs.append(s)
            elif name.startswith("cu"):
                launch[e.correlation_id()] = s
        if not spans_["request"]:
            raise RuntimeError("the trace holds no request span")
        w0, w1 = spans_["request"][0]
        dev = [d for d in dev if d[2] > w0 and d[1] < w1]
        self.window_s = (w1 - w0) / 1e9
        busy = _union([(max(s, w0), min(e, w1)) for _, s, e, _ in dev])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.device_ops = len(dev)

        self.family_s = {n: 0.0 for n in fams}
        by_label, unmatched = {}, {}
        fam_of = {}
        for name, s, e, _ in dev:
            if name not in fam_of:
                fam_of[name] = next((n for n, p in pats.items() if p.search(name)), None)
            fam = fam_of[name]
            if fam is not None:
                self.family_s[fam] += (e - s) / 1e9
            else:
                unmatched[name] = unmatched.get(name, 0) + 1
            label = fams[fam].NAME if fam else name[:100]
            by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e9
        self.unmatched = unmatched
        self.unmatched_port = sorted(n for n in unmatched if any(
            re.search(rf"\b{k}\b", n) for k in port))
        self.top_ops = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]

        gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)]
        if busy:
            gaps += [(busy[0][0] - w0, w0), (w1 - busy[-1][1], busy[-1][1])]
        inner = [(s, e, n) for n in SPANS for s, e in spans_[n]]

        def label(t):
            open_ = [(e - s, n) for s, e, n in inner if s <= t < e]
            return min(open_)[1] if open_ else "host, outside the request"

        self.idle_gaps = [(label(t), g / 1e9) for g, t in sorted(gaps, reverse=True)[:TOP]
                          if g > 0]

        forwards = spans_["unet.forward"]
        self.unet_forwards = len(forwards)
        self.unet_syncs = sum(1 for t in syncs if any(s <= t < e for s, e in forwards))
        vae = spans_["vae.encode"] + spans_["vae.decode"]
        self.vae_s = sum((e - s) / 1e9 for _, s, e, c in dev
                         if c in launch and any(a <= launch[c] < b for a, b in vae))
        self.vae_calls = len(vae)
        self.shapes = shapes
        self.request_flops = request_flops
        self.untraced_requests, self.untraced_s = window

    # -- what the readers read ---------------------------------------------------

    def roofline(self, family: str):
        """The family's least time over its device time, in %; None where it
        did not run."""
        t = self.family_s.get(family, 0.0)
        if t <= 0 or not self.shapes.calls.get(family):
            return None
        return 100.0 * self.shapes.ideal[family] / t

    def mfu(self):
        """The model operations of the untraced window's requests over its
        seconds and the peak, in %."""
        flops = self.request_flops * self.untraced_requests
        return 100.0 * flops / self.untraced_s / roofline.PEAK_FLOPS

    def syncs_per_forward(self):
        return self.unet_syncs / self.unet_forwards if self.unet_forwards else None

    def vae_ms(self):
        return 1e3 * self.vae_s if self.vae_calls else None

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.top_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}
