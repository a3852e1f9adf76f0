"""Benchmark: 16-frame 512^2 AnyV2V invert + PnP-edit wall-clock on one GPU
(counterpart of the repository's root ``bench.py``).

    python -m anyv2v_torch.bench

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"detail"}``, the JAX entry's keys.

The workload is the JAX entry's: i2vgen-xl with seeded random bf16 weights
(UNet and VAE only: the text and image embeddings are inputs drawn from
``np.random.RandomState(0)``, as are the frames), 17 VAE encodes (16 frames
and the conditioning frame) and 16 decodes, DDIM inversion (500 UNet
forwards, batch 1) and PnP edit (50 forwards, batch 3 [src, uncond, cond],
then batch 2 once the injections expire) at 16 frames, 512^2, fp32 scans.

By default each scan runs warm (after a short scan of :data:`WARM_STEPS`
steps: the port compiles nothing, so the warm-up only builds the kernels
and fills the allocator) for 20 inversion and 10 edit steps, and the
totals are projected to 500 and 50 steps: a step's cost does not depend on
its index (the edit's injection steps are a fixed share of the grid).
``BENCH_FULL=1`` runs the true 500 + 50. ``BENCH_FRAMES`` sets the clip
length (from 64 frames on the trajectory is kept in host memory, as the
JAX entry does), ``BENCH_ARCH`` the architecture, ``BENCH_PROFILE=<dir>``
traces the measured inversion with ``torch.profiler`` (a Chrome trace;
tracing adds overhead, so a profiled number is for analysis, not for the
record), ``BENCH_VERBOSE=1`` logs progress on stderr.

Each phase's time is host wall-clock between two synchronisations
(:func:`anyv2v_torch.utils.benchguard.hard_sync` on its outputs), and each
scan must pass :func:`check_scan_time`. ``vs_baseline`` is null: the JAX
entry divides a 60 s target set for a TPU v5e-8, which sets nothing here.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .utils.benchguard import check_scan_time, hard_sync
from .utils.profiling import trace_if

INV_STEPS, EDIT_STEPS = 500, 50          # the workload's true step counts
INV_MEASURE, EDIT_MEASURE = 20, 10       # the measured scans when projecting
WARM_STEPS = 2                           # the warm-up scans
HOST_STORE_FRAMES = 64                   # from here on the trajectory lives in host memory

_T0 = time.perf_counter()


def log(msg: str) -> None:
    if os.environ.get("BENCH_VERBOSE", "0") == "1":
        print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def timed(fn):
    """(``fn()``, its wall seconds): the device drained before, and the
    output synchronised by :func:`hard_sync` after (which raises on a
    non-finite output)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    hard_sync(out)
    return out, time.perf_counter() - t0


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def step_counts(full: bool, inv_steps: int = INV_MEASURE, edit_steps: int = EDIT_MEASURE):
    """(inversion steps run, edit steps run): the true counts, or the
    measured scans that are projected to them."""
    return (INV_STEPS, EDIT_STEPS) if full else (inv_steps, edit_steps)


def scan(label: str, run, steps: int, total_steps: int, warm_steps: int = WARM_STEPS,
         profile_dir=None):
    """Warm ``run(warm_steps)``, then time ``run(steps)`` (traced into
    ``profile_dir`` where given): (its output, the seconds projected to
    ``total_steps``). The timed scan must pass :func:`check_scan_time`."""
    log(f"{label}: warm-up scan of {warm_steps} steps")
    timed(lambda: run(warm_steps))
    log(f"{label}: measuring {steps} steps")
    with trace_if(profile_dir):
        out, sec = timed(lambda: run(steps))
    check_scan_time(label, sec, steps)
    return out, sec * total_steps / steps


def vae_times(encode, decode):
    """(latents, encode s, decode s): each timed after a warm call."""
    timed(encode)
    lat, t_enc = timed(encode)
    timed(lambda: decode(lat))
    _, t_dec = timed(lambda: decode(lat))
    return lat, t_enc, t_dec


def record(name: str, frames: int, size: int, full: bool, device, invert_s: float,
           edit_s: float, vae_encode_s: float, vae_decode_s: float) -> dict:
    """The JSON record of one backbone, with the JAX entry's keys."""
    total = invert_s + edit_s + vae_encode_s + vae_decode_s
    where = "1 GPU" if torch.device(device).type == "cuda" else "CPU"
    return {
        "metric": f"{frames}f {size}^2 {name} invert({INV_STEPS})+pnp-edit({EDIT_STEPS}) "
                  f"wall-clock, {where}" + ("" if full else " (projected from warm short scans)"),
        "value": total,
        "unit": "s",
        "vs_baseline": None,
        "detail": {"invert_s": invert_s, "edit_s": edit_s, "vae_encode_s": vae_encode_s,
                   "vae_decode_s": vae_decode_s, "device": device_name(device),
                   "mode": "full" if full else "projected"},
    }


def bench_i2vgen(device="cuda", arch: str = "i2vgen-xl", frames: int = 16, size: int = 512,
                 full: bool = False, inv_steps: int = INV_MEASURE,
                 edit_steps: int = EDIT_MEASURE, warm_steps: int = WARM_STEPS,
                 profile_dir=None) -> dict:
    """The workload on i2vgen, with seeded random bf16 UNet and VAE built
    for ``arch`` on ``device``. Returns its JSON record."""
    from .utils.model_zoo import build_i2vgen_pipeline

    log(f"building pipeline arch={arch}")
    pipe = build_i2vgen_pipeline(arch, device=device, seed=0, dtype=torch.bfloat16,
                                 components=("unet", "vae"))
    dim = pipe.unet.config.cross_attention_dim
    rng = np.random.RandomState(0)
    frames01 = rng.rand(frames, size, size, 3).astype(np.float32)
    text = torch.from_numpy(rng.randn(1, 77, dim).astype(np.float32) * 0.02)
    img_emb = torch.from_numpy(rng.randn(1, 1, dim).astype(np.float32) * 0.02)
    traj_store = "host" if frames >= HOST_STORE_FRAMES else "device"

    def encode():
        return pipe.encode_video(frames01), pipe.prepare_image_latents(frames01[0], frames)

    (latents, img_lat), t_enc, t_dec = vae_times(encode, lambda lat: pipe.decode_latents(lat[0]))
    n_inv, n_edit = step_counts(full, inv_steps, edit_steps)
    (traj, inv_ts), t_inv = scan(
        "i2vgen invert",
        lambda n: pipe.invert(latents, text, img_lat, img_emb, num_inversion_steps=n,
                              traj_store=traj_store),
        n_inv, INV_STEPS, warm_steps, profile_dir)
    rows3 = [torch.cat([x] * 3) for x in (text, img_lat, img_emb)]
    _, t_edit = scan(
        "i2vgen edit",
        lambda n: pipe.sample_with_pnp(traj, inv_ts, *rows3, num_inference_steps=n),
        n_edit, EDIT_STEPS, warm_steps)
    return record(arch, frames, size, full, pipe.device, t_inv, t_edit, t_enc, t_dec)


def main() -> None:
    full = os.environ.get("BENCH_FULL", "0") == "1"
    rec = bench_i2vgen(arch=os.environ.get("BENCH_ARCH", "i2vgen-xl"),
                       frames=int(os.environ.get("BENCH_FRAMES", "16")), full=full,
                       profile_dir=os.environ.get("BENCH_PROFILE"))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
