"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
 1. environment: torch and CUDA versions, the card's name and power limit;
 2. build the four CUDA kernels of ``anyv2v_torch/csrc`` with nvcc (sm_90a);
 3. hold each kernel against its plain PyTorch version in bf16 at the shapes
    the main path gives it, and time both;
 4. the main path at full i2vgen-xl width (16 frames, 512x512, seeded random
    bf16 weights, a seeded synthetic video): VAE encode, DDIM inversion,
    the ``ddim_latents_{t}.npy`` cache written and read back, PnP edit
    (injection segments and the batch-2 tail), decode; every kernel's
    launch count over that run must be positive and the outputs finite;
 5. one i2vgen-xl UNet forward at batch 1 and at batch 3 under torch.profiler:
    device time by kernel group, the device's busy share and the 12 kernels
    that take the most time.

Prints one JSON line with the kernel records, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line, when
there is no CUDA GPU or any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
INV_STEPS = 10
EDIT_STEPS = 10


def log(*a):
    print(*a, flush=True)


def phase_env():
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])   # the card's name and power limit


def phase_build():
    from anyv2v_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s) "
        f"into {_build.BUILD_DIR}")


def _time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_cases():
    """(record name, route, source, replaces, case label, kernel fn, plain fn,
    args factory, atol, rtol). Shapes are the main path's (i2vgen-xl, 16
    frames, 512^2; K1 at batch rows 1-2)."""
    from anyv2v_torch.ops import ffn, folded_attention as fa, frame_attention as fr
    from anyv2v_torch.ops import temporal_conv as tc

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    def attn(b, sq, sk, heads, dh, true_dh):
        def make():
            return (rn(b, sq, heads * dh), rn(b, sk, heads * dh),
                    rn(b, sk, heads * dh), heads, true_dh ** -0.5)
        return make

    def frames(b, s, hw, heads, dh, true_dh):
        def make():
            return (rn(b, s, hw, heads * dh), rn(b, s, hw, heads * dh),
                    rn(b, s, hw, heads * dh), heads, true_dh ** -0.5)
        return make

    def ffn_args(n, c):
        i = 4 * c

        def make():
            return (rn(n, c), rn(2 * i, c, std=c ** -0.5), rn(2 * i, std=0.1),
                    rn(c, i, std=i ** -0.5), rn(c, std=0.1))
        return make

    def tconv_args(b, f, p, c):
        def make():
            s = (torch.rand(b, c, generator=g, device="cuda") + 0.5).float()
            t = (torch.randn(b, c, generator=g, device="cuda") * 0.5).float()
            return (rn(b, f, p, c), s, t, rn(3, c, c, std=(3 * c) ** -0.5), rn(c, std=0.1))
        return make

    k1 = ("folded_attention", "cuda", "anyv2v_torch/csrc/folded_attention.cu",
          "anyv2v_tpu/ops/pallas_packed_flash.py:357", fa.folded_attention,
          fa.folded_attention_plain)
    k2 = ("frame_attention", "cuda", "anyv2v_torch/csrc/frame_attention.cu",
          "anyv2v_tpu/ops/pallas_temporal_ew.py:69", fr.frame_attention,
          fr.frame_attention_plain)
    k3 = ("ffn_geglu", "cuda", "anyv2v_torch/csrc/ffn.cu",
          "anyv2v_tpu/ops/pallas_ffn.py:64", ffn.ffn_geglu, ffn.ffn_geglu_plain)
    k4 = ("gn_silu_temporal_conv", "cuda", "anyv2v_torch/csrc/temporal_conv.cu",
          "anyv2v_tpu/ops/pallas_temporal_conv.py:38", tc.gn_silu_temporal_conv,
          tc.gn_silu_temporal_conv_plain)
    tol_attn, tol_mm = (1e-2, 2e-2), (1e-2, 2e-2)
    return [
        (*k1, "L0 self b2 S4096 h64 dh8", attn(2, 4096, 4096, 64, 8, 5), *tol_attn),
        (*k1, "L0 cross b2 Sq4096 Sk157 dh8", attn(2, 4096, 157, 64, 8, 5), *tol_attn),
        (*k1, "L1 self b2 S1024 dh16", attn(2, 1024, 1024, 64, 16, 10), *tol_attn),
        (*k1, "L2 cross b2 Sq256 Sk157 dh32", attn(2, 256, 157, 64, 32, 20), *tol_attn),
        (*k1, "mid self b16 S64 dh32", attn(16, 64, 64, 64, 32, 20), *tol_attn),
        (*k1, "image-latent encoder b4096 S16 h2 dh8", attn(4096, 16, 16, 2, 8, 4), *tol_attn),
        (*k2, "L0 temporal b1 S16 HW4096 h64 dh8", frames(1, 16, 4096, 64, 8, 5), *tol_attn),
        (*k2, "L1 temporal b3 S16 HW1024 dh16", frames(3, 16, 1024, 64, 16, 10), *tol_attn),
        (*k2, "L2 temporal b3 S16 HW256 dh32", frames(3, 16, 256, 64, 32, 20), *tol_attn),
        (*k2, "transformer_in b1 S16 HW4096 h8 dh64", frames(1, 16, 4096, 8, 64, 64), *tol_attn),
        (*k3, "L0 C320 rows 65536", ffn_args(65536, 320), *tol_mm),
        (*k3, "transformer_in C512 rows 65536", ffn_args(65536, 512), *tol_mm),
        (*k3, "L1 C640 rows 16384", ffn_args(16384, 640), *tol_mm),
        (*k4, "L0 C320 P4096 F16 b1", tconv_args(1, 16, 4096, 320), *tol_mm),
        (*k4, "L1 C640 P1024 F16 b3", tconv_args(3, 16, 1024, 640), *tol_mm),
        (*k4, "L2 C1280 P256 F16 b3", tconv_args(3, 16, 256, 1280), *tol_mm),
        (*k4, "mid C1280 P64 F16 b3", tconv_args(3, 16, 64, 1280), *tol_mm),
        # edge masking, off the main path: rows, channels not multiples of the tiles
        (*k3, "ragged rows 1000 C320", ffn_args(1000, 320), *tol_mm),
        (*k4, "ragged C36 P30 F5 b2", tconv_args(2, 5, 30, 36), *tol_mm),
    ]


def phase_kernels():
    """Each kernel against its plain version; returns {name: record} with the
    worst error and the summed times over the kernel's cases."""
    records, failures = {}, []
    for name, route, src, repl, kern, plain, label, make, atol, rtol in _kernel_cases():
        args = make()
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        bound = atol + rtol * want.float().abs().max().item()
        ok = bool(np.isfinite(err)) and err <= bound
        iters = 5
        ms = _time_ms(lambda: kern(*args), iters)
        plain_ms = _time_ms(lambda: plain(*args), 2)
        log(f"kernel {name} [{label}]: max_abs_err {err:.3e} (bound {bound:.3e}, "
            f"atol {atol} + rtol {rtol}*max|ref|) {'ok' if ok else 'MISS'}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not ok:
            failures.append(f"{name} [{label}]")
        rec = records.setdefault(name, {"name": name, "route": route, "source": src,
                                        "replaces": repl, "launches": 0,
                                        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                        "cases": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if not label.startswith("ragged"):   # the record's times: main-path shapes only
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms
        rec["cases"].append({"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        del args, got, want
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return records


def main():
    if not torch.cuda.is_available():
        log("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_env()
    phase_build()
    records = phase_kernels()
    counts = phase_main_path()
    for rec in records.values():
        rec["launches"] = counts[rec["name"]]
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched by the main path: {missing}")
    log(json.dumps({"kernels": list(records.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _synthetic_video(rng, frames, size):
    """A seeded moving pattern: smooth colour gradients plus a bright square
    drifting across the frame, [F, H, W, 3] in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.rand(3).astype(np.float32) * 6.28
    video = np.empty((frames, size, size, 3), np.float32)
    for f in range(frames):
        for c in range(3):
            video[f, :, :, c] = 0.5 + 0.4 * np.sin(6.0 * xx + 4.0 * yy + phase[c] + 0.2 * f)
        x0 = int(size * (0.1 + 0.04 * f))
        video[f, size // 3:size // 3 + size // 5, x0:x0 + size // 5] = (0.95, 0.85, 0.2)
    return video


def _reference_check():
    """The port on the card (bf16, kernels) against the port's plain fp32
    path on the CPU, same weights, one i2vgen-tiny UNet forward at the edit
    batch with every PnP flag on."""
    from anyv2v_torch.utils.model_zoo import build_i2vgen_pipeline, build_modules

    cpu = build_i2vgen_pipeline("i2vgen-tiny", device="cpu", dtype=torch.float32, seed=1)
    unet = build_modules("i2vgen-tiny", torch.bfloat16)["unet"]
    unet.to_empty(device="cuda").to(torch.bfloat16)
    unet.load_state_dict(cpu.unet.state_dict())
    unet.eval()
    rng = np.random.RandomState(1)
    args = [rng.randn(3, 8, 16, 16, 4).astype(np.float32), 501,
            rng.randn(3, 77, 32).astype(np.float32), 8,
            rng.randn(3, 8, 16, 16, 4).astype(np.float32),
            rng.randn(3, 1, 32).astype(np.float32)]
    with torch.inference_mode():
        want = cpu.unet(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args],
                        pnp=(True, True, True)).float()
        got = unet(*[torch.from_numpy(a).cuda() if isinstance(a, np.ndarray) else a
                     for a in args], pnp=(True, True, True)).float().cpu()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    bound = 0.02 + 0.05 * want.abs().max().item()
    log(f"reference check (i2vgen-tiny UNet, bf16 card vs fp32 CPU plain): max_abs_err "
        f"{err:.3e}, bound {bound:.3e} (0.02 + 0.05*max|ref|)")
    if not (np.isfinite(err) and err <= bound):
        raise RuntimeError("the port on the card disagrees with its CPU reference")


def phase_main_path():
    """i2vgen-xl at full width: invert -> cache files -> PnP edit -> decode,
    through the CLIs' per-entry functions. Returns each kernel's launch
    count over this run."""
    from anyv2v_torch.cli.run_group_ddim_inversion import invert_video
    from anyv2v_torch.cli.run_group_pnp_edit import edit_video, output_stem
    from anyv2v_torch.ops import ffn, folded_attention, frame_attention, temporal_conv
    from anyv2v_torch.pipelines.i2vgen import PnPConfig
    from anyv2v_torch.utils.io import load_ddim_trajectory
    from anyv2v_torch.utils.model_zoo import build_i2vgen_pipeline

    _reference_check()

    wrappers = {"folded_attention": folded_attention.folded_attention,
                "frame_attention": frame_attention.frame_attention,
                "ffn_geglu": ffn.ffn_geglu,
                "gn_silu_temporal_conv": temporal_conv.gn_silu_temporal_conv}
    t0 = time.perf_counter()
    pipe = build_i2vgen_pipeline("i2vgen-xl", device="cuda", seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder,
                                       pipe.vision_encoder) for p in m.parameters())
    log(f"pipeline i2vgen-xl built with seeded random bf16 weights: {n_params} parameters "
        f"(padded storage) in {time.perf_counter() - t0:.2f} s")

    frames = 16
    rng = np.random.RandomState(0)
    video = _synthetic_video(rng, frames, 512)
    edited_first = np.ascontiguousarray(video[0][:, :, ::-1])   # colour-swapped edit
    ids = np.zeros((1, 77), np.int64)
    pnp = PnPConfig(0.2, 0.2, 0.5)

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents, traj, inv_ts, *_ = invert_video(pipe, video, text_ids=ids, n_steps=INV_STEPS,
                                                 fps=8, clip_width=512, output_dir=tmp)
        torch.cuda.synchronize()
        times["encode+invert+write cache"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        traj_np, ts_np = load_ddim_trajectory(tmp, per_step_files=True)
        times["read ddim_latents_{t}.npy"] = time.perf_counter() - t0
        n_files = len([f for f in os.listdir(tmp) if f.startswith("ddim_latents_")])
        if not (np.array_equal(ts_np, inv_ts) and n_files == INV_STEPS
                and np.array_equal(traj_np, traj.cpu().numpy())):
            raise RuntimeError("latent cache files do not read back the trajectory")

        t0 = time.perf_counter()
        out, edited = edit_video(pipe, traj_np, ts_np, video[0], edited_first,
                                 text_ids=(ids, ids, ids), n_frames=frames, n_steps=EDIT_STEPS,
                                 t_idx=0, guidance_scale=9.0, pnp=pnp, fps=8, clip_width=512)
        torch.cuda.synchronize()
        times["PnP edit+decode"] = time.perf_counter() - t0
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    checks = {
        "latents [1,16,64,64,4] finite": tuple(latents.shape) == (1, frames, 64, 64, 4)
        and bool(torch.isfinite(latents).all()),
        "trajectory finite": bool(torch.isfinite(traj).all()),
        "edited latents finite": tuple(out.shape) == (1, frames, 64, 64, 4)
        and bool(torch.isfinite(out).all()),
        "video [16,512,512,3] in [0,1]": tuple(edited.shape) == (frames, 512, 512, 3)
        and bool(torch.isfinite(edited).all()) and float(edited.min()) >= 0.0
        and float(edited.max()) <= 1.0,
    }
    for name, sec in times.items():
        log(f"phase {name}: {sec:.3f} s")
    log(f"main path: invert {INV_STEPS} steps (batch 1) + PnP edit {EDIT_STEPS} steps "
        f"(thresholds 0.2/0.2/0.5: {int(EDIT_STEPS * 0.5)} batch-3 steps, "
        f"{EDIT_STEPS - int(EDIT_STEPS * 0.5)} batch-2 steps); output name "
        f"{output_stem(9.0, EDIT_STEPS, 0, 0.2, 0.2, 0.5)}")
    log(f"peak device memory: {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"kernel launches in the main path: {counts}")
    log(f"output checks: {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"output checks failed: {checks}")
    phase_profile(pipe)
    return counts


_KERNEL_GROUPS = (("K1 folded_attention", "folded_attention_kernel"),
                  ("K2 frame_attention", "frame_attention_kernel"),
                  ("K3 ffn_geglu", "ffn_geglu_kernel"),
                  ("K4 temporal_conv", "temporal_conv_kernel"))


def phase_profile(pipe):
    """One i2vgen-xl UNet forward at the inversion batch (1) and at the edit
    batch (3, every PnP flag on) under torch.profiler: device time by kernel
    group and the device's busy share of the forward's wall time."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(2)
    for batch, pnp in ((1, None), (3, (True, True, True))):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        args = (rn(batch, 16, 64, 64, 4), 501, rn(batch, 77, 1024, scale=0.1), 8,
                rn(batch, 16, 64, 64, 4), rn(batch, 1, 1024, scale=0.1))
        with torch.inference_mode():
            pipe.unet(*args, pnp=pnp)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                pipe.unet(*args, pnp=pnp)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        groups = {label: 0.0 for label, _ in _KERNEL_GROUPS}
        groups["other"] = 0.0
        for e in events:
            label = next((lb for lb, key in _KERNEL_GROUPS if key in e.key), "other")
            groups[label] += e.self_device_time_total / 1e3
        log(f"profile UNet forward batch {batch}: wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall); by group (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in groups.items()))
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        for e in top:
            log(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<4d} {e.key[:110]}")


if __name__ == "__main__":
    sys.exit(main())
