"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
 1. environment: torch and CUDA versions, the card's name and power limit;
 2. build the seven CUDA sources of ``anyv2v_torch/csrc`` with nvcc (sm_90a),
    one nvcc per source, all started together, and print ptxas's registers
    and spills of every kernel's instances;
 3. hold each kernel against its plain PyTorch version in bf16 at the shapes
    the main paths give it, and time it beside its plain version, its bound
    (the least time the card could take: bytes over 3.35 TB/s or bf16
    operations over 989 TFLOP/s, whichever is larger) and, where one PyTorch
    call computes the same function, that call (``scaled_dot_product_attention``;
    for K2 long on copies transposed to ``[B*HW, H, S, dh]`` beforehand, the
    transposes timed apart); each attention kernel and its plain version also
    against the fp32 truth, and each attention case's exp2 count beside the
    special-function units' time for it; K1 also at the shapes of the seine-tiny reference
    check (untimed) and at the class of the Pallas ``_packed_kernel``, keys
    past 4096 (2 rows, Sq = Sk = 8192), its short body (Sq <= 32 and the
    short-key class, Sk <= 192 where its grid fills the card: the record
    ``folded_attention_short``, which every K1 case whose plan takes that
    body reports to) at its own cases, and both K1 bodies and K2 long on
    each side of their class and tile boundaries (ragged, Sk 191 and 193
    at dh 8 and 64 for the short-key class); K2 long at the 128-frame i2vgen-xl shapes
    (L0-L3 temporal and transformer_in, batch 1 and 3), at SEINE's widths
    with a relative-position bias (S 64) and at Sk = S + 8; K1, K3 and K4 at
    128-frame shapes; K3 and K4 also at i2vgen-xl's edit batch and at the
    tiny archs' widths; K5 also at SEINE's L0 spatial self-attention (48
    rows of 4096, 8 heads of 40); K4's prologue-free form at main-path
    shapes beside one ``F.conv3d`` (kernel (3, 1, 1) on the
    ``channels_last_3d`` view, no copy); K5 and K3 at the first-frame
    editors' shapes (SD1.5 self-attention at 4096/1024/256/64 tokens, 8
    heads of 40/80/160, and its cross-attention over 77 tokens; SDXL
    self-attention at 4096 and 1024 tokens, 10 and 20 heads of 64, and its
    cross-attention; the IP-Adapter's attention over 4 keys; K3 at C 320
    and 640) and K5 at the IP-Adapter Plus resampler's 16 queries over 273
    keys; the operand modes that no configuration reaches (records
    ``flash_attention_bias`` and ``ffn_gelu``): K5 with a score bias shared
    by the batch at SEINE's L0 self shape and at i2vgen-xl's L2 widths (dh
    32), per row at ConsistI2V's L0 spatial cross shape (its library time
    SDPA with a float ``attn_mask``), ragged; K5 unbiased at dh 32, and with
    and without a bias at the Pallas kernel's other widths (24, 48, ...,
    128: multiples of 8 that no model has), ragged; K3's GELU
    form at C 320 x 65536 rows, 640 x 16384 and ragged (no single library
    call); K2 with a bias on the ``[B, S, 1, C]`` view that a biased short
    ``[B, S, C]`` call takes; beside every K3 and K4 case, its products
    alone by cuBLAS (``torch.addmm`` in bf16 on operands laid out
    beforehand: K3's two launches, the first without its activation, and
    K4's GEMM without its prologue), a yardstick that no single PyTorch call
    computing the kernel's function gives (the records' ``products_ms``;
    ``library_ms`` stays null); K4's prologue kernel, launched before its
    GEMM wherever s, t are given, timed apart under torch.profiler beside
    its byte bound (its record ``gn_silu_temporal_conv_prologue``, its
    launches the wrapper's ``prologue_launches``; its error is the K4
    output's, which its h feeds); KN, the norms (``csrc/norm.cu``: the group
    norm with and without SiLU, K4's group statistics, the layer norm) at
    ConsistI2V's L0-L3 shapes at the edit batch (51 images), the up blocks'
    concatenated widths, the VAE's 512^2 decode widths and the layer norms'
    rows, fp32 in and out off the path, beside ``F.group_norm`` (SiLU after
    it where the case fuses one) and ``F.layer_norm`` on the same values
    (the group norm's on a contiguous NCHW copy made beforehand), a yardstick
    that the port never calls; KR, the rotary (``csrc/rotary.cu``), at
    ConsistI2V's L0-L2 at the edit batch (q over 17 frames, k over 25 rows
    with the 8 augmented keys at position 0, the cross-attention q) and at
    SEINE's L0 (8 heads of 40, 32 rotated), each required to equal its plain
    version bit for bit (no library call computes it);
 3b. the op surfaces (before phase 4): the port's ``Attention`` with a score
    bias (SEINE L0 self, ConsistI2V L0 spatial cross per row, i2vgen-xl L2
    at dh 32), ``TemporalTransformer`` with a bias over its frames (SEINE L0
    widths, 3 rows of 16 frames at 64x64) and ``FeedForward(gelu)`` at C
    320 and 640 at full width (:func:`op_surfaces`), after the same modules
    at small sizes against their fp32 CPU path, and the dispatcher's two
    SDPA routes for a bias on bf16 tokens against a float64 reference (the
    bias kept in fp32); K5 must launch with the bias
    on the three biased calls, K2 on the view once, K3's GELU form twice,
    nothing may reach SDPA, the outputs must be finite;
 4. the i2vgen-xl main path at full width (16 frames, 512x512, seeded random
    bf16 weights, a seeded synthetic video): VAE encode, DDIM inversion,
    the ``ddim_latents_{t}.npy`` cache written and read back, PnP edit
    (injection segments and the batch-2 tail), decode; every kernel it routes
    (K1-K4) must launch, K5 must not, and the outputs must be finite;
    then one i2vgen-xl UNet forward at batch 1 and at batch 3 under
    torch.profiler: device time by kernel group (a group whose wrapper
    launched in the forward must show device time under its kernel's
    name), the device's busy share and the 12 kernels that take the most
    time;
 5. the i2vgen-xl long-video path at full width (128 frames, 512x512, the
    same pipeline): an i2vgen-tiny reference check at 40 frames, then VAE
    encode, a 4-step inversion into host memory (``traj_store="host"``, two
    chunks of 2), the cache files, a 2-step PnP edit (one batch-3 injection
    step, one batch-2 tail step) and decode; K2 long must launch on all 34
    temporal attentions of every UNet forward and K2 (S <= 32) never, K1,
    K3 and K4 must launch, K5 must not, the outputs must be finite and the
    peak device memory under 80 GB; then one batch-3 UNet forward
    under torch.profiler;
 6. the ConsistI2V main path at full width (16 frames plus the conditioning
    frame, 512x512): a consisti2v-tiny reference check, then inversion, the
    cache files, the dual-CFG PnP edit at cfg_txt 35 / cfg_img 1 (batch 3,
    then the batch-2 tail) and decode; K1-K5 and KR must all launch, K5 in its
    three roles, K2 with the augmented key axis, and no UNet attention of head
    width 40/64/80 may reach SDPA; then its profile at batch 1 and 3;
 7. ConsistI2V from a checkpoint folder: the full-width seeded weights
    written as a diffusers-layout snapshot in fp16 (``unet/`` in two
    safetensors shards, ``vae/``, ``text_encoder/``, each with its
    ``config.json``) into a temporary directory, converted by
    ``anyv2v_torch.cli.convert_checkpoint`` and loaded through
    ``init: <out>.npz``, where every loaded tensor must equal the tensor
    written after the same cast to the module dtype; then plain generation
    from the clean first-frame latent of a synthetic video: pyoco
    progressive noise (alpha 1) re-initialised by FreeInit (butterworth,
    level 999), 16 frames, cfg_txt 7.5 / cfg_img 1.5 (guidance "both",
    batch 3), the last 5 DDIM steps of a 50-step schedule, and decode; the
    outputs must be finite, K1's short class, K2 with the augmented key
    axis, K3, K4 and K5 must launch, no UNet attention of head width
    40/64/80/160 may reach SDPA, and every biased or GELU-form call that a
    kernel takes must have launched it (``_RouteLog.mode_checks``, as in
    phases 3b and 9-12);
 8. the SEINE main path at full width (SD1.4 widths, 8 heads, 16 frames,
    512x512): a seine-tiny reference check (K2 with the bias at dh 8),
    then VAE encode, the masked conditioning, inversion with every step on
    the save grid, the cache files, a DDPM PnP edit at cfg 4 with thresholds
    0.2/0.2/0.5/0.0 (batch 3, then the batch-2 tail) and decode; K2 must
    launch with the relative-position bias on every temporal attention, K3
    and K5 (spatial self, mid self, cross) must launch, K1 and K4 must not,
    and the dispatcher may send only the VAE's 512-wide head to SDPA; then
    its profile at batch 1 and 3;
 9. InstructPix2Pix at full width (SD1.5, 512x512): an instructpix2pix-tiny
    reference check, then ``cli/edit_image.py``'s array-level
    ``edit_frame`` on a seeded synthetic frame: VAE mode encode, the whole
    100-step Euler-Ancestral grid at batch 3 (guidance 7.5, image guidance
    1.5), decode; the image must be finite, K5 and K3 must launch and K1,
    K2, K2 long and K4 must not, no UNet attention may reach SDPA (only the
    VAE's 512-wide head), and the mode checks hold; then one profiled
    batch-3 forward;
10. CosXL at full width (SDXL, 1024x1024): a cosxl-tiny check, then
    ``edit_frame``: the whole 20-step EDM grid at batch 3 (guidance 7, image
    guidance 1.5) on zero text embeddings, decode; the same checks, the peak
    device memory, one profiled batch-3 forward;
11. InstantStyle at full width (SDXL + the canny ControlNet + the base
    IP-Adapter, 1024x1024): instantstyle-tiny checks of its UNet (with IP
    tokens) and its ControlNet, then ``style_frame`` with a numpy edge map
    (``canny_map`` needs OpenCV) and a seeded style embedding: the whole
    30-step Euler-Discrete grid at batch 2 (guidance 5, ControlNet scale
    0.6, IP scale 1), decode; the same checks, K5 over the 4 IP keys on each
    of up_0_attn_1's 10 transformer blocks in every forward and nowhere
    else, the peak device memory, one profiled forward (ControlNet and
    UNet);
12. the product layer at full width (``anyv2v_torch.product``), both
    pipelines resident: ``Predictor.setup`` (i2vgen-xl + InstructPix2Pix,
    seeded random bf16 weights) timed, then three requests in a row on a
    seeded synthetic 16-frame 512x512 video through the array-level entry
    points: ``predict_arrays`` twice (the editor's 100-step grid, 10
    inversion and 10 edit steps at PnP 1.0/1.0/1.0, all at batch 3), then
    the runner's ``edit_arrays`` at the gradio defaults (PnP 0.2/0.2/0.5, a
    batch-2 tail) on request 2's edited frame; each request timed in three
    stages (editor, inversion, edit + decode); the outputs must be finite,
    K1-K4 must launch in the video stages and K5 not, K5 and K3 in the
    editor stage and K1, K2, K4 not, K2 long nowhere, the mode checks hold
    (the image-latent encoder's GELU feed-forward, C 4, is outside K3's
    range), requests 2 and 3 must build nothing (the same pipeline and
    editor objects, device memory within 64 MiB of its level after request
    1) and the peak stay under 80 GB;
13. frame sharding, one rank's program on this card (``mock_manual_axis(4)``:
    every collective a local copy of the same shape; run after phase 5, and
    for ConsistI2V and SEINE after phases 6 and 8, on their pipelines):
    i2vgen-xl's 128-frame forward at 32 frames per rank (the image latents
    whole), one at batch 3 (every PnP flag on) and one at batch 1, timed by
    CUDA events beside phase 5's unsharded forwards and profiled by kernel
    group; K2 long must launch on all 34 temporal attentions at S 128 over
    a quarter of the pixels, K1, K3, K4 must launch, K2 and K5 not, the
    outputs must be finite; then ConsistI2V's and SEINE's forwards at 4 of
    16 frames (K2 at S 17 / Sk 25 and at S 16 with the bias); phase 3 holds
    K2 long, K4 (with given s, t) and K3 at the per-rank shapes ("rank of
    4" cases);
14. the NCCL leg, only where two or more GPUs are visible (else one line
    says it did not run): 2 or 4 ranks, one process per GPU (this script
    with ``--nccl-rank rank world port dir``), run one i2vgen-xl forward and
    the 16-frame invert (4 steps) + edit (2 steps at guidance 1: a batch-3
    injection step and a batch-2 tail step) at full width on the frame
    mesh; each rank's forward and trajectory within 0.02 + 0.05*max|ref| of
    this process's single-GPU run, its edited latents and video finite and
    whole (their distance reported, not held: :func:`nccl_checks`), every
    rank's arrays equal;
15. the bench entries (``anyv2v_torch/bench.py``, ``bench_backbones.py``),
    projected, at 16 frames for i2vgen-xl, ConsistI2V and SEINE: each
    prints its JSON line, every value finite and every scan through
    ``check_scan_time``.

Each tiny-arch reference check runs the card's bf16 UNet against the plain
fp32 path on the CPU with the same bf16-rounded weights and inputs. Phases
4-8 time their inversion, edit or generation with the port's
``PhaseTimers`` (``utils/profiling.py``), synchronised on their outputs by
``hard_sync`` (phase 5's on its host trajectory too), and every timed scan
must pass ``check_scan_time`` for its step count; phases 9-11 time theirs
the same way, their floor per step the operations of one forward counted
from its shapes (``torch.utils.flop_counter`` on the ``meta`` device) at
989 TFLOP/s; phase 12 its DDIM stages as phase 4 and its editor stage as
phase 9.

Video preparation (``utils/video_prep.py``, ``cli/prepare_video.py``) and
camera motion (``utils/camera.py``) are host code on OpenCV and PIL, which
the card's machine lacks; they are tested on the CPU only, and this script
does not import them.

Prints the card's name and power limit, the bench's three JSON lines, one
JSON line with the kernel records (each with its launches by path), then,
as the last line, ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, when there is no CUDA GPU or any phase fails.
"""

from __future__ import annotations

import json
import os
import re
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


def _ptxas_summary(report, names):
    """ptxas's registers and spills of each instance of the named kernels:
    "name<template args>: R registers, S bytes spill stores, L loads"."""
    out, current = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = next((n for n in names if n + "I" in mangled or n + "E" in mangled), None)
            current = None
            if name:
                args = re.findall(r"L([ib])(\d+)E", mangled[mangled.index(name):])
                current = name + ("<" + ",".join(
                    v if k == "i" else ("true" if v == "1" else "false") for k, v in args) + ">"
                    if args else "")
                spill = ""
            continue
        if current and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            spill = f"{st} bytes spill stores, {ld} bytes spill loads"
        elif current and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{current}: {regs} registers, {spill}")
            current = None
    return out


def phase_build():
    from anyv2v_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s) "
        f"into {_build.BUILD_DIR}")
    for line in _ptxas_summary(_build.ptxas_report(), [key for _, key, _ in _KERNEL_GROUPS]):
        log(f"ptxas {line}")


SPIN_CYCLES = 2_000_000   # about 1 ms at the card's top clock


def _time_ms(fn, iters):
    """Device ms per call: CUDA events around ``iters`` calls after a warm-up.
    A spin kernel queued first keeps the device behind the host while the
    calls are queued, so that a short kernel's time is its own and not the
    host's cost of launching it (the wrapper's Python)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PEAK_FLOPS = 989e12      # bf16 dense tensor-core peak, H100 SXM
PEAK_BYTES = 3.35e12     # HBM3 bandwidth, H100 SXM


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _attn_cost(q, k, v, heads, scale, k_ctx=None, v_ctx=None, frames=1, bias=None):
    """(operations, bytes) of softmax attention on folded heads: q.k and p.v
    over every key of the row, each operand (the bias too) read once, the
    output written."""
    b, sq, c = q.shape
    sk = k.shape[1] + (k_ctx.shape[1] if k_ctx is not None else 0)
    return 4 * b * sq * sk * c, _nbytes(q, q, k, v, k_ctx, v_ctx, bias)


def _frame_cost(q, k, v, heads, scale, bias=None):
    b, s, hw, c = q.shape
    return 4 * b * hw * s * k.shape[1] * c, _nbytes(q, q, k, v, bias)


def _ffn_cost(x, w1, b1, w2, b2):
    """Both products: x @ W1^T over W1's rows (2I for GEGLU, I for GELU),
    then h @ W2^T."""
    n, c = x.numel() // x.shape[-1], x.shape[-1]
    inner = w2.shape[1]
    return 2 * n * c * (w1.shape[0] + inner), _nbytes(x, x, w1, b1, w2, b2)


def _tconv_cost(x, s, t, w, b):
    bsz, f, p, c = x.shape
    return (2 * bsz * f * p * 3 * c * w.shape[2],
            _nbytes(x, s, t, w, b) + bsz * f * p * w.shape[2] * x.element_size())


def _exp2_count(name, args):
    """Exponentials of an attention case's softmax, one per score (every
    query row against every key of its row), or None for other kernels."""
    if name in ("frame_attention", "frame_attention_long"):
        q, k, heads = args[0], args[1], args[3]
        b, s, hw, _ = q.shape
        return b * hw * heads * s * k.shape[1]
    if name in ("folded_attention", "folded_attention_short", "flash_attention",
                "flash_attention_bias"):
        q, k, heads = args[0], args[1], args[3]
        k_ctx = args[5] if len(args) > 5 else None
        return q.shape[0] * heads * q.shape[1] * (
            k.shape[1] + (k_ctx.shape[1] if k_ctx is not None else 0))
    return None


SFU_EXP2_PER_CLOCK = 16   # ex2 per clock per SM (Hopper's special-function units)


def _attn_library(q, k, v, heads, scale, k_ctx=None, v_ctx=None, frames=1, bias=None):
    """One SDPA call on the same inputs; the split-KV context is repeated and
    concatenated beforehand, outside the timed call; a bias becomes a float
    ``attn_mask`` (in q's dtype, cast beforehand)."""
    if k_ctx is not None:
        k = torch.cat([k, k_ctx.repeat_interleave(frames, dim=0)], dim=1)
        v = torch.cat([v, v_ctx.repeat_interleave(frames, dim=0)], dim=1)
    mask = None if bias is None else bias.to(q.dtype)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        *(x.view(x.shape[0], x.shape[1], heads, -1).transpose(1, 2) for x in (q, k, v)),
        attn_mask=mask, scale=scale)


def _tconv_library(x, s, t, w, b):
    """K4's prologue-free form (``s = t = None``) as one ``F.conv3d`` with
    kernel (3, 1, 1) and padding (1, 0, 0) on the ``channels_last_3d`` view
    ``[B, C, F, P, 1]`` of the same ``[B, F, P, C]`` tensor (no copy); the
    weight is laid out as conv3d's ``[C', C, 3, 1, 1]`` beforehand."""
    x5 = x.permute(0, 3, 1, 2).unsqueeze(-1)
    if not x5.is_contiguous(memory_format=torch.channels_last_3d):
        raise RuntimeError("the channels_last_3d view of x is not contiguous")
    w5 = w.permute(2, 1, 0)[..., None, None].contiguous()
    return lambda: torch.nn.functional.conv3d(x5, w5, b, padding=(1, 0, 0))


def _gemm_yardstick(name, args):
    """The products of K3's two launches and of K4 alone, each by one cuBLAS
    call (``torch.addmm`` in bf16) a chunk of 2^18 rows, as the kernel runs
    them, on operands laid out beforehand: launch 1's ``x W1^T + b1``
    without its activation, launch 2's ``h W2^T + b2`` (its exact function,
    on an h of x's rows), and K4's ``[B*F*P, 3C] x [3C, C'] + bias`` on the
    three taps concatenated (no prologue). [(label, call)] for K3 and K4,
    else []. A yardstick only: the port never calls them."""
    if name in ("ffn_geglu", "ffn_gelu"):
        from anyv2v_torch.ops.ffn import CHUNK_ROWS

        x, w1, b1, w2, b2 = args
        flat = x.reshape(-1, x.shape[-1])
        h = torch.randn(min(flat.shape[0], CHUNK_ROWS), w2.shape[1], device=x.device,
                        dtype=x.dtype)
        o1 = torch.empty(h.shape[0], w1.shape[0], device=x.device, dtype=x.dtype)
        o2 = torch.empty(h.shape[0], w2.shape[0], device=x.device, dtype=x.dtype)
        chunks = [(i, min(CHUNK_ROWS, flat.shape[0] - i))
                  for i in range(0, flat.shape[0], CHUNK_ROWS)]

        def launch1():
            for i, n in chunks:
                torch.addmm(b1, flat[i:i + n], w1.t(), out=o1[:n])

        def launch2():
            for _, n in chunks:
                torch.addmm(b2, h[:n], w2.t(), out=o2[:n])
        return [("launch 1's product", launch1), ("launch 2", launch2)]
    if name == "gn_silu_temporal_conv":
        x, _, _, w, b = args
        f = x.shape[1]
        hp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
        taps = torch.cat([hp[:, d:d + f] for d in range(3)], dim=-1).reshape(-1, 3 * x.shape[-1])
        del hp
        w2d = w.reshape(-1, w.shape[-1])
        return [("the GEMM", lambda: torch.addmm(b, taps, w2d))]
    return []


def _k4_prologue(name, kern, args, calls=3):
    """K4's prologue kernel in a case with s, t: {"ms": device ms per launch
    under torch.profiler (over the events that carry its name), "plain_ms":
    the plain prologue's (fp32, rounded to x's dtype), "bound_ms": x, s, t
    read and h written once over the memory rate}, or None where the calls
    launched no prologue (a tree without it). Raises where the wrapper
    counted a prologue but no device event carries the kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    if name != "gn_silu_temporal_conv" or args[1] is None:
        return None
    count = _wrappers()[K4_PROLOGUE[0]]
    before = count.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kern(*args)
        torch.cuda.synchronize()
    if count.launches == before:
        return None
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and K4_PROLOGUE[1] in e.key]
    n = sum(e.count for e in events)
    if not n:
        raise RuntimeError(f"K4 counted {count.launches - before} prologues but no device "
                           f"event carries {K4_PROLOGUE[1]}")
    if n != count.launches - before:
        log(f"K4 prologue: {n} device events for {count.launches - before} launches")
    x, s, t = args[:3]

    def plain():
        h = x.float() * s[:, None, None] + t[:, None, None]
        return torch.nn.functional.silu(h).to(x.dtype)
    return {"ms": sum(e.self_device_time_total for e in events) / 1e3 / n,
            "plain_ms": _time_ms(plain, 2),
            "bound_ms": _nbytes(x, s, t, x) / PEAK_BYTES * 1e3}


def _add_k4_prologue(records, label, err, prologue):
    """The prologue's record beside K4's: its error is the K4 case's (its h
    feeds the output), its times summed over the main-path cases."""
    rec = records.setdefault(K4_PROLOGUE[0], {
        "name": K4_PROLOGUE[0], "route": "cuda", "source": "anyv2v_torch/csrc/temporal_conv.cu",
        "replaces": "anyv2v_tpu/ops/pallas_temporal_conv.py:38", "launches": 0,
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
        "library_ms": None, "cases": [], "_ops_ms": 0.0, "_bytes_ms": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if not label.startswith(_OFF_PATH):
        for key in ("ms", "plain_ms", "bound_ms"):
            rec[key] += prologue[key]
        rec["_bytes_ms"] += prologue["bound_ms"]
    rec["cases"].append({"shape": label, "max_abs_err": err, **prologue, "bound_by": "bytes",
                         "exp2": None})


def _frame_view(x, heads):
    """The frame-axis view ``[B*HW, H, S, dh]`` of ``[B, S, HW, C]``."""
    b, s, hw, c = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * hw, s, heads, c // heads).transpose(1, 2)


def _frame_library(q, k, v, heads, scale, bias=None):
    """SDPA on the frame-axis view of ``[B, S, HW, C]``; the bias becomes a
    float ``attn_mask`` (in q's dtype, cast beforehand)."""
    mask = None if bias is None else bias.to(q.dtype)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        _frame_view(q, heads), _frame_view(k, heads), _frame_view(v, heads), attn_mask=mask,
        scale=scale)


def _frame_long_library(q, k, v, heads, scale, bias=None):
    """SDPA on contiguous ``[B*HW, H, S, dh]`` copies of q, k and v made
    beforehand: the transposes that the JAX package pays past 32 frames are
    not in this time (``_frame_transposes`` times them)."""
    mask = None if bias is None else bias.to(q.dtype)
    qt, kt, vt = (_frame_view(x, heads).contiguous() for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                    scale=scale)


def _frame_transposes(q, k, v, heads):
    """The four transposes around SDPA on the frame axis: q, k and v to
    ``[B*HW, H, S, dh]`` and an output-sized tensor back to ``[B, S, HW, C]``."""
    b, s, hw, c = q.shape
    back = _frame_view(q, heads).contiguous()

    def run():
        for x in (q, k, v):
            _frame_view(x, heads).contiguous()
        back.transpose(1, 2).reshape(b, hw, s, c).permute(0, 2, 1, 3).contiguous()
    return run


def _norm_cost(x, weight, bias, *args, **kwargs):
    """KN: no operations; x read once, the affine parameters, the output
    written once: x's shape in the dtype the call names, or s and t ``[N,
    C]`` fp32 where it names none (K4's statistics)."""
    out = next((a for a in (*args, *kwargs.values()) if isinstance(a, torch.dtype)), None)
    written = (2 * x.shape[0] * x.shape[-1] * 4 if out is None
               else x.numel() * torch.finfo(out).bits // 8)
    return 0, _nbytes(x, weight, bias) + written


def _rotary_cost(x, positions, rot, groups=1):
    """KR: no operations; x read once, the output written once, the
    positions and the fp32 frequency table read."""
    return 0, 2 * _nbytes(x) + _nbytes(positions) + 4 * (rot // 2)


def _group_norm_library(x, weight, bias, groups, eps, dtype, silu=False, gather=None):
    """``F.group_norm`` on a contiguous NCHW copy of x made beforehand (and
    ``F.silu`` after it where the case fuses one), in x's dtype (over x
    alone where a case gathers partials)."""
    xc = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1)).contiguous()

    def run():
        y = torch.nn.functional.group_norm(xc, groups, weight, bias, eps)
        return torch.nn.functional.silu(y) if silu else y
    return run


def _layer_norm_library(x, weight, bias, eps, dtype):
    return lambda: torch.nn.functional.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def _scale_shift(fn):
    """K4's statistics ``s, t`` as one ``[N, 2C]`` tensor, for the checks."""
    return lambda *args: torch.cat(fn(*args), dim=1)


def _kernels():
    """name -> (route, source, replaces, wrapper, plain version, cost,
    library call factory or None)."""
    from anyv2v_torch.ops import ffn, flash_attention as fl, folded_attention as fa
    from anyv2v_torch.ops import frame_attention as fr, norm as kn, rotary as kr
    from anyv2v_torch.ops import temporal_conv as tc

    return {
        "folded_attention": ("cuda", "anyv2v_torch/csrc/folded_attention.cu",
                             "anyv2v_tpu/ops/pallas_packed_flash.py:357", fa.folded_attention,
                             fa.folded_attention_plain, _attn_cost, _attn_library),
        # K1's short body (Sq <= 32 and the short-key class, its own kernel
        # symbol), replacing _short_kernel's K1 classes and, at short key
        # axes, the _wide_t_kernel class; its launches are the wrapper's
        # short_launches (also counted in the wrapper's launches)
        "folded_attention_short": ("cuda", "anyv2v_torch/csrc/folded_attention.cu",
                                   "anyv2v_tpu/ops/pallas_short_attention.py:125",
                                   fa.folded_attention, fa.folded_attention_plain, _attn_cost,
                                   _attn_library),
        "frame_attention": ("cuda", "anyv2v_torch/csrc/frame_attention.cu",
                            "anyv2v_tpu/ops/pallas_short_attention.py:223", fr.frame_attention,
                            fr.frame_attention_plain, _frame_cost, _frame_library),
        # K2 long: the >32-frame route
        "frame_attention_long": ("cuda", "anyv2v_torch/csrc/frame_attention.cu",
                                 "anyv2v_tpu/ops/pallas_short_attention.py:125",
                                 fr.frame_attention_long, fr.frame_attention_plain, _frame_cost,
                                 _frame_long_library),
        "ffn_geglu": ("cuda", "anyv2v_torch/csrc/ffn.cu", "anyv2v_tpu/ops/pallas_ffn.py:64",
                      ffn.ffn_geglu, ffn.ffn_geglu_plain, _ffn_cost, None),
        # K3's GELU form: the same source and Pallas kernel, its other branch
        "ffn_gelu": ("cuda", "anyv2v_torch/csrc/ffn.cu", "anyv2v_tpu/ops/pallas_ffn.py:64",
                     ffn.ffn_gelu, ffn.ffn_gelu_plain, _ffn_cost, None),
        "gn_silu_temporal_conv": ("cuda", "anyv2v_torch/csrc/temporal_conv.cu",
                                  "anyv2v_tpu/ops/pallas_temporal_conv.py:38",
                                  tc.gn_silu_temporal_conv, tc.gn_silu_temporal_conv_plain,
                                  _tconv_cost, None),
        "flash_attention": ("cuda", "anyv2v_torch/csrc/flash_attention.cu",
                            "anyv2v_tpu/ops/pallas_attention.py:131", fl.flash_attention,
                            fl.flash_attention_plain, _attn_cost, _attn_library),
        # K5 with its score bias (the BIAS instances), replacing _flash_kernel
        # with its bias_ref; its launches are the wrapper's bias_launches
        "flash_attention_bias": ("cuda", "anyv2v_torch/csrc/flash_attention.cu",
                                 "anyv2v_tpu/ops/pallas_attention.py:44", fl.flash_attention,
                                 fl.flash_attention_plain, _attn_cost, _attn_library),
        # KN: no Pallas kernel (the JAX package leaves its norms to XLA)
        "group_norm": ("cuda", "anyv2v_torch/csrc/norm.cu", None, kn.group_norm,
                       kn.group_norm_plain, _norm_cost, _group_norm_library),
        "group_scale_shift": ("cuda", "anyv2v_torch/csrc/norm.cu", None, _scale_shift(
            kn.group_scale_shift), _scale_shift(kn.group_scale_shift_plain), _norm_cost, None),
        "layer_norm": ("cuda", "anyv2v_torch/csrc/norm.cu", None, kn.layer_norm,
                       kn.layer_norm_plain, _norm_cost, _layer_norm_library),
        # KR: no Pallas kernel (the JAX package leaves its rotary to XLA)
        "rotate_partial": ("cuda", "anyv2v_torch/csrc/rotary.cu", None, kr.rotate_partial,
                           kr.rotate_partial_plain, _rotary_cost, None),
    }


def _kernel_cases():
    """(kernel name, case label, args factory[, library call factory that
    replaces the kernel's]). Shapes are the main paths':
    i2vgen-xl (16 frames, 512^2; K1 at batch rows 1-2) and ConsistI2V (16
    frames plus the conditioning frame, 512^2, the edit batch of 3 rows)."""
    gen = []   # the seeded generator, made at the first draw

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        if not gen:
            gen.append(torch.Generator(device="cuda").manual_seed(0))
        return (torch.randn(*shape, generator=gen[0], device="cuda") * std).to(dtype)

    def tagged(make, **shape):
        """A factory that also carries its call's shape (``make.shape``), so
        that launch plans can be checked without making the tensors."""
        make.shape = shape
        return make

    def attn(b, sq, sk, heads, dh, true_dh):
        def make():
            return (rn(b, sq, heads * dh), rn(b, sk, heads * dh),
                    rn(b, sk, heads * dh), heads, true_dh ** -0.5)
        return tagged(make, b=b, sq=sq, sk=sk, heads=heads, dh=dh)

    def splitkv(rows, frames, s, heads, dh, sk=None, sk2=None):
        sk, sk2 = sk or s, sk2 or s

        def make():
            c = heads * dh
            return (rn(rows, s, c), rn(rows, sk, c), rn(rows, sk, c), heads, dh ** -0.5,
                    rn(rows // frames, sk2, c), rn(rows // frames, sk2, c), frames)
        return tagged(make, b=rows, sq=s, sk=sk, sk2=sk2, frames=frames, heads=heads, dh=dh)

    def frames(b, s, hw, heads, dh, true_dh, sk=None, bias=False):
        def make():
            c = heads * dh
            args = (rn(b, s, hw, c), rn(b, sk or s, hw, c), rn(b, sk or s, hw, c), heads,
                    true_dh ** -0.5)
            return args + (rn(heads, s, sk or s, dtype=torch.float32),) if bias else args
        return tagged(make, b=b, s=s, sk=sk or s, hw=hw, heads=heads, dh=dh)

    def relpos_frames(b, s, hw, heads, dh):
        """SEINE's temporal attention with its T5 relative-position bias
        (32 buckets, max distance 32) from a seeded table."""
        from anyv2v_torch.ops.relpos import relative_position_bias

        def make():
            args = frames(b, s, hw, heads, dh, dh)()
            table = torch.randn(32, heads, generator=gen[0], device="cuda")
            bias = relative_position_bias(table, s, s, num_buckets=32, max_distance=32)
            return args + (bias.contiguous(),)
        return tagged(make, b=b, s=s, sk=s, hw=hw, heads=heads, dh=dh)

    def ffn_args(n, c, gelu=False):
        i = 4 * c
        rows1 = i if gelu else 2 * i

        def make():
            return (rn(n, c), rn(rows1, c, std=c ** -0.5), rn(rows1, std=0.1),
                    rn(c, i, std=i ** -0.5), rn(c, std=0.1))
        return tagged(make, n=n, c=c, inner=i)

    def attn_bias(b, sq, sk, heads, dh, true_dh, form):
        """K5 with a score bias, shared by the batch ([H, Sq, Sk]) or per row
        ([B, H, Sq, Sk]), std 2 (a bias that moves the softmax)."""
        def make():
            q, k, v, h, scale = attn(b, sq, sk, heads, dh, true_dh)()
            shape = (heads, sq, sk) if form == "shared" else (b, heads, sq, sk)
            return (q, k, v, h, scale, None, None, 1,
                    rn(*shape, std=2.0, dtype=torch.float32))
        return tagged(make, b=b, sq=sq, sk=sk, heads=heads, dh=dh, bias=form)

    def tconv_args(b, f, p, c, prologue=True, c_out=None):
        co = c_out or c

        def make():
            w, bias = rn(3, c, co, std=(3 * c) ** -0.5), rn(co, std=0.1)
            if not prologue:
                return (rn(b, f, p, c), None, None, w, bias)
            x = rn(b, f, p, c)
            s = (torch.rand(b, c, generator=gen[0], device="cuda") + 0.5).float()
            t = (torch.randn(b, c, generator=gen[0], device="cuda") * 0.5).float()
            return (x, s, t, w, bias)
        return tagged(make, b=b, f=f, p=p, c=c, c_out=co)

    def gn_args(n, p, c, groups=32, silu=True, dtype=torch.bfloat16, out=torch.bfloat16,
                stats=False, ranks=1):
        """``ranks`` > 1: x is one rank's share, its partials gathered with
        ranks - 1 copies of themselves (the mock region's all-gather)."""
        def make():
            x = rn(n, p, c, std=1.5, dtype=dtype) + 0.3
            w, b = 1 + rn(c, std=0.1, dtype=dtype), rn(c, std=0.1, dtype=dtype)
            eps = 1e-6 if silu else 1e-5
            if stats:
                return (x, w, b, groups, eps)
            if ranks > 1:
                return (x, w, b, groups, eps, out, silu,
                        lambda part: torch.cat([part] * ranks, dim=2))
            return (x, w, b, groups, eps, out, silu)
        return tagged(make, n=n, p=p, c=c, groups=groups)

    def ln_args(rows, c, dtype=torch.bfloat16, out=torch.bfloat16):
        def make():
            x = rn(rows, c, std=2.0, dtype=dtype) - 0.2
            return x, 1 + rn(c, std=0.1, dtype=dtype), rn(c, std=0.1, dtype=dtype), 1e-5, out
        return tagged(make, rows=rows, c=c)

    def rot_args(b, positions, hw, c, rot, groups=1):
        def make():
            pos = torch.as_tensor(positions, dtype=torch.float32, device="cuda")
            return rn(b, len(positions), hw, c, std=2.0), pos, rot, groups
        return tagged(make, b=b, p=len(positions), hw=hw, c=c, rot=rot, groups=groups)

    k1, k2, k3, k4, k5 = ("folded_attention", "frame_attention", "ffn_geglu",
                          "gn_silu_temporal_conv", "flash_attention")
    gn, gss, ln = "group_norm", "group_scale_shift", "layer_norm"
    k2l, k3g, k5b = "frame_attention_long", "ffn_gelu", "flash_attention_bias"
    k1s = "folded_attention_short"
    return [
        (k1, "L0 self b2 S4096 h64 dh8", attn(2, 4096, 4096, 64, 8, 5)),
        (k1, "L0 cross b2 Sq4096 Sk157 dh8", attn(2, 4096, 157, 64, 8, 5)),
        (k1, "L1 self b2 S1024 dh16", attn(2, 1024, 1024, 64, 16, 10)),
        # the cross-attentions at the batch-3 forward's 48 rows: the short
        # body's class reads its grid, and at 2 rows L2 cross would take
        # the Hopper body, which the forward does not
        (k1, "L1 cross b48 Sq1024 Sk157 dh16", attn(48, 1024, 157, 64, 16, 10)),
        (k1, "L2 cross b48 Sq256 Sk157 dh32", attn(48, 256, 157, 64, 32, 20)),
        (k1, "L2 self b48 S256 dh32", attn(48, 256, 256, 64, 32, 20)),
        (k1, "mid self b16 S64 dh32", attn(16, 64, 64, 64, 32, 20)),
        (k1s, "image-latent encoder b4096 S16 h2 dh8", attn(4096, 16, 16, 2, 8, 4)),
        (k1, "ConsistI2V mid cross b51 Sq64 Sk77 h20 dh64", attn(51, 64, 77, 20, 64, 64)),
        (k2, "L0 temporal b1 S16 HW4096 h64 dh8", frames(1, 16, 4096, 64, 8, 5)),
        (k2, "L1 temporal b3 S16 HW1024 dh16", frames(3, 16, 1024, 64, 16, 10)),
        (k2, "L2 temporal b3 S16 HW256 dh32", frames(3, 16, 256, 64, 32, 20)),
        (k2, "transformer_in b1 S16 HW4096 h8 dh64", frames(1, 16, 4096, 8, 64, 64)),
        (k2, "transformer_in b3 S16 HW4096 h8 dh64", frames(3, 16, 4096, 8, 64, 64)),
        (k2, "ConsistI2V L0 temporal b3 S17 Sk25 HW4096 h8 dh40",
         frames(3, 17, 4096, 8, 40, 40, sk=25)),
        (k2, "ConsistI2V L1 temporal b3 S17 Sk25 HW1024 h8 dh80",
         frames(3, 17, 1024, 8, 80, 80, sk=25)),
        (k2, "ConsistI2V L2 temporal b3 S17 Sk25 HW256 h8 dh160",
         frames(3, 17, 256, 8, 160, 160, sk=25)),
        (k3, "L0 C320 rows 65536", ffn_args(65536, 320)),
        (k3, "transformer_in C512 rows 65536", ffn_args(65536, 512)),
        (k3, "L1 C640 rows 16384", ffn_args(16384, 640)),
        (k4, "L0 C320 P4096 F16 b1", tconv_args(1, 16, 4096, 320)),
        (k4, "L1 C640 P1024 F16 b3", tconv_args(3, 16, 1024, 640)),
        (k4, "L2 C1280 P256 F16 b3", tconv_args(3, 16, 256, 1280)),
        (k4, "mid C1280 P64 F16 b3", tconv_args(3, 16, 64, 1280)),
        (k3, "ConsistI2V L0 C320 rows 3*17*4096", ffn_args(3 * 17 * 4096, 320)),
        (k4, "ConsistI2V L0 C320 P4096 F17 b3", tconv_args(3, 17, 4096, 320)),
        # i2vgen-xl's edit batch (3 rows of 16 frames) at L0
        (k3, "L0 C320 rows 3*16*4096", ffn_args(3 * 16 * 4096, 320)),
        (k4, "L0 C320 P4096 F16 b3", tconv_args(3, 16, 4096, 320)),
        (k5, "split-KV L0 51 rows Sq4096 Sk4096+4096 h5 dh64", splitkv(51, 17, 4096, 5, 64)),
        (k5, "split-KV L1 51 rows Sq1024 Sk1024+1024 h10 dh64", splitkv(51, 17, 1024, 10, 64)),
        (k5, "split-KV L2 51 rows Sq256 Sk256+256 h20 dh64", splitkv(51, 17, 256, 20, 64)),
        (k5, "spatial cross L0 b51 Sq4096 Sk77 h5 dh64", attn(51, 4096, 77, 5, 64, 64)),
        (k5, "temporal cross L0 b3 Sq17*4096 Sk77 h8 dh40", attn(3, 17 * 4096, 77, 8, 40, 40)),
        (k5, "temporal cross L1 b3 Sq17*1024 Sk77 h8 dh80", attn(3, 17 * 1024, 77, 8, 80, 80)),
        (k5, "temporal cross L2 b3 Sq17*256 Sk77 h8 dh160", attn(3, 17 * 256, 77, 8, 160, 160)),
        (k5, "SEINE L0 spatial self b48 S4096 h8 dh40", attn(48, 4096, 4096, 8, 40, 40)),
        (k2, "SEINE L0 temporal b3 S16 HW4096 h8 dh40 bias",
         frames(3, 16, 4096, 8, 40, 40, bias=True)),
        (k2, "SEINE L1 temporal b3 S16 HW1024 h8 dh80 bias",
         frames(3, 16, 1024, 8, 80, 80, bias=True)),
        (k2, "SEINE L2 temporal b3 S16 HW256 h8 dh160 bias",
         frames(3, 16, 256, 8, 160, 160, bias=True)),
        (k2, "off-path bias b1 S16 HW4096 h64 dh8", frames(1, 16, 4096, 64, 8, 5, bias=True)),
        # edge masking, off the main paths: rows, keys, channels not multiples of the tiles
        (k3, "ragged rows 1000 C320", ffn_args(1000, 320)),
        (k4, "ragged C40->C24 P30 F5 b2", tconv_args(2, 5, 30, 40, c_out=24)),
        # the tiny archs' widths (i2vgen-tiny, consisti2v-tiny): K3 at C 32, K4
        # at C 16 with one pixel a frame, so a tile spans batch rows
        (k3, "ragged tiny C32 rows 300", ffn_args(300, 32)),
        (k4, "ragged tiny C16 P1 F8 b3", tconv_args(3, 8, 1, 16)),
        (k5, "ragged split-KV 6 rows Sq1000 Sk999+77 h3 dh80",
         splitkv(6, 3, 1000, 3, 80, sk=999, sk2=77)),
        (k2, "ragged b2 S7 Sk13 HW37 h2 dh40", frames(2, 7, 37, 2, 40, 40, sk=13)),
        (k2, "ragged bias b2 S7 Sk13 HW37 h2 dh80", frames(2, 7, 37, 2, 80, 80, sk=13, bias=True)),
        # seine-tiny's reference check (3 rows x 8 frames, 2 heads of 8): its K1 calls
        (k1, "seine-tiny self b24 S64 h2 dh8", attn(24, 64, 64, 2, 8, 8)),
        (k1, "seine-tiny cross b24 Sq64 Sk77 h2 dh8", attn(24, 64, 77, 2, 8, 8)),
        (k1s, "seine-tiny self b24 S16 h2 dh8", attn(24, 16, 16, 2, 8, 8)),
        (k1s, "seine-tiny cross b24 Sq16 Sk77 h2 dh8", attn(24, 16, 77, 2, 8, 8)),
        (k1s, "seine-tiny self b24 S4 h2 dh8", attn(24, 4, 4, 2, 8, 8)),
        (k1s, "seine-tiny cross b24 Sq4 Sk77 h2 dh8", attn(24, 4, 77, 2, 8, 8)),
        # K1 on each side of its class and tile boundaries: the short-query
        # body up to 32 queries, one 64-row query tile an item up to 64, two
        # past it; query and key axes not multiples of 64; odd units a
        # warpgroup (3 heads of 16, 1 head of 8 at 5 heads)
        (k1s, "ragged short class b2 Sq32 Sk77 h64 dh8", attn(2, 32, 77, 64, 8, 5)),
        (k1, "ragged b2 Sq33 Sk77 h64 dh8", attn(2, 33, 77, 64, 8, 5)),
        (k1, "ragged b3 Sq64 Sk130 h8 dh16", attn(3, 64, 130, 8, 16, 10)),
        (k1, "ragged b3 Sq65 Sk64 h4 dh32", attn(3, 65, 64, 4, 32, 20)),
        (k1, "ragged b2 Sq200 Sk300 h3 dh64", attn(2, 200, 300, 3, 64, 64)),
        (k1, "ragged b2 Sq300 Sk65 h5 dh8", attn(2, 300, 65, 5, 8, 8)),
        (k1, "ragged b2 Sq100 Sk100 h3 dh16", attn(2, 100, 100, 3, 16, 16)),
        # the three-warpgroup layout (dh 8 where its items fill the card
        # WG3_MIN_WAVES times and pad the rows little) at 1, 2 and 3 units a
        # warpgroup, ragged rows and keys
        (k1, "ragged wg3 b120 Sq300 Sk300 h5 dh8", attn(120, 300, 300, 5, 8, 8)),
        (k1, "ragged wg3 b300 Sq300 Sk260 h2 dh8", attn(300, 300, 260, 2, 8, 8)),
        (k1, "ragged wg3 b150 Sq300 Sk260 h6 dh8", attn(150, 300, 260, 6, 8, 8)),
        # K1 on each side of the short-key class (folded_attention
        # SHORT_MAX_KEYS, where the short body's grid fills the card): Sk
        # just under it takes the short body, just over it the Hopper body
        (k1, "ragged short-key class b2 Sq4096 Sk191 h64 dh8", attn(2, 4096, 191, 64, 8, 5)),
        (k1, "ragged past the short-key class b2 Sq4096 Sk193 h64 dh8",
         attn(2, 4096, 193, 64, 8, 5)),
        (k1, "ragged short-key class b51 Sq64 Sk191 h20 dh64", attn(51, 64, 191, 20, 64, 64)),
        (k1, "ragged past the short-key class b51 Sq64 Sk193 h20 dh64",
         attn(51, 64, 193, 20, 64, 64)),
        # the 128-frame long-video path (i2vgen-xl, 512^2): K2 long on every
        # temporal attention (64 heads of 5/10/20 stored as 8/16/32; L3 is the
        # mid block at 8x8), K1 on the image-latent encoder, K3 and K4 at L0
        *[(k2l, f"{lv} temporal b{b} S128 HW{hw} h{h} dh{dh}",
           frames(b, 128, hw, h, dh, true_dh))
          for b in (1, 3)
          for lv, hw, h, dh, true_dh in (("L0", 4096, 64, 8, 5), ("L1", 1024, 64, 16, 10),
                                         ("L2", 256, 64, 32, 20), ("L3 (mid)", 64, 64, 32, 20),
                                         ("transformer_in", 4096, 8, 64, 64))],
        (k1, "long image-latent encoder b3*4096 S128 h2 dh8", attn(3 * 4096, 128, 128, 2, 8, 4)),
        # one rank's program of a 4-rank frame split of the 128-frame path:
        # every frame over a quarter of the pixels after the all-to-all
        # (K2 long, K4 with s, t from the all-reduced moments), a quarter of
        # the frames for the per-frame kernels (K3)
        *[(k2l, f"rank of 4: {lv} temporal b{b} S128 HW{hw} h{h} dh{dh}",
           frames(b, 128, hw, h, dh, true_dh))
          for lv, hw, h, dh, true_dh, batches in (
              ("L0", 1024, 64, 8, 5, (1, 3)), ("L1", 256, 64, 16, 10, (3,)),
              ("L2", 64, 64, 32, 20, (3,)), ("L3 (mid)", 16, 64, 32, 20, (1, 3)),
              ("transformer_in", 1024, 8, 64, 64, (3,)))
          for b in batches],
        (k4, "rank of 4: L0 C320 P1024 F128 b3", tconv_args(3, 128, 1024, 320)),
        (k4, "rank of 4: L2 C1280 P64 F128 b3", tconv_args(3, 128, 64, 1280)),
        (k4, "rank of 4: mid C1280 P16 F128 b3", tconv_args(3, 128, 16, 1280)),
        (k3, "rank of 4: L0 C320 rows 3*32*4096", ffn_args(3 * 32 * 4096, 320)),
        (k3, "long L0 C320 rows 3*128*4096", ffn_args(3 * 128 * 4096, 320)),
        (k4, "long L0 C320 P4096 F128 b3", tconv_args(3, 128, 4096, 320)),
        (k4, "long L2 C1280 P256 F128 b3", tconv_args(3, 128, 256, 1280)),
        # K2 long off the paths: SEINE's widths with its bias at 64 frames, the
        # augmented key axis at 128, a ragged shape
        *[(k2l, f"off-path SEINE {lv} temporal b3 S64 HW{hw} h8 dh{dh} relpos bias",
           relpos_frames(3, 64, hw, 8, dh))
          for lv, hw, dh in (("L0", 4096, 40), ("L1", 1024, 80), ("L2", 256, 160))],
        (k2l, "off-path Sk=S+8 b1 S128 Sk136 HW1024 h8 dh40",
         frames(1, 128, 1024, 8, 40, 40, sk=136)),
        (k2l, "ragged bias b2 S40 Sk47 HW37 h2 dh80",
         frames(2, 40, 37, 2, 80, 80, sk=47, bias=True)),
        # K2 long on each side of its boundaries: 33 and 127 frames, one
        # 64-frame query tile an item up to 64 frames, two past it, the key
        # tile of 144 past 128 keys
        (k2l, "ragged b2 S33 HW37 h64 dh8", frames(2, 33, 37, 64, 8, 5)),
        (k2l, "ragged b1 S127 Sk143 HW30 h8 dh40", frames(1, 127, 30, 8, 40, 40, sk=143)),
        (k2l, "ragged bias b1 S64 HW20 h2 dh160", frames(1, 64, 20, 2, 160, 160, bias=True)),
        (k2l, "ragged bias b1 S65 Sk70 HW20 h8 dh64", frames(1, 65, 20, 8, 64, 64, sk=70,
                                                             bias=True)),
        (k2l, "ragged b3 S100 HW50 h64 dh16", frames(3, 100, 50, 64, 16, 10)),
        # K1 at the class of the Pallas _packed_kernel, which took Sk past
        # 4096: 2 rows, 64 heads of dh 8, Sq = Sk = 8192
        (k1, "off-path row 5 class b2 S8192 h64 dh8", attn(2, 8192, 8192, 64, 8, 5)),
        # the first-frame editors at full width: InstructPix2Pix / MagicBrush
        # (SD1.5, 512^2, CFG batch 3: 8 heads of 40/80/160), CosXL (SDXL,
        # 1024^2, batch 3: 10 and 20 heads of 64) and InstantStyle (batch 2:
        # the IP-Adapter's attention over 4 image tokens on up_0_attn_1)
        (k5, "SD1.5 L0 self b3 S4096 h8 dh40", attn(3, 4096, 4096, 8, 40, 40)),
        (k5, "SD1.5 L1 self b3 S1024 h8 dh80", attn(3, 1024, 1024, 8, 80, 80)),
        (k5, "SD1.5 L2 self b3 S256 h8 dh160", attn(3, 256, 256, 8, 160, 160)),
        (k5, "SD1.5 mid self b3 S64 h8 dh160", attn(3, 64, 64, 8, 160, 160)),
        (k5, "SD1.5 L0 cross b3 Sq4096 Sk77 h8 dh40", attn(3, 4096, 77, 8, 40, 40)),
        (k5, "SDXL L1 self b3 S4096 h10 dh64", attn(3, 4096, 4096, 10, 64, 64)),
        (k5, "SDXL L2 self b3 S1024 h20 dh64", attn(3, 1024, 1024, 20, 64, 64)),
        (k5, "SDXL L2 cross b3 Sq1024 Sk77 h20 dh64", attn(3, 1024, 77, 20, 64, 64)),
        (k5, "InstantStyle IP b2 Sq1024 Sk4 h20 dh64", attn(2, 1024, 4, 20, 64, 64)),
        (k3, "SD1.5 L0 C320 rows 3*4096", ffn_args(3 * 4096, 320)),
        (k3, "SD1.5 L1 C640 rows 3*1024", ffn_args(3 * 1024, 640)),
        (k3, "SDXL L1 C640 rows 3*4096", ffn_args(3 * 4096, 640)),
        # the IP-Adapter Plus resampler (not on InstantStyle's path, which
        # takes the base adapter): 16 latents over 257 + 16 keys, 12 heads of 64
        (k5, "off-path Resampler b1 Sq16 Sk273 h12 dh64", attn(1, 16, 273, 12, 64, 64)),
        # K5's one-key-tile body on each side of its key widths (Sk rounded up
        # to 16, past 128 the tiles body; at dh 40 past 80 keys too, where
        # K, V and the Q ring do not fit beside each other) and at
        # head counts that leave a ragged head group (3 of 40; 12 of 40: 8 +
        # 4; 6 of 80: 4 + 2; 3 of 160: 2 + 1; 7 of 64: 5 + 2), at query
        # counts that give the body its items (and not a multiple of 64)
        *[(k5, f"ragged one-tile b13 Sq4100 Sk{sk} h5 dh64", attn(13, 4100, sk, 5, 64, 64))
          for sk in (1, 4, 16, 17, 77, 80, 128, 129)],
        (k5, "ragged one-tile b13 Sq4100 Sk77 h3 dh40", attn(13, 4100, 77, 3, 40, 40)),
        (k5, "ragged one-tile b13 Sq4100 Sk33 h12 dh40", attn(13, 4100, 33, 12, 40, 40)),
        (k5, "ragged one-tile b13 Sq4100 Sk112 h8 dh40", attn(13, 4100, 112, 8, 40, 40)),
        (k5, "ragged one-tile b13 Sq4100 Sk50 h6 dh80", attn(13, 4100, 50, 6, 80, 80)),
        (k5, "ragged one-tile b13 Sq4100 Sk50 h3 dh160", attn(13, 4100, 50, 3, 160, 160)),
        (k5, "ragged one-tile b13 Sq4100 Sk16 h7 dh64", attn(13, 4100, 16, 7, 64, 64)),
        # K4's prologue-free form at main-path shapes, beside one conv3d
        *[(k4, f"off-path prologue-free {lb}", tconv_args(*shape, prologue=False),
           _tconv_library)
          for lb, shape in (("L0 C320 P4096 F16 b1", (1, 16, 4096, 320)),
                            ("L1 C640 P1024 F16 b3", (3, 16, 1024, 640)),
                            ("L2 C1280 P256 F16 b3", (3, 16, 256, 1280)),
                            ("long L0 C320 P4096 F128 b3", (3, 128, 4096, 320)))],
        # the op surfaces (no configuration reaches them; chip_smoke's "op
        # surfaces" path drives the port's modules at these widths): K5 with
        # a score bias at SEINE's L0 spatial self-attention (shared by the
        # batch), ConsistI2V's L0 spatial cross-attention (per row) and
        # i2vgen-xl's L2 widths (64 heads of 20 stored as 32); K3's GELU form;
        # K2 on the [B, S, 1, C] view that a biased short [B, S, C] call takes
        (k5b, "SEINE L0 spatial self b48 S4096 h8 dh40 shared bias",
         attn_bias(48, 4096, 4096, 8, 40, 40, "shared")),
        (k5b, "ConsistI2V spatial cross L0 b51 Sq4096 Sk77 h5 dh64 per-row bias",
         attn_bias(51, 4096, 77, 5, 64, 64, "batch")),
        (k5b, "i2vgen L2 self b48 S256 h64 dh32 shared bias",
         attn_bias(48, 256, 256, 64, 32, 20, "shared")),
        (k5, "off-path i2vgen L2 self b48 S256 h64 dh32", attn(48, 256, 256, 64, 32, 20)),
        (k5b, "ragged per-row bias b2 Sq1000 Sk999 h3 dh80",
         attn_bias(2, 1000, 999, 3, 80, 80, "batch")),
        (k5b, "ragged shared bias b3 Sq130 Sk77 h2 dh8", attn_bias(3, 130, 77, 2, 8, 5, "shared")),
        (k5b, "ragged shared bias b2 Sq200 Sk300 h4 dh16",
         attn_bias(2, 200, 300, 4, 16, 16, "shared")),
        (k5b, "ragged per-row bias b2 Sq70 Sk129 h2 dh160",
         attn_bias(2, 70, 129, 2, 160, 160, "batch")),
        (k3g, "L0 C320 rows 65536", ffn_args(65536, 320, gelu=True)),
        (k3g, "L1 C640 rows 16384", ffn_args(16384, 640, gelu=True)),
        (k3g, "ragged rows 1000 C320", ffn_args(1000, 320, gelu=True)),
        (k3g, "ragged tiny C32 rows 300", ffn_args(300, 32, gelu=True)),
        (k2, "[B,S,1,C] view b3*4096 S16 h8 dh40 bias", frames(3 * 4096, 16, 1, 8, 40, 40,
                                                              bias=True)),
        (k2, "ragged [B,S,1,C] view b5 S7 Sk13 h2 dh64 bias",
         frames(5, 7, 1, 2, 64, 64, sk=13, bias=True)),
        # K5 at the Pallas kernel's widths that no model has (every multiple of
        # 8 up to 128), with and without a bias, ragged
        *[case for dh in (24, 48, 56, 72, 88, 96, 104, 112, 120, 128) for case in (
            (k5, f"ragged b2 Sq300 Sk200 h2 dh{dh}", attn(2, 300, 200, 2, dh, dh)),
            (k5b, f"ragged shared bias b2 Sq200 Sk300 h2 dh{dh}",
             attn_bias(2, 200, 300, 2, dh, dh, "shared")))],
        *KN_CASES(gn_args, ln_args),
        *KR_CASES(rot_args),
    ]


def KN_CASES(gn_args, ln_args):
    """KN's cases: ConsistI2V at the edit batch (3 rows of 17 frames, 51
    images of 64x64 / 32x32 / 16x16 / 8x8 latents): the resnets' norms with
    SiLU, the spatial transformers' without, the up blocks' concatenated
    widths, K4's statistics over a row's 17 frames, the transformers' layer
    norms; i2vgen-xl's temporal transformer norms, each over a clip of 16
    frames as one image (N of 1-3: the apply's grid cut apart from the
    statistics'), and one rank's 32 of 128 frames with its partials gathered
    from 4 ranks (the frame-sharded path); the VAE's encode of one frame and decode of 16 frames at
    its 512^2 widths (the last up block's first resnet norms 256 channels
    there); CLIP's and the
    InstantStyle resampler's layer norms, i2vgen-xl's 4-wide one; fp32 in and
    out and the tiny archs' widths off the path."""
    gn, gss, ln = "group_norm", "group_scale_shift", "layer_norm"
    return [
        (gn, "ConsistI2V L0 resnet N51 P4096 C320 silu", gn_args(51, 4096, 320)),
        (gn, "ConsistI2V L0 spatial N51 P4096 C320", gn_args(51, 4096, 320, silu=False)),
        (gn, "ConsistI2V L1 resnet N51 P1024 C640 silu", gn_args(51, 1024, 640)),
        (gn, "ConsistI2V L2 resnet N51 P256 C1280 silu", gn_args(51, 256, 1280)),
        (gn, "ConsistI2V mid resnet N51 P64 C1280 silu", gn_args(51, 64, 1280)),
        (gn, "ConsistI2V up L0 concat N51 P4096 C960 silu", gn_args(51, 4096, 960)),
        (gn, "ConsistI2V up L1 concat N51 P1024 C1920 silu", gn_args(51, 1024, 1920)),
        (gn, "ConsistI2V up L2 concat N51 P256 C2560 silu", gn_args(51, 256, 2560)),
        (gn, "i2vgen-xl temporal clip L0 b3 N3 P16*4096 C320",
         gn_args(3, 16 * 4096, 320, silu=False)),
        (gn, "i2vgen-xl temporal clip L1 b2 N2 P16*1024 C640",
         gn_args(2, 16 * 1024, 640, silu=False)),
        (gn, "i2vgen-xl temporal clip L3 b1 N1 P16*64 C1280",
         gn_args(1, 16 * 64, 1280, silu=False)),
        (gn, "i2vgen-xl temporal clip rank of 4 L0 b3 N3 P32*4096 C320 gathered",
         gn_args(3, 32 * 4096, 320, silu=False, ranks=4)),
        (gn, "VAE encode 512^2 N1 P262144 C128 silu", gn_args(1, 512 * 512, 128)),
        (gss, "ConsistI2V K4 L0 b3 F17 P4096 C320", gn_args(3, 17 * 4096, 320, stats=True)),
        (gss, "ConsistI2V K4 L1 b3 F17 P1024 C640", gn_args(3, 17 * 1024, 640, stats=True)),
        (gss, "ConsistI2V K4 L2 b3 F17 P256 C1280", gn_args(3, 17 * 256, 1280, stats=True)),
        (ln, "ConsistI2V L0 tokens rows 51*4096 C320", ln_args(51 * 4096, 320)),
        (ln, "ConsistI2V L1 tokens rows 51*1024 C640", ln_args(51 * 1024, 640)),
        (ln, "ConsistI2V L2 tokens rows 51*256 C1280", ln_args(51 * 256, 1280)),
        (gn, "VAE decode up 512^2 N16 P262144 C256 silu", gn_args(16, 512 * 512, 256)),
        (gn, "VAE decode up 512^2 N16 P262144 C128 silu", gn_args(16, 512 * 512, 128)),
        (gn, "VAE decode up 256^2 N16 P65536 C512 silu", gn_args(16, 256 * 256, 512)),
        (gn, "VAE decode mid attention N16 P4096 C512", gn_args(16, 4096, 512, silu=False)),
        (ln, "CLIP text rows 77 C1024", ln_args(77, 1024)),
        (ln, "off-path InstantStyle resampler rows 2*16 C2048", ln_args(32, 2048)),
        (ln, "off-path i2vgen-xl image-latent encoder rows 3*4096*16 C4", ln_args(3 * 4096 * 16, 4)),
        (gn, "ragged fp32 in and out N3 P37 C64 G8", gn_args(3, 37, 64, 8, dtype=torch.float32,
                                                            out=torch.float32)),
        (gn, "ragged bf16 in fp32 out N2 P1000 C2560", gn_args(2, 1000, 2560,
                                                               out=torch.float32)),
        (gn, "ragged tiny N4 P16 C16 G8 silu", gn_args(4, 16, 16, 8)),
        (gn, "ragged tiny N24 P1 C8 G4 silu", gn_args(24, 1, 8, 4)),
        (gss, "ragged fp32 b2 F5 P30 C40 G8", gn_args(2, 5 * 30, 40, 8, dtype=torch.float32,
                                                      stats=True)),
        (ln, "ragged fp32 in bf16 out rows 1001 C768", ln_args(1001, 768, dtype=torch.float32)),
        (ln, "ragged bf16 in fp32 out rows 999 C1280", ln_args(999, 1280, out=torch.float32)),
        (ln, "ragged tiny rows 300 C16", ln_args(300, 16)),
        (ln, "ragged rows 5 C12", ln_args(5, 12)),
    ]


def KR_CASES(rot_args):
    """KR's cases: ConsistI2V's three rotary calls of a temporal transformer
    at L0-L2 at the edit batch (3 rows): q over 17 frames, k over 17 frames
    and the 8 augmented keys at position 0, the cross-attention q; SEINE's
    q at L0 (8 heads of 40, the first 32 of each rotated); off the path a
    rank's cross-attention q (its conditioning frame, then frames 9-12),
    seine-tiny's 4 of 8 and a slab that ends inside a block."""
    kr, q17, k25 = "rotate_partial", list(range(17)), list(range(17)) + [0] * 8
    cases = []
    for level, hw, c in (("L0", 4096, 320), ("L1", 1024, 640), ("L2", 256, 1280)):
        cases += [
            (kr, f"ConsistI2V {level} q b3 F17 HW{hw} C{c}", rot_args(3, q17, hw, c, c // 2)),
            (kr, f"ConsistI2V {level} k b3 F17+8 HW{hw} C{c}", rot_args(3, k25, hw, c, c // 2)),
            (kr, f"ConsistI2V {level} cross q b3 F17 HW{hw} C{c}",
             rot_args(3, q17, hw, c, c // 2))]
    return cases + [
        (kr, "SEINE L0 q b3 F16 HW4096 h8 dh40 rot 32",
         rot_args(3, list(range(16)), 4096, 320, 32, 8)),
        (kr, "ragged rank 3 of 4 cross q b3 F1+4 HW4096 C320",
         rot_args(3, [0, 9, 10, 11, 12], 4096, 320, 160)),
        (kr, "ragged seine-tiny b3 F8 HW256 h2 dh8 rot 4",
         rot_args(3, list(range(8)), 256, 16, 4, 2)),
        (kr, "ragged b2 F3 HW7 C24 rot 24", rot_args(2, [0, 5, 2], 7, 24, 24)),
    ]


# case labels checked and timed, but not summed into the records' times
_OFF_PATH = ("ragged", "seine-tiny", "off-path")
_ATTENTION = ("folded_attention", "folded_attention_short", "frame_attention",
              "frame_attention_long", "flash_attention", "flash_attention_bias")
# the records of the two operand modes that no backbone reaches (the "op
# surfaces" path launches them)
_MODES = ("flash_attention_bias", "ffn_gelu")
# the records whose launches are a share of another wrapper's: K1's short
# body (the image-latent encoder, the cross-attentions over 77 or 157 keys,
# the mid block's self-attention, the seine-tiny check) and K4's prologue
# (every K4 call of the models)
_SUBS = ("folded_attention_short", "gn_silu_temporal_conv_prologue")
K4_PROLOGUE = ("gn_silu_temporal_conv_prologue", "temporal_conv_kernel_prologue")
# the records whose kernel repeats its plain version's arithmetic: equal bit
# for bit
_EXACT = ("rotate_partial",)
# an attention kernel's error against the fp32 truth may be at most FP32_RATIO
# times its plain version's (the bf16 rounding of the output) plus FP32_ATOL
FP32_RATIO, FP32_ATOL = 1.5, 1e-4


def phase_kernels(cases=None):
    """Each kernel against its plain version (max error within ``0.01 +
    0.02*max|ref|``); returns {name: record} with the worst error and, over
    the main-path cases, the summed times and bounds. An attention kernel and
    its plain version are also each held against the fp32 truth (the plain
    version on the inputs cast to fp32, output unrounded), which tells a
    kernel's own error from bf16 rounding of the output. Each attention case
    also gets its exp2 count and the special-function units' time for it:
    exp2s / (16 x SMs x the highest SM clock nvidia-smi sampled over this
    phase), logged after the cases; ``bound_ms`` stays bytes or operations.
    An attention case also fails where its error against the fp32 truth
    exceeds ``FP32_RATIO`` times the plain version's plus ``FP32_ATOL``: bf16
    P accounts for at most that, and a wrong kernel whose outputs are small
    (thousands of keys) can still sit under the first bound. ``cases``
    (default: every case of :func:`_kernel_cases`) lets a probe check a
    subset the same way."""
    kernels = _kernels()
    records, failures = {}, []
    atol, rtol = 1e-2, 2e-2
    with _ClockSampler() as clocks:
        _run_kernel_cases(kernels, records, failures, atol, rtol,
                          _kernel_cases() if cases is None else cases)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = clocks.max_sm_mhz
    log(f"exp2 floors: {SFU_EXP2_PER_CLOCK} exp2 per clock per SM x {sms} SMs x {mhz:g} MHz "
        f"(the highest SM clock sampled over the kernel cases; {clocks.summary})")
    for rec in records.values():
        for case in rec["cases"]:
            if case["exp2"] is None:
                continue
            case["exp2_floor_ms"] = case["exp2"] / (SFU_EXP2_PER_CLOCK * sms * mhz * 1e6) * 1e3
            log(f"exp2 floor {rec['name']} [{case['shape']}]: {case['exp2']:.4e} exp2, "
                f"{case['exp2_floor_ms']:.4f} ms; kernel {case['ms']:.4f} ms "
                f"({case['ms'] / case['exp2_floor_ms']:.2f}x), bound {case['bound_ms']:.4f} ms "
                f"({case['bound_by']})")
    for rec in records.values():
        ops_ms, bytes_ms = rec.pop("_ops_ms"), rec.pop("_bytes_ms")
        rec["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return records


def _k1_record(name, make):
    """A K1 case's record is the body its plan takes: ``folded_attention``
    (the Hopper body) or ``folded_attention_short`` (the short body, which
    takes Sq <= 32 and the short-key class)."""
    shape = getattr(make, "shape", None)
    if name not in ("folded_attention", "folded_attention_short") or shape is None:
        return name
    from anyv2v_torch.ops import folded_attention as fa

    plan = fa.folded_plan(shape["b"], shape["sq"], shape["sk"], shape["heads"], shape["dh"],
                          sms=torch.cuda.get_device_properties(0).multi_processor_count)
    return "folded_attention_short" if plan["body"] == "short" else "folded_attention"


def _run_kernel_cases(kernels, records, failures, atol, rtol, cases):
    for name, label, make, *override in cases:
        name = _k1_record(name, make)
        route, src, repl, kern, plain, cost, library = kernels[name]
        case_library = override[0] if override else library
        args = make()
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        bound = atol + rtol * want.float().abs().max().item()
        ok = bool(np.isfinite(err)) and err <= bound
        if name in _EXACT:
            ok = got.dtype == want.dtype and torch.equal(got.view(torch.int16),
                                                        want.view(torch.int16))
        vs_fp32 = None
        if name in _ATTENTION:
            truth = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
            vs_fp32 = [(x.float() - truth).abs().max().item() for x in (got, want)]
            ok = ok and vs_fp32[0] <= FP32_RATIO * vs_fp32[1] + FP32_ATOL
            del truth
        del got, want
        ms = _time_ms(lambda: kern(*args), 5)
        plain_ms = _time_ms(lambda: plain(*args), 2)
        lib_ms = _time_ms(case_library(*args), 5) if case_library is not None else None
        transpose_ms = (_time_ms(_frame_transposes(*args[:4]), 5)
                        if name == "frame_attention_long" else None)
        products = {label: _time_ms(call, 5) for label, call in _gemm_yardstick(name, args)}
        prologue = _k4_prologue(name, kern, args)
        flops, nbytes = cost(*args)
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
        held = ("bit for bit" if name in _EXACT
                else f"bound {bound:.3e}, atol {atol} + rtol {rtol}*max|ref|")
        log(f"kernel {name} [{label}]: max_abs_err {err:.3e} ({held}) "
            f"{'ok' if ok else 'MISS'}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops:.3e} op, "
            f"{nbytes:.3e} B), library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            + ("" if transpose_ms is None else
               f" (on transposed copies; the transposes {transpose_ms:.4f} ms)")
            + ("" if not products else "; the products alone (cuBLAS addmm): " + ", ".join(
                f"{label} {v:.4f} ms" for label, v in products.items()))
            + ("" if prologue is None else
               f"; of it the prologue kernel {prologue['ms']:.4f} ms (profiler; plain "
               f"{prologue['plain_ms']:.4f} ms, bound {prologue['bound_ms']:.4f} ms: bytes)")
            + ("" if vs_fp32 is None else
               f"; vs fp32 truth: kernel {vs_fp32[0]:.3e}, plain {vs_fp32[1]:.3e} "
               f"(bound {FP32_RATIO} x plain + {FP32_ATOL})"))
        if not ok:
            failures.append(f"{name} [{label}]")
        rec = records.setdefault(name, {
            "name": name, "route": route, "source": src, "replaces": repl, "launches": 0,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": None, "library_ms": 0.0 if library is not None else None,
            **({"products_ms": 0.0} if products else {}),
            "cases": [], "_ops_ms": 0.0, "_bytes_ms": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if not label.startswith(_OFF_PATH):   # the record's times: main-path shapes only
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms
            rec["bound_ms"] += bound_ms
            rec["_ops_ms" if bound_by == "operations" else "_bytes_ms"] += bound_ms
            if lib_ms is not None:
                rec["library_ms"] += lib_ms
            if products:
                rec["products_ms"] += sum(products.values())
        rec["cases"].append({"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                             "transpose_ms": transpose_ms, "products_ms": products or None,
                             "vs_fp32": vs_fp32,
                             "exp2": _exp2_count(name, args)})
        if prologue is not None:
            _add_k4_prologue(records, label, err, prologue)
        del args
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        log("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    if sys.argv[1:2] == ["--nccl-rank"]:   # one rank of phase 14's NCCL group
        rank, world, port = (int(a) for a in sys.argv[2:5])
        sys.path.insert(0, REPO)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return nccl_rank_main(rank, world, port, sys.argv[5])
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_env()
    phase_build()
    records = phase_kernels()
    by_path = {"op surfaces": phase_op_surfaces()}
    torch.cuda.empty_cache()
    by_path["i2vgen-xl"], pipe = phase_main_path()
    by_path["i2vgen-xl long video"], unsharded_ms = phase_long_video(pipe)
    by_path["i2vgen-xl per rank of 4"] = phase_sharded(pipe, unsharded_ms)
    phase_nccl(pipe)
    del pipe
    torch.cuda.empty_cache()
    by_path["consisti2v"], pipe = phase_consisti2v()
    by_path["consisti2v per rank of 4"] = phase_sharded_backbone(
        "consisti2v", pipe.unet, consisti2v_rank_args, "S17 Sk25")
    del pipe
    torch.cuda.empty_cache()
    by_path["consisti2v checkpoint folder"] = phase_checkpoint_folder()
    torch.cuda.empty_cache()
    by_path["seine"], pipe = phase_seine()
    by_path["seine per rank of 4"] = phase_sharded_backbone(
        "seine", pipe.unet, seine_rank_args, "S16 Sk16", _seine_k5_role)
    del pipe
    torch.cuda.empty_cache()
    by_path["instructpix2pix"] = phase_instructpix2pix()
    torch.cuda.empty_cache()
    by_path["cosxl"] = phase_cosxl()
    torch.cuda.empty_cache()
    by_path["instantstyle"] = phase_instantstyle()
    torch.cuda.empty_cache()
    by_path["product"] = phase_product()
    torch.cuda.empty_cache()
    by_path["bench"] = phase_bench()
    # every K4 call site of the models passes s, t: its prologue kernel runs
    unpaired = {path: (c["gn_silu_temporal_conv"], c[K4_PROLOGUE[0]])
                for path, c in by_path.items()
                if c["gn_silu_temporal_conv"] != c[K4_PROLOGUE[0]]}
    if unpaired:
        raise RuntimeError(f"K4 calls without their prologue kernel (K4, prologue): {unpaired}")
    for rec in records.values():
        rec["launches_by_path"] = {path: c[rec["name"]] for path, c in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    log(json.dumps({"kernels": list(records.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _synthetic_video(rng, frames, size):
    """A seeded moving pattern: smooth colour gradients plus a bright square
    drifting across the frame (and round again past frame 22), [F, H, W, 3]
    in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.rand(3).astype(np.float32) * 6.28
    video = np.empty((frames, size, size, 3), np.float32)
    for f in range(frames):
        for c in range(3):
            video[f, :, :, c] = 0.5 + 0.4 * np.sin(6.0 * xx + 4.0 * yy + phase[c] + 0.2 * f)
        x0 = int(size * ((0.1 + 0.04 * f) % 1.0))
        video[f, size // 3:size // 3 + size // 5, x0:x0 + size // 5] = (0.95, 0.85, 0.2)
    return video


class _Count:
    """A wrapper's launch count kept under another attribute (K5's biased
    launches, ``flash_attention.bias_launches``), read and set as
    ``launches``."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):   # 0 on a wrapper without the count (an older tree under A/B)
        return getattr(self.fn, self.attr, 0)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


def _wrappers():
    from anyv2v_torch.ops import ffn, flash_attention, folded_attention, frame_attention
    from anyv2v_torch.ops import norm, rotary, temporal_conv

    return {"folded_attention": folded_attention.folded_attention,
            "frame_attention": frame_attention.frame_attention,
            "frame_attention_long": frame_attention.frame_attention_long,
            "folded_attention_short": _Count(folded_attention.folded_attention,
                                             "short_launches"),
            "ffn_geglu": ffn.ffn_geglu,
            "gn_silu_temporal_conv": temporal_conv.gn_silu_temporal_conv,
            "gn_silu_temporal_conv_prologue": _Count(temporal_conv.gn_silu_temporal_conv,
                                                     "prologue_launches"),
            "flash_attention": flash_attention.flash_attention,
            "flash_attention_bias": _Count(flash_attention.flash_attention, "bias_launches"),
            "ffn_gelu": ffn.ffn_gelu,
            "group_norm": norm.group_norm,
            "group_scale_shift": norm.group_scale_shift,
            "layer_norm": norm.layer_norm,
            "rotate_partial": rotary.rotate_partial}


def _flat(out):
    """A module's output (a tensor, or nested tuples of them: the
    ControlNet's residuals) as one flat fp32 tensor."""
    if isinstance(out, (tuple, list)):
        return torch.cat([_flat(o) for o in out])
    return out.float().reshape(-1)


def _reference_error(arch, build, args, kwargs, rounded=True, component="unet"):
    """(max error, mean error, bound) of the port on the card (bf16, kernels)
    against the port's plain fp32 path on the CPU: one tiny UNet (or
    ``component``) forward at the edit batch with every PnP flag on. The
    reference gets the card's own weights and inputs, each rounded to bf16
    once (unless ``rounded`` is false), so that the error is what the card's
    arithmetic adds, not the rounding of its parameters."""
    from anyv2v_torch.utils.model_zoo import build_modules

    cpu = getattr(build(arch, device="cpu", dtype=torch.float32, seed=1), component)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if rounded else (lambda t: t)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(rnd(p))
    card = build_modules(arch, torch.bfloat16)[component]
    card.to_empty(device="cuda").to(torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    card.eval()
    args = [rnd(torch.from_numpy(a)) if isinstance(a, np.ndarray) else a for a in args]
    with torch.inference_mode():
        want = _flat(cpu(*args, **kwargs))
        got = _flat(card(*[a.cuda() if torch.is_tensor(a) else a for a in args],
                         **kwargs)).cpu()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    return diff.max().item(), diff.mean().item(), 0.02 + 0.05 * want.abs().max().item()


def _reference_check(arch, build, args, kwargs, component="unet"):
    err, mean, bound = _reference_error(arch, build, args, kwargs, component=component)
    log(f"reference check ({arch} {component}, bf16 card vs fp32 CPU plain on the card's "
        f"weights and inputs): max_abs_err {err:.3e}, bound {bound:.3e} (0.02 + "
        f"0.05*max|ref|); mean_abs_err {mean:.3e}")
    if not (np.isfinite(err) and err <= bound):
        raise RuntimeError(f"the port on the card disagrees with its CPU reference ({arch})")


def _check_outputs(checks):
    log(f"output checks: {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"output checks failed: {checks}")


def _log_times(path, timers, scans, min_step_s=None):
    """Log every phase time of ``timers`` unrounded; each phase named in
    ``scans`` (name -> UNet steps) must pass ``check_scan_time`` (at
    ``min_step_s`` per step where given, else its default)."""
    from anyv2v_torch.utils.benchguard import check_scan_time

    for name, sec in timers.seconds.items():
        log(f"phase {path} {name}: {sec!r} s")
    floor = {} if min_step_s is None else {"min_step_s": min_step_s}
    for name, steps in scans.items():
        check_scan_time(f"{path} {name}", timers.seconds[name], steps, **floor)


def _read_back_cache(tmp, traj, inv_ts, times):
    from anyv2v_torch.pipelines.common import host_array
    from anyv2v_torch.utils.io import load_ddim_trajectory

    t0 = time.perf_counter()
    traj_np, ts_np = load_ddim_trajectory(tmp, per_step_files=True)
    times["read ddim_latents_{t}.npy"] = time.perf_counter() - t0
    n_files = len([f for f in os.listdir(tmp) if f.startswith("ddim_latents_")])
    if not (np.array_equal(ts_np, inv_ts) and n_files == len(inv_ts)
            and np.array_equal(traj_np, host_array(traj))):
        raise RuntimeError("latent cache files do not read back the trajectory")
    return traj_np, ts_np


def phase_main_path():
    """i2vgen-xl at full width: invert -> cache files -> PnP edit -> decode,
    through the CLIs' per-entry functions. Returns each kernel's launch
    count over this run, and the pipeline (the long-video path reuses it)."""
    from anyv2v_torch.cli.run_group_ddim_inversion import invert_video
    from anyv2v_torch.cli.run_group_pnp_edit import edit_video, output_stem
    from anyv2v_torch.pipelines.i2vgen import PnPConfig
    from anyv2v_torch.utils.model_zoo import build_i2vgen_pipeline
    from anyv2v_torch.utils.profiling import PhaseTimers

    rng = np.random.RandomState(1)
    _reference_check("i2vgen-tiny", build_i2vgen_pipeline,
                     [rng.randn(3, 8, 16, 16, 4).astype(np.float32), 501,
                      rng.randn(3, 77, 32).astype(np.float32), 8,
                      rng.randn(3, 8, 16, 16, 4).astype(np.float32),
                      rng.randn(3, 1, 32).astype(np.float32)], {"pnp": (True, True, True)})

    wrappers = _wrappers()
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
    timers, inv, ed = PhaseTimers("cuda"), {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        with timers.phase("encode+invert+write cache", sync=inv):
            inv["latents"], inv["traj"], inv_ts, *_ = invert_video(
                pipe, video, text_ids=ids, n_steps=INV_STEPS, fps=8, clip_width=512,
                output_dir=tmp)
        latents, traj = inv["latents"], inv["traj"]
        traj_np, ts_np = _read_back_cache(tmp, traj, inv_ts, timers.seconds)

        with timers.phase("PnP edit+decode", sync=ed):
            ed["out"], ed["video"] = edit_video(
                pipe, traj_np, ts_np, video[0], edited_first, text_ids=(ids, ids, ids),
                n_frames=frames, n_steps=EDIT_STEPS, t_idx=0, guidance_scale=9.0, pnp=pnp,
                fps=8, clip_width=512)
        out, edited = ed["out"], ed["video"]
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    _log_times("i2vgen-xl", timers, {"encode+invert+write cache": INV_STEPS,
                                     "PnP edit+decode": EDIT_STEPS})
    log(f"i2vgen-xl main path: invert {INV_STEPS} steps (batch 1) + PnP edit {EDIT_STEPS} steps "
        f"(thresholds 0.2/0.2/0.5: {int(EDIT_STEPS * 0.5)} batch-3 steps, "
        f"{EDIT_STEPS - int(EDIT_STEPS * 0.5)} batch-2 steps); output name "
        f"{output_stem(9.0, EDIT_STEPS, 0, 0.2, 0.2, 0.5)}")
    log(f"i2vgen-xl peak device memory: {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"kernel launches in the i2vgen-xl main path: {counts}")
    _check_outputs({
        "latents [1,16,64,64,4] finite": tuple(latents.shape) == (1, frames, 64, 64, 4)
        and bool(torch.isfinite(latents).all()),
        "trajectory finite": bool(torch.isfinite(traj).all()),
        "edited latents finite": tuple(out.shape) == (1, frames, 64, 64, 4)
        and bool(torch.isfinite(out).all()),
        "video [16,512,512,3] in [0,1]": tuple(edited.shape) == (frames, 512, 512, 3)
        and bool(torch.isfinite(edited).all()) and float(edited.min()) >= 0.0
        and float(edited.max()) <= 1.0,
        # the i2vgen-xl routes are K1-K4, as before K5 existed
        "K1-K4 launched": all(counts[n] > 0 for n in counts
                              if n not in ("flash_attention", "frame_attention_long",
                                           "rotate_partial") + _MODES),
        "KR not launched (i2vgen-xl has no rotary)": counts["rotate_partial"] == 0,
        "K1's short body launched (the image-latent encoder, the short-key class)":
        counts["folded_attention_short"] > 0,
        "K5 and K2 long not launched": counts["flash_attention"] == 0
        and counts["frame_attention_long"] == 0,
    })

    def i2vgen_args(batch, g):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        kw = {"pnp": (True, True, True)} if batch == 3 else {}
        return (rn(batch, 16, 64, 64, 4), 501, rn(batch, 77, 1024, scale=0.1), 8,
                rn(batch, 16, 64, 64, 4), rn(batch, 1, 1024, scale=0.1)), kw

    phase_profile(pipe, "i2vgen-xl", i2vgen_args)
    return counts, pipe


LONG_FRAMES = 128
LONG_INV_STEPS, LONG_CHUNK, LONG_EDIT_STEPS = 4, 2, 2
TEMPORAL_PER_FORWARD = 34   # i2vgen-xl: 17 temporal transformers of 2 attentions


class _PhaseTimer:
    """Wall seconds of a pipeline's encode, UNet forwards (by batch), decode
    and host-store copies, each between two synchronisations, by wrapping
    the pipeline instance's methods and ``HostTrajectory.append``."""

    def __init__(self, pipe):
        self.pipe, self.times = pipe, {}

    def _add(self, key, sec):
        self.times.setdefault(key, []).append(sec)

    def _wrap(self, fn, key_of):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self._add(key_of(*a), time.perf_counter() - t0)
            return out
        return call

    def __enter__(self):
        from anyv2v_torch.pipelines.common import HostTrajectory

        p = self.pipe
        p.encode_video = self._wrap(p.encode_video, lambda *a: "VAE encode")
        p.decode_latents = self._wrap(p.decode_latents, lambda *a: "VAE decode")
        p._eps = self._wrap(p._eps, lambda x, *a: f"UNet forward batch {x.shape[0]}")
        self.append = HostTrajectory.append
        HostTrajectory.append = self._wrap(self.append, lambda *a: "copy a chunk to the host")
        return self

    def __exit__(self, *exc):
        from anyv2v_torch.pipelines.common import HostTrajectory

        for name in ("encode_video", "decode_latents", "_eps"):
            del self.pipe.__dict__[name]
        HostTrajectory.append = self.append


def phase_long_video(pipe):
    """i2vgen-xl long video at full width: 128 frames at 512^2 through the
    CLIs' per-entry functions, the trajectory in host memory (two chunks of
    2 steps), the cache files, a PnP edit of one batch-3 injection step and
    one batch-2 tail step, decode. Returns each kernel's launch count over
    this run, and the profiled wall ms of one unsharded UNet forward by
    batch (1 and 3)."""
    from anyv2v_torch.cli.run_group_ddim_inversion import invert_video
    from anyv2v_torch.cli.run_group_pnp_edit import edit_video
    from anyv2v_torch.pipelines.common import HostTrajectory
    from anyv2v_torch.pipelines.i2vgen import PnPConfig
    from anyv2v_torch.utils.model_zoo import build_i2vgen_pipeline
    from anyv2v_torch.utils.profiling import PhaseTimers

    rng = np.random.RandomState(6)
    _reference_check("i2vgen-tiny", build_i2vgen_pipeline,
                     [rng.randn(3, 40, 16, 16, 4).astype(np.float32), 501,
                      rng.randn(3, 77, 32).astype(np.float32), 8,
                      rng.randn(3, 40, 16, 16, 4).astype(np.float32),
                      rng.randn(3, 1, 32).astype(np.float32)], {"pnp": (True, True, True)})

    frames = LONG_FRAMES
    video = _synthetic_video(np.random.RandomState(7), frames, 512)
    edited_first = np.ascontiguousarray(video[0][:, :, ::-1])   # colour-swapped edit
    ids = np.zeros((1, 77), np.int64)
    pnp = PnPConfig(0.5, 0.5, 0.5)   # 2 steps: step 0 injects every family, step 1 is the tail

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    timers, inv, ed = PhaseTimers("cuda"), {}, {}
    with tempfile.TemporaryDirectory() as tmp, _RouteLog() as routes, _PhaseTimer(pipe) as pt:
        # hard_sync checks the host trajectory's chunks with the latents
        with timers.phase("encode+invert+write cache", sync=inv):
            inv["latents"], inv["store"], inv_ts, *_ = invert_video(
                pipe, video, text_ids=ids, n_steps=LONG_INV_STEPS, fps=8, clip_width=512,
                output_dir=tmp, chunk_steps=LONG_CHUNK, traj_store="host")
        latents, store = inv["latents"], inv["store"]
        traj_np, ts_np = _read_back_cache(tmp, store, inv_ts, timers.seconds)

        with timers.phase("PnP edit+decode", sync=ed):
            ed["out"], ed["video"] = edit_video(
                pipe, traj_np, ts_np, video[0], edited_first, text_ids=(ids, ids, ids),
                n_frames=frames, n_steps=LONG_EDIT_STEPS, t_idx=0, guidance_scale=9.0, pnp=pnp,
                fps=8, clip_width=512)
        out, edited = ed["out"], ed["video"]
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    _log_times("i2vgen-xl long video", timers, {"encode+invert+write cache": LONG_INV_STEPS,
                                                "PnP edit+decode": LONG_EDIT_STEPS})
    for name, secs in pt.times.items():
        log(f"phase i2vgen-xl long video {name}: {len(secs)} x, "
            + ", ".join(f"{s:.3f}" for s in secs) + " s")
    n_forwards = LONG_INV_STEPS + LONG_EDIT_STEPS
    n_chunks = len(pt.times.get("copy a chunk to the host", []))
    log(f"i2vgen-xl long video: {frames} frames at 512x512, invert {LONG_INV_STEPS} steps "
        f"(batch 1, host store, chunks of {LONG_CHUNK}: {store.nbytes} bytes in "
        f"{n_chunks} chunks) + PnP edit {LONG_EDIT_STEPS} steps (thresholds "
        f"0.5/0.5/0.5: 1 batch-3 step, 1 batch-2 step)")
    log(f"i2vgen-xl long video peak device memory: {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated; the card holds "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB)")
    log(f"kernel launches in the i2vgen-xl long-video path: {counts}")
    log(f"i2vgen-xl long video routes: K2 by shape {routes.k2}; K5 by role {routes.k5}; "
        f"SDPA through the dispatcher by head width {routes.sdpa}")
    shape = (1, frames, 64, 64, 4)
    _check_outputs({
        f"latents {list(shape)} finite": tuple(latents.shape) == shape
        and bool(torch.isfinite(latents).all()),
        f"host store of {LONG_INV_STEPS} rows in {LONG_INV_STEPS // LONG_CHUNK} chunks, finite":
        isinstance(store, HostTrajectory) and store.shape == (LONG_INV_STEPS,) + shape
        and n_chunks == LONG_INV_STEPS // LONG_CHUNK
        and bool(np.isfinite(np.asarray(store)).all()),
        "edited latents finite": tuple(out.shape) == shape and bool(torch.isfinite(out).all()),
        f"video [{frames},512,512,3] in [0,1]": tuple(edited.shape) == (frames, 512, 512, 3)
        and bool(torch.isfinite(edited).all()) and float(edited.min()) >= 0.0
        and float(edited.max()) <= 1.0,
        f"UNet forwards: {LONG_INV_STEPS} at batch 1, 1 at batch 3, 1 at batch 2":
        [len(pt.times.get(f"UNet forward batch {b}", [])) for b in (1, 3, 2)]
        == [LONG_INV_STEPS, 1, 1],
        f"K2 long on all {TEMPORAL_PER_FORWARD} temporal attentions of {n_forwards} forwards":
        counts["frame_attention_long"] == TEMPORAL_PER_FORWARD * n_forwards
        and sum(routes.k2.values()) == counts["frame_attention_long"]
        and all(key.startswith("long S128 Sk128") for key in routes.k2),
        "K2 (S <= 32) not launched": counts["frame_attention"] == 0,
        "K1, K3, K4 launched; K5 not": all(counts[n] > 0 for n in (
            "folded_attention", "ffn_geglu", "gn_silu_temporal_conv"))
        and counts["flash_attention"] == 0,
        "peak device memory under 80 GB": peak < 80e9,
    })

    def long_args(batch, g):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        kw = {"pnp": (True, True, True)} if batch == 3 else {}
        return (rn(batch, frames, 64, 64, 4), 501, rn(batch, 77, 1024, scale=0.1), 8,
                rn(batch, frames, 64, 64, 4), rn(batch, 1, 1024, scale=0.1)), kw

    # batch 1 too: the unsharded forwards beside phase 13's per-rank ones
    return counts, phase_profile(pipe, "i2vgen-xl 128 frames", long_args, batches=(1, 3))


SHARD_RANKS = 4


def _mocked(forward):
    """``forward`` as one rank's program of a SHARD_RANKS-rank frame split,
    every collective a local op of the same shape."""
    from anyv2v_torch.parallel.mesh import mock_manual_axis

    def call(*a, **kw):
        with mock_manual_axis(SHARD_RANKS):
            return forward(*a, **kw)
    return call


def _per_rank_run(path, forward, make_args, batches, k2_key, k5_role=None):
    """The per-rank forwards of ``path``: the launch counts of one forward at
    each of ``batches`` (counts set to 0 just before, read just after), its
    routes, its outputs' shapes and finiteness, then each forward's device
    time by CUDA events (2 calls after a warm-up). The counts also hold
    ``group_norm_gathered``: KN's group norms whose statistics spanned every
    rank's share. Returns (counts, routes, outputs' checks, ms by batch)."""
    from anyv2v_torch.ops import norm

    wrappers = _wrappers()
    g = torch.Generator(device="cuda").manual_seed(3)
    inputs = {b: make_args(b, g) for b in batches}
    for w in wrappers.values():
        w.launches = 0
    norm.group_norm.gathered_launches = 0
    outs = {}
    with torch.inference_mode(), _RouteLog(k5_role or _consisti2v_k5_role) as routes:
        for b in batches:
            args, kw = inputs[b]
            outs[b] = forward(*args, **kw)
        torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    counts["group_norm_gathered"] = norm.group_norm.gathered_launches
    finite = {b: (tuple(o.shape), bool(torch.isfinite(o).all())) for b, o in outs.items()}
    del outs
    ms = {}
    with torch.inference_mode():
        for b in batches:
            args, kw = inputs[b]
            ms[b] = _time_ms(lambda: forward(*args, **kw), 2)
            log(f"{path} UNet forward batch {b}: {ms[b]:.1f} ms (CUDA events, mean of 2 after "
                f"a warm-up)")
    log(f"kernel launches in the {path} forwards (batches {list(batches)}): {counts}")
    log(f"{path} routes: K2 by shape {routes.k2}; K5 by role {routes.k5}; SDPA through the "
        f"dispatcher by head width {routes.sdpa}")
    if not all(key.startswith(k2_key) for key in routes.k2):
        raise RuntimeError(f"{path}: a temporal attention off {k2_key}: {routes.k2}")
    return counts, routes, finite, ms


def phase_sharded(pipe, unsharded_ms):
    """One rank's program of i2vgen-xl's 128-frame path split over 4 ranks,
    on this card (``mock_manual_axis``): 32 frames per rank, the image
    latents whole, every frame-coupled op at its per-rank shape (K2 long at
    all 128 frames over a quarter of the pixels, K4 likewise with the
    all-reduced moments' s, t; KN's temporal transformer norms on every
    rank's gathered partials). One forward at batch 3 (every PnP flag on)
    and one at batch 1, timed by CUDA events beside phase 5's unsharded
    forwards (``unsharded_ms``: their profiled wall ms by batch), then
    profiled by kernel group. The collectives are local copies
    of the same shapes: the outputs mean nothing, and are only checked
    finite. Returns each kernel's launch count over the two forwards."""
    frames, f_loc = LONG_FRAMES, LONG_FRAMES // SHARD_RANKS

    def args(batch, g):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        kw = {"pnp": (True, True, True)} if batch == 3 else {}
        return (rn(batch, f_loc, 64, 64, 4), 501, rn(batch, 77, 1024, scale=0.1), 8,
                rn(batch, frames, 64, 64, 4), rn(batch, 1, 1024, scale=0.1)), kw

    forward = _mocked(pipe.unet)
    counts, routes, finite, ms = _per_rank_run(
        "i2vgen-xl per rank of 4 (128 frames)", forward, args, (3, 1), "long S128 Sk128")
    for b in (3, 1):
        whole = unsharded_ms.get(b)
        log(f"i2vgen-xl 128 frames batch {b}: one rank of 4 {ms[b]:.1f} ms"
            + ("" if whole is None else f", the unsharded forward {whole:.1f} ms (phase 5's "
               f"profiled wall), ratio {whole / ms[b]:.2f}"))
    _check_outputs({
        **{f"batch {b} per-rank output [{b},{f_loc},64,64,4] finite":
           finite[b] == ((b, f_loc, 64, 64, 4), True) for b in (3, 1)},
        f"K2 long on all {TEMPORAL_PER_FORWARD} temporal attentions of 2 forwards, at S128":
        counts["frame_attention_long"] == 2 * TEMPORAL_PER_FORWARD
        and sum(routes.k2.values()) == counts["frame_attention_long"],
        "K2 (S <= 32) and K5 not launched": counts["frame_attention"] == 0
        and counts["flash_attention"] == 0,
        "K1, K3, K4 launched": all(counts[n] > 0 for n in (
            "folded_attention", "ffn_geglu", "gn_silu_temporal_conv")),
        f"KN's group norm over every rank's frames in all {TEMPORAL_PER_FORWARD // 2} temporal "
        "transformers of 2 forwards": counts["group_norm"] > 0
        and counts["group_norm_gathered"] == TEMPORAL_PER_FORWARD,
    })

    phase_profile(pipe, "i2vgen-xl per rank of 4 (128 frames)", args, forward=forward)
    return counts


def phase_sharded_backbone(arch, unet, make_args, k2_key, k5_role=None):
    """One rank's program of ``arch``'s 16-frame path split over 4 ranks on
    this card: 4 frames per rank (ConsistI2V's conditioning frame on every
    rank), one forward at batch 3 and one at batch 1, outputs finite, K2 at
    the whole frame axis (``k2_key``). Returns the launch counts."""
    f_loc = 16 // SHARD_RANKS
    counts, routes, finite, ms = _per_rank_run(
        f"{arch} per rank of 4 (16 frames)", _mocked(unet),
        lambda b, g: make_args(b, g, f_loc), (3, 1), k2_key, k5_role)
    _check_outputs({
        **{f"batch {b} per-rank output [{b},{f_loc},64,64,4] finite":
           finite[b] == ((b, f_loc, 64, 64, 4), True) for b in (3, 1)},
        "K2, K3 and KR launched": all(counts[n] > 0 for n in (
            "frame_attention", "ffn_geglu", "rotate_partial")),
        "K2 long not launched": counts["frame_attention_long"] == 0,
    })
    return counts


# the NCCL leg: the 16-frame i2vgen-xl forward and invert + edit on n GPUs
# against one
NCCL_FRAMES, NCCL_INV_STEPS, NCCL_EDIT_STEPS = 16, 4, 2
NCCL_TIMEOUT_S = 900


def _nccl_forward(pipe, region=None, rank=0, world=1, size=512):
    """One i2vgen UNet forward at the edit batch (3 rows, every PnP flag on)
    on seeded inputs made whole on every device; with ``region`` (the frame
    group and its size) this rank's frames in a manual-SPMD region, the
    outputs gathered. Returns the host array."""
    from anyv2v_torch.parallel.mesh import gather_frames, manual_axis

    g = torch.Generator(device=pipe.device).manual_seed(5)
    hw, ctx = size // 8, pipe.unet.config.cross_attention_dim

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=pipe.device) * scale

    sample = rn(3, NCCL_FRAMES, hw, hw, 4)
    args = (501, rn(3, 77, ctx, scale=0.1), 8, rn(3, NCCL_FRAMES, hw, hw, 4),
            rn(3, 1, ctx, scale=0.1))
    with torch.inference_mode():
        if region is None:
            return pipe.unet(sample, *args, pnp=(True, True, True)).float().cpu().numpy()
        f = NCCL_FRAMES // world
        with manual_axis(*region):
            eps = pipe.unet(sample[:, rank * f:(rank + 1) * f].contiguous(), *args,
                            pnp=(True, True, True))
        return gather_frames(eps, region[0], 1).float().cpu().numpy()


def _nccl_workload(pipe, size=512):
    """invert NCCL_INV_STEPS + PnP edit NCCL_EDIT_STEPS (thresholds
    0.5/0.5/0.5: a batch-3 step, then the batch-2 tail) of a seeded
    synthetic 16-frame video through the CLIs' per-entry functions. The edit
    runs at guidance 1, so that its distance to one device shows the
    sharded path's bf16 drift and not the guidance weight's amplification of
    it. Returns the host arrays of the
    trajectory, the edited latents and the video, and the seconds of each
    stage (between synchronisations)."""
    from anyv2v_torch.cli.run_group_ddim_inversion import invert_video
    from anyv2v_torch.cli.run_group_pnp_edit import edit_video
    from anyv2v_torch.pipelines.i2vgen import PnPConfig

    video = _synthetic_video(np.random.RandomState(9), NCCL_FRAMES, size)
    ids = np.zeros((1, 77), np.int64)
    cuda = pipe.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    _, traj, inv_ts, *_ = invert_video(pipe, video, text_ids=ids, n_steps=NCCL_INV_STEPS, fps=8,
                                       clip_width=size)
    sync()
    t1 = time.perf_counter()
    out, edited = edit_video(pipe, traj, inv_ts, video[0], np.ascontiguousarray(video[0][::-1]),
                             text_ids=(ids, ids, ids), n_frames=NCCL_FRAMES,
                             n_steps=NCCL_EDIT_STEPS, t_idx=0, guidance_scale=1.0,
                             pnp=PnPConfig(0.5, 0.5, 0.5), fps=8, clip_width=size)
    sync()
    t2 = time.perf_counter()
    return ({"traj": traj.float().cpu().numpy(), "out": out.float().cpu().numpy(),
             "video": edited.float().cpu().numpy()},
            {"encode+invert": t1 - t0, "edit+decode": t2 - t1})


def nccl_rank_main(rank, world, port, out_dir, backend="nccl", device="cuda",
                   arch="i2vgen-xl", size=512, dtype=torch.bfloat16):
    """One rank of the NCCL leg: join the group, build ``arch`` with the
    frame mesh (the same seeded weights on every rank), run one sharded UNet
    forward and :func:`_nccl_workload`, write the arrays to
    ``<out_dir>/<rank>.npz``."""
    import torch.distributed as dist

    from anyv2v_torch.parallel.mesh import make_mesh
    from anyv2v_torch.utils.model_zoo import build_i2vgen_pipeline

    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(1, world, device_type=device)
        pipe = build_i2vgen_pipeline(arch, device=device, seed=0, dtype=dtype, mesh=mesh)
        wrappers = _wrappers()
        for w in wrappers.values():
            w.launches = 0
        arrays = {"forward": _nccl_forward(pipe, (mesh.get_group("frame"), world), rank, world,
                                           size)}
        with torch.inference_mode():
            workload, secs = _nccl_workload(pipe, size)
        arrays.update(workload)
        np.savez(os.path.join(out_dir, f"{rank}.npz"), **arrays)
        log(f"NCCL rank {rank}/{world}: {secs} s; kernel launches "
            f"{ {n: w.launches for n, w in wrappers.items()} }")
    finally:
        dist.destroy_process_group()
    return 0


def phase_nccl(pipe):
    """The sharded path across cards, where two or more GPUs are visible: 2
    or 4 NCCL ranks (one process per GPU, this script with
    ``--nccl-rank``) run one i2vgen-xl UNet forward and the 16-frame invert
    + edit at full width on the frame mesh, against this process's
    single-GPU runs, by :func:`nccl_checks`. With one GPU visible the leg
    does not run, and says so."""
    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        log(f"sharded NCCL leg: NOT RUN ({n_gpu} GPU visible; it needs 2 or more) - the "
            "collectives across cards are not exercised by this run")
        return
    world = 4 if n_gpu >= 4 else 2
    want = {"forward": _nccl_forward(pipe)}
    with torch.inference_mode():
        workload, secs = _nccl_workload(pipe)
    want.update(workload)
    log(f"NCCL leg single-GPU reference: {secs} s")
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--nccl-rank",
                                   str(r), str(world), str(port), out_dir])
                 for r in range(world)]
        deadline = time.monotonic() + NCCL_TIMEOUT_S
        try:
            for proc in procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        rcs = [proc.returncode for proc in procs]
        if any(rcs):
            raise RuntimeError(f"NCCL leg: rank exit codes {rcs}")
        got = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"{r}.npz")) as arrays:
                got.append(dict(arrays))
    checks, errors = nccl_checks(want, got)
    log(f"sharded NCCL leg on {world} GPUs of {n_gpu} (max_abs_err, bound) against one GPU "
        f"(the edit's out and video reported, not held): {errors}")
    _check_outputs(checks)


NCCL_HELD = ("forward", "traj")


def nccl_checks(want, got_by_rank):
    """The NCCL leg's checks of every rank's arrays (``got_by_rank``) against
    the single-device run's (``want``): the forward and the trajectory
    within 0.02 + 0.05*max|ref| (the tiny reference checks' bf16 bound); the
    edited latents and video finite, of the whole clip's shape; every
    array equal on every rank (each rank gathers the whole clip). The
    edit's distance to one device is reported and not held: its last step
    returns the x0 prediction, which divides the UNet's bf16 differences
    (the sharded forwards' smaller GEMMs round otherwise) by sqrt(alpha) of
    a noisy step, and decoding spreads them further; on four H100s a
    2-step guidance-1 edit's latents moved 0.111 (bound 0.101) and its
    video 0.242 (bound 0.07). The fp32 gloo tests hold the sharded edit
    loop to one process. Returns (checks, {"rank r key": (max_abs_err,
    bound)})."""
    checks, errors = {}, {}
    for r, got in enumerate(got_by_rank):
        for key, ref in want.items():
            shaped = got[key].shape == ref.shape
            err = float(np.abs(got[key] - ref).max()) if shaped else float("inf")
            bound = 0.02 + 0.05 * float(np.abs(ref).max())
            errors[f"rank {r} {key}"] = (err, bound)
            if key in NCCL_HELD:
                checks[f"NCCL rank {r} {key} within its bound"] = bool(np.isfinite(err)
                                                                      and err <= bound)
            else:
                checks[f"NCCL rank {r} {key} finite, the whole clip's shape"] = bool(
                    shaped and np.isfinite(got[key]).all())
        checks[f"NCCL rank {r} equal to rank 0"] = all(
            np.array_equal(got[key], got_by_rank[0][key]) for key in want)
    return checks, errors


def _consisti2v_k5_role(q, k, heads, k_ctx):
    if k_ctx is not None:
        return "split-KV"
    return "spatial cross" if q.shape[-1] // heads == 64 else "temporal cross"


class _RouteLog:
    """Records which attention routes a UNet takes: the roles of K5's calls
    (``k5_role(q, k, heads, k_ctx)``; " bias" appended to a biased call's),
    the key axes and bias of K2's (K2 long's with a "long " prefix), and the
    head widths of calls that reach the dispatcher's SDPA (CLIP calls SDPA
    directly and is not seen), those with a mask or bias apart
    (``sdpa_masked``). It wraps the dispatcher's references and calls
    through, so the wrappers' own launch counts are untouched. It also
    counts the GELU-form ``FeedForward`` calls (``gelu``: "fits" where K3's
    range takes them, else "unfused")."""

    def __init__(self, k5_role=_consisti2v_k5_role):
        from anyv2v_torch.models import layers
        from anyv2v_torch.ops import attention

        self.mod, self.k5, self.k2, self.sdpa = attention, {}, {}, {}
        self.sdpa_masked, self.gelu = {}, {"fits": 0, "unfused": 0}
        self.layers, self.ff_forward = layers, layers.FeedForward.forward
        self.k5_role = k5_role
        self.saved = {n: getattr(attention, n) for n in (
            "flash_attention", "frame_attention", "frame_attention_long", "sdpa_attention")}

    def _bump(self, table, key):
        table[key] = table.get(key, 0) + 1

    def __enter__(self):
        saved, ff_forward = self.saved, self.ff_forward

        def flash(q, k, v, heads, scale, k_ctx=None, v_ctx=None, frames=1, bias=None):
            self._bump(self.k5, self.k5_role(q, k, heads, k_ctx)
                       + ("" if bias is None else " bias"))
            return saved["flash_attention"](q, k, v, heads, scale, k_ctx, v_ctx, frames, bias)

        def feed_forward(module, x):
            if module.activation == "gelu":
                from anyv2v_torch.ops.ffn import fits

                fit = fits(x.shape[-1], module.net[2].in_features)
                self.gelu["fits" if fit else "unfused"] += 1
            return ff_forward(module, x)

        def frame(name):
            def call(q, k, v, heads, scale, bias=None):
                self._bump(self.k2, ("long " if name.endswith("long") else "")
                           + f"S{q.shape[1]} Sk{k.shape[1]} dh{q.shape[-1] // heads}"
                           + ("" if bias is None else " bias"))
                return saved[name](q, k, v, heads, scale, bias)
            return call

        def sdpa(q, k, v, heads, scale, causal=False, attn_mask=None):
            self._bump(self.sdpa if attn_mask is None else self.sdpa_masked,
                       q.shape[-1] // heads)
            return saved["sdpa_attention"](q, k, v, heads, scale, causal, attn_mask)

        self.mod.flash_attention, self.mod.sdpa_attention = flash, sdpa
        self.mod.frame_attention = frame("frame_attention")
        self.mod.frame_attention_long = frame("frame_attention_long")
        self.layers.FeedForward.forward = feed_forward
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.mod, n, f)
        self.layers.FeedForward.forward = self.ff_forward

    def mode_checks(self, counts):
        """The checks of the two operand modes that no backbone reaches, for
        a path's launch ``counts``: every biased attention call that K5 takes
        launched its bias instances, none at one of K5's widths reached SDPA,
        and every GELU-form feed-forward call in K3's range launched K3's
        GELU form (all hold where a path has no such call)."""
        from anyv2v_torch.ops.flash_attention import HEAD_DIMS

        k5_biased = sum(n for role, n in self.k5.items() if role.endswith(" bias"))
        log(f"operand modes: K5 biased calls {k5_biased} (launches "
            f"{counts['flash_attention_bias']}); SDPA with a mask or bias by head width "
            f"{self.sdpa_masked}; GELU-form feed-forwards {self.gelu} (K3 GELU launches "
            f"{counts['ffn_gelu']})")
        return {
            "every biased attention call that K5 takes launched it":
            k5_biased == counts["flash_attention_bias"]
            and not set(self.sdpa_masked) & set(HEAD_DIMS),
            "every GELU-form feed-forward call in K3's range launched it":
            self.gelu["fits"] == counts["ffn_gelu"],
        }


def phase_consisti2v():
    """ConsistI2V at full width: invert -> cache files -> dual-CFG PnP edit ->
    decode, through the CLIs' per-entry functions. Returns each kernel's
    launch count over this run, and the pipeline."""
    from anyv2v_torch.cli.consisti2v_run_ddim_inversion import invert_video
    from anyv2v_torch.cli.consisti2v_run_pnp_edit import edit_video, output_stem
    from anyv2v_torch.pipelines.i2vgen import PnPConfig
    from anyv2v_torch.utils.model_zoo import build_consisti2v_pipeline
    from anyv2v_torch.utils.profiling import PhaseTimers

    rng = np.random.RandomState(2)
    _reference_check("consisti2v-tiny", build_consisti2v_pipeline,
                     [rng.randn(3, 8, 16, 16, 4).astype(np.float32), 501,
                      rng.randn(3, 77, 32).astype(np.float32),
                      rng.randn(3, 1, 16, 16, 4).astype(np.float32), 3],
                     {"pnp": (True, True, True), "pnp_chunks": 3})

    wrappers = _wrappers()
    t0 = time.perf_counter()
    pipe = build_consisti2v_pipeline("consisti2v", device="cuda", seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder)
                   for p in m.parameters())
    log(f"pipeline consisti2v built with seeded random bf16 weights: {n_params} parameters "
        f"in {time.perf_counter() - t0:.2f} s")

    frames = 17           # the conditioning frame and 16 frames
    video = _synthetic_video(np.random.RandomState(3), frames, 512)
    edited_first = np.ascontiguousarray(video[0][:, :, ::-1])   # colour-swapped edit
    ids = np.zeros((1, 77), np.int64)
    pnp = PnPConfig(0.2, 0.2, 0.5)
    cfg_txt, cfg_img = 35.0, 1.0

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    timers, inv, ed = PhaseTimers("cuda"), {}, {}
    with tempfile.TemporaryDirectory() as tmp, _RouteLog() as routes:
        with timers.phase("encode+invert+write cache", sync=inv):
            inv["latents"], inv["traj"], inv_ts = invert_video(
                pipe, video, text_ids=ids, n_steps=INV_STEPS, frame_stride=3, output_dir=tmp)
        latents, traj = inv["latents"], inv["traj"]
        traj_np, ts_np = _read_back_cache(tmp, traj, inv_ts, timers.seconds)

        with timers.phase("PnP edit+decode", sync=ed):
            ed["out"], ed["video"] = edit_video(
                pipe, traj_np, ts_np, video[0], edited_first, text_ids=(ids, ids, ids),
                n_steps=EDIT_STEPS, t_idx=0, cfg_txt=cfg_txt, cfg_img=cfg_img, pnp=pnp,
                frame_stride=3)
        out, edited = ed["out"], ed["video"]
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    edited_ff = pipe.encode_video(edited_first[None])

    _log_times("consisti2v", timers, {"encode+invert+write cache": INV_STEPS,
                                      "PnP edit+decode": EDIT_STEPS})
    n_pnp = int(EDIT_STEPS * 0.5)
    log(f"consisti2v main path: invert {INV_STEPS} steps (batch 1, {frames} frames) + PnP edit "
        f"{EDIT_STEPS} steps at cfg_txt {cfg_txt} / cfg_img {cfg_img} (guidance 'text': "
        f"{n_pnp} batch-3 steps, {EDIT_STEPS - n_pnp} batch-2 steps); output name "
        f"{output_stem(cfg_txt, cfg_img, EDIT_STEPS, 0)}")
    log(f"consisti2v peak device memory: {peak / 2**30:.2f} GiB "
        "(torch.cuda.max_memory_allocated)")
    log(f"kernel launches in the consisti2v main path: {counts}")
    log(f"consisti2v routes: K5 by role {routes.k5}; K2 by shape {routes.k2}; "
        f"SDPA (UNet and VAE) by head width {routes.sdpa}")
    shape = (1, frames, 64, 64, 4)
    _check_outputs({
        f"latents {list(shape)} finite": tuple(latents.shape) == shape
        and bool(torch.isfinite(latents).all()),
        "trajectory finite, clean frame 0 in every row": bool(torch.isfinite(traj).all())
        and bool((traj[:, :, :1] == latents[:, :1].float()).all()),
        "edited latents finite, frame 0 the edited image": tuple(out.shape) == shape
        and bool(torch.isfinite(out).all())
        and float((out[:, :1] - edited_ff).abs().max()) <= 1e-3,
        f"video [{frames},512,512,3] in [0,1]": tuple(edited.shape) == (frames, 512, 512, 3)
        and bool(torch.isfinite(edited).all()) and float(edited.min()) >= 0.0
        and float(edited.max()) <= 1.0,
        "K1-K5 and KR launched": all(c > 0 for n, c in counts.items()
                                     if n not in ("frame_attention_long",) + _MODES + _SUBS),
        "K5 in its three roles": set(routes.k5) == {"split-KV", "spatial cross",
                                                   "temporal cross"},
        "K2 with Sk 25": any(key.startswith("S17 Sk25") for key in routes.k2),
        "no dh 40/64/80 attention on SDPA": not set(routes.sdpa) & {40, 64, 80},
    })

    def consisti2v_args(batch, g):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        kw = {"pnp": (True, True, True), "pnp_chunks": 3} if batch == 3 else {}
        return (rn(batch, 16, 64, 64, 4), 501, rn(batch, 77, 1024, scale=0.1),
                rn(batch, 1, 64, 64, 4), 3), kw

    phase_profile(pipe, "consisti2v", consisti2v_args)
    return counts, pipe


def consisti2v_rank_args(batch, g, frames):
    """A full-width ConsistI2V UNet forward's inputs at ``frames`` denoised
    frames, the conditioning frame apart; every PnP flag on at batch 3."""
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale
    kw = {"pnp": (True, True, True), "pnp_chunks": 3} if batch == 3 else {}
    return (rn(batch, frames, 64, 64, 4), 501, rn(batch, 77, 1024, scale=0.1),
            rn(batch, 1, 64, 64, 4), 3), kw


# ---------------------------------------------------------------------------
# checkpoint folders in the diffusers layout, written from seeded weights
# (the CPU tests write their tiny folders with the same functions)
# ---------------------------------------------------------------------------

_ST_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
             torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def write_safetensors(path, tensors):
    """A ``.safetensors`` file: 8-byte little-endian header length, the JSON
    header (names, dtypes, shapes, byte offsets; padded to 8 bytes), then
    each tensor's raw little-endian bytes."""
    tensors = {k: v.detach().cpu().contiguous() for k, v in tensors.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())


def hf_config(cfg):
    """The diffusers / transformers ``config.json`` of a port config: the
    fields the checkpoint converters read, in the published checkpoints'
    conventions (the UNets' head COUNT under ``attention_head_dim``, one per
    level for ConsistI2V's SD2.1 base and SDXL)."""
    from anyv2v_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
    from anyv2v_torch.models.unet_i2vgen import I2VGenUNetConfig
    from anyv2v_torch.models.unet_sd import SDUNetConfig
    from anyv2v_torch.models.unet_seine import SeineUNetConfig
    from anyv2v_torch.models.unet_videoldm import VideoLDMUNetConfig
    from anyv2v_torch.models.vae import VAEConfig

    if isinstance(cfg, (CLIPTextConfig, CLIPVisionConfig)):
        out = {"hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
               "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
               "hidden_act": cfg.hidden_act}
        if isinstance(cfg, CLIPTextConfig):
            return {"architectures": ["CLIPTextModel"], **out,
                    "max_position_embeddings": cfg.max_position_embeddings,
                    "vocab_size": cfg.vocab_size}
        return {"architectures": ["CLIPVisionModelWithProjection"], **out,
                "image_size": cfg.image_size, "patch_size": cfg.patch_size,
                "num_channels": cfg.num_channels, "projection_dim": cfg.projection_dim}
    boc = list(cfg.block_out_channels)
    if isinstance(cfg, VAEConfig):
        return {"_class_name": "AutoencoderKL", "in_channels": cfg.in_channels,
                "out_channels": cfg.out_channels, "latent_channels": cfg.latent_channels,
                "block_out_channels": boc, "layers_per_block": cfg.layers_per_block,
                "norm_num_groups": cfg.norm_num_groups, "scaling_factor": cfg.scaling_factor}
    n = len(boc)
    unet = {"in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
            "block_out_channels": boc, "layers_per_block": cfg.layers_per_block,
            "cross_attention_dim": cfg.cross_attention_dim,
            "norm_num_groups": cfg.norm_num_groups}
    if isinstance(cfg, I2VGenUNetConfig):
        if not cfg.num_attention_heads:
            raise ValueError("i2vgen-xl's config.json holds one head count: set "
                             "num_attention_heads")
        return {"_class_name": "I2VGenXLUNet", **unet, "num_attention_heads": None,
                "attention_head_dim": cfg.num_attention_heads,
                "down_block_types": ["CrossAttnDownBlock3D"] * (n - 1) + ["DownBlock3D"],
                "up_block_types": ["UpBlock3D"] + ["CrossAttnUpBlock3D"] * (n - 1)}
    if isinstance(cfg, SDUNetConfig):   # the editors: SDXL's addition embedding and depths
        def per_level(v):
            return list(v) if isinstance(v, tuple) else v
        out = {"_class_name": "UNet2DConditionModel", **unet,
               "down_block_types": [("CrossAttnDownBlock2D" if c else "DownBlock2D")
                                    for c in cfg.cross_attn_blocks],
               "up_block_types": [("CrossAttnUpBlock2D" if c else "UpBlock2D")
                                  for c in reversed(cfg.cross_attn_blocks)],
               "attention_head_dim": per_level(cfg.num_attention_heads),
               "transformer_layers_per_block": per_level(cfg.transformer_depth),
               "use_linear_projection": cfg.linear_projection}
        if cfg.addition_embed == "sdxl":
            out.update(addition_embed_type="text_time",
                       addition_time_embed_dim=cfg.addition_time_embed_dim,
                       projection_class_embeddings_input_dim=cfg.
                       projection_class_embeddings_input_dim)
        return out
    blocks = {"down_block_types": ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"],
              "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * (n - 1)}
    if isinstance(cfg, VideoLDMUNetConfig):
        return {"_class_name": "VideoLDMUNet3DConditionModel", **unet, **blocks,
                "attention_head_dim": [c // cfg.attention_head_dim for c in boc],
                "n_temp_heads": cfg.n_temp_heads,
                "first_frame_condition_mode": cfg.first_frame_condition_mode,
                "temp_pos_embedding": cfg.temp_pos_embedding,
                "augment_temporal_attention": cfg.augment_temporal_attention,
                "use_frame_stride_condition": cfg.use_frame_stride_condition,
                "use_temporal": cfg.use_temporal}
    if isinstance(cfg, SeineUNetConfig):   # SD1.4's unet/config.json: 4 input channels
        return {"_class_name": "UNet2DConditionModel", **unet, **blocks, "in_channels": 4,
                "attention_head_dim": cfg.num_attention_heads}
    raise TypeError(type(cfg).__name__)


SUBFOLDERS = {"unet": "unet", "vae": "vae", "text": "text_encoder", "vision": "image_encoder"}


def write_snapshot(folder, components, shards=None):
    """A diffusers-layout snapshot: for each ``{component: (config, state
    dict or None)}`` a subfolder with its ``config.json`` and, given a state
    dict, its weights (``shards[component]`` safetensors files, default 1)."""
    for name, (cfg, sd) in components.items():
        sub = os.path.join(folder, SUBFOLDERS[name])
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, "config.json"), "w") as f:
            json.dump(hf_config(cfg), f, indent=1)
        if sd is None:
            continue
        stem = "diffusion_pytorch_model" if name in ("unet", "vae") else "model"
        n = (shards or {}).get(name, 1)
        keys = list(sd)
        for i in range(n):
            part = {k: sd[k] for k in keys[i::n]}
            suffix = f"-{i + 1:05d}-of-{n:05d}" if n > 1 else ""
            write_safetensors(os.path.join(sub, f"{stem}{suffix}.safetensors"), part)


FOLDER_FRAMES, FOLDER_STEPS, FOLDER_SCHEDULE = 16, 5, 50


def phase_checkpoint_folder():
    """ConsistI2V at full width from a checkpoint folder: write the seeded
    weights as an fp16 diffusers snapshot, convert it with the port's CLI,
    load it through ``init``, check every tensor, then generate with pyoco
    noise and FreeInit at guidance "both" and decode. Returns each kernel's
    launch count over the generation and decode."""
    from anyv2v_torch.cli import convert_checkpoint
    from anyv2v_torch.utils.model_zoo import (ARCHS, build_consisti2v_pipeline, build_modules,
                                              random_state_dict)
    from anyv2v_torch.utils.profiling import PhaseTimers

    timers = PhaseTimers("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        src, npz = os.path.join(tmp, "ConsistI2V"), os.path.join(tmp, "consisti2v.npz")
        with timers.phase("write the fp16 folder"):
            gen = torch.Generator(device="cuda").manual_seed(11)
            written = {name: {k: v.half().cpu() for k, v in
                              random_state_dict(m, gen, torch.device("cuda")).items()}
                       for name, m in build_modules("consisti2v", torch.float32).items()}
            write_snapshot(src, {name: (ARCHS["consisti2v"][name], sd)
                                 for name, sd in written.items()}, shards={"unet": 2})
        folder_bytes = sum(os.path.getsize(os.path.join(d, f))
                           for d, _, fs in os.walk(src) for f in fs)
        with timers.phase("convert (read, validate, write .npz)"):
            convert_checkpoint.main(["--backbone", "consisti2v", "--src", src, "--out", npz])
        npz_bytes = os.path.getsize(npz)
        with timers.phase("load through init"):
            pipe = build_consisti2v_pipeline("consisti2v", device="cuda", init=npz,
                                             dtype=torch.bfloat16)
    exact = {}
    for name, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_encoder)):
        got = module.state_dict()
        exact[name] = set(got) == set(written[name]) and all(
            torch.equal(got[k], written[name][k].to(device="cuda", dtype=got[k].dtype))
            for k in got)
    log(f"consisti2v folder: {folder_bytes} bytes of fp16 safetensors "
        f"({sum(len(sd) for sd in written.values())} tensors), .npz {npz_bytes} bytes; "
        f"every loaded tensor equals the one written: {exact}")
    del written

    video = _synthetic_video(np.random.RandomState(9), 1, 512)
    ids = np.zeros((1, 77), np.int64)
    wrappers = _wrappers()
    ff = pipe.encode_video(video)
    text = pipe.encode_text(ids)
    text_all = torch.cat([text, text, text])           # guidance "both": [neg, neg, cond]
    t_idx = FOLDER_SCHEDULE - FOLDER_STEPS
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    gen_out, dec = {}, {}
    with _RouteLog() as routes:
        with timers.phase("sample", sync=gen_out):
            gen_out["latents"] = pipe.sample(
                ff, text_all, num_frames=FOLDER_FRAMES, num_inference_steps=FOLDER_SCHEDULE,
                cfg_txt=7.5, cfg_img=1.5, frame_stride=3, seed=1,
                noise_sampling_method="pyoco_progressive", noise_alpha=1.0,
                use_frameinit=True, frameinit_noise_level=999, t_idx=t_idx)
        with timers.phase("decode", sync=dec):
            dec["video"] = pipe.decode_latents(gen_out["latents"])
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    out, frames01 = gen_out["latents"], dec["video"]

    _log_times("consisti2v checkpoint folder", timers, {"sample": FOLDER_STEPS})
    log(f"consisti2v checkpoint folder: sample {FOLDER_FRAMES} frames, steps {t_idx}..."
        f"{FOLDER_SCHEDULE - 1} of a {FOLDER_SCHEDULE}-step DDIM schedule at cfg_txt 7.5 / "
        f"cfg_img 1.5 (batch 3), pyoco_progressive noise, FreeInit butterworth at 999")
    log(f"consisti2v checkpoint folder peak device memory over sample + decode: "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"kernel launches in the consisti2v checkpoint-folder path: {counts}")
    log(f"consisti2v checkpoint-folder routes: K5 by role {routes.k5}; K2 by shape "
        f"{routes.k2}; SDPA (UNet and VAE) by head width {routes.sdpa}")
    shape = (1, FOLDER_FRAMES, 64, 64, 4)
    _check_outputs({
        **routes.mode_checks(counts),
        "every loaded tensor equals the one written": all(exact.values()),
        f"latents {list(shape)} finite, frame 0 the clean first-frame latent":
        tuple(out.shape) == shape and bool(torch.isfinite(out).all())
        and bool((out[:, :1] == ff).all()),
        f"video [{FOLDER_FRAMES},512,512,3] in [0,1]":
        tuple(frames01.shape) == (FOLDER_FRAMES, 512, 512, 3)
        and bool(torch.isfinite(frames01).all()) and float(frames01.min()) >= 0.0
        and float(frames01.max()) <= 1.0,
        "K1 (short class), K2, K3, K4, K5, KR launched; K2 long not":
        all(c > 0 for n, c in counts.items()
            if n not in ("frame_attention_long",) + _MODES + _SUBS)
        and counts["frame_attention_long"] == 0,
        "K2 with the augmented key axis": any(
            int(key.split()[1][2:]) > int(key.split()[0][1:]) for key in routes.k2),
        "no dh 40/64/80/160 attention on SDPA": not set(routes.sdpa) & {40, 64, 80, 160},
    })
    return counts


def _seine_k5_role(q, k, heads, k_ctx):
    if k.shape[1] != q.shape[1]:
        return "cross"
    return "mid self" if q.shape[1] == 64 else "spatial self"


def seine_tiny_args(seed):
    """The seine-tiny reference check's UNet inputs: 3 rows of 8 frames of
    16x16 9-channel latents, timestep 501, 77 context tokens of 16."""
    rng = np.random.RandomState(seed)
    return [rng.randn(3, 8, 16, 16, 9).astype(np.float32), 501,
            rng.randn(3, 77, 16).astype(np.float32)]


def phase_seine():
    """SEINE at full width: invert (every step on the save grid) -> cache
    files -> DDPM PnP edit -> decode, through the CLIs' per-entry functions.
    Returns each kernel's launch count over this run, and the pipeline."""
    from anyv2v_torch.cli.seine_run_ddim_inversion import invert_video
    from anyv2v_torch.cli.seine_run_pnp_edit import edit_video
    from anyv2v_torch.pipelines.seine import SeinePnPConfig
    from anyv2v_torch.utils.model_zoo import build_seine_pipeline
    from anyv2v_torch.utils.profiling import PhaseTimers

    _reference_check("seine-tiny", build_seine_pipeline, seine_tiny_args(4),
                     {"pnp": (True, True, True, True)})

    wrappers = _wrappers()
    t0 = time.perf_counter()
    pipe = build_seine_pipeline("seine", device="cuda", seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder)
                   for p in m.parameters())
    log(f"pipeline seine built with seeded random bf16 weights: {n_params} parameters "
        f"in {time.perf_counter() - t0:.2f} s")

    frames = 16
    video = _synthetic_video(np.random.RandomState(5), frames, 512)
    edited_first = np.ascontiguousarray(video[0][:, :, ::-1])   # colour-swapped edit
    ids = np.zeros((1, 77), np.int64)
    pnp = SeinePnPConfig(conv=0.2, spatial=0.2, temporal=0.5, cross=0.0)

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    timers, inv, ed = PhaseTimers("cuda"), {}, {}
    with tempfile.TemporaryDirectory() as tmp, _RouteLog(_seine_k5_role) as routes:
        with timers.phase("encode+invert+write cache", sync=inv):
            inv["latents"], inv["traj"], traj_ts = invert_video(
                pipe, video, text_ids=ids, n_steps=INV_STEPS, n_save_steps=INV_STEPS,
                output_dir=tmp)
        latents, traj = inv["latents"], inv["traj"]
        traj_np, ts_np = _read_back_cache(tmp, traj, traj_ts, timers.seconds)

        with timers.phase("DDPM PnP edit+decode", sync=ed):
            ed["out"], ed["video"] = edit_video(
                pipe, traj_np, ts_np, video[0], edited_first, n_frames=frames,
                text_ids=(ids, ids, ids), n_steps=EDIT_STEPS, cfg_scale=4.0, sampler="ddpm",
                pnp=pnp, seed=1)
        out, edited = ed["out"], ed["video"]
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    _log_times("seine", timers, {"encode+invert+write cache": INV_STEPS,
                                 "DDPM PnP edit+decode": EDIT_STEPS})
    log(f"seine main path: invert {INV_STEPS} steps (batch 1, {frames} frames, save grid "
        f"{INV_STEPS} steps) + DDPM PnP edit {EDIT_STEPS} steps at cfg 4, thresholds "
        f"conv 0.2 / spatial 0.2 / temporal 0.5 / cross 0.0 (2 steps conv+spatial+temporal, "
        f"3 temporal only, 5 at batch 2)")
    log(f"seine peak device memory: {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"kernel launches in the seine main path: {counts}")
    log(f"seine routes: K5 by role {routes.k5}; K2 by shape {routes.k2}; SDPA through the "
        f"dispatcher by head width {routes.sdpa} (CLIP calls SDPA directly)")
    shape = (1, frames, 64, 64, 4)
    n_temporal = 16 * (INV_STEPS + EDIT_STEPS)   # 16 temporal attentions per UNet forward
    _check_outputs({
        f"latents {list(shape)} finite": tuple(latents.shape) == shape
        and bool(torch.isfinite(latents).all()),
        f"trajectory [{INV_STEPS},1,16,64,64,4] finite": tuple(traj.shape) == (INV_STEPS,) + shape
        and bool(torch.isfinite(traj).all()),
        "edited latents finite": tuple(out.shape) == shape and bool(torch.isfinite(out).all()),
        f"video [{frames},512,512,3] in [0,1]": tuple(edited.shape) == (frames, 512, 512, 3)
        and bool(torch.isfinite(edited).all()) and float(edited.min()) >= 0.0
        and float(edited.max()) <= 1.0,
        "K2, K3, K5 launched; K1, K4 not": all(counts[n] > 0 for n in (
            "frame_attention", "ffn_geglu", "flash_attention"))
        and counts["folded_attention"] == 0 and counts["gn_silu_temporal_conv"] == 0,
        "K5 in its three roles": set(routes.k5) == {"spatial self", "mid self", "cross"},
        f"K2 with the bias on all {n_temporal} temporal attentions":
        all(key.endswith(" bias") for key in routes.k2)
        and sum(routes.k2.values()) == n_temporal == counts["frame_attention"],
        f"KR on the q and k of all {n_temporal} temporal attentions":
        counts["rotate_partial"] == 2 * n_temporal,
        "only the VAE's 512-wide head on SDPA": set(routes.sdpa) <= {512},
    })

    phase_profile(pipe, "seine", seine_forward_args)
    return counts, pipe


def seine_rank_args(batch, g, frames):
    """A full-width SEINE UNet forward's inputs: ``frames`` frames of 64x64
    9-channel latents, every PnP flag on at the edit batch 3."""
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale
    kw = {"pnp": (True, True, True, True)} if batch == 3 else {}
    return (rn(batch, frames, 64, 64, 9), 501, rn(batch, 77, 768, scale=0.1)), kw


def seine_forward_args(batch, g):
    """The profile's SEINE forward: 16 frames."""
    return seine_rank_args(batch, g, 16)


# ---------------------------------------------------------------------------
# the first-frame editors (phases 9-11)
# ---------------------------------------------------------------------------


def _editor_inputs(arch, batch, size, make):
    """One editor forward's inputs at ``size``^2 and ``batch``, each tensor
    from ``make(*shape)``: (UNet keyword arguments, ControlNet keyword
    arguments or None)."""
    from anyv2v_torch.utils.model_zoo import ARCHS

    cfg = ARCHS[arch]["unet"]
    h, ctx = size // 8, cfg.cross_attention_dim
    text = make(batch, 77, ctx)
    sdxl = {}
    if cfg.addition_embed == "sdxl":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        sdxl = {"added_text_embeds": make(batch, pooled), "added_time_ids": make(batch, 6)}
    unet = {"sample": make(batch, h, h, cfg.in_channels), "timestep": 501.0,
            "encoder_hidden_states": text, **sdxl}
    if cfg.ip_adapter_targets:
        unet["ip_tokens"] = make(batch, 4, ctx)
    if "controlnet" not in ARCHS[arch]:
        return unet, None
    return unet, {"sample": unet["sample"], "timestep": 501.0, "encoder_hidden_states": text,
                  "controlnet_cond": make(batch, size, size, 3), "conditioning_scale": 0.6,
                  **sdxl}


def _editor_forward(unet, controlnet, unet_kw, cn_kw):
    """One editor step's networks: the ControlNet (when there is one), then
    the UNet with its residuals."""
    if cn_kw is not None:
        down, mid = controlnet(**cn_kw)
        unet_kw = dict(unet_kw, down_block_residuals=down, mid_block_residual=mid)
    return unet(**unet_kw)


def _forward_flops(arch, size, batch):
    """Operations of one full-width editor forward, counted from the shapes:
    ``torch.utils.flop_counter`` over a forward on the ``meta`` device, the
    kernels' plain versions standing in for them (the same products)."""
    from torch.utils.flop_counter import FlopCounterMode

    from anyv2v_torch.models import layers
    from anyv2v_torch.ops import attention, ffn, norm
    from anyv2v_torch.ops import flash_attention as fl, folded_attention as fa
    from anyv2v_torch.utils.model_zoo import build_modules

    saved = attention.flash_attention, attention.folded_attention, layers.ffn_geglu
    saved_norms = norm.group_norm, norm.layer_norm
    attention.flash_attention, attention.folded_attention, layers.ffn_geglu = (
        fl.flash_attention_plain, fa.folded_attention_plain, ffn.ffn_geglu_plain)
    norm.group_norm, norm.layer_norm = norm.group_norm_plain, norm.layer_norm_plain
    try:
        modules = {k: m.to(torch.bfloat16).eval()
                   for k, m in build_modules(arch, torch.bfloat16).items()}
        inputs = _editor_inputs(arch, batch, size, lambda *shape: torch.empty(
            *shape, device="meta", dtype=torch.bfloat16))
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            _editor_forward(modules["unet"], modules.get("controlnet"), *inputs)
        return counter.get_total_flops()
    finally:
        attention.flash_attention, attention.folded_attention, layers.ffn_geglu = saved
        norm.group_norm, norm.layer_norm = saved_norms


def _editor_k5_role(q, k, heads, k_ctx):
    sk = k.shape[1]
    if sk == 4:
        return f"IP Sq{q.shape[1]} Sk4"
    return "cross" if sk == 77 else "self"


def _editor_path(path, arch, size, batch, steps, run):
    """An editor at full width with seeded random bf16 weights: the one-step
    operations counted from the shapes (``check_scan_time``'s floor per step
    is that count at 989 TFLOP/s), then ``run(pipe)`` (encode, ``steps``
    steps, decode) timed, its launches counted and its routes logged.
    Returns (pipeline, output image, launch counts, routes)."""
    from anyv2v_torch.utils.model_zoo import build_image_edit_pipeline
    from anyv2v_torch.utils.profiling import PhaseTimers

    flops = _forward_flops(arch, size, batch)
    min_step_s = flops / PEAK_FLOPS
    log(f"{path} forward at batch {batch}, {size}x{size}: {flops:.6e} operations counted from "
        f"the shapes (meta device); check_scan_time's floor {min_step_s * 1e3:.4f} ms per step "
        f"(the count at {PEAK_FLOPS:.3g} FLOP/s)")
    wrappers = _wrappers()
    t0 = time.perf_counter()
    pipe = build_image_edit_pipeline(arch, device="cuda", seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.unet, getattr(pipe, "controlnet", None), pipe.vae,
                                       pipe.text_encoder, getattr(pipe, "image_proj", None))
                   if m is not None for p in m.parameters())
    log(f"pipeline {arch} built with seeded random bf16 weights: {n_params} parameters in "
        f"{time.perf_counter() - t0:.2f} s")
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    timers, res = PhaseTimers("cuda"), {}
    label = f"encode+{steps} steps+decode"
    with _RouteLog(_editor_k5_role) as routes:
        with timers.phase(label, sync=res):
            res["image"] = run(pipe)
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    _log_times(path, timers, {label: steps}, min_step_s)
    log(f"{path} peak device memory: {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"kernel launches in the {path} path: {counts}")
    log(f"{path} routes: K5 by role {routes.k5}; SDPA through the dispatcher by head width "
        f"{routes.sdpa} (CLIP calls SDPA directly)")
    image = res["image"]
    _check_outputs({
        **routes.mode_checks(counts),
        f"image [{size},{size},3] in [0,1]": tuple(image.shape) == (size, size, 3)
        and bool(np.isfinite(image).all()) and float(image.min()) >= 0.0
        and float(image.max()) <= 1.0,
        "K5 and K3 launched; K1, K2, K2 long, K4 not": counts["flash_attention"] > 0
        and counts["ffn_geglu"] > 0 and not any(counts[n] for n in (
            "folded_attention", "frame_attention", "frame_attention_long",
            "gn_silu_temporal_conv")),
        "no UNet attention on SDPA (only the VAE's 512-wide head)": set(routes.sdpa) <= {512},
    })
    return pipe, image, counts, routes


def _editor_profile(pipe, arch, size, batch):
    def make_args(b, g):
        inputs = _editor_inputs(arch, b, size, lambda *shape: torch.randn(
            *shape, generator=g, device="cuda"))
        return (), {"unet_kw": inputs[0], "cn_kw": inputs[1]}

    controlnet = getattr(pipe, "controlnet", None)
    phase_profile(pipe, arch, make_args, batches=(batch,),
                  forward=lambda unet_kw, cn_kw: _editor_forward(pipe.unet, controlnet, unet_kw,
                                                                 cn_kw),
                  what="ControlNet + UNet" if controlnet is not None else "UNet")


IP2P_STEPS, COSXL_STEPS, STYLE_STEPS = 100, 20, 30


def phase_instructpix2pix():
    """InstructPix2Pix at full width (SD1.5, 512x512): an instructpix2pix-tiny
    reference check, then the CLI's array-level ``edit_frame`` on the first
    frame of a seeded synthetic video: VAE mode encode, the whole 100-step
    Euler-Ancestral grid at batch 3 (guidance 7.5, image guidance 1.5), and
    decode; then one profiled batch-3 forward."""
    from anyv2v_torch.cli.edit_image import DEFAULT_NEGATIVE, edit_frame
    from anyv2v_torch.utils.model_zoo import build_image_edit_pipeline

    rng = np.random.RandomState(20)
    _reference_check("instructpix2pix-tiny", build_image_edit_pipeline,
                     [rng.randn(3, 16, 16, 8).astype(np.float32), 612.25,
                      rng.randn(3, 77, 16).astype(np.float32)], {})
    frame = _synthetic_video(np.random.RandomState(21), 1, 512)[0]
    pipe, _, counts, _ = _editor_path(
        "instructpix2pix", "instructpix2pix", 512, 3, IP2P_STEPS,
        lambda p: edit_frame(p, frame, "turn it into a watercolour", seed=42,
                             negative_prompt=DEFAULT_NEGATIVE, num_inference_steps=IP2P_STEPS))
    _editor_profile(pipe, "instructpix2pix", 512, 3)
    return counts


def phase_cosxl():
    """CosXL at full width (SDXL, 1024x1024): a cosxl-tiny reference check (a
    negative EDM timestep), then ``edit_frame`` on a seeded synthetic frame:
    VAE mode encode, the whole 20-step EDM grid at batch 3 (guidance 7,
    image guidance 1.5) on zero text embeddings, as the JAX CLI runs it, and
    decode; peak memory; then one profiled batch-3 forward."""
    from anyv2v_torch.cli.edit_image import edit_frame
    from anyv2v_torch.utils.model_zoo import build_image_edit_pipeline

    rng = np.random.RandomState(22)
    ids = np.tile(np.float32([[128, 128, 0, 0, 128, 128]]), (3, 1))
    _reference_check("cosxl-tiny", build_image_edit_pipeline,
                     [rng.randn(3, 16, 16, 8).astype(np.float32), -1.37,
                      rng.randn(3, 77, 16).astype(np.float32),
                      rng.randn(3, 16).astype(np.float32), ids], {})
    frame = _synthetic_video(np.random.RandomState(23), 1, 1024)[0]
    pipe, _, counts, _ = _editor_path(
        "cosxl", "cosxl", 1024, 3, COSXL_STEPS,
        lambda p: edit_frame(p, frame, "", seed=42, num_inference_steps=COSXL_STEPS))
    _editor_profile(pipe, "cosxl", 1024, 3)
    return counts


def _edge_map(frame01):
    """A stand-in for ``canny_map`` (OpenCV, which this machine lacks): the
    pixels where the luminance changes by more than 0.02 to the next pixel
    down or right, as a 3-channel map in {0, 1}."""
    g = frame01.mean(axis=-1)
    step = (np.abs(np.diff(g, axis=0, append=g[-1:])) + np.abs(np.diff(g, axis=1,
                                                                       append=g[:, -1:])))
    return np.repeat((step > 0.02)[..., None], 3, axis=-1).astype(np.float32)


def phase_instantstyle():
    """InstantStyle at full width (SDXL + the canny ControlNet + the base
    IP-Adapter on up_0_attn_1, 1024x1024): instantstyle-tiny reference checks
    of its UNet (with IP tokens) and its ControlNet, then ``style_frame`` on
    a seeded synthetic frame with an edge map made in numpy and a seeded
    style embedding: the whole 30-step Euler-Discrete grid at batch 2
    (guidance 5, ControlNet scale 0.6, IP scale 1), and decode. K5 must take
    the IP attention (4 keys) on each of up_0_attn_1's 10 transformer blocks
    in every forward, and no other attention has 4 keys; peak memory; then
    one profiled batch-2 forward (ControlNet and UNet)."""
    from anyv2v_torch.cli.edit_image import style_frame
    from anyv2v_torch.utils.model_zoo import build_image_edit_pipeline

    rng = np.random.RandomState(24)
    ids = np.tile(np.float32([[128, 128, 0, 0, 128, 128]]), (2, 1))
    x, text, pooled = (rng.randn(2, 16, 16, 4).astype(np.float32),
                       rng.randn(2, 77, 16).astype(np.float32), rng.randn(2, 16).astype(np.float32))
    _reference_check("instantstyle-tiny", build_image_edit_pipeline,
                     [x, 401.5, text, pooled, ids, rng.randn(2, 4, 16).astype(np.float32), 1.0], {})
    _reference_check("instantstyle-tiny", build_image_edit_pipeline,
                     [x, 401.5, text, rng.rand(2, 128, 128, 3).astype(np.float32), 0.6, pooled,
                      ids], {}, component="controlnet")
    frame = _synthetic_video(np.random.RandomState(25), 1, 1024)[0]
    control = _edge_map(frame)
    style = torch.from_numpy(np.random.RandomState(26).randn(1, 1280).astype(np.float32))
    log(f"instantstyle control map: {int(control[..., 0].sum())} edge pixels of {1024 * 1024}")
    pipe, _, counts, routes = _editor_path(
        "instantstyle", "instantstyle", 1024, 2, STYLE_STEPS,
        lambda p: style_frame(p, frame, style.cuda(), seed=42, num_inference_steps=STYLE_STEPS,
                              control01=control))
    ip_blocks = len(pipe.unet.up_blocks[0].attentions[1].transformer_blocks)
    ip_roles = {role: n for role, n in routes.k5.items() if role.startswith("IP")}
    _check_outputs({
        f"K5 on the {ip_blocks} IP attentions of up_0_attn_1 (1024 queries over 4 keys) in "
        f"every one of {STYLE_STEPS} forwards, nowhere else":
        ip_roles == {"IP Sq1024 Sk4": ip_blocks * STYLE_STEPS} and ip_blocks == 10,
    })
    _editor_profile(pipe, "instantstyle", 1024, 2)
    return counts


PRODUCT_EDITOR_STEPS = 100   # the Predictor's default: InstructPix2Pix's whole grid
PRODUCT_MEM_SLACK = 64 * 2**20   # bytes a later request may hold beyond request 1


class _StageTimers:
    """Times the three stages of a product request, each between two
    synchronisations (``PhaseTimers`` with ``sync=`` its output): the
    first-frame editor, the inversion (encode + invert) and the PnP edit +
    decode, by wrapping the predictor's ``edit_first_frame`` and the
    runner's two per-entry functions; it also counts each stage's kernel
    launches. ``new_request()`` starts a request's timers."""

    STAGES = {"edit_first_frame": "editor", "invert_video": "inversion",
              "edit_video": "edit+decode"}

    def __init__(self, predictor):
        from anyv2v_torch.product import anyv2v as product

        self.predictor, self.product = predictor, product
        self.launches = {stage: {} for stage in self.STAGES.values()}

    def new_request(self):
        from anyv2v_torch.utils.profiling import PhaseTimers

        self.timers = PhaseTimers("cuda")
        return self.timers

    def _wrap(self, fn, stage):
        def call(*a, **kw):
            before = {n: w.launches for n, w in _wrappers().items()}
            out = {}
            with self.timers.phase(stage, sync=out):
                out["result"] = fn(*a, **kw)
            counts = self.launches[stage]
            for n, w in _wrappers().items():
                counts[n] = counts.get(n, 0) + w.launches - before[n]
            return out["result"]
        return call

    def __enter__(self):
        p, mod = self.predictor, self.product
        self.saved = {n: getattr(mod, n) for n in ("invert_video", "edit_video")}
        p.edit_first_frame = self._wrap(p.edit_first_frame, "editor")
        for n, f in self.saved.items():
            setattr(mod, n, self._wrap(f, self.STAGES[n]))
        return self

    def __exit__(self, *exc):
        del self.predictor.__dict__["edit_first_frame"]
        for n, f in self.saved.items():
            setattr(self.product, n, f)


def phase_product():
    """The product layer at full width, both pipelines resident: one
    ``Predictor`` set up (seeded random bf16 weights), then three requests in
    a row through the array-level entry points on a seeded synthetic video:
    ``predict_arrays`` at the Predictor's defaults (PnP 1.0 / 1.0 / 1.0, every
    edit step at batch 3; the editor's whole 100-step grid), again with
    another prompt and seed, then the runner's core ``edit_arrays`` at the
    gradio defaults (PnP 0.2 / 0.2 / 0.5, t_idx 0: a batch-2 tail) on
    request 2's edited frame. DDIM at INV_STEPS / EDIT_STEPS. Each request
    timed in its stages; nothing may be built again, nor device memory grow
    past request 1's level by more than 64 MiB. Returns each kernel's launch
    count over the three requests."""
    from anyv2v_torch.product import DEFAULTS, Predictor
    from anyv2v_torch.utils.benchguard import check_scan_time, hard_sync

    arch, editor, size, frames = "i2vgen-xl", "instructpix2pix", 512, 16
    flops = _forward_flops(editor, size, 3)
    editor_floor = flops / PEAK_FLOPS
    log(f"product editor {editor} forward at batch 3, {size}x{size}: {flops:.6e} operations "
        f"counted from the shapes; check_scan_time's floor {editor_floor * 1e3:.4f} ms per step")
    t0 = time.perf_counter()
    predictor = Predictor()
    predictor.setup(arch=arch, image_edit_arch=editor, device="cuda")
    torch.cuda.synchronize()
    log(f"product: Predictor.setup({arch} + {editor}, seeded random bf16 weights): "
        f"{time.perf_counter() - t0!r} s")
    pipe, image_editor = predictor.runner._pipe, predictor.image_editor
    video = _synthetic_video(np.random.RandomState(30), frames, size)
    ddim = dict(ddim_inversion_steps=INV_STEPS, num_inference_steps=EDIT_STEPS)
    requests = [
        ("request 1: predict_arrays, PnP 1.0/1.0/1.0", lambda: predictor.predict_arrays(
            video, "turn it into a watercolour", "a watercolour painting", seed=42,
            image_edit_steps=PRODUCT_EDITOR_STEPS, **ddim)),
        ("request 2: predict_arrays, PnP 1.0/1.0/1.0", lambda: predictor.predict_arrays(
            video, "make it snowy", "a snowy scene", seed=7,
            image_edit_steps=PRODUCT_EDITOR_STEPS, **ddim)),
        ("request 3: edit_arrays, PnP 0.2/0.2/0.5", lambda: predictor.runner.edit_arrays(
            video, edited2, "a snowy scene", **{**DEFAULTS, **ddim})),
    ]
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    checks, allocated, edited2 = {}, [], None
    with _RouteLog(_editor_k5_role) as routes, _StageTimers(predictor) as stages:
        for i, (label, run) in enumerate(requests):
            timers = stages.new_request()
            t0 = time.perf_counter()
            out = run()
            hard_sync(out[:2])
            wall = time.perf_counter() - t0
            log(f"product {label}: wall {wall!r} s")
            _log_times(f"product {label}", timers, {"inversion": INV_STEPS,
                                                    "edit+decode": EDIT_STEPS})
            if "editor" in timers.seconds:
                check_scan_time(f"product {label} editor", timers.seconds["editor"],
                                PRODUCT_EDITOR_STEPS, editor_floor)
            video_out, second = out[0], out[1]
            checks[f"{label}: video [{frames},{size},{size},3] finite in [0,1]"] = (
                tuple(video_out.shape) == (frames, size, size, 3)
                and bool(torch.isfinite(video_out).all()) and float(video_out.min()) >= 0.0
                and float(video_out.max()) <= 1.0)
            if i < 2:
                edited2 = second
                checks[f"{label}: edited frame [{size},{size},3] finite"] = (
                    second.shape == (size, size, 3) and bool(np.isfinite(second).all()))
            else:
                checks[f"{label}: trajectory finite"] = bool(torch.isfinite(second).all())
            del out, video_out, second
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated())
            log(f"product {label}: device memory allocated after it (its outputs freed): "
                f"{allocated[-1]} bytes")
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"product peak device memory over the three requests: {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log(f"kernel launches in the product path: {counts}; by stage: {stages.launches}")
    log(f"product routes: K5 by role {routes.k5}; K2 by shape {routes.k2}; SDPA through the "
        f"dispatcher by head width {routes.sdpa}")
    video_k = {n: sum(stages.launches[s].get(n, 0) for s in ("inversion", "edit+decode"))
               for n in wrappers}
    editor_k = stages.launches["editor"]
    checks.update({
        "K1, K2, K3, K4 launched in the video stages; K5 not": all(
            video_k[n] > 0 for n in ("folded_attention", "frame_attention", "ffn_geglu",
                                     "gn_silu_temporal_conv")) and video_k["flash_attention"] == 0,
        "K5 and K3 launched in the editor stage; K1, K2, K4 not": editor_k.get(
            "flash_attention", 0) > 0 and editor_k.get("ffn_geglu", 0) > 0 and not any(
            editor_k.get(n, 0) for n in ("folded_attention", "frame_attention",
                                         "gn_silu_temporal_conv")),
        "K2 long not launched": counts["frame_attention_long"] == 0,
        # the image-latent encoder's GELU feed-forward (C 4) is outside K3's
        # range, as it fails the Pallas kernel's gate (pallas_ffn.py:147)
        **routes.mode_checks(counts),
        "requests 2 and 3 built nothing (the same pipeline and editor)":
        predictor.runner._pipe is pipe and predictor.image_editor is image_editor,
        "memory allocated after requests 2 and 3 within 64 MiB of request 1's": all(
            abs(a - allocated[0]) <= PRODUCT_MEM_SLACK for a in allocated[1:]),
        "peak device memory under 80 GB": peak < 80e9,
    })
    _check_outputs(checks)
    return counts


def op_surfaces(device="cuda", dtype=torch.bfloat16, small=False, seed=0):
    """The port's modules on the operand modes that no configuration of the
    repo reaches, at full width (``small``: fewer rows and tokens, the same
    widths): {label: (module, its inputs, its output)}.

    - ``Attention`` with a score bias at SEINE's L0 spatial self-attention
      (48 rows of 4096 tokens, 8 heads of 40, a bias shared by the batch),
      at ConsistI2V's L0 spatial cross-attention (51 rows, 5 heads of 64 over
      77 text tokens, a bias per row) and at i2vgen-xl's L2 widths (64 heads
      of 20 stored as 32, 256 tokens, shared): K5 with its bias;
    - ``TemporalTransformer`` at SEINE's L0 widths (3 rows of 16 frames at
      64x64, 8 heads of 40) with a bias over the frames shared by every
      pixel: K2 on the ``[B, S, 1, C]`` view (then K5, K3 GEGLU);
    - ``FeedForward(activation="gelu")`` at C 320 (65536 rows) and 640 (16384):
      K3's GELU form.

    The modules get PyTorch's default init from ``torch.manual_seed(seed)``
    on the CPU (padded head storage zeroed), rounded to bf16, then move to ``device`` and ``dtype``; the
    inputs are drawn from a generator seeded with ``seed`` (on the CPU where
    ``small``, so that a CPU reference gets the same numbers), rounded to
    bf16. On the ``meta`` device nothing is drawn (shapes only)."""
    from anyv2v_torch.models.layers import Attention, FeedForward, TemporalTransformer

    meta = torch.device(device).type == "meta"
    torch.manual_seed(seed)
    with torch.device("meta" if meta else "cpu"):
        mods = {"seine self": Attention(320, 8, 40),
                "consisti2v cross": Attention(320, 5, 64, cross_attention_dim=1024),
                "i2vgen L2 self": Attention(1280, 64, 20),
                "temporal": TemporalTransformer(320, 8, 40, dtype=dtype),
                "gelu 320": FeedForward(320, activation="gelu"),
                "gelu 640": FeedForward(640, activation="gelu")}
    for m in mods.values():
        if not meta:
            m.load_state_dict(m.state_dict())   # zero the padded heads' storage
            with torch.no_grad():
                for p in m.parameters():
                    p.copy_(p.to(torch.bfloat16).float())
        m.to(device=device, dtype=dtype).eval()
    gen = None if meta else torch.Generator(device="cpu" if small else device).manual_seed(seed)

    def rn(*shape, std=1.0, fp32=False):
        if meta:
            return torch.empty(*shape, device="meta", dtype=torch.float32 if fp32 else dtype)
        x = (torch.randn(*shape, generator=gen, device=gen.device) * std).to(torch.bfloat16)
        return x.to(device=device, dtype=torch.float32 if fp32 else dtype)

    rows, s0, s2, px, n0, n1 = (2, 1024, 256, 16, 4096, 1024) if small else \
        (48, 4096, 256, 64, 65536, 16384)
    inputs = {
        "seine self": ((rn(rows, s0, 320),), {"bias": rn(8, s0, s0, std=2.0, fp32=True)}),
        "consisti2v cross": ((rn(rows + 3, s0, 320), rn(rows + 3, 77, 1024, std=0.1)),
                             {"bias": rn(rows + 3, 5, s0, 77, std=2.0, fp32=True)}),
        "i2vgen L2 self": ((rn(rows, s2, 1280),), {"bias": rn(64, s2, s2, std=2.0, fp32=True)}),
        "temporal": ((rn(3, 16, px, px, 320),), {"bias": rn(8, 16, 16, std=2.0, fp32=True)}),
        "gelu 320": ((rn(n0, 320),), {}),
        "gelu 640": ((rn(n1, 640),), {}),
    }
    out = {}
    with torch.inference_mode():
        for label, m in mods.items():
            args, kw = inputs[label]
            out[label] = (m, (args, kw), m(*args, **kw))
    return out


def _surface_reference():
    """The op surfaces at small sizes: the card (bf16, the kernels) against
    the port's plain fp32 path on the CPU, on the same bf16-rounded weights
    and inputs; each output within 0.02 + 0.05 * max|ref|."""
    want = op_surfaces("cpu", torch.float32, small=True)
    got = op_surfaces("cuda", torch.bfloat16, small=True)
    for label, (_, _, ref) in want.items():
        diff = (got[label][2].float().cpu() - ref).abs()
        err, bound = diff.max().item(), 0.02 + 0.05 * ref.abs().max().item()
        log(f"reference check (op surface {label}, bf16 card vs fp32 CPU plain): max_abs_err "
            f"{err:.3e}, bound {bound:.3e} (0.02 + 0.05*max|ref|); mean_abs_err "
            f"{diff.mean().item():.3e}")
        if not (np.isfinite(err) and err <= bound):
            raise RuntimeError(f"the op surface {label} on the card disagrees with its CPU "
                               "reference")


def _sdpa_bias_check():
    """The dispatcher's two SDPA routes for a bias (a width K5 lacks; a bias
    with a mask) on bf16 tokens on the card, with a T5-sized fp32 bias
    (|bias| ~ 10, where a bf16 step is 0.0625): the bias is added to fp32
    scores, so each output is within a bf16 rounding of a float64 reference
    on the CPU (2^-8 * |ref| + 1e-4)."""
    from anyv2v_torch.ops.attention import multi_head_attention

    gen = torch.Generator().manual_seed(5)
    b, s, heads = 2, 256, 2
    for dh, with_mask in ((192, False), (64, True)):
        q, k, v = (torch.randn(b, s, heads * dh, generator=gen).bfloat16() for _ in range(3))
        bias = 8.0 + 3.0 * torch.randn(heads, s, s, generator=gen)
        mask = torch.rand(b, heads, s, s, generator=gen) > 0.4
        mask[..., 0] = True
        if not with_mask:
            mask[:] = True
        scale = dh ** -0.5

        def split(x):
            return x.double().reshape(b, s, heads, dh).transpose(1, 2)

        scores = (split(q) @ split(k).transpose(-1, -2) * scale + bias.double())
        want = (scores.masked_fill(~mask, float("-inf")).softmax(-1) @ split(v)).transpose(
            1, 2).reshape(b, s, -1)
        got = multi_head_attention(q.cuda(), k.cuda(), v.cuda(), heads, scale,
                                   bias=bias.cuda(), mask=mask.cuda() if with_mask else None)
        diff = (got.double().cpu() - want).abs()
        excess = (diff - (2.0 ** -8 * want.abs() + 1e-4)).max().item()
        log(f"SDPA bias route (dh {dh}{', with a mask' if with_mask else ''}, bf16 tokens, "
            f"fp32 bias): max_abs_err {diff.max().item():.3e} against the float64 reference")
        if got.dtype != torch.bfloat16 or not excess <= 0.0:
            raise RuntimeError(f"the SDPA bias route at dh {dh} is not within a bf16 rounding "
                               "of its float64 reference")


def phase_op_surfaces():
    """The two operand modes that no configuration reaches, through the
    port's modules (:func:`op_surfaces`) at full width after a small-size
    reference check and the SDPA bias routes' check
    (:func:`_sdpa_bias_check`): K5 with a bias on all three biased ``Attention`` calls,
    K2 on the view once (the temporal transformer's biased attention), K3's
    GELU form on both feed-forwards; the outputs finite and of their
    shapes. Returns each kernel's launch count over the run."""
    _surface_reference()
    _sdpa_bias_check()
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    with _RouteLog(_editor_k5_role) as routes:
        out = op_surfaces("cuda")
        torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"kernel launches in the op-surfaces path: {counts}")
    log(f"op-surfaces routes: K5 by role {routes.k5}; K2 by shape {routes.k2}; SDPA through "
        f"the dispatcher by head width {routes.sdpa}, with a mask or bias {routes.sdpa_masked}")
    checks = {f"{label}: {list(y.shape)} finite": tuple(y.shape) == tuple(args[0].shape)
              and bool(torch.isfinite(y).all()) for label, (_, (args, _), y) in out.items()}
    checks.update({
        **routes.mode_checks(counts),
        "K5 with a bias on the three biased Attention calls": counts["flash_attention_bias"] == 3,
        "K2 on the [B, S, 1, C] view, with the bias": counts["frame_attention"] == 1
        and set(routes.k2) == {"S16 Sk16 dh40 bias"},
        "K3's GELU form on both feed-forwards": counts["ffn_gelu"] == 2,
        "nothing on SDPA": not routes.sdpa and not routes.sdpa_masked,
    })
    _check_outputs(checks)
    return counts


def phase_bench():
    """The port's bench entries (``anyv2v_torch/bench.py`` and
    ``bench_backbones.py``), projected, at 16 frames for the three
    backbones: each builds its pipeline (UNet and VAE, seeded random bf16
    weights), times VAE encode and decode, warm 20-step inversion and
    10-step edit scans (each after a 2-step warm-up, each through
    ``check_scan_time``) and prints its JSON line. Every value must be
    finite. Returns each kernel's launch count over the three."""
    from anyv2v_torch.bench import bench_i2vgen
    from anyv2v_torch.bench_backbones import bench_consisti2v, bench_seine

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    recs = []
    for fn in (bench_i2vgen, bench_consisti2v, bench_seine):
        recs.append(fn())
        log(json.dumps(recs[-1]))
        torch.cuda.empty_cache()
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"kernel launches in the bench path: {counts}")
    _check_outputs({
        f"{r['metric']}: finite": all(np.isfinite(v) for v in [r["value"]] + [
            r["detail"][k] for k in ("invert_s", "edit_s", "vae_encode_s", "vae_decode_s")])
        for r in recs})
    return counts


# (profile group, kernel symbol that the group's device events contain,
# wrapper); K3's two launches (and both forms) are ffn_kernel instances, so
# the group holds them all
_KERNEL_GROUPS = (("K1 folded_attention", "folded_attention_kernel", "folded_attention"),
                  ("K1 short", "folded_attention_short_kernel", "folded_attention_short"),
                  ("K2 long", "frame_attention_long_kernel", "frame_attention_long"),
                  ("K2 frame_attention", "frame_attention_kernel", "frame_attention"),
                  ("K3 ffn", "ffn_kernel", "ffn_geglu"),
                  ("K4 prologue", "temporal_conv_kernel_prologue",
                   "gn_silu_temporal_conv_prologue"),
                  ("K4 temporal_conv", "temporal_conv_kernel", "gn_silu_temporal_conv"),
                  ("K5 flash_attention", "flash_attention_kernel", "flash_attention"),
                  ("KN group statistics", "kn_group_stats_kernel", "group_norm"),
                  ("KN group apply", "kn_group_apply_kernel", "group_norm"),
                  ("KN K4 finalize", "kn_group_finalize_kernel", "group_scale_shift"),
                  ("KN layer_norm", "kn_layer_norm_kernel", "layer_norm"),
                  ("KR rotary", "kr_rotary_kernel", "rotate_partial"))


class _ClockSampler:
    """nvidia-smi sampling the SM clock, power draw and temperature every
    100 ms over the warm-up and the profiled forward; reports min and max of
    each."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
                if line.count(",") == 2]
        if rows:
            cols = list(zip(*rows))
            self.summary = ", ".join(f"{name} {min(c):g}-{max(c):g}" for name, c in
                                     zip(("SM MHz", "W", "C"), cols))
            self.max_sm_mhz = max(cols[0])
        else:
            self.summary = "no nvidia-smi samples"
            self.max_sm_mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                capture_output=True, text=True).stdout.split()[0])


def phase_profile(pipe, arch, make_args, batches=(1, 3), forward=None, what="UNet"):
    """One UNet forward at the inversion batch (1) and at the edit batch (3,
    every PnP flag on), or at ``batches``, under torch.profiler: device time by kernel group, the
    device's busy share of the forward's wall time, the number of device ops,
    the host's waits on the device (stream syncs, host-to-device copies)
    inside the forward and its peak device memory (allocated, the weights
    included). ``forward`` (default ``pipe.unet``) is what one
    forward calls, ``what`` its name in the log (InstantStyle: its
    ControlNet, then its UNet). Returns each forward's profiled wall ms by
    batch."""
    from torch.profiler import ProfilerActivity, profile

    forward = forward or pipe.unet
    g = torch.Generator(device="cuda").manual_seed(2)
    walls = {}
    for batch in batches:
        args, kw = make_args(batch, g)
        with torch.inference_mode(), _ClockSampler() as clocks:
            forward(*args, **kw)
            torch.cuda.synchronize()
            before = {name: fn.launches for name, fn in _wrappers().items()}
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                forward(*args, **kw)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        averages = prof.key_averages()
        events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        syncs = sum(e.count for e in averages if e.key == "cudaStreamSynchronize")
        h2d = sum(e.count for e in events if e.key.startswith("Memcpy HtoD"))
        groups = {label: 0.0 for label, _, _ in _KERNEL_GROUPS}
        groups["other"] = 0.0
        for e in events:
            label = next((lb for lb, key, _ in _KERNEL_GROUPS if key in e.key), "other")
            groups[label] += e.self_device_time_total / 1e3
        launched = {name: fn.launches - before[name] for name, fn in _wrappers().items()}
        # K1's wrapper counts both bodies: its Hopper body's launches are
        # what its short body's leave (ConsistI2V's K1 calls all take the
        # short body)
        launched["folded_attention"] -= launched["folded_attention_short"]
        silent = [label for label, _, name in _KERNEL_GROUPS
                  if launched[name] and not groups[label] > 0]
        if silent:
            raise RuntimeError(f"profile {arch} batch {batch}: {silent} launched but no "
                               "device event carries its kernel's name")
        walls[batch] = wall_ms
        log(f"profile {arch} {what} forward batch {batch}: wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall); by group (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in groups.items())
            + f"; {sum(e.count for e in events)} device ops, host waits: {syncs} "
            f"cudaStreamSynchronize, {h2d} host-to-device copies; peak device memory "
            f"{peak_gib:.2f} GiB (allocated, weights included)"
            + f"; nvidia-smi over warm-up and window: {clocks.summary}")
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        for e in top:
            log(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<4d} {e.key[:110]}")
    return walls


if __name__ == "__main__":
    sys.exit(main())
