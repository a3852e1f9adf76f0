"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

All sources under ``anyv2v_torch/csrc`` compile into one shared library with a
plain C interface (no PyTorch headers). Each source compiles in its own nvcc
process, all started together, and one more nvcc links the objects. The build
lands in ``build/anyv2v_torch/`` at the repository root, named by a hash of
every ``*.cu`` and ``*.cuh`` file there (the shared header ``hopper.cuh`` is
never compiled alone, but an edit to it rebuilds), so an edited source
rebuilds and an unchanged one loads the cached library. ptxas reports each
kernel's registers, spills and shared memory into ``libanyv2v_<hash>.ptxas.txt``
beside the library (:func:`ptxas_report`). Nothing is built at import time: the
first kernel launch builds.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "anyv2v_torch")
SOURCES = ("folded_attention.cu", "frame_attention.cu", "ffn.cu", "temporal_conv.cu",
           "flash_attention.cu", "norm.cu", "rotary.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")
PTXAS_VERBOSE = ("-Xptxas", "-v")   # compile steps only: registers, spills, shared memory

SMEM_LIMIT = 232448                        # dynamic shared memory of one H100 block
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)  # grid x, y, z
H100_SMS = 132

# hopper.cuh's GEMM main loop (K3, K4): 128-row tiles on two consumer
# warpgroups and a producer warpgroup, a ring of stages 64 deep with a full
# and an empty mbarrier each, output tiles 64..320 columns wide by 64
GEMM_ROWS, GEMM_DEPTH, GEMM_THREADS = 128, 64, 384
GEMM_WIDTHS = (64, 128, 192, 256, 320)

_lib = None
build_seconds = None   # wall time of the nvcc build in this process, if any


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _source_hash() -> str:
    """A hash of the flags and of every ``*.cu`` and ``*.cuh`` under CSRC."""
    names = sorted(n for n in os.listdir(CSRC) if n.endswith((".cu", ".cuh")))
    h = hashlib.sha256()
    for name in tuple(NVCC_FLAGS) + PTXAS_VERBOSE:
        h.update(name.encode())
    for name in names:
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands as parallel processes and wait for every one; raise
    with the output of the first that failed, else return their stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed, errs = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError(f"nvcc failed: {failed[0]}")
    return "".join(errs)


def _compile_and_link(so: str) -> None:
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    report = _report_path(so)
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", "-o", obj,
                         os.path.join(CSRC, src)] for src, obj in zip(SOURCES, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{so}.{tag}", *objs]])
        if log:
            with open(f"{report}.{tag}", "w") as f:
                f.write(log)
            os.replace(f"{report}.{tag}", report)
        os.replace(f"{so}.{tag}", so)
    finally:
        for path in objs + [f"{so}.{tag}", f"{report}.{tag}"]:
            if os.path.exists(path):
                os.remove(path)


def _report_path(so: str) -> str:
    return os.path.splitext(so)[0] + ".ptxas.txt"


def ptxas_report() -> str:
    """ptxas's report of the loaded library's build (registers, spills and
    shared memory of every kernel), or "" when the library was built without
    one."""
    path = _report_path(os.path.join(BUILD_DIR, f"libanyv2v_{_source_hash()}.so"))
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA GPU; none is available")
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libanyv2v_{_source_hash()}.so")
    if not os.path.exists(so):
        t0 = time.perf_counter()
        _compile_and_link(so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    lib.anyv2v_error_string.restype = ctypes.c_char_p
    lib.anyv2v_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().anyv2v_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require_cuda(name: str, *tensors: torch.Tensor, dtype=torch.bfloat16) -> None:
    """The checks every wrapper makes before a launch: all tensors on one
    CUDA device, of ``dtype``, contiguous (``None`` entries skipped)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA or CPU tensors, got {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device: a persistent grid's size."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def gemm_width(cols: int, rows: int = 0, sms: int = H100_SMS) -> tuple:
    """(column tiles, tile width) of a GEMM with ``cols`` output columns: as
    few tiles of at most 320 columns as possible, each a multiple of 64 wide
    (the last one masked). With ``rows``, of that width and the narrower
    ones down to 256, the one whose tiles' rounds over ``sms`` blocks times
    the width (the busiest block's share of the work) is least, the wider on
    a tie: a grid that would leave many SMs idle (the mid block's 96 tiles of
    320 on 132) takes tiles of 256 (120). Narrower tiles are not taken: each
    column tile reads the whole of A again."""
    tiles = -(-cols // GEMM_WIDTHS[-1])
    per_tile = -(-cols // tiles)
    fewest = -(-per_tile // 64) * 64
    if not rows:
        return tiles, fewest
    row_tiles = -(-rows // GEMM_ROWS)
    widths = [w for w in GEMM_WIDTHS if min(fewest, 256) <= w <= fewest]

    def cost(w):
        return -(-row_tiles * -(-cols // w) // sms) * w
    width = min(widths, key=lambda w: (cost(w), -w))
    return -(-cols // width), width


def gemm_plan(rows: int, col_tiles: int, width: int, ksteps: int, extra_bytes: int = 0,
              sms: int = H100_SMS, stages: int = 4, pingpong: bool = False) -> dict:
    """The launch of one GEMM on hopper.cuh's main loop: a ring of ``stages``
    stages of A [128, 64] and B [64, width] bf16, ``extra_bytes`` of the
    body's own, a full and an empty mbarrier per stage and 1024 bytes that
    align the ring (hopper.cuh ``gemm_smem_bytes``); a persistent
    grid of at most one block per SM over ``ceil(rows / 128) * col_tiles``
    tiles. Cooperative: block x takes tiles x, x + grid, ...; ping-pong
    (``pingpong``, only where the tiles outnumber the SMs): block x takes
    units x, x + grid, ... of two tiles, 2u for its first consumer warpgroup
    and 2u + 1 for its second."""
    stage = (GEMM_ROWS + width) * GEMM_DEPTH * 2
    tiles = -(-rows // GEMM_ROWS) * col_tiles
    if pingpong and tiles <= sms:
        raise ValueError(f"gemm_plan: {tiles} tiles pair on no more than {sms} SMs")
    units = -(-tiles // 2) if pingpong else tiles
    return {"width": width, "col_tiles": col_tiles, "tiles": tiles, "ksteps": ksteps,
            "schedule": "pingpong" if pingpong else "cooperative", "units": units,
            "stages": stages, "threads": GEMM_THREADS,
            "smem_bytes": stages * stage + extra_bytes + 2 * stages * 8 + 1024,
            "grid": (max(1, min(units, sms)),)}


# name -> a kernel's own check of a plan's fields (registered by its module)
PLAN_CHECKS = {}


def check_plan(name: str, plan: dict) -> None:
    """Raise unless a launch plan's block fits one H100 SM's shared memory
    and its grid the launch limits, and the kernel's own check in
    :data:`PLAN_CHECKS`, if it has one, takes it."""
    if plan["smem_bytes"] > SMEM_LIMIT or any(
            g > lim for g, lim in zip(plan["grid"], GRID_LIMITS)):
        raise ValueError(f"{name}: no launch for this shape: {plan}")
    if name in PLAN_CHECKS:
        PLAN_CHECKS[name](plan)


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Kernels that read 16-byte vectors need 16-byte aligned data pointers
    (``None`` entries skipped)."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not "
                             "16-byte aligned")
