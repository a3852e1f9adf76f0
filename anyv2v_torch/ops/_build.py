"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

All sources under ``anyv2v_torch/csrc`` compile into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds). The build
lands in ``build/anyv2v_torch/`` at the repository root, named by a hash of the
sources, so an edited source rebuilds and an unchanged one loads the cached
library. Nothing is built at import time: the first kernel launch builds.

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
SOURCES = ("folded_attention.cu", "frame_attention.cu", "ffn.cu", "temporal_conv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None   # wall time of the nvcc call in this process, if any


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + tuple(NVCC_FLAGS):
        h.update(name.encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


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
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[os.path.join(CSRC, s) for s in SOURCES]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
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
