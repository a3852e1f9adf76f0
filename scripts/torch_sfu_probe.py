"""Instruction throughput of the softmax's instructions on one NVIDIA GPU, in
results per SM per clock, and the SASS each compiles to.

    python3 scripts/torch_sfu_probe.py [--out DIR]

Writes a small CUDA source into ``DIR`` (default ``build/variants/sfu_probe``,
git-ignored), builds it with nvcc for sm_90a, prints the SASS opcodes of each
probe kernel (``cuobjdump -sass``), then runs each kernel with one block per SM
at 8 and at 32 warps a block. Every thread keeps 8 independent chains of the
instruction under test, so that a warp always has one to issue; each block
times its loop with ``clock64`` and the rate is results / cycles, averaged
over the SMs. The instructions:

- ``ex2.approx.ftz.f32`` (one result a lane), ``ex2.approx.f16x2`` and
  ``ex2.approx.ftz.bf16x2`` (two results a lane): a packed exponential
  halves the softmax's special-function work only if it retires two results
  for one issue, i.e. if its rate in results is twice the fp32 one;
- ``cvt.rn.bf16x2.f32`` (two floats packed to bf16, the P operand of P.V;
  one result counted per packed pair);
- ``max.f32`` and ``fma.rn.f32``;
- mixes of the softmax's inner loop, rates in exponentials per SM per clock:
  ``ex2 + cvt`` (two fp32 exponentials and their pack: shows whether the pack
  takes the exponentials' pipe) and ``fma + ex2 + cvt`` (the whole inner loop
  of the fp32 form), and ``fma + cvt + ex2.bf16x2`` (the argument packed to
  bf16x2 first, then one packed exponential per pair);
- ``ex2_poly``: 2^x for x <= 0 on the FMA and integer pipes (below: a
  clamp, a floor by one add rounding down, a degree-3 polynomial, the
  exponent added into the bits);
- ``loop_poly<n>8``: the softmax's real inner loop, a scale fma, a running
  maximum, the exponential and the bf16 pack of each pair of scores, with
  n of every 8 exponentials (n = 0 .. 4) on ``ex2_poly`` and the rest on
  ``ex2.approx``: the rate at each share says how far moving exponentials
  off the special-function unit lowers the softmax's floor.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "anyv2v_torch", "csrc")
ITERS = 256
CHAINS = 8

# name -> (loop body over chain j, results per chain per iteration)
OPS = {
    "ex2_f32": ('asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(f[j]));', 1),
    "ex2_f16x2": ('asm volatile("ex2.approx.f16x2 %0, %0;" : "+r"(u[j]));', 2),
    "ex2_bf16x2": ('asm volatile("ex2.approx.ftz.bf16x2 %0, %0;" : "+r"(u[j]));', 2),
    "cvt_bf16x2_f32": ('asm volatile("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(u[j]) : "f"(f[j]));'
                       ' f[j] = __uint_as_float(u[j]);', 1),
    "fmax_f32": ('asm volatile("max.f32 %0, %0, %1;" : "+f"(f[j]) : "f"(g));', 1),
    "ffma_f32": ('asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(f[j]) : "f"(g));', 1),
    # two exponentials and their bf16 pack (rate: exponentials)
    "mix_ex2_cvt": ('asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(f[j]));'
                    ' asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(e[j]));'
                    ' asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u[j]) : "f"(e[j]), "f"(f[j]));'
                    ' f[j] = __uint_as_float(u[j]);', 2),
    # the fp32 inner loop: fma, ex2 on each of two scores, one pack
    "mix_fma_ex2_cvt": ('asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(f[j]) : "f"(g));'
                        ' asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(e[j]) : "f"(g));'
                        ' asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(f[j]));'
                        ' asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(e[j]));'
                        ' asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u[j]) : "f"(e[j]), "f"(f[j]));'
                        ' f[j] = __uint_as_float(u[j]);', 2),
    # the packed form: fma on each score, pack the arguments, one bf16x2 exponential
    "mix_fma_cvt_ex2bf16x2": ('asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(f[j]) : "f"(g));'
                              ' asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(e[j]) : "f"(g));'
                              ' asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u[j]) : "f"(e[j]), "f"(f[j]));'
                              ' asm volatile("ex2.approx.ftz.bf16x2 %0, %0;" : "+r"(u[j]));'
                              ' f[j] = __uint_as_float(u[j]);', 2),
}
# the real inner loop with n of each 8 exponentials (chains j < n) on ex2_poly
for _n in range(5):
    OPS[f"loop_poly{_n}8"] = (
        "{ const float a = fmaf(f[j], g, -1.f), b = fmaf(e[j], g, -1.f);"
        " m[j] = fmaxf(m[j], fmaxf(a, b));"
        f" const float x = j < {_n} ? ex2_poly(a) : hopper::ex2(a);"
        f" const float y = j < {_n} ? ex2_poly(b) : hopper::ex2(b);"
        ' asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u[j]) : "f"(y), "f"(x));'
        " f[j] = __uint_as_float(u[j]); e[j] = y; }", 2)
OPS["ex2_poly"] = ("f[j] = ex2_poly(-f[j]);", 1)

# 2^x for x <= 0 off the special-function unit: x clamped to -127, j =
# floor(x) by one add of 1.5 * 2^23 rounding down (j lands in the sum's low
# mantissa bits), f = x - j in [0, 1), 2^f by a degree-3 polynomial (minimax
# in relative error with p(0) = 1: at most 8.6e-5, a tenth of bf16's
# half-ulp), j added into the exponent bits; -inf gives exactly 0
POLY = """
__device__ __forceinline__ float ex2_poly(float x) {
  constexpr float ROUND = 12582912.f;   // 1.5 * 2^23
  x = fmaxf(x, -127.f);
  float t;
  asm("add.rm.f32 %0, %1, %2;" : "=f"(t) : "f"(x), "f"(ROUND));
  const float f = x - (t - ROUND);
  const float p = fmaf(fmaf(fmaf(0.077068031f, f, 0.22764353f), f, 0.69511729f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
"""

KERNEL = """
__global__ void probe_{name}(unsigned long long* cycles, float* sink, float seed) {{
  float f[{chains}], e[{chains}], m[{chains}];
  unsigned u[{chains}];
  const float g = seed * 0.5f;
#pragma unroll
  for (int j = 0; j < {chains}; ++j) {{
    f[j] = seed * (j + 1) * 1e-3f;
    e[j] = -f[j];
    m[j] = -INFINITY;
    u[j] = 0xBC00BC00u ^ (unsigned)(threadIdx.x + j);
  }}
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < {iters}; ++i) {{
#pragma unroll
    for (int j = 0; j < {chains}; ++j) {{ {body} }}
  }}
  __syncthreads();
  const long long t1 = clock64();
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < {chains}; ++j) acc += f[j] + e[j] + m[j] + __uint_as_float(u[j]);
  if (acc == 1.2345f) sink[threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = (unsigned long long)(t1 - t0);
}}
extern "C" int run_{name}(void* cycles, void* sink, int blocks, int threads) {{
  probe_{name}<<<blocks, threads>>>((unsigned long long*)cycles, (float*)sink, 0.37f);
  return (int)cudaGetLastError();
}}
"""


def build(out: str) -> str:
    if os.path.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)
    src = os.path.join(out, "sfu_probe.cu")
    with open(src, "w") as f:
        f.write("#include <cuda_runtime.h>\n#include \"hopper.cuh\"\n" + POLY)
        for name, (body, _) in OPS.items():
            f.write(KERNEL.format(name=name, body=body, iters=ITERS, chains=CHAINS))
    so = os.path.join(out, "libsfu_probe.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-Xcompiler", "-fPIC", "-shared", "-I", CSRC, "-o", so, src], check=True)
    return so


def sass_opcodes(so: str) -> dict:
    """{kernel: {opcode: count}} of the probe kernels' SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*probe_(\w+?)(?:P\w*)?$", line.strip())
        if m:
            current = next((n for n in OPS if m.group(1).startswith(n)), m.group(1))
            out[current] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if current and m:
            op = m.group(1)
            out[current][op] = out[current].get(op, 0) + 1
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build", "variants", "sfu_probe"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    print("device:", torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    so = build(a.out)
    ops = sass_opcodes(so)
    for name in OPS:
        interesting = {k: v for k, v in ops.get(name, {}).items()
                       if k.split(".")[0] in ("MUFU", "F2FP", "FMNMX", "FFMA", "HMUL2", "HFMA2",
                                              "F2F", "PRMT", "FMUL", "HADD2", "IMAD", "MOV", "FADD",
                                              "SHF", "LEA", "IADD3", "LOP3", "FSEL")}
        print(f"sass {name}: {interesting}")
    lib = ctypes.CDLL(so)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1024, device="cuda")
    for warps in (8, 32):
        threads = 32 * warps
        for name, (_, per) in OPS.items():
            fn = getattr(lib, f"run_{name}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            for _ in range(2):   # the first launch warms up
                rc = fn(ctypes.c_void_p(cycles.data_ptr()), ctypes.c_void_p(sink.data_ptr()),
                        sms, threads)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
                torch.cuda.synchronize()
            cyc = cycles.double().cpu().numpy()
            results = threads * ITERS * CHAINS * per
            rate = results / cyc
            print(f"rate {name} warps {warps}: {np.mean(rate):.3f} results per SM per clock "
                  f"(min {np.min(rate):.3f}, max {np.max(rate):.3f}; "
                  f"{np.mean(cyc):.0f} cycles a block)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
