"""What ``setmaxnreg`` gives a consumer warpgroup on this toolchain: builds
kernels with nvcc for ``sm_90a`` (no launch) and reads, from each kernel's
SASS, the highest register its code uses.

    python3 scripts/torch_regcap_probe.py [--cutlass DIR] [--out DIR]

Two families, compiled side by side:

- CUTLASS's SM90 warp-specialised GEMM kernels (``GemmUniversal`` with
  ``KernelTmaWarpSpecializedCooperative``, a 128 x 256 x 64 tile, and
  ``KernelTmaWarpSpecializedPingpong``, 64 x 256 x 64; bf16 in, fp32
  accumulators, bf16 out), instantiated from the headers under ``--cutlass``
  (default ``/usr/local/cutlass/include``); the register counts their
  kernels ask of ``setmaxnreg`` are read from the same headers;
- minimal kernels of the port's own, on ``csrc/hopper.cuh``'s
  ``setmaxnreg_inc`` / ``setmaxnreg_dec`` with the role taken by
  ``__shfl_sync`` as ``gemm_main_loop`` does: a producer (a warpgroup, or
  K5's lone warp) and 2 or 3 consumer warpgroups whose code keeps N fp32
  values live across a loop (or holds wgmma accumulators of 128 + 64
  columns), each with and without ``setmaxnreg``.

For each kernel it prints ptxas's "Used N registers" (the launch's
allocation), the highest register number the SASS uses plus one, the
``STL`` / ``LDL`` (spill) and ``USETMAXREG`` counts, and every ptxas
warning, word for word. A consumer that passes 65536 / threads without
``STL`` got its registers from ``setmaxnreg``.

    python3 scripts/torch_regcap_probe.py --k1 [--only TEXT] [--out DIR]

builds, instead, K1's ``csrc/folded_attention.cu`` with every head width in
the three-warpgroup layout of its Hopper body (``setmaxnreg`` 24 / 160), once
as it is and once with each change of ``K1_VARIANTS`` (text patches of the
source: other placements of ``setmaxnreg``, and a bulk-group wait put back in
the consumers' code, which holds them at the launch's 128 registers), and
prints the same table for every instance of its kernels (``--only``: the
builds whose name contains the text).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "anyv2v_torch", "csrc")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-Xptxas", "-v",
         "-cubin"]

CUTLASS_SRC = r"""
#include <cutlass/cutlass.h>
#include <cute/tensor.hpp>
#include <cutlass/gemm/dispatch_policy.hpp>
#include <cutlass/gemm/collective/collective_builder.hpp>
#include <cutlass/epilogue/collective/collective_builder.hpp>
#include <cutlass/gemm/kernel/gemm_universal.hpp>
#include <cutlass/gemm/device/gemm_universal_adapter.h>

using namespace cute;
using Bf16 = cutlass::bfloat16_t;
constexpr int AL = 8;

template <class Tile, class Schedule, class EpiSchedule>
struct Gemm {
  using Epi = typename cutlass::epilogue::collective::CollectiveBuilder<
      cutlass::arch::Sm90, cutlass::arch::OpClassTensorOp, Tile, Shape<_1, _1, _1>,
      cutlass::epilogue::collective::EpilogueTileAuto, float, float, Bf16,
      cutlass::layout::RowMajor, AL, Bf16, cutlass::layout::RowMajor, AL,
      EpiSchedule>::CollectiveOp;
  using Main = typename cutlass::gemm::collective::CollectiveBuilder<
      cutlass::arch::Sm90, cutlass::arch::OpClassTensorOp, Bf16, cutlass::layout::RowMajor, AL, Bf16,
      cutlass::layout::ColumnMajor, AL, float, Tile, Shape<_1, _1, _1>,
      cutlass::gemm::collective::StageCountAutoCarveout<static_cast<int>(
          sizeof(typename Epi::SharedStorage))>,
      Schedule>::CollectiveOp;
  using Kernel = cutlass::gemm::kernel::GemmUniversal<Shape<int, int, int, int>, Main, Epi>;
};

using Coop = Gemm<Shape<_128, _256, _64>, cutlass::gemm::KernelTmaWarpSpecializedCooperative,
                  cutlass::epilogue::TmaWarpSpecializedCooperative>::Kernel;
using Ping = Gemm<Shape<_64, _256, _64>, cutlass::gemm::KernelTmaWarpSpecializedPingpong,
                  cutlass::epilogue::TmaWarpSpecialized>::Kernel;

// taking the kernels' addresses instantiates them
extern "C" const void* regcap_cutlass(int i) {
  return i ? (const void*)&cutlass::device_kernel<Ping> : (const void*)&cutlass::device_kernel<Coop>;
}
"""

PORT_SRC = r"""
#include "hopper.cuh"

// NC consumer warpgroups, then the producer (threads NC*128 .. THREADS-1);
// PREG / CREG: the setmaxnreg counts (0: none). Each consumer thread keeps
// LIVE fp32 values live across the loop.
template <int THREADS, int NC, int PREG, int CREG, int LIVE>
__global__ void __launch_bounds__(THREADS, 1)
    regcap_live(const float* __restrict__ in, float* __restrict__ out, int iters) {
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == NC) {
    if constexpr (PREG > 0) hopper::setmaxnreg_dec<PREG>();
    if (threadIdx.x == NC * 128) out[blockIdx.x] = in[blockIdx.x];
    return;
  }
  if constexpr (CREG > 0) hopper::setmaxnreg_inc<CREG>();
  const int stride = gridDim.x * THREADS;
  const float* src = in + blockIdx.x * THREADS + threadIdx.x;
  float a[LIVE];
#pragma unroll
  for (int i = 0; i < LIVE; ++i) a[i] = src[i * stride];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < LIVE; ++i) a[i] = fmaf(a[i], a[(i + 1) % LIVE], 1.0f);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LIVE; ++i) s += a[i];
  out[blockIdx.x * THREADS + threadIdx.x] = s;
}

// The same roles; each consumer warpgroup holds a 64 x 256 and a 64 x 128
// wgmma accumulator (128 + 64 registers a thread) across a loop of products.
template <int THREADS, int NC, int PREG, int CREG>
__global__ void __launch_bounds__(THREADS, 1)
    regcap_wgmma(float* __restrict__ out, int iters) {
  __shared__ __align__(1024) unsigned char smem[64 * 64 * 2 * 3];
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == NC) {
    if constexpr (PREG > 0) hopper::setmaxnreg_dec<PREG>();
    return;
  }
  if constexpr (CREG > 0) hopper::setmaxnreg_inc<CREG>();
  using namespace hopper;
  float d[128], e[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) e[i] = 0.f;
  const uint32_t base = smem_addr(smem);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
    wgmma_ss_n256(d, wgmma_desc_sw128(base, 16, 1024), wgmma_desc_sw128(base + 8192, 16, 1024), 1);
    wgmma_ss_n128(e, wgmma_desc_sw128(base, 16, 1024), wgmma_desc_sw128(base + 16384, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frag(d);
    fence_frag(e);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += d[i];
#pragma unroll
  for (int i = 0; i < 64; ++i) s += e[i];
  out[blockIdx.x * THREADS + threadIdx.x] = s;
}

template __global__ void regcap_live<384, 2, 40, 232, 200>(const float*, float*, int);
template __global__ void regcap_live<384, 2, 0, 0, 200>(const float*, float*, int);
template __global__ void regcap_live<288, 2, 0, 232, 200>(const float*, float*, int);
template __global__ void regcap_live<288, 2, 0, 0, 200>(const float*, float*, int);
template __global__ void regcap_live<512, 3, 24, 160, 140>(const float*, float*, int);
template __global__ void regcap_live<512, 3, 0, 0, 140>(const float*, float*, int);
template __global__ void regcap_wgmma<384, 2, 40, 232>(float*, int);
template __global__ void regcap_wgmma<384, 2, 0, 0>(float*, int);
template __global__ void regcap_wgmma<288, 2, 0, 232>(float*, int);
"""


# K1's Hopper body with every head width in the three-warpgroup layout (the
# C entry's switch launching WG3 instances; compiled, never launched)
K1_ALL_WG3 = [(f"launch_units<{dh}, WARP2>(p", f"launch_units<{dh}, WG3>(p")
              for dh in (16, 32, 64)]
# the same with setmaxnreg placed otherwise, and with what held the
# consumers at the launch's registers put back: (anchor, replacement) text
# patches of csrc/folded_attention.cu
_INC = "  if constexpr (F::PRODUCER_WG) setmaxnreg_inc<F::CONSUMER_REGS>();\n"
_DEC = "    if constexpr (F::PRODUCER_WG) setmaxnreg_dec<F::PRODUCER_REGS>();\n"
_RETURN = "    if (threadIdx.x != 128 * NWG) return;\n"
_ROLE = "  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);\n"
_TURN0 = "  if (TURNS && wg == NWG - 1) named_barrier_arrive(NWG + 1, 256);\n"
K1_VARIANTS = {
    # the role from threadIdx.x alone: not warp-uniform to the compiler
    "role not by shfl": [(_ROLE, "  const int role = (int)threadIdx.x / 128;\n")],
    # the increase after code that only some consumer threads run
    "inc after divergent code": [(_INC, ""), (_TURN0, _TURN0 + _INC)],
    # the increase inside a lambda
    "inc in a lambda": [(_INC, "  auto take = [] { setmaxnreg_inc<F::CONSUMER_REGS>(); };\n"
                               "  take();\n")],
    # the increase and the decrease on two paths that merge before the roles split
    "inc on a merging path": [(_INC, ""), (_DEC, ""),
                              (_ROLE, _ROLE + "  if (role == NWG) setmaxnreg_dec<F::PRODUCER_REGS>();\n"
                               "  else setmaxnreg_inc<F::CONSUMER_REGS>();\n")],
    # the decrease by the producer's one TMA thread only
    "dec after the return": [(_DEC, ""), (_RETURN, _RETURN + _DEC)],
    # no __launch_bounds__
    "no launch bounds": [("__global__ void __launch_bounds__(FormCfg<L>::THREADS, 1)\n"
                          "    folded_attention_kernel", "__global__ void folded_attention_kernel")],
    # the producer warpgroup at 40 and the consumers at 152
    "producer at 40": [("PRODUCER_REGS = 24, CONSUMER_REGS = 160;",
                        "PRODUCER_REGS = 40, CONSUMER_REGS = 152;")],
    # (not runnable) a bulk-group wait in the consumers' code, as WARP2's TMA
    # stores of the output have it
    "a bulk wait in the consumers": [("  if (!F::PRODUCER_WG && tw == 0) bulk_wait();\n}\n",
                                      "  if (tw == 0) bulk_wait();\n}\n")],
}


def k1_source(patches=()) -> str:
    with open(os.path.join(CSRC, "folded_attention.cu")) as f:
        src = f.read()
    for anchor, new in [*K1_ALL_WG3, *patches]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor found {src.count(anchor)} times: {anchor!r}")
        src = src.replace(anchor, new)
    return src


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def sass_table(cubin: str) -> list:
    """(function, highest register + 1, STL, LDL, USETMAXREG, CALL) per function."""
    text = subprocess.run([tool("cuobjdump"), "-sass", cubin], capture_output=True,
                          text=True).stdout
    rows = []
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", func)]
        ops = collections.Counter(
            o.split(".")[0] for o in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func))
        rows.append((name, max(regs) + 1 if regs else 0, ops["STL"], ops["LDL"],
                     ops["USETMAXREG"], ops["CALL"]))
    return rows


def demangle(names):
    p = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
    return p.stdout.splitlines() if p.returncode == 0 else list(names)


def cutlass_counts(include: str) -> list:
    """The register counts that CUTLASS's two kernels ask of setmaxnreg."""
    out = []
    for f in ("sm90_gemm_tma_warpspecialized_cooperative.hpp",
              "sm90_gemm_tma_warpspecialized_pingpong.hpp"):
        path = os.path.join(include, "cutlass", "gemm", "kernel", f)
        try:
            text = open(path).read()
        except OSError as e:
            out.append(f"{f}: {e}")
            continue
        found = [line.strip() for line in text.splitlines() if "RegisterRequirement" in line
                 and ("=" in line or "reg_" in line)]
        out.append(f"{f}: " + " | ".join(found[:6]))
    return out


def build(name, src, out, extra):
    path = os.path.join(out, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cubin = os.path.join(out, f"{name}.cubin")
    return cubin, subprocess.Popen([nvcc(), *FLAGS, *extra, "-o", cubin, path],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cutlass", default="/usr/local/cutlass/include")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "regcap"))
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--only", default="", help="with --k1: the builds whose name contains this")
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)
    print(subprocess.run([nvcc(), "--version"], capture_output=True, text=True).stdout.strip()
          .splitlines()[-1])
    if a.k1:
        builds = [("k1_wg3", k1_source())]
        builds += [("k1_wg3_" + name.replace(" ", "_"), k1_source(patches))
                   for name, patches in K1_VARIANTS.items()]
        jobs = [build(name, text, a.out, ["-I", CSRC]) for name, text in builds
                if a.only in name]
    else:
        for line in cutlass_counts(a.cutlass):
            print(f"cutlass header: {line}")
        jobs = [build("cutlass_ws", CUTLASS_SRC, a.out,
                      ["-I", a.cutlass, "--expt-relaxed-constexpr", "-DNDEBUG"]),
                build("port_ws", PORT_SRC, a.out, ["-I", CSRC])]
    failed = 0
    for cubin, proc in jobs:
        log, _ = proc.communicate()
        name = os.path.basename(cubin)
        for line in log.splitlines():
            if ("Used" in line or "Compiling entry" in line or "warning" in line.lower()
                    or "error" in line.lower() or "C75" in line):
                print(f"ptxas/nvcc [{name}]: {line.strip()[:400]}")
        if proc.returncode:
            print(f"nvcc failed for {name} (exit {proc.returncode}); its last lines:")
            print("\n".join(log.splitlines()[-30:]))
            failed += 1
            continue
        rows = sass_table(cubin)
        for (fn, regs, stl, ldl, setmax, call), pretty in zip(rows,
                                                             demangle([r[0] for r in rows])):
            print(f"sass [{name}] {pretty[:160]}: {regs} registers used, STL {stl}, LDL {ldl}, "
                  f"USETMAXREG {setmax}, CALL {call}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
