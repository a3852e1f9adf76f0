"""``chip_smoke.py``'s NCCL leg (phase 14) on a gloo group of 4 CPU
processes: the same rank program (``nccl_rank_main``: one sharded i2vgen
forward, the 16-frame invert + edit on the frame mesh) on i2vgen-tiny at
64^2 in fp32, held by the leg's own comparison (``nccl_checks``) against
this process's run on one device; and that comparison fails a rank whose
frames came back out of order, or whose edit is not the whole clip.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from anyv2v_torch.utils.model_zoo import build_i2vgen_pipeline
from test_torch_parallel import REPO, SPAWN_TIMEOUT_S, WORLD, _free_port

SIZE = 64


@pytest.fixture(scope="module")
def leg(tmp_path_factory):
    """(single-device arrays, [rank 0's arrays, ...])."""
    out_dir = str(tmp_path_factory.mktemp("nccl_leg"))
    port = _free_port()
    code = (f"import sys, torch; sys.path[:0] = [{REPO!r}]; torch.set_num_threads(1); "
            "import chip_smoke as cs; "
            f"cs.nccl_rank_main(int(sys.argv[1]), {WORLD}, {port}, {out_dir!r}, backend='gloo', "
            f"device='cpu', arch='i2vgen-tiny', size={SIZE}, dtype=torch.float32)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    torch.set_num_threads(1)
    pipe = build_i2vgen_pipeline("i2vgen-tiny", device="cpu", seed=0, dtype=torch.float32)
    want = {"forward": chip_smoke._nccl_forward(pipe, size=SIZE)}
    with torch.inference_mode():
        want.update(chip_smoke._nccl_workload(pipe, SIZE)[0])
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert not any(rcs), f"ranks {rcs}:\n" + "\n".join(log[-3000:] for log in logs)
    got = []
    for r in range(WORLD):
        with np.load(os.path.join(out_dir, f"{r}.npz")) as z:
            got.append(dict(z))
    return want, got


def test_rank_program_passes_the_legs_checks(leg):
    want, got = leg
    checks, errors = chip_smoke.nccl_checks(want, got)
    assert all(checks.values()), checks
    assert len(checks) == WORLD * (len(want) + 1)
    assert set(want) == {"forward", "traj", "out", "video"}
    assert want["traj"].shape == (chip_smoke.NCCL_INV_STEPS, 1, chip_smoke.NCCL_FRAMES,
                                  SIZE // 8, SIZE // 8, 4)
    # fp32: the sharded program is the one-device program to rounding
    for key, (err, _) in errors.items():
        assert err <= 1e-4, key


@pytest.mark.parametrize("fault", ["frames out of order", "edit not whole"])
def test_legs_checks_fail_a_broken_rank(leg, fault):
    want, got = leg
    broken = [dict(g) for g in got]
    if fault == "frames out of order":
        for key in ("forward", "traj"):
            axis = 1 if key == "forward" else 2
            broken[2][key] = np.roll(broken[2][key], chip_smoke.NCCL_FRAMES // WORLD, axis=axis)
        failed = {"NCCL rank 2 forward within its bound", "NCCL rank 2 traj within its bound",
                  "NCCL rank 2 equal to rank 0"}
    else:
        broken[1]["video"] = broken[1]["video"][: chip_smoke.NCCL_FRAMES // WORLD]
        failed = {"NCCL rank 1 video finite, the whole clip's shape",
                  "NCCL rank 1 equal to rank 0"}
    checks, _ = chip_smoke.nccl_checks(want, broken)
    assert {k for k, ok in checks.items() if not ok} == failed
