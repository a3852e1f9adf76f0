"""Guards of the PyTorch port: it never imports JAX, it never runs a CUDA
request on the CPU, and its kernel wrappers never answer a non-CPU request
with their plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import anyv2v_torch
from anyv2v_torch.ops import _build, ffn, folded_attention, frame_attention, temporal_conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "anyv2v_torch", "anyv2v_torch.ops.attention", "anyv2v_torch.ops.pnp",
    "anyv2v_torch.ops.folded_attention", "anyv2v_torch.ops.frame_attention",
    "anyv2v_torch.ops.ffn", "anyv2v_torch.ops.temporal_conv", "anyv2v_torch.schedulers",
    "anyv2v_torch.models.layers", "anyv2v_torch.models.unet_i2vgen",
    "anyv2v_torch.models.vae", "anyv2v_torch.models.clip", "anyv2v_torch.pipelines.common",
    "anyv2v_torch.pipelines.i2vgen", "anyv2v_torch.utils.model_zoo",
    "anyv2v_torch.utils.weights", "anyv2v_torch.utils.io", "anyv2v_torch.cli.common",
    "anyv2v_torch.cli.run_group_ddim_inversion", "anyv2v_torch.cli.run_group_pnp_edit",
]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA GPU")


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_never_import_jax():
    for dirpath, _, files in os.walk(os.path.join(REPO, "anyv2v_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        words = line.split()
                        assert not (words[:2] == ["import", "jax"] or words[:1] == ["from"]
                                    and words[1:2] and words[1].split(".")[0] == "jax"), \
                            f"{name}: {line.strip()}"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert "jax" not in f.read()


def test_cuda_device_without_gpu_raises():
    _no_cuda()
    from anyv2v_torch.cli.common import build_pipeline_from_config
    from anyv2v_torch.utils.model_zoo import build_i2vgen_pipeline

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        anyv2v_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_i2vgen_pipeline("i2vgen-tiny", device="cuda", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_pipeline_from_config({"model": {"arch": "i2vgen-tiny"}}, "cuda")
    with pytest.raises(ValueError, match="device is required"):
        anyv2v_torch.resolve_device(None)


def test_kernel_library_needs_a_gpu():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        _build.library()


@pytest.mark.parametrize("name", ["folded", "frame", "ffn", "temporal_conv"])
def test_wrappers_refuse_non_cpu_tensors(name):
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper either launches its kernel (CUDA) or raises."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    calls = {
        "folded": lambda: folded_attention.folded_attention(t(1, 16, 64), t(1, 16, 64),
                                                            t(1, 16, 64), 8, 0.3),
        "frame": lambda: frame_attention.frame_attention(t(1, 4, 8, 64), t(1, 4, 8, 64),
                                                         t(1, 4, 8, 64), 8, 0.3),
        "ffn": lambda: ffn.ffn_geglu(t(4, 64), t(512, 64), t(512), t(64, 256), t(64)),
        "temporal_conv": lambda: temporal_conv.gn_silu_temporal_conv(
            t(1, 4, 8, 64), t(1, 64, dtype=torch.float32), t(1, 64, dtype=torch.float32),
            t(3, 64, 64), t(64)),
    }
    before = {w: w.launches for w in (folded_attention.folded_attention,
                                      frame_attention.frame_attention, ffn.ffn_geglu,
                                      temporal_conv.gn_silu_temporal_conv)}
    with pytest.raises(ValueError, match="expected CUDA or CPU tensors"):
        calls[name]()
    assert all(w.launches == n for w, n in before.items())


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32))
    got = folded_attention.folded_attention(q, q, q, 4, 0.5)
    want = folded_attention.folded_attention_plain(q, q, q, 4, 0.5)
    assert torch.equal(got, want) and folded_attention.folded_attention.launches == 0
