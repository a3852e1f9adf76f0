"""Guards of the PyTorch port: it never imports JAX or the JAX package, it
never runs a CUDA request on the CPU, and its kernel wrappers never answer a
non-CPU request with their plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import anyv2v_torch
from anyv2v_torch.ops import (_build, ffn, flash_attention, folded_attention, frame_attention,
                               norm, rotary, temporal_conv)

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
    "anyv2v_torch.ops.flash_attention", "anyv2v_torch.ops.rotary",
    "anyv2v_torch.models.unet_videoldm", "anyv2v_torch.pipelines.consisti2v",
    "anyv2v_torch.utils.config", "anyv2v_torch.utils.tokenizer", "anyv2v_torch.utils.metrics",
    "anyv2v_torch.cli.consisti2v_run_ddim_inversion", "anyv2v_torch.cli.consisti2v_run_pnp_edit",
    "anyv2v_torch.ops.relpos", "anyv2v_torch.schedulers.ddpm", "anyv2v_torch.models.unet_seine",
    "anyv2v_torch.pipelines.seine", "anyv2v_torch.cli.seine_run_ddim_inversion",
    "anyv2v_torch.cli.seine_run_pnp_edit", "anyv2v_torch.utils.benchguard",
    "anyv2v_torch.utils.profiling", "anyv2v_torch.ops.freeinit", "anyv2v_torch.utils.camera",
    "anyv2v_torch.utils.checkpoint", "anyv2v_torch.cli.convert_checkpoint",
    "anyv2v_torch.utils.video_prep", "anyv2v_torch.cli.prepare_video",
    "anyv2v_torch.schedulers.euler", "anyv2v_torch.models.unet_sd",
    "anyv2v_torch.models.controlnet", "anyv2v_torch.pipelines.image_edit",
    "anyv2v_torch.pipelines.instantstyle", "anyv2v_torch.ops.attn_maps",
    "anyv2v_torch.cli.edit_image", "anyv2v_torch.product", "anyv2v_torch.product.anyv2v",
    "anyv2v_torch.product.predictor", "anyv2v_torch.product.gradio_app",
    "anyv2v_torch.product.web_demo", "anyv2v_torch.product.walkthrough",
    "anyv2v_torch.cli.gradio_demo", "anyv2v_torch.cli.gradio_demo_cosxl",
    "anyv2v_torch.cli.gradio_demo_style", "anyv2v_torch.parallel",
    "anyv2v_torch.parallel.mesh", "anyv2v_torch.bench", "anyv2v_torch.bench_backbones",
]
FORBIDDEN = ("jax", "anyv2v_tpu")
# host packages the card's machine lacks: only functions that need them
# import them
HOST_ONLY = ("cv2", "PIL", "safetensors", "imageio", "yaml", "gradio")


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA GPU")


def test_port_imports_no_jax():
    """Importing every port module loads neither jax nor the JAX package."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_imports_without_host_packages():
    """Every port module (video preparation, camera motion, the checkpoint
    reader and the product layer included) and chip_smoke.py import where
    OpenCV, PIL, safetensors, imageio, PyYAML and gradio are missing."""
    code = ("import importlib, sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {HOST_ONLY!r}:\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            f"for m in {PORT_MODULES + ['chip_smoke']!r}: importlib.import_module(m)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_roots(line: str):
    """The top-level packages an ``import`` or ``from ... import`` line names."""
    words = line.split()
    if words[:1] == ["import"]:
        return [part.split()[0].split(".")[0] for part in line[len("import"):].split(",")]
    if words[:1] == ["from"] and len(words) > 1:
        return [words[1].split(".")[0]]
    return []


def test_port_sources_never_import_jax():
    """No import statement of the port, of chip_smoke.py or of the port's
    GPU scripts (``scripts/torch_*.py``) names jax or anyv2v_tpu (comments
    and docstrings may)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    paths += [os.path.join(REPO, "scripts", n) for n in os.listdir(os.path.join(REPO, "scripts"))
              if n.startswith("torch_") and n.endswith(".py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "anyv2v_torch")):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for line in f:
                bad = [r for r in _imported_roots(line.strip()) if r in FORBIDDEN]
                assert not bad, f"{path}: {line.strip()}"


def test_import_scan_sees_both_forms():
    assert _imported_roots("import jax.numpy as jnp") == ["jax"]
    assert _imported_roots("from anyv2v_tpu.utils import io") == ["anyv2v_tpu"]
    assert _imported_roots("import os, jax") == ["os", "jax"]
    assert _imported_roots("# from anyv2v_tpu import x") == []


def test_cuda_device_without_gpu_raises():
    _no_cuda()
    from anyv2v_torch.cli.common import build_pipeline_from_config
    from anyv2v_torch.utils.model_zoo import (build_consisti2v_pipeline, build_i2vgen_pipeline,
                                              build_seine_pipeline)

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        anyv2v_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_i2vgen_pipeline("i2vgen-tiny", device="cuda", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_pipeline_from_config({"model": {"arch": "i2vgen-tiny"}}, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_consisti2v_pipeline("consisti2v-tiny", device="cuda", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_pipeline_from_config({"model": {"arch": "consisti2v-tiny"}}, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_seine_pipeline("seine-tiny", device="cuda", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_pipeline_from_config({"model": {"arch": "seine-tiny"}}, "cuda")
    with pytest.raises(ValueError, match="device is required"):
        anyv2v_torch.resolve_device(None)


def test_kernel_library_needs_a_gpu():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        _build.library()


FAKE_NVCC = """#!/bin/sh
echo "$@" >> {log}
case "$*" in *{fail}*) exit 3 ;; esac
while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done
"""


@pytest.mark.parametrize("fail", [None, "ffn.cu"])
def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch, fail):
    """Every source compiles in its own nvcc process, then one nvcc links the
    objects; a failed compile raises and no object or library is left behind.
    (A stand-in nvcc script records its calls: no CUDA toolkit here.)"""
    log, fake = tmp_path / "calls.txt", tmp_path / "nvcc"
    fake.write_text(FAKE_NVCC.format(log=log, fail=fail or "no-such-source"))
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    so = str(tmp_path / "lib.so")
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed.*ffn.cu"):
            _build._compile_and_link(so)
    else:
        _build._compile_and_link(so)
    calls = [c.split() for c in log.read_text().splitlines()]
    compiles = sorted(os.path.basename(c[-1]) for c in calls if "-c" in c)
    assert compiles == sorted(_build.SOURCES)
    links = [c for c in calls if "-shared" in c]
    assert len(links) == (0 if fail else 1) and len(calls) == len(compiles) + len(links)
    left = sorted(os.listdir(tmp_path))
    assert left == sorted(["calls.txt", "nvcc"] + ([] if fail else ["lib.so"]))


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """The library's name hashes every source and header under CSRC: an edit
    to a header that is never compiled alone (``hopper.cuh``) rebuilds, and
    a file of another kind changes nothing."""
    for name in _build.SOURCES + ("hopper.cuh",):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build._source_hash()
    (tmp_path / "notes.txt").write_text("not a source")
    assert _build._source_hash() == before
    (tmp_path / "hopper.cuh").write_text("// hopper.cuh, edited\n")
    edited = _build._source_hash()
    assert edited != before
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert _build._source_hash() not in (before, edited)


@pytest.mark.parametrize("name", ["folded", "frame", "frame_long", "ffn", "temporal_conv",
                                  "flash", "flash_splitkv", "group_norm", "group_scale_shift",
                                  "layer_norm", "rotary"])
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
        "frame_long": lambda: frame_attention.frame_attention_long(
            t(1, 64, 4, 64), t(1, 72, 4, 64), t(1, 72, 4, 64), 8, 0.3),
        "ffn": lambda: ffn.ffn_geglu(t(4, 64), t(512, 64), t(512), t(64, 256), t(64)),
        "temporal_conv": lambda: temporal_conv.gn_silu_temporal_conv(
            t(1, 4, 8, 64), t(1, 64, dtype=torch.float32), t(1, 64, dtype=torch.float32),
            t(3, 64, 64), t(64)),
        "flash": lambda: flash_attention.flash_attention(t(1, 16, 80), t(1, 7, 80),
                                                         t(1, 7, 80), 2, 0.3),
        "flash_splitkv": lambda: flash_attention.flash_attention(
            t(4, 16, 64), t(4, 16, 64), t(4, 16, 64), 1, 0.3, t(2, 16, 64), t(2, 16, 64), 2),
        "group_norm": lambda: norm.group_norm(t(2, 4, 4, 64), t(64), t(64), 8, 1e-5,
                                              torch.bfloat16, silu=True),
        "group_scale_shift": lambda: norm.group_scale_shift(t(2, 4, 16, 64), t(64), t(64), 8,
                                                            1e-5),
        "layer_norm": lambda: norm.layer_norm(t(2, 16, 64), t(64), t(64), 1e-5, torch.bfloat16),
        "rotary": lambda: rotary.rotate_partial(t(2, 5, 8, 64), t(5, dtype=torch.float32), 32),
    }
    before = {w: w.launches for w in (folded_attention.folded_attention,
                                      frame_attention.frame_attention,
                                      frame_attention.frame_attention_long, ffn.ffn_geglu,
                                      temporal_conv.gn_silu_temporal_conv,
                                      flash_attention.flash_attention, norm.group_norm,
                                      norm.group_scale_shift, norm.layer_norm,
                                      rotary.rotate_partial)}
    with pytest.raises(ValueError, match="expected CUDA or CPU tensors"):
        calls[name]()
    assert all(w.launches == n for w, n in before.items())


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout", "device"])
def test_frame_attention_refuses_a_bad_bias(bad):
    """The bias operand is fp32, contiguous, ``[heads, S, Sk]`` and on q's
    device; anything else raises and is never dropped."""
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 6, 8, 16)
    bias = {"shape": torch.zeros(2, 4, 4), "dtype": torch.zeros(2, 4, 6, dtype=torch.bfloat16),
            "layout": torch.zeros(2, 6, 4).transpose(1, 2),
            "device": torch.zeros(2, 4, 6, device="meta")}[bad]
    with pytest.raises(ValueError, match="bias must be"):
        frame_attention.frame_attention(q, k, k, 2, 0.3, bias)
    assert frame_attention.frame_attention.launches == 0


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32))
    got = folded_attention.folded_attention(q, q, q, 4, 0.5)
    want = folded_attention.folded_attention_plain(q, q, q, 4, 0.5)
    assert torch.equal(got, want) and folded_attention.folded_attention.launches == 0
