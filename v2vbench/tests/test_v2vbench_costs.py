"""The yardstick's counts: kernel families at the configuration's true head
widths, and the model's operations from the reference on meta."""

from __future__ import annotations

import json
import os

import pytest
import torch

from v2vbench import manifest, roofline
from v2vbench.reference import spec
from v2vbench.tests.helpers import BENCH

FAMS = manifest.kernel_families()


def stored(b, s, heads, padded):
    return torch.zeros(b, s, heads * padded, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("true,padded", [(5, 8), (10, 16), (20, 32)])
def test_k1_counts_i2vgen_heads_at_their_true_width(true, padded):
    """i2vgen-xl's 64 heads of 5/10/20 are stored 8/16/32 wide; the count
    takes the width from the softmax scale."""
    q, k = stored(48, 4096, 64, padded), stored(48, 4096, 64, padded)
    flops, nbytes = FAMS["k1"].cost(q, k, k, 64, true ** -0.5)
    assert flops == 4 * 48 * 64 * 4096 * 4096 * true
    assert nbytes == 4 * 48 * 4096 * 64 * true * 2
    assert flops < 4 * 48 * 64 * 4096 * 4096 * padded


def test_frame_and_flash_families_count_true_widths():
    q = torch.zeros(3, 16, 4096, 64 * 8, dtype=torch.bfloat16, device="meta")
    flops, _ = FAMS["k2"].cost(q, q, q, 64, 5 ** -0.5)
    assert flops == 4 * 3 * 4096 * 64 * 16 * 16 * 5
    q = torch.zeros(51, 4096, 320, dtype=torch.bfloat16, device="meta")
    ctx = torch.zeros(3, 4096, 320, dtype=torch.bfloat16, device="meta")
    flops, _ = FAMS["k5"].cost(q, q, q, 5, 64 ** -0.5, ctx, ctx, 17)
    assert flops == 4 * 51 * 5 * 4096 * (4096 + 4096) * 64


def test_gemm_families():
    x = torch.zeros(65536, 320, dtype=torch.bfloat16, device="meta")
    w1 = torch.zeros(2560, 320, dtype=torch.bfloat16, device="meta")
    w2 = torch.zeros(320, 1280, dtype=torch.bfloat16, device="meta")
    b1, b2 = (torch.zeros(n, dtype=torch.bfloat16, device="meta") for n in (2560, 320))
    flops, _ = FAMS["k3"].cost(x, w1, b1, w2, b2)
    assert flops == 2 * 65536 * 320 * (2560 + 1280)
    h = torch.zeros(1, 16, 4096, 320, dtype=torch.bfloat16, device="meta")
    st = torch.zeros(1, 320, device="meta")
    w = torch.zeros(3, 320, 320, dtype=torch.bfloat16, device="meta")
    flops, nbytes = FAMS["k4"].cost(h, st, st, w, b2)
    assert flops == 2 * 16 * 4096 * 3 * 320 * 320
    assert roofline.ideal_seconds(flops, nbytes) > 0


def conf(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_model_count_is_positive_stable_and_at_true_widths():
    c = conf("i2vgen-xl")["unet"]
    one = spec.unet_flops("i2vgen", c, 1, 2, 16, 16, 77)
    assert one > 0 and spec.unet_flops("i2vgen", c, 1, 2, 16, 16, 77) == one
    assert spec.unet_flops("i2vgen", c, 3, 2, 16, 16, 77) == 3 * one
    # attention's products depend on heads x width = C alone: 64 heads of
    # 5/10/20 count as 5/10/20 heads of 64 (8/16/32-wide storage would count
    # 64 x 32 = 2048 at C 1280)
    other = dict(c, num_attention_heads=None)
    assert spec.unet_flops("i2vgen", other, 1, 2, 16, 16, 77) == one


def test_vae_count():
    v = conf("i2vgen-xl")["vae"]
    enc = spec.vae_flops(v, "encode", 1, 64, 64)
    assert enc > 0 and spec.vae_flops(v, "encode", 2, 64, 64) == 2 * enc
    assert spec.vae_flops(v, "decode", 1, 64, 64) > 0
