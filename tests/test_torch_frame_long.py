"""K2 long, the >32-frame temporal route: the port's dispatcher against the
JAX package's ``short_attention_frames``.

Past 32 frames ``short_attention_frames`` transposes ``[B, S, HW, C]`` to
``[B*HW, S, C]`` and runs ``_short_kernel`` (interpret mode off the TPU); the
port's ``temporal_attention`` routes the same shapes to
``frame_attention_long``, whose CPU path is the plain version. Cases: S = 40,
64, 128 (the long-video clip) at 16 heads of 8 (i2vgen-xl's padded L0 heads)
and 2 heads of 64 (``transformer_in``'s width), with Sk = S, and Sk = S + 8 at
head width 40; with and without a per-head score bias. B*HW <= 8.

Tolerance: rtol 1e-4, atol 2e-5, as ``tests/test_torch_kernels.py``. The CUDA
kernel is held against the same plain version on the GPU by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.ops.pallas_short_attention import short_attention_frames
from anyv2v_torch.ops import attention
from anyv2v_torch.ops.frame_attention import frame_attention_long, takes, takes_long

TOL = dict(rtol=1e-4, atol=2e-5)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("s", [40, 64, 128])
@pytest.mark.parametrize(
    "b,extra,hw,heads,dh,bias",
    [
        (1, 0, 4, 16, 8, False),    # i2vgen-xl L0 class: 64 heads of 5 stored as 8
        (2, 0, 4, 2, 64, True),     # transformer_in's width, with a bias
        (1, 8, 8, 2, 40, False),    # augmented keys at the row body's dh 40
        (2, 8, 2, 2, 40, True),
    ],
)
def test_long_route_vs_short_attention_frames(s, b, extra, hw, heads, dh, bias):
    rng = np.random.RandomState(s + dh)
    sk = s + extra
    c = heads * dh
    q, k, v = _rand(rng, b, s, hw, c), _rand(rng, b, sk, hw, c), _rand(rng, b, sk, hw, c)
    tb = _rand(rng, heads, s, sk) if bias else None
    want = short_attention_frames(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
                                  scale=dh ** -0.5,
                                  bias=None if tb is None else jnp.asarray(tb))
    got = attention.temporal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), heads, dh ** -0.5,
                                       None if tb is None else torch.from_numpy(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dispatcher_routes_by_frame_count(monkeypatch):
    """S <= 32 goes to K2, 32 < S <= 128 to K2 long, past 128 nowhere."""
    seen = []
    for name in ("frame_attention", "frame_attention_long"):
        orig = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _n=name, _f=orig: seen.append(_n) or _f(*a))
    for s in (32, 33, 128):
        x = torch.zeros(1, s, 2, 16)
        attention.temporal_attention(x, x, x, 2, 0.125)
    assert seen == ["frame_attention", "frame_attention_long", "frame_attention_long"]
    x = torch.zeros(1, 129, 2, 16)
    with pytest.raises(NotImplementedError, match="129 query frames"):
        attention.temporal_attention(x, x, x, 2, 0.125)
    assert takes(32, 48, 40) and not takes(33, 33, 8)
    assert takes_long(33, 33, 8) and takes_long(128, 144, 160)
    assert not takes_long(128, 145, 8) and not takes_long(64, 64, 24)


def test_long_wrapper_never_falls_back():
    """A tensor that is not on the CPU launches the kernel or raises: here
    (no GPU) a meta tensor raises instead of taking the plain version."""
    x = torch.empty(1, 64, 4, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expected CUDA or CPU tensors"):
        frame_attention_long(x, x, x, 2, 0.125)
