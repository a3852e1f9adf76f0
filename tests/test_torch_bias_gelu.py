"""The port's score-bias and GELU-form surfaces against the JAX package.

``multi_head_attention(bias=, mask=)`` in every route class it has (a bias
shared by the batch at short lengths on the frame kernels' ``[B, S, 1, C]``
view, K2 and K2 long; any other bias on K5 at its widths; a bias at another
width, a mask, or both, on SDPA), each call's route recorded; ``Attention``,
``BasicTransformerBlock`` and ``TemporalTransformer`` with a bias; and
``FeedForward(activation="gelu")`` on K3's GELU form. On the CPU every
kernel wrapper runs its plain version. The JAX side runs its own modules on
the converter's weights, fp32 on the CPU, where its dispatcher sends every
biased or masked call to XLA.

Tolerance rtol 1e-4, atol 2e-5 (tests/test_torch_kernels.py's ``TOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import layers as jl
from anyv2v_tpu.ops import attention as jattn
from anyv2v_tpu.utils import convert as C
from anyv2v_torch.models import layers as tl
from anyv2v_torch.ops import attention
from test_torch_blocks import jparams, randomize
from jax_clip_norm import module_clip_norm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=2e-5)
ROUTES = ("folded_attention", "frame_attention", "frame_attention_long", "flash_attention",
          "sdpa_attention")


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture
def routes(monkeypatch):
    """The dispatcher's routes taken, in call order (each wrapper called
    through)."""
    taken = []

    def wrap(name, fn):
        def call(*args, **kwargs):
            taken.append(name)
            return fn(*args, **kwargs)
        return call

    for name in ROUTES:
        monkeypatch.setattr(attention, name, wrap(name, getattr(attention, name)))
    return taken


# (id, b, sq, sk, heads, dh, bias shape or None, mask shape or None, route)
_MHA = [
    ("shared short -> K2", 3, 16, 16, 2, 40, "h", None, "frame_attention"),
    ("shared [1,H] augmented keys -> K2", 2, 17, 25, 2, 64, "1h", None, "frame_attention"),
    ("shared [Sq,Sk] broadcast -> K2", 4, 8, 8, 4, 8, "qk", None, "frame_attention"),
    ("shared past 32 frames -> K2 long", 2, 40, 48, 2, 16, "h", None, "frame_attention_long"),
    ("shared long -> K5", 2, 150, 150, 2, 32, "h", None, "flash_attention"),
    ("shared cross Sk > Sq + 16 -> K5", 2, 16, 77, 2, 40, "h", None, "flash_attention"),
    ("per row short -> K5", 3, 16, 16, 2, 80, "bh", None, "flash_attention"),
    ("per row [B,1] long -> K5", 2, 130, 70, 2, 16, "b1", None, "flash_attention"),
    ("shared at a width no kernel takes -> SDPA", 2, 16, 16, 2, 192, "h", None,
     "sdpa_attention"),
    ("mask -> SDPA", 2, 20, 30, 2, 40, None, "b1", "sdpa_attention"),
    ("mask and bias -> SDPA", 2, 20, 20, 2, 64, "h", "bh", "sdpa_attention"),
]


def _bias_shape(form, b, heads, sq, sk):
    return {"h": (heads, sq, sk), "1h": (1, heads, sq, sk), "qk": (sq, sk),
            "bh": (b, heads, sq, sk), "b1": (b, 1, sq, sk)}[form]


@pytest.mark.parametrize("case", [pytest.param(c[1:], id=c[0]) for c in _MHA])
def test_multi_head_attention_bias_and_mask(routes, case):
    b, sq, sk, heads, dh, bias_form, mask_form, route = case
    rng = np.random.RandomState(20)
    c = heads * dh
    q, k, v = _rand(rng, b, sq, c), _rand(rng, b, sk, c), _rand(rng, b, sk, c)
    bias = None if bias_form is None else _rand(rng, *_bias_shape(bias_form, b, heads, sq, sk))
    mask = None
    if mask_form is not None:
        mask = rng.rand(*_bias_shape(mask_form, b, heads, sq, sk)) > 0.4
        mask[..., 0] = True   # every query row keeps a key
    scale = dh ** -0.5
    jb = None if bias is None else jnp.asarray(bias if bias.ndim == 4 else bias[None]
                                               if bias.ndim == 3 else bias[None, None])
    want = jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                      bias=jb, mask=None if mask is None else jnp.asarray(mask),
                                      scale=scale)
    got = attention.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads, scale,
        bias=None if bias is None else torch.from_numpy(bias),
        mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want)
    assert routes == [route]


@pytest.mark.parametrize("dh,with_mask", [(192, False), (64, True)],
                         ids=["bias at a width no kernel takes", "mask and bias"])
def test_sdpa_bias_routes_keep_the_bias_in_fp32(routes, dh, with_mask):
    """bf16 tokens with a T5-sized fp32 bias (|bias| ~ 10, where a bf16
    step is 0.0625) on the SDPA routes: the bias is added to fp32 scores,
    so the bf16 output is the float64 reference rounded once (within a
    bf16 step of it)."""
    b, s, heads = 2, 16, 2
    rng = np.random.RandomState(26)
    q, k, v = (torch.from_numpy(_rand(rng, b, s, heads * dh)).bfloat16() for _ in range(3))
    bias = (8.0 + 3.0 * _rand(rng, heads, s, s)).astype(np.float32)
    mask = rng.rand(b, heads, s, s) > 0.4 if with_mask else np.ones((b, heads, s, s), bool)
    mask[..., 0] = True
    scale = dh ** -0.5

    def split(x):
        return x.double().numpy().reshape(b, s, heads, dh).transpose(0, 2, 1, 3)

    scores = np.where(mask, split(q) @ split(k).transpose(0, 1, 3, 2) * scale + bias, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    want = ((p / p.sum(-1, keepdims=True)) @ split(v)).transpose(0, 2, 1, 3).reshape(b, s, -1)
    got = attention.multi_head_attention(q, k, v, heads, scale, bias=torch.from_numpy(bias),
                                         mask=torch.from_numpy(mask) if with_mask else None)
    assert got.dtype == torch.bfloat16 and routes == ["sdpa_attention"]
    assert np.all(np.abs(got.double().numpy() - want) <= 2.0 ** -8 * np.abs(want) + 1e-5)


def test_multi_head_attention_refuses_causal_with_a_bias():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="causal"):
        attention.multi_head_attention(x, x, x, 1, 1.0, causal=True, bias=torch.zeros(1, 4, 4))


@pytest.mark.parametrize("ctx_dim,form", [(None, "h"), (None, "bh"), (12, "bh")])
def test_attention_with_a_bias(routes, ctx_dim, form):
    """``Attention(bias=)``: self-attention with a shared or per-row bias, and
    cross-attention with a per-row one, at padded head storage (dh 5 -> 8)."""
    heads, hd, dim, b, s, sk = 2, 5, 24, 3, 10, 7 if ctx_dim else 10
    m = tl.Attention(dim, heads, hd, cross_attention_dim=ctx_dim)
    sd = randomize(m, 21)
    rng = np.random.RandomState(21)
    x = _rand(rng, b, s, dim)
    ctx = _rand(rng, b, sk, ctx_dim) if ctx_dim else None
    bias = _rand(rng, *_bias_shape(form, b, heads, s, sk))
    want = jl.Attention(heads, hd, cross_attention_dim=ctx_dim).apply(
        jparams(C._attn(sd, "m", heads, hd)), jnp.asarray(x),
        context=None if ctx is None else jnp.asarray(ctx),
        bias=jnp.asarray(bias if bias.ndim == 4 else bias[None]))
    got = m(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx),
            bias=torch.from_numpy(bias))
    _close(got, want)
    assert routes == ["frame_attention" if form == "h" else "flash_attention"]


@pytest.mark.parametrize("ctx_dim", [None, 12])
def test_basic_transformer_block_with_a_bias(routes, ctx_dim):
    """The bias reaches attn1 only, as in the JAX block."""
    heads, hd, dim, b, s = 4, 8, 32, 2, 12
    m = tl.BasicTransformerBlock(dim, heads, hd, cross_attention_dim=ctx_dim)
    sd = randomize(m, 22)
    rng = np.random.RandomState(22)
    x = _rand(rng, b, s, dim)
    ctx = _rand(rng, b, 6, ctx_dim) if ctx_dim else None
    bias = _rand(rng, heads, s, s)
    want = jl.BasicTransformerBlock(heads, hd, cross_attention_dim=ctx_dim).apply(
        jparams(C._basic_block(sd, "m", heads, hd)), jnp.asarray(x),
        context=None if ctx is None else jnp.asarray(ctx), bias=jnp.asarray(bias[None]))
    got = m(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx),
            bias=torch.from_numpy(bias))
    _close(got, want)
    assert routes[0] == "frame_attention" and "frame_attention" not in routes[1:]


@pytest.mark.parametrize("form,inject", [("h", False), ("h", True), ("rows", False)])
def test_temporal_transformer_with_a_bias(routes, form, inject):
    """``TemporalTransformer(bias=)`` over [(B H W), F, C] rows, as the JAX
    module: a bias over F shared by every row reaches K2 on the [B, S, 1, C]
    view, a per-row one K5."""
    heads, hd, c, b, f, h, w = 4, 8, 32, 3, 5, 4, 4
    m = tl.TemporalTransformer(c, heads, hd, groups=8)
    sd = randomize(m, 23)
    rng = np.random.RandomState(23)
    x = _rand(rng, b, f, h, w, c)
    bias = _rand(rng, *((heads, f, f) if form == "h" else (b * h * w, heads, f, f)))
    want = jl.TemporalTransformer(heads, hd, groups=8).apply(
        jparams(C._temporal_transformer(sd, "m", heads, hd)), jnp.asarray(x),
        inject=inject if inject else None, bias=jnp.asarray(bias))
    got = m(torch.from_numpy(x), inject=inject, bias=torch.from_numpy(bias))
    _close(got, want)
    assert routes[0] == ("frame_attention" if form == "h" else "flash_attention")


@pytest.mark.parametrize("dim", [32, 64])
def test_feed_forward_gelu_takes_k3(monkeypatch, dim):
    """The GELU form at C 32 and 64 (both inside K3's range) goes to
    ``ffn_gelu``, its plain version on the CPU."""
    calls = []
    real = tl.ffn_gelu
    monkeypatch.setattr(tl, "ffn_gelu", lambda *a: calls.append(a[0].shape) or real(*a))
    m = tl.FeedForward(dim, activation="gelu")
    sd = randomize(m, 24)
    x = _rand(np.random.RandomState(24), 2, 9, dim)
    want = jl.FeedForward(activation="gelu").apply(jparams(C._ff(sd, "m")), jnp.asarray(x))
    _close(m(torch.from_numpy(x)), want)
    assert calls == [(2, 9, dim)]


def test_feed_forward_gelu_outside_k3_stays_unfused(monkeypatch):
    """C 4 (i2vgen's image-latent encoder) fails K3's gate, as it fails the
    Pallas one: the plain Linear path, the same function as JAX's."""
    monkeypatch.setattr(tl, "ffn_gelu", lambda *a: pytest.fail("K3 took C 4"))
    m = tl.FeedForward(4, activation="gelu")
    sd = randomize(m, 25)
    x = _rand(np.random.RandomState(25), 3, 16, 4)
    want = jl.FeedForward(activation="gelu").apply(jparams(C._ff(sd, "m")), jnp.asarray(x))
    _close(m(torch.from_numpy(x)), want)
