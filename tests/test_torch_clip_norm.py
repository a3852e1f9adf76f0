"""i2vgen-xl's temporal transformer normalises over each clip's frames, as
the published module does (diffusers' ``TransformerTemporalModel`` takes
``nn.GroupNorm`` on ``[B, C, F, H, W]``), on every path of the port.

- The norm itself (``layers.clip_group_norm``) and the one the module feeds
  its ``proj_in``, unbiased, biased and with the PnP source row injected,
  against ``F.group_norm`` on ``[B, C, F, H, W]``: float32, rtol and atol
  1e-5 (fp32 statistics over at most a few thousand elements a group round
  to about 1e-6; the per-frame norm misses by more than 0.1 here).
- A tiny i2vgen UNet of 4 frames on seeded weights against the benchmark's
  plain float32 reference (``v2vbench/reference/unet_i2vgen.py``, which
  imports nothing of the port), with and without PnP: relative L2 under
  1e-5 (float32 rounding through the UNet reads 1.0e-6; the same UNet
  with the norm per frame reads 7.1e-2, and is held to read above 1e-3).
- The frame-sharded branch on the mock mesh (one process, the collectives
  local): a rank's frames of a clip made of ``n`` copies of them normalise
  as the whole clip does (``n`` equal partial moments merge into the same
  mean and variance), to 1e-6.
  ``test_torch_parallel.py`` holds the branch on a real 4-rank gloo group.
"""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from anyv2v_torch.models import layers as tl
from anyv2v_torch.parallel import mesh as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _published(x, norm):
    """``nn.GroupNorm`` on ``[B, C, F, H, W]``, back to ``[B, F, H, W, C]``."""
    y = F.group_norm(x.permute(0, 4, 1, 2, 3), norm.num_groups, norm.weight, norm.bias, norm.eps)
    return y.permute(0, 2, 3, 4, 1)


def _module(c=32, heads=4, hd=8, groups=8, seed=0):
    torch.manual_seed(seed)
    m = tl.TemporalTransformer(c, heads, hd, groups=groups)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
        m.norm.weight += 1.0
    return m.eval()


def _clip(b=3, f=5, h=4, w=4, c=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    # frames far apart, so that per-frame and per-clip statistics differ
    return (torch.randn(b, f, h, w, c, generator=g)
            + 2.0 * torch.arange(f, dtype=torch.float32)[None, :, None, None, None])


@pytest.mark.parametrize("b,f,side,c,groups", [(3, 5, 4, 32, 8), (2, 4, 8, 64, 8),
                                               (3, 4, 4, 320, 32), (3, 16, 4, 40, 4)])
def test_clip_group_norm_is_group_norm_over_the_clip(b, f, side, c, groups):
    m = _module(c=c, groups=groups)
    x = _clip(b=b, f=f, h=side, w=side, c=c)
    want = _published(x, m.norm)
    torch.testing.assert_close(tl.clip_group_norm(x, m.norm), want, **TOL)
    per_frame = tl.group_norm(x.reshape(-1, *x.shape[2:]), m.norm).reshape(x.shape)
    assert (per_frame - want).abs().max() > 0.1


@pytest.mark.parametrize("path", ["plain", "inject", "bias"])
def test_temporal_transformer_feeds_proj_in_the_clip_norm(path):
    """What the module's ``proj_in`` receives is the published norm of its
    input on every branch: the frame-axis block (with and without the PnP
    source row injected) and the biased ``[(B H W), F, C]`` rows."""
    m = _module()
    x = _clip()
    seen = []
    m.proj_in.register_forward_pre_hook(lambda mod, args: seen.append(args[0].clone()))
    bias = torch.randn(4, 5, 5) if path == "bias" else None
    with torch.no_grad():
        m(x, inject=path == "inject", bias=bias)
    want = _published(x, m.norm).reshape(3, 5, 16, 32)
    assert len(seen) == 1
    torch.testing.assert_close(seen[0], want, **TOL)


def _tiny_unet():
    from v2vbench import weights
    from v2vbench.cell import as_tuples, load_module
    from v2vbench.reference import spec

    from anyv2v_torch.models.unet_i2vgen import I2VGenUNet, I2VGenUNetConfig

    with open(os.path.join(REPO, "v2vbench", "tests", "configs", "i2vgen-tiny.json")) as f:
        cfg = json.load(f)["unet"]
    state = {k: v.float() for k, v in
             weights.draw(spec.unet_spec("i2vgen", cfg), 7, 1, "cpu").items()}
    prog = load_module(I2VGenUNet, I2VGenUNetConfig(**as_tuples(cfg), dtype=torch.float32),
                       state, "cpu", torch.float32)
    return cfg, state, prog


def _gap(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pnp", [None, (True, True, True)], ids=["plain", "pnp"])
def test_tiny_i2vgen_unet_matches_the_published_reference(two_threads, monkeypatch, pnp):
    from v2vbench.reference import unet_i2vgen
    from v2vbench.reference.nn import Params

    cfg, state, prog = _tiny_unet()
    g = torch.Generator().manual_seed(11)
    b, f = 3, 4
    x = torch.randn(b, f, 32, 32, 4, generator=g)
    text = torch.randn(b, 4, cfg["cross_attention_dim"], generator=g)
    il = torch.randn(b, f, 32, 32, 4, generator=g)
    ie = torch.randn(b, 1, cfg["cross_attention_dim"], generator=g)
    with torch.inference_mode():
        want = unet_i2vgen.unet(Params(state), cfg, x, 501, text, 8, il, ie, pnp=pnp)
        got = prog(x, 501, text, 8, il, ie, pnp=pnp)
        assert _gap(got, want) < 1e-5
        # the same UNet with the norm per frame is far off: the test can tell
        monkeypatch.setattr(tl, "clip_group_norm", lambda y, norm: tl.group_norm(
            y.reshape(-1, *y.shape[2:]), norm).reshape(y.shape))
        assert _gap(prog(x, 501, text, 8, il, ie, pnp=pnp), want) > 1e-3


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_branch_on_the_mock_mesh(n):
    """Inside an n-rank mock region a rank holds F/n frames and the gather
    of partial moments tiles this rank's n times: for a clip of n copies of
    one rank's frames the rank's output equals its frames of the whole
    clip's norm, through the sharded branch's merge of gathered partials."""
    m = _module()
    local = _clip(f=3)
    whole = torch.cat([local] * n, dim=1)
    want = _published(whole, m.norm)[:, :3]
    with tm.mock_manual_axis(n):
        assert tm.sharded_region() is not None
        got = tl.clip_group_norm(local, m.norm)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # with the gather a tiling, any rank's frames normalise as a clip of their own
    other = _clip(f=3, seed=5)
    with tm.mock_manual_axis(n):
        own = tl.clip_group_norm(other, m.norm)
    torch.testing.assert_close(own, _published(other, m.norm), rtol=1e-6, atol=1e-6)
