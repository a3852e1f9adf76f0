"""The published I2VGen-XL temporal norm on the JAX side of the port's parity
tests.

The port's ``TemporalTransformer`` takes its group norm's statistics over
each clip's frames and pixels together, as diffusers'
``TransformerTemporalModel`` does: it permutes to ``[B, C, F, H, W]`` and
calls ``torch.nn.GroupNorm``. The JAX package's module normalises each frame
on its own (``x.reshape(b * f, h, w, c)`` into ``nn.GroupNorm``), and it is
not changed. A test that holds a port module reaching an i2vgen temporal
transformer to the JAX module runs the JAX side under :func:`clip_norm`: a
``flax.linen.intercept_methods`` interceptor that gives that ``norm``
GroupNorm's call the published norm of its clip, torch's ``F.group_norm`` on
``[B, C, F*H, W]`` (a ``jax.pure_callback``) with the GroupNorm's own scale,
bias, groups and eps, and hands it back in the module's shape. Nothing else
of the JAX module changes. The published op rather than flax's GroupNorm on
``[B, F*H, W, C]``: flax takes the variance as ``E[x^2] - E[x]^2``, torch in
two passes, and the tiny pipelines' edits amplify that difference in the
rounding to about the parity tests' tolerance.

:func:`clip_norm` is a context manager; :func:`module_clip_norm` is the same
as a module-scoped autouse fixture (``from jax_clip_norm import
module_clip_norm``), set up before the module's other fixtures, so that JAX
references built once per module take the published norm too. Inside a
sharded JAX region the interceptor refuses to run: the port's sharded norm is
held to the unsharded JAX module instead.
"""

from __future__ import annotations

import contextlib
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.models import layers as jl
from anyv2v_tpu.parallel import mesh as jm

_clips = []   # the batch of each TemporalTransformer call in progress, innermost last


def _published_norm(x, scale, bias, groups, eps):
    """torch's ``F.group_norm`` of a channels-last ``[B, S, W, C]`` fp32 array."""
    t = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
    y = torch.nn.functional.group_norm(t, groups, torch.from_numpy(np.array(scale)),
                                       torch.from_numpy(np.array(bias)), eps)
    return y.permute(0, 2, 3, 1).contiguous().numpy()


def _interceptor(next_fun, args, kwargs, context):
    module = context.module
    if context.method_name != "__call__":
        return next_fun(*args, **kwargs)
    if isinstance(module, jl.TemporalTransformer):
        _clips.append(args[0].shape[0])
        try:
            return next_fun(*args, **kwargs)
        finally:
            _clips.pop()
    if (isinstance(module, nn.GroupNorm) and module.name == "norm"
            and isinstance(module.parent, jl.TemporalTransformer)):
        region = jm.current_manual_axis()
        if region is not None and region[1] > 1:
            raise NotImplementedError("clip_norm: a sharded JAX region")
        x = args[0]
        clip = x.reshape(_clips[-1], -1, *x.shape[2:]).astype(jnp.float32)
        if module.is_initializing():
            next_fun(clip, *args[1:], **kwargs)        # the module's own call makes its parameters
        p = module.variables["params"]
        out = jax.pure_callback(
            functools.partial(_published_norm, groups=module.num_groups, eps=module.epsilon),
            jax.ShapeDtypeStruct(clip.shape, jnp.float32), clip, p["scale"], p["bias"],
            vmap_method="sequential")
        # the dtype flax's GroupNorm gives an fp32 input: its own, else fp32
        return out.astype(module.dtype or jnp.float32).reshape(x.shape)
    return next_fun(*args, **kwargs)


@contextlib.contextmanager
def clip_norm():
    """The JAX i2vgen ``TemporalTransformer``'s norm over each clip's frames,
    inside the context. JAX's traced functions are dropped on the way in and
    out (``jax.clear_caches``): one traced before, or under, the context
    would otherwise be reused with the other norm."""
    jax.clear_caches()
    try:
        with nn.intercept_methods(_interceptor):
            yield
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def module_clip_norm():
    with clip_norm():
        yield
