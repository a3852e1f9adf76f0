"""The weight keys and shapes each reference model reads, and its operation
count, both from a forward on the ``meta`` device."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import unet_i2vgen, unet_videoldm, vae
from .nn import Params

UNETS = {"i2vgen": unet_i2vgen.unet, "videoldm": unet_videoldm.unet}


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def unet_call(kind: str, cfg: dict, batch: int, frames: int, h: int, w: int, text_tokens: int,
              pnp=None):
    """(function, args, kwargs) of one UNet forward at these sizes on meta
    inputs."""
    d, c = cfg["cross_attention_dim"], cfg["in_channels"]
    x, text = _meta(batch, frames, h, w, c), _meta(batch, text_tokens, d)
    if kind == "i2vgen":
        args = (x, 500, text, 8, _meta(batch, frames, h, w, c), _meta(batch, 1, d))
    else:
        args = (x, 500, text, _meta(batch, 1, h, w, c), 3)
    return UNETS[kind], args, {"pnp": pnp, "chunks": max(batch, 1)}


def unet_spec(kind: str, cfg: dict) -> dict:
    """Key -> shape of a UNet's weights."""
    P = Params()
    fn, args, kw = unet_call(kind, cfg, 1, 2, 8, 8, 4)
    fn(P, cfg, *args, **kw)
    return P.spec


def vae_spec(cfg: dict) -> dict:
    P = Params()
    z = vae.encode(P, cfg, _meta(1, 16, 16, cfg["in_channels"]))
    vae.decode(P, cfg, z)
    return P.spec


def count_flops(fn, *args, **kwargs) -> int:
    """Operations of ``fn`` on meta weights (matrix products, convolutions,
    attention's two products), by ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as counter:
        fn(Params(), *args, **kwargs)
    return int(counter.get_total_flops())


def unet_flops(kind: str, cfg: dict, batch: int, frames: int, h: int, w: int,
               text_tokens: int, pnp=None) -> int:
    fn, args, kw = unet_call(kind, cfg, batch, frames, h, w, text_tokens, pnp)
    return count_flops(fn, cfg, *args, **kw)


def vae_flops(cfg: dict, part: str, frames: int, height: int, width: int) -> int:
    if part == "encode":
        return count_flops(vae.encode, cfg, _meta(frames, height, width, cfg["in_channels"]))
    f = 2 ** (len(cfg["block_out_channels"]) - 1)
    return count_flops(vae.decode, cfg, _meta(frames, height // f, width // f,
                                              cfg["latent_channels"]))
