"""What the program's spans cost while tracing is off, per ConsistI2V edit.

    python3 scripts/torch_span_cost.py [--edit-steps 46] [--batch3-steps 21]

Counts the spans of one full-width ConsistI2V UNet forward (16 + 1 frames at
64x64 latents, batch 3 with PnP and batch 2, on the ``meta`` device with the
kernel entries stubbed), of the VAE calls of an edit (two one-frame encodes,
the 17-frame decode in chunks of 16) and of the pipeline's loop, then times a disabled span
on this host: a ``@spanned`` function call and a ``with span(...)`` block,
each less a plain call. Prints the spans an edit opens and their cost, as
milliseconds and as a share of an edit of ``--edit-s`` seconds. No device
and no weights: shapes only.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from anyv2v_torch.models import layers  # noqa: E402
from anyv2v_torch.ops import attention, norm, temporal_conv  # noqa: E402
from anyv2v_torch.utils import profiling  # noqa: E402
from anyv2v_torch.utils.model_zoo import ARCHS, build_modules  # noqa: E402


def _meta(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


def _stub_kernels() -> None:
    """The kernel entries as shape-only functions (a kernel has no meta form)."""
    layers.ffn_geglu = lambda x, w1, b1, w2, b2: x.new_empty(*x.shape[:-1], w2.shape[0])
    temporal_conv.gn_silu_temporal_conv = lambda x, s, t, w, b: x.new_empty(*x.shape[:-1],
                                                                           w.shape[2])
    for name in ("flash_attention", "folded_attention", "frame_attention",
                 "frame_attention_long"):
        setattr(attention, name, lambda q, *args, **kwargs: torch.empty_like(q))
    norm.group_norm = lambda x, w, b, groups, eps, dtype, silu=False: x.new_empty(x.shape,
                                                                                 dtype=dtype)
    norm.layer_norm = lambda x, w, b, eps, dtype: x.new_empty(x.shape, dtype=dtype)
    norm.group_scale_shift = lambda x, w, b, groups, eps: 2 * (
        x.new_empty(x.shape[0], x.shape[-1], dtype=torch.float32),)


def edit_spans(steps: int, batch3: int) -> tuple:
    """(spans an edit opens by name, of them opened by ``with span``)."""
    _stub_kernels()
    modules = build_modules("consisti2v", torch.bfloat16)
    unet, vae = (modules[k].to(torch.bfloat16).eval() for k in ("unet", "vae"))
    ctx = ARCHS["consisti2v"]["unet"].cross_attention_dim
    counts = collections.Counter()
    with torch.inference_mode():
        for batch, n in ((3, batch3), (2, steps - batch3)):
            pnp = {"pnp": (True, True, True), "pnp_chunks": 3} if batch == 3 else {}
            with profiling.tracing() as tracer:
                unet(_meta(batch, 16, 64, 64, 4), 501, _meta(batch, 77, ctx),
                     _meta(batch, 1, 64, 64, 4), 3, **pnp)
            counts.update({k: v * n for k, v in
                           collections.Counter(s.name for s in tracer.take()).items()})
        with profiling.tracing() as tracer:
            vae.encode_moments(_meta(1, 512, 512, 3))
            vae.encode_moments(_meta(1, 512, 512, 3))
            vae.decode(_meta(16, 64, 64, 4))   # decode_latents: chunks of 16 frames
            vae.decode(_meta(1, 64, 64, 4))
        counts.update(s.name for s in tracer.take())
    # the pipeline: an edit, its steps and CFG updates, three segments, two
    # encodes and a decode (their VAE spans counted above)
    counts.update({"pipe.edit": 1, "pipe.step": steps, "pipe.guide": steps, "pipe.segment": 3,
                   "pipe.encode": 2, "pipe.decode": 1})
    resnets = sum(isinstance(m, layers.ResnetBlock2D) for m in unet.modules())
    inline = steps * (1 + resnets) + 2 * steps + 3   # unet.embed, ResnetBlock2D, step, guide
    return counts, inline


def off_cost_ns(number: int = 1_000_000, repeat: int = 7) -> tuple:
    """(a disabled ``@spanned`` call, a disabled ``with span`` block), each
    less a plain call, in ns: the best of ``repeat``."""
    def plain():
        return None

    @profiling.spanned("layer.norm")
    def decorated():
        return None

    def inline():
        with profiling.span("layer.norm"):
            return None

    best = {f: min(timeit.repeat(f, number=number, repeat=repeat)) / number * 1e9
            for f in (plain, decorated, inline)}
    return best[decorated] - best[plain], best[inline] - best[plain]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--edit-steps", type=int, default=46)
    ap.add_argument("--batch3-steps", type=int, default=21)
    ap.add_argument("--edit-s", type=float, default=13.687)
    args = ap.parse_args()
    counts, inline = edit_spans(args.edit_steps, args.batch3_steps)
    total = sum(counts.values())
    deco_ns, with_ns = off_cost_ns()
    cost = (total - inline) * deco_ns + inline * with_ns
    print(f"spans an edit: {total} ({inline} by `with span`), by name: {dict(counts)}")
    print(f"a disabled span: @spanned +{deco_ns:.1f} ns, `with span` +{with_ns:.1f} ns")
    print(f"off cost of an edit: {cost / 1e6:.3f} ms, {100 * cost / 1e9 / args.edit_s:.4f} % "
          f"of {args.edit_s} s; every span at the `with` cost: {total * with_ns / 1e6:.3f} ms, "
          f"{100 * total * with_ns / 1e9 / args.edit_s:.4f} %")


if __name__ == "__main__":
    main()
