"""K4, the fused groupnorm-SiLU and (3,1,1) temporal conv
(``csrc/temporal_conv.cu``: its prologue kernel and its GEMM)."""

from v2vbench.roofline import nbytes

NAME = "K4"
PATTERNS = (r"\btemporal_conv_kernel(_prologue)?\b",)
WRAP = (("anyv2v_torch.ops.temporal_conv", "gn_silu_temporal_conv"),)


def cost(x, s, t, w, b, *args, **kwargs):
    """x ``[B, F, P, C]``, the per-channel scale and shift ``s, t``, w
    ``[3, C, C']``: three frame taps of a C x C' product per token."""
    bsz, f, p, c = x.shape
    c_out = w.shape[2]
    out = bsz * f * p * c_out * x.element_size()
    return 2 * bsz * f * p * 3 * c * c_out, sum(nbytes(a) for a in (x, s, t, w, b)) + out
