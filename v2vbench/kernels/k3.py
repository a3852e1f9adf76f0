"""K3, the fused feed-forward (``csrc/ffn.cu``): x.W1^T with the GEGLU (or
GELU) epilogue, then h.W2^T, where C <= 768."""

from v2vbench.roofline import BF16, nbytes

NAME = "K3"
PATTERNS = (r"\bffn_kernel\b",)
WRAP = (("anyv2v_torch.models.layers", "ffn_geglu"), ("anyv2v_torch.models.layers", "ffn_gelu"))


def cost(x, w1, b1, w2, b2, *args, **kwargs):
    """Both products over W1's rows (2I for GEGLU, I for GELU) and W2's;
    x and the weights read, the output written."""
    c, inner = x.shape[-1], w2.shape[1]
    n = x.numel() // c
    flops = 2 * n * c * (w1.shape[0] + inner)
    return flops, 2 * n * c * BF16 + sum(nbytes(t) for t in (w1, b1, w2, b2))
