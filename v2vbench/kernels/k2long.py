"""K2 long, the frame-axis attention past 32 frames
(``csrc/frame_attention.cu``, ``frame_attention_long_kernel``): long video."""

from v2vbench.roofline import attention_cost, true_head_dim

NAME = "K2long"
PATTERNS = (r"\bframe_attention_long_kernel\b",)
WRAP = (("anyv2v_torch.ops.attention", "frame_attention_long"),)


def cost(q, k, v, heads, scale, bias=None, *args, **kwargs):
    b, s, p, _ = q.shape
    return attention_cost(b * p, s, k.shape[1], heads, true_head_dim(scale), bias=bias)
