"""K2, the frame-axis attention (``csrc/frame_attention.cu``, up to 32
frames): the temporal attention of every pixel over the clip's frames."""

from v2vbench.roofline import attention_cost, true_head_dim

NAME = "K2"
PATTERNS = (r"\bframe_attention_kernel\b",)
WRAP = (("anyv2v_torch.ops.attention", "frame_attention"),)


def cost(q, k, v, heads, scale, bias=None, *args, **kwargs):
    """q ``[B, S, P, H*dh]``, k/v ``[B, Sk, P, H*dh]``: B*P rows."""
    b, s, p, _ = q.shape
    return attention_cost(b * p, s, k.shape[1], heads, true_head_dim(scale), bias=bias)
