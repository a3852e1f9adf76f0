"""K1, the folded attention (``csrc/folded_attention.cu``): i2vgen-xl's
spatial self- and cross-attention of 64 narrow heads, and short self- and
cross-attention (both of its bodies)."""

from v2vbench.roofline import attention_cost, true_head_dim

NAME = "K1"
PATTERNS = (r"\bfolded_attention_kernel\b", r"\bfolded_attention_short_kernel\b")
WRAP = (("anyv2v_torch.ops.attention", "folded_attention"),)


def cost(q, k, v, heads, scale, *args, **kwargs):
    """q ``[B, Sq, H*dh]``, k/v ``[B, Sk, H*dh]``."""
    return attention_cost(q.shape[0], q.shape[1], k.shape[1], heads, true_head_dim(scale))
