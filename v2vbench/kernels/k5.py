"""K5, the flash attention (``csrc/flash_attention.cu``): ConsistI2V's spatial
self-attention with frame 0's keys (split-KV), its spatial and temporal
cross-attention; any attention of other widths."""

from v2vbench.roofline import attention_cost, true_head_dim

NAME = "K5"
PATTERNS = (r"\bflash_attention_kernel\b",)
WRAP = (("anyv2v_torch.ops.attention", "flash_attention"),)


def cost(q, k, v, heads, scale, k_ctx=None, v_ctx=None, frames=1, bias=None, *args, **kwargs):
    """q ``[B, Sq, H*dh]``, k/v ``[B, Sk, H*dh]``, a context ``[B/frames, Sk2,
    H*dh]`` that every frame of a row also attends to."""
    extra = (0, 0) if k_ctx is None else (k_ctx.shape[0], k_ctx.shape[1])
    return attention_cost(q.shape[0], q.shape[1], k.shape[1], heads, true_head_dim(scale),
                          extra_kv=extra, bias=bias)
