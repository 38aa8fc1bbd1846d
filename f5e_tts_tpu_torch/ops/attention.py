"""Multi-head self-attention of the DiT block (counterpart of
`f5e_tts_tpu/ops/attention.py: attention`).

Fused q|k|v projection, (B, N, H, dh) heads, key lengths from the padding
mask, the fused RoPE + attention kernels (K1 forward, K4 backward, joined by
an autograd Function), the output projection, and zeroed output rows where
the mask is False. Gradients flow through all of them.

reference semantics: src/f5_tts/model/modules.py:435-503 (AttnProcessor).
"""

from __future__ import annotations

from typing import Optional

import torch

from f5e_tts_tpu_torch.kernels.rope_attention import RopeAttention
from f5e_tts_tpu_torch.ops import nn as fnn


def attention(
    p: dict,
    x: torch.Tensor,  # (B, N, D)
    heads: int,
    mask: Optional[torch.Tensor] = None,  # (B, N) True = keep; a length prefix
    rope_cos: Optional[torch.Tensor] = None,  # (>= N, dh) half-split tables
    rope_sin: Optional[torch.Tensor] = None,
    pe_attn_head: Optional[int] = None,
    qk_norm: Optional[str] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Self-attention matching the reference AttnProcessor, (B, N, D) out.

    p: {to_qkv | to_q, to_k, to_v; to_out}. q/k/v stay column slices of the
    fused projection; the kernel reads them through their row stride.
    """
    if qk_norm is not None:
        raise NotImplementedError("qk_norm is not ported yet")
    if rope_cos is None or rope_sin is None:
        raise NotImplementedError("attention without RoPE tables is not ported yet")
    b, n, _ = x.shape
    if "to_qkv" in p:
        q, k, v = fnn.linear(p["to_qkv"], x, compute_dtype).chunk(3, dim=-1)
    else:
        q, k, v = (fnn.linear(p[name], x, compute_dtype) for name in ("to_q", "to_k", "to_v"))
    dh = q.shape[-1] // heads
    q, k, v = (t.unflatten(-1, (heads, dh)) for t in (q, k, v))

    if mask is not None:
        kv_lens = mask.sum(dim=-1, dtype=torch.int32)
    else:
        kv_lens = torch.full((b,), n, dtype=torch.int32, device=x.device)
    rope_heads = pe_attn_head if pe_attn_head is not None else heads
    o = RopeAttention.apply(q, k, v, kv_lens, rope_cos[:n], rope_sin[:n], rope_heads)
    o = fnn.linear(p["to_out"], o.reshape(b, n, heads * dh), compute_dtype)
    if mask is not None:
        o = o.masked_fill(~mask[:, :, None], 0.0)
    return o
