"""Multi-head attention layers (counterpart of `f5e_tts_tpu/ops/attention.py`):
`attention`, the self-attention of the DiT block, and `joint_attention`, the
dual-stream attention of the MMDiT block.

Projections, (B, N, H, dh) heads, optional per-head RMSNorm of q and k, key
lengths from the padding mask, one of the hand-written attention kernels
through its autograd Function, the output projection, and zeroed output
rows where the mask is False. Gradients flow through all of them. Which
kernel runs follows the JAX dispatch without its TPU shape gate:
- self-attention with RoPE tables: fused RoPE + attention (`RopeAttention`);
- self-attention without them: key-length-masked attention (`MaskedAttention`);
- joint attention with a padding mask: the [audio | text] joint mask
  (`JointAttention`), RoPE applied to each stream before the concatenation;
- joint attention without a mask: every key valid (`MaskedAttention`).

reference semantics: src/f5_tts/model/modules.py:435-503 (AttnProcessor) and
:510-604 (JointAttnProcessor).
"""

from __future__ import annotations

from typing import Optional

import torch

from f5e_tts_tpu_torch.kernels.attention import JointAttention, MaskedAttention
from f5e_tts_tpu_torch.kernels.rope_attention import RopeAttention
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops.rope import apply_rotary_half


def _check_qk_norm(qk_norm: Optional[str]) -> None:
    if qk_norm not in (None, "rms_norm"):
        raise ValueError(f"unknown qk_norm {qk_norm!r}")


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
    kept: Optional[dict] = None,
) -> torch.Tensor:
    """Self-attention matching the reference AttnProcessor, (B, N, D) out.

    p: {to_qkv | to_q, to_k, to_v; to_out; [q_norm, k_norm]}. q/k/v stay
    column slices of the fused projection; the kernel reads them through
    their row stride. `kept` (a checkpointed DiT block's, RoPE only) keeps
    the kernel's output from the first forward for the recompute (see
    `RopeAttention`).
    """
    _check_qk_norm(qk_norm)
    b, n, _ = x.shape
    if "to_qkv" in p:
        q, k, v = fnn.linear(p["to_qkv"], x, compute_dtype).chunk(3, dim=-1)
    else:
        q, k, v = (fnn.linear(p[name], x, compute_dtype) for name in ("to_q", "to_k", "to_v"))
    dh = q.shape[-1] // heads
    q, k, v = (t.unflatten(-1, (heads, dh)) for t in (q, k, v))
    if qk_norm == "rms_norm":
        q, k = fnn.rmsnorm(p["q_norm"], q), fnn.rmsnorm(p["k_norm"], k)

    if mask is not None:
        kv_lens = mask.sum(dim=-1, dtype=torch.int32)
    else:
        kv_lens = torch.full((b,), n, dtype=torch.int32, device=x.device)
    if rope_cos is not None:
        rope_heads = pe_attn_head if pe_attn_head is not None else heads
        o = RopeAttention.apply(q, k, v, kv_lens, rope_cos[:n], rope_sin[:n], rope_heads, kept)
    else:
        o = MaskedAttention.apply(q, k, v, kv_lens)
    o = fnn.linear(p["to_out"], o.reshape(b, n, heads * dh), compute_dtype)
    if mask is not None:
        o = o.masked_fill(~mask[:, :, None], 0.0)
    return o


def joint_attention(
    p: dict,
    x: torch.Tensor,  # (B, N, D) audio stream
    c: torch.Tensor,  # (B, Nt, Dc) text stream
    heads: int,
    mask: Optional[torch.Tensor] = None,  # (B, N) audio padding mask, a length prefix
    rope_cos: Optional[torch.Tensor] = None,  # (>= N, dh), positions of the audio stream
    rope_sin: Optional[torch.Tensor] = None,
    c_rope_cos: Optional[torch.Tensor] = None,  # (>= Nt, dh), positions restart at 0
    c_rope_sin: Optional[torch.Tensor] = None,
    context_pre_only: bool = False,
    qk_norm: Optional[str] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Joint (MMDiT) attention over the keys [audio | text]; returns
    (x_out (B, N, D), c_out (B, Nt, Dc)); c_out is None when
    `context_pre_only`.

    p: {to_q, to_k, to_v, to_q_c, to_k_c, to_v_c, to_out, [to_out_c],
    [q_norm, k_norm, c_q_norm, c_k_norm]}.
    """
    _check_qk_norm(qk_norm)
    b, n, _ = x.shape
    nt = c.shape[1]

    def proj(name, y):
        return fnn.linear(p[name], y, compute_dtype).unflatten(-1, (heads, -1))

    q, k, v = proj("to_q", x), proj("to_k", x), proj("to_v", x)
    cq, ck, cv = proj("to_q_c", c), proj("to_k_c", c), proj("to_v_c", c)
    dh = q.shape[-1]
    if qk_norm == "rms_norm":
        q, k = fnn.rmsnorm(p["q_norm"], q), fnn.rmsnorm(p["k_norm"], k)
        cq, ck = fnn.rmsnorm(p["c_q_norm"], cq), fnn.rmsnorm(p["c_k_norm"], ck)
    if rope_cos is not None:
        cos, sin = rope_cos[None, :n, None, :], rope_sin[None, :n, None, :]
        q, k = apply_rotary_half(q, cos, sin), apply_rotary_half(k, cos, sin)
    if c_rope_cos is not None:
        cos, sin = c_rope_cos[None, :nt, None, :], c_rope_sin[None, :nt, None, :]
        cq, ck = apply_rotary_half(cq, cos, sin), apply_rotary_half(ck, cos, sin)
    q, k, v = torch.cat([q, cq], dim=1), torch.cat([k, ck], dim=1), torch.cat([v, cv], dim=1)

    if mask is not None:
        # [audio prefix | all-True text] is not a length prefix: the joint kernel
        o = JointAttention.apply(q, k, v, mask.sum(dim=-1, dtype=torch.int32), n)
    else:
        kv_lens = torch.full((b,), n + nt, dtype=torch.int32, device=x.device)
        o = MaskedAttention.apply(q, k, v, kv_lens)
    o = o.reshape(b, n + nt, heads * dh)
    xo = fnn.linear(p["to_out"], o[:, :n], compute_dtype)
    co = None if context_pre_only else fnn.linear(p["to_out_c"], o[:, n:], compute_dtype)
    if mask is not None:
        xo = xo.masked_fill(~mask[:, :, None], 0.0)
    return xo, co


def joint_attention_init(dim: int, context_dim: int, heads: int, dim_head: int,
                         generator: torch.Generator, device="cpu",
                         context_pre_only: bool = False, qk_norm: Optional[str] = None) -> dict:
    """fp32 parameters of `joint_attention` from `generator`, torch's default
    linear rule U(+-1/sqrt(fan_in)) as the JAX init."""
    inner = heads * dim_head
    p = {name: fnn.linear_init(d_in, inner, generator, device)
         for name, d_in in (("to_q", dim), ("to_k", dim), ("to_v", dim), ("to_q_c", context_dim),
                            ("to_k_c", context_dim), ("to_v_c", context_dim))}
    p["to_out"] = fnn.linear_init(inner, dim, generator, device)
    if not context_pre_only:
        p["to_out_c"] = fnn.linear_init(inner, context_dim, generator, device)
    if qk_norm == "rms_norm":
        for name in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
            p[name] = {"g": torch.ones(dim_head, device=device)}
    return p
