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
The kernels take head widths 64 and 128, in bf16 or fp32, as the TPU
kernels do (`supported()`, pallas_attention.py); any other width takes the
JAX package's route outside Pallas, `unfused_attention` (`UnfusedAttention`
in the layers), which the shape picks before anything launches (a TPU
dispatch declines such widths too).

Under the active mesh (parallel/mesh.py: active, which the training step
enters), as the JAX dispatch (ops/attention.py: 52-140, 227-268):
- a "model" axis > 1: a DiT block's attention
  (`sharded_heads=True`: its q/k/v are column slices, to_out a row slice)
  runs the kernel on the rank's H/tp heads, its RoPE heads mapped onto the
  ranks that hold them (a partial-RoPE preset's first head is on rank 0),
  and to_out's partial products are all-reduced before its bias;
- a "seq" axis > 1: a sequence of n >= min_seq
  frames that the axis divides, with RoPE on every head or none, takes ring
  attention (ops/ring_attention.py): K/V stay sharded over the axis.

reference semantics: src/f5_tts/model/modules.py:435-503 (AttnProcessor) and
:510-604 (JointAttnProcessor).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from f5e_tts_tpu_torch.kernels.attention import JointAttention, MaskedAttention
from f5e_tts_tpu_torch.kernels.rope_attention import RopeAttention
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops.ring_attention import ring_attention
from f5e_tts_tpu_torch.ops.rope import apply_rotary_half
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.parallel.mesh import CopyToGroup, ReduceFromGroup

KERNEL_HEAD_WIDTHS = (64, 128)  # what the attention kernels take


def _tp_shards() -> int:
    """The model axis's size under the active mesh (parallel/mesh.py: active)."""
    mesh = pmesh.current().over("model")
    return 1 if mesh is None else mesh.size("model")


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering the model axis's column-parallel region
    (identity forward, gradient all-reduced over the axis)."""
    mesh = pmesh.current().over("model")
    return x if mesh is None else CopyToGroup.apply(x, mesh, "model")


def row_parallel_linear(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A row-parallel linear: this rank's rows of w times its columns of x,
    the partial products summed over the model axis in fp32, then the bias
    and one rounding to the compute dtype (`fnn.linear` without a mesh)."""
    mesh = pmesh.current().over("model")
    if mesh is None:
        return fnn.linear(p, x, compute_dtype)
    part = fnn.linear({"w": p["w"]}, x, compute_dtype).float()
    out = ReduceFromGroup.apply(part, mesh, "model")
    if "b" in p:
        out = out + p["b"].float()
    return out.to(compute_dtype or x.dtype)


def _sp_shards(n: int) -> int:
    """The seq axis's size when a sequence of n frames takes ring attention
    under the active mesh: n >= its min_seq and divisible (JAX's rule)."""
    ctx = pmesh.current()
    mesh = ctx.over("seq")
    if mesh is None:
        return 1
    s = mesh.size("seq")
    return 1 if n < ctx.min_seq or n % s else s


unfused_calls = 0  # forward calls of `unfused_attention` since the caller last set it to 0


def _unfused_core(q, k, v, valid, cos, sin, rope_heads: int) -> torch.Tensor:
    n, dh = q.shape[1], q.shape[-1]
    if cos is not None:
        c, s = cos[None, :n, None, :], sin[None, :n, None, :]
        q, k = (torch.cat([apply_rotary_half(t[:, :, :rope_heads], c, s), t[:, :, rope_heads:]],
                          dim=2) for t in (q, k))
    # softmax(q k^T / sqrt(dh)) v in fp32 (at least): the scale on q before
    # the product, masked keys at -0.7 x the largest value (as
    # dot_product_attention pads them: a row with no valid key averages every
    # key), the exponentials' sum dividing P.V after the product. Among the
    # orders of these fp32 sums this one sits closest to the JAX package's
    # compiled reference in the tests that hold Adam steps and int8 codes to it.
    ct = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(ct) * (1.0 / math.sqrt(dh)), k.to(ct))
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, :], -0.7 * torch.finfo(ct).max)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct)) / p.sum(dim=-1).transpose(1, 2)[..., None]
    return o.to(q.dtype)


def unfused_attention(q, k, v, valid: Optional[torch.Tensor] = None,
                      cos: Optional[torch.Tensor] = None, sin: Optional[torch.Tensor] = None,
                      rope_heads: int = 0) -> torch.Tensor:
    """Attention for a head width the kernels do not take, as the JAX package
    computes it outside Pallas (f5e_tts_tpu/ops/attention.py:276-289, then
    sdpa's jax.nn.dot_product_attention branch, :186-191): RoPE by
    `apply_rotary_half` on the heads h < rope_heads when `cos`/`sin` (>= N,
    dh) are given, then softmax(q k^T / sqrt(dh)) v with keys where `valid`
    (B, N) is False set to -0.7 x the largest value, as
    jax.nn.dot_product_attention masks them (a row with no valid key
    averages all of them), in fp32 at least. q, k, v (B, N, H, dh) in,
    (B, N, H, dh) out in q's dtype; differentiable. Counted in
    `unfused_calls`."""
    global unfused_calls
    unfused_calls += 1
    return _unfused_core(q, k, v, valid, cos, sin, rope_heads)


class UnfusedAttention(torch.autograd.Function):
    """`unfused_attention` with the `kept` contract of `RopeAttention`: a
    checkpointed block's recompute (remat policies save_attn, save_attn_ff)
    takes the first forward's output from `kept["attn_out"]` and computes no
    attention, as the JAX policies save the "attn_out" name on this route
    too. The backward recomputes the attention under autograd (uncounted)."""

    @staticmethod
    def forward(ctx, q, k, v, valid, cos, sin, rope_heads: int, kept=None):
        if kept is not None and "attn_out" in kept:
            out = kept["attn_out"][0]
        else:
            out = unfused_attention(q, k, v, valid, cos, sin, rope_heads)
        if kept is not None:
            kept.setdefault("attn_out", (out.detach(), None))
        ctx.rope_heads = rope_heads
        ctx.save_for_backward(q, k, v, valid, cos, sin)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid, cos, sin = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in
                      zip((q, k, v), ctx.needs_input_grad[:3])]
            out = _unfused_core(*inputs, valid, cos, sin, ctx.rope_heads)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None, None)


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
    sharded_heads: bool = False,
) -> torch.Tensor:
    """Self-attention matching the reference AttnProcessor, (B, N, D) out.

    p: {to_qkv | to_q, to_k, to_v; to_out; [q_norm, k_norm]}. q/k/v stay
    column slices of the fused projection; the kernel reads them through
    their row stride. `kept` (a checkpointed DiT block's, RoPE only) keeps
    the kernel's output from the first forward for the recompute (see
    `RopeAttention`). A head width outside `KERNEL_HEAD_WIDTHS` takes
    `unfused_attention` (through `UnfusedAttention`, which keeps `kept` too).
    `sharded_heads`: p holds this rank's slices under the active mesh's
    model axis (a DiT block's, parallel/mesh.py: dit_param_spec): x is
    replicated, `heads` counts the global heads.
    """
    _check_qk_norm(qk_norm)
    b, n, _ = x.shape
    rope_heads = pe_attn_head if pe_attn_head is not None else heads
    if sharded_heads and _tp_shards() > 1:
        heads //= _tp_shards()
        # the global RoPE heads h < rope_heads that this rank's heads hold
        start = pmesh.current().mesh.index("model") * heads
        rope_heads = max(0, min(rope_heads - start, heads))
        x = tp_copy(x)
        norms = {name: {"g": tp_copy(p[name]["g"])} for name in ("q_norm", "k_norm") if name in p}
        p = {**p, **norms}
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
    if _sp_shards(n) > 1 and (pe_attn_head is None or rope_cos is None):
        o = ring_attention(q, k, v, None if mask is None else kv_lens, pmesh.current().mesh, "seq",
                           rope_cos=None if rope_cos is None else rope_cos[:n],
                           rope_sin=None if rope_sin is None else rope_sin[:n])
    elif dh not in KERNEL_HEAD_WIDTHS:
        o = UnfusedAttention.apply(q, k, v, mask, rope_cos, rope_sin, rope_heads, kept)
    elif rope_cos is not None:
        o = RopeAttention.apply(q, k, v, kv_lens, rope_cos[:n], rope_sin[:n], rope_heads, kept)
    else:
        o = MaskedAttention.apply(q, k, v, kv_lens)
    o = (row_parallel_linear if sharded_heads else fnn.linear)(
        p["to_out"], o.reshape(b, n, heads * dh), compute_dtype)
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

    if dh not in KERNEL_HEAD_WIDTHS:
        full = None if mask is None else torch.cat(
            [mask, torch.ones((b, nt), dtype=torch.bool, device=mask.device)], dim=1)
        o = UnfusedAttention.apply(q, k, v, full, None, None, 0)
    elif mask is not None:
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
