"""Fused RoPE + attention forward (K1) and backward (K4): wrappers, plain
versions, launch counts, and the autograd Function that joins them.

Ports of f5e_tts_tpu/ops/pallas_attention.py: mha_chunked_rope (K1) and
mha_chunked_rope_bwd (K4). The kernels are in `csrc/rope_attention.cu` (its
header says what bounds them and how they are built); this module checks
and lays out the operands, launches them on PyTorch's current stream, and
counts the launches in `launches` (K1) and `bwd_launches` (K4).

Contract: q, k, v (B, N, H, dh), kv_lens (B,) int; key column c is valid
iff c < kv_len; cos/sin (>= N, dh) fp32 half-split tables; RoPE on heads
h < rope_heads; sm_scale = 1/sqrt(dh); masked scores -1e30; normalisation
after P.V in fp32. Output (B, N, H, dh) in q's dtype. `RopeAttention.apply`
is the differentiable form the attention layer calls.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from f5e_tts_tpu_torch.kernels import _build
from f5e_tts_tpu_torch.ops.rope import rot_half

launches = 0  # K1 kernel launches since the caller last set it to 0
bwd_launches = 0  # K4 kernel launches since the caller last set it to 0


def _rotated(q, k, cos, sin, rope_heads: int):
    """(q', k') with the kernels' rounding points: rot(q) in fp32 (fp64 for
    fp64 inputs), scaled by 1/sqrt(dh) and rounded to q's dtype; rot(k)
    rounded to k's dtype; both returned in the math dtype."""
    b, n, h, dh = q.shape
    dtype = q.dtype
    ct = torch.promote_types(dtype, torch.float32)
    c = cos[:n].to(ct)[None, :, None, :]
    s = sin[:n].to(ct)[None, :, None, :]
    rope = (torch.arange(h, device=q.device) < rope_heads)[None, None, :, None]
    qf, kf = q.to(ct), k.to(ct)
    qr = torch.where(rope, qf * c + rot_half(qf) * s, qf)
    kr = torch.where(rope, kf * c + rot_half(kf) * s, kf)
    return (qr * (1.0 / math.sqrt(dh))).to(dtype).to(ct), kr.to(dtype).to(ct), (c, s, rope)


def _masked_scores(qs, ks, kv_lens, with_valid: bool = False):
    """q'.k'^T (B, H, Nq, Nk), keys at or past kv_len set to -1e30 (and the
    (B, 1, 1, Nk) key-validity mask when asked)."""
    n = qs.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, ks)
    valid = (torch.arange(n, device=qs.device)[None, :]
             < kv_lens.to(qs.device)[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, -1e30)
    return (scores, valid) if with_valid else scores


def rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads: int) -> torch.Tensor:
    """The same function in plain PyTorch, with the kernel's rounding points:
    q rotated in fp32, scaled and rounded to q's dtype; k rotated in fp32 and
    rounded; scores and P.V accumulate in fp32 with P rounded to q's dtype."""
    dtype = q.dtype
    qs, ks, _ = _rotated(q, k, cos, sin, rope_heads)
    scores = _masked_scores(qs, ks, kv_lens)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).to(qs.dtype), v.to(qs.dtype))
    return (o / l.transpose(1, 2)).to(dtype)


def rope_attention_bwd_plain(q, k, v, kv_lens, cos, sin, g, rope_heads: int):
    """(dq, dk, dv) of K1 in plain PyTorch, as the TPU kernel computes them
    (pallas_attention.py:379-453): P recomputed from q', k'; linv =
    1 / max(sum p~, 1e-30); delta = linv * sum p~ dP; dS = bf16(p~ (dP -
    delta) linv); dV = bf16(p~)^T bf16(dO linv); dQ = sm_scale dS k' and
    dK = dS^T q', each through the RoPE adjoint x cos - rot_half(x sin).
    dS is 0 at masked keys (the derivative of the mask): the same as the TPU
    kernel except in a row whose keys are all masked (kv_len = 0), whose
    dq and dk are 0 here, as in jax.vjp of the XLA reference."""
    dtype = q.dtype
    dh = q.shape[-1]
    qs, ks, (c, s, rope) = _rotated(q, k, cos, sin, rope_heads)
    ct = qs.dtype
    scores, valid = _masked_scores(qs, ks, kv_lens, with_valid=True)
    pt = torch.exp(scores - scores.amax(dim=-1, keepdim=True))  # (B, H, Nq, Nk)
    linv = 1.0 / pt.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    gf = g.to(ct)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.to(ct))
    delta = linv * (pt * dp).sum(dim=-1, keepdim=True)
    ds = (pt * (dp - delta) * linv).masked_fill(~valid, 0.0).to(dtype).to(ct)
    dol = (gf * linv.squeeze(-1).transpose(1, 2)[..., None]).to(dtype).to(ct)
    dv = torch.einsum("bhqk,bqhd->bkhd", pt.to(dtype).to(ct), dol)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ks) * (1.0 / math.sqrt(dh))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dq = torch.where(rope, dq * c - rot_half(dq * s), dq)
    dk = torch.where(rope, dk * c - rot_half(dk * s), dk)
    return dq.to(dtype), dk.to(dtype), dv.to(v.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rope_attention")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.rope_attention_fwd.argtypes = [p, p, p, ll, ll, ll, ll, ll, ll, p, p, p, p, p, p,
                                       i, i, i, i, i, f, p]
    lib.rope_attention_fwd.restype = i
    lib.rope_attention_bwd.argtypes = [p, p, p, p, p] + [ll] * 10 + [p] * 9 + [i] * 5 + [f, p]
    lib.rope_attention_bwd.restype = i
    return lib


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it through (batch, row) strides:
    contiguous heads and last axis, 16-byte aligned rows; else a copy."""
    b, n, h, dh = x.shape
    ok = (x.stride(3) == 1 and x.stride(2) == dh and x.stride(1) % 8 == 0
          and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def _check(name: str, q, others, kv_lens, cos, sin) -> None:
    """Device, shape, dtype and head-width checks shared by K1 and K4."""
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, n, h, dh = q.shape
    if any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: operand shapes differ: {[tuple(t.shape) for t in (q, *others)]}")
    if any(t.dtype != torch.bfloat16 for t in (q, *others)):
        raise ValueError(f"{name} kernel takes bf16 operands, got {q.dtype}")
    if dh not in (64, 128):
        raise ValueError(f"{name} kernel takes dh in (64, 128), got {dh}")
    if cos.shape[0] < n or cos.shape[1] != dh or sin.shape != cos.shape:
        raise ValueError(f"{name}: cos/sin {tuple(cos.shape)} do not cover ({n}, {dh})")
    if any(t.device != q.device for t in (*others, kv_lens, cos, sin)):
        raise ValueError(f"{name}: operands on different devices")


def _tables(kv_lens, cos, sin, n: int):
    return (kv_lens.to(torch.int32).contiguous(), cos[:n].float().contiguous(),
            sin[:n].float().contiguous())


def rope_attention(q, k, v, kv_lens, cos, sin, rope_heads: int, return_stats: bool = False):
    """softmax(rot(q) rot(k)^T / sqrt(dh), key-length mask) v, (B, N, H, dh).

    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16,
    dh in {64, 128}) or raise. With `return_stats`, returns (out, stats):
    stats is the kernel's (row max, row 1/sum) pair, fp32 (B, H, N) each, that
    K4 takes, or None on the CPU. Not differentiable: see `RopeAttention`.
    """
    global launches
    if q.device.type == "cpu":
        out = rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads)
        return (out, None) if return_stats else out
    _check("rope_attention", q, (k, v), kv_lens, cos, sin)
    b, n, h, dh = q.shape
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    kv_lens, cos, sin = _tables(kv_lens, cos, sin, n)
    out = torch.empty((b, n, h, dh), dtype=torch.bfloat16, device=q.device)
    stats = None
    if return_stats:
        stats = tuple(torch.empty((b, h, n), dtype=torch.float32, device=q.device)
                      for _ in range(2))
    err = _lib().rope_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), kv_lens.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), stats[0].data_ptr() if stats else None,
        stats[1].data_ptr() if stats else None, b, n, h, dh, int(rope_heads),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return (out, stats) if return_stats else out


def rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, rope_heads: int, out=None, stats=None):
    """(dq, dk, dv) of `rope_attention` for the output cotangent g, (B, N, H,
    dh) each. CPU tensors take the plain version, which recomputes
    everything; CUDA tensors launch the kernel, which also takes K1's output
    `out` and its `stats`, or raise."""
    global bwd_launches
    if q.device.type == "cpu":
        return rope_attention_bwd_plain(q, k, v, kv_lens, cos, sin, g, rope_heads)
    if out is None or stats is None:
        raise ValueError("rope_attention_bwd kernel needs K1's output and its row statistics")
    _check("rope_attention_bwd", q, (k, v, g, out), kv_lens, cos, sin)
    b, n, h, dh = q.shape
    if any(t.shape != (b, h, n) or t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != q.device for t in stats):
        raise ValueError("rope_attention_bwd: stats must be contiguous fp32 (B, H, N) on q's device")
    q, k, v, g, out = (_kernel_operand(t) for t in (q, k, v, g, out))
    kv_lens, cos, sin = _tables(kv_lens, cos, sin, n)
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=torch.bfloat16, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = _lib().rope_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        g.stride(0), g.stride(1), out.stride(0), out.stride(1), kv_lens.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h, dh,
        int(rope_heads), 1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_attention_bwd kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


class RopeAttention(torch.autograd.Function):
    """Differentiable RoPE attention: K1 forward, K4 backward (their plain
    versions for CPU tensors). Saves what the TPU custom_vjp saves (q, k, v,
    kv_lens, cos, sin) plus, on the card, K1's output and row statistics."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, cos, sin, rope_heads: int):
        need = any(ctx.needs_input_grad[:3])
        if need and q.is_cuda:
            out, stats = rope_attention(q, k, v, kv_lens, cos, sin, rope_heads, return_stats=True)
        else:
            out, stats = rope_attention(q, k, v, kv_lens, cos, sin, rope_heads), None
        ctx.rope_heads = rope_heads
        if need:
            ctx.save_for_backward(q, k, v, kv_lens, cos, sin, out, *(stats or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, cos, sin, out, *stats = ctx.saved_tensors
        dq, dk, dv = rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, ctx.rope_heads, out,
                                        tuple(stats) or None)
        return dq, dk, dv, None, None, None, None
