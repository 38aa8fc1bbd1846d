"""Fused RoPE + attention forward and backward: wrappers, plain versions,
launch counts, and the autograd Function that joins them.

Ports of the TPU kernels of f5e_tts_tpu/ops/pallas_attention.py that fuse
RoPE into attention. They compute one function and differed in how a head's
K/V sat in VMEM; here one kernel serves them all:
- mha_chunked_rope (K1) and mha_chunked_rope_bwd (K4): RoPE on all or none of
  the heads; launches counted in `launches` and `bwd_launches`;
- mha_fullkv_rope (K3) and mha_fullkv_rope_bwd (K6): RoPE on the heads
  h < rope_heads only, what the `pe_attn_head=1` presets run; a launch with
  0 < rope_heads < H counts in `partial_launches` and `partial_bwd_launches`
  instead;
- mha_packed_rope (K11a) and mha_packed_rope_bwd (K11b): the same function
  for any rope_heads with all heads of a batch row in one TPU cell, so every
  launch counted above is also a launch of their counterpart.
The kernels are the RoPE instantiation of `csrc/attention_core.cuh` in
`csrc/rope_attention.cu` (the header says what bounds them and how they are
built); this module checks and lays out the operands and launches them on
PyTorch's current stream. On fp32 operands it launches the fp32 kernels of
`csrc/attention_fp32.cuh` and counts them apart: `fp32_launches`,
`fp32_bwd_launches`, `fp32_partial_launches`, `fp32_partial_bwd_launches`.

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
from f5e_tts_tpu_torch.kernels.attention import (attention_prep_plain, check_operands,
                                                 check_stats, core_bwd_plain, core_plain,
                                                 is_fp32, kernel_operand, prefix_valid,
                                                 prep_scratch, stream, strides)

launches = 0  # K1: launches with RoPE on all or none of the heads since last set to 0
bwd_launches = 0  # K4: backward launches, likewise
partial_launches = 0  # K3: launches with 0 < rope_heads < H
partial_bwd_launches = 0  # K6: backward launches, likewise
fp32_launches = 0  # the four above, on fp32 operands
fp32_bwd_launches = 0
fp32_partial_launches = 0
fp32_partial_bwd_launches = 0


def rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads: int) -> torch.Tensor:
    """The same function in plain PyTorch, with the kernel's rounding points:
    q rotated in fp32, scaled and rounded to q's dtype; k rotated in fp32 and
    rounded; scores and P.V accumulate in fp32 with P rounded to q's dtype."""
    qs, ks, _ = attention_prep_plain(q, k, cos=cos, sin=sin, rope_heads=rope_heads)
    return core_plain(qs, ks, v, prefix_valid(kv_lens, q.shape[1], q.device), q.dtype)


def rope_attention_bwd_plain(q, k, v, kv_lens, cos, sin, g, rope_heads: int):
    """(dq, dk, dv) of K1 in plain PyTorch, as the TPU kernel computes them
    (pallas_attention.py:379-453; `kernels/attention.py: core_bwd_plain`), dQ
    and dK each through the RoPE adjoint x cos - rot_half(x sin) on the
    rotated heads."""
    return core_bwd_plain(q, k, v, prefix_valid(kv_lens, q.shape[1], q.device), g, cos, sin,
                          rope_heads)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rope_attention")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.rope_attention_fwd.argtypes = [p, p, p, ll, ll, ll, ll, ll, ll] + [p] * 8 + [i] * 5 + [
        f, i, p]
    lib.rope_attention_fwd.restype = i
    lib.rope_attention_bwd.argtypes = [p, p, p, p, p] + [ll] * 10 + [p] * 11 + [i] * 5 + [f, i, p]
    lib.rope_attention_bwd.restype = i
    lib.attention_smem.argtypes = [i, i]
    lib.attention_smem.restype = i
    return lib


def _check(name: str, q, others, kv_lens, cos, sin) -> None:
    check_operands(name, q, others, kv_lens)
    n, dh = q.shape[1], q.shape[3]
    if cos.shape[0] < n or cos.shape[1] != dh or sin.shape != cos.shape:
        raise ValueError(f"{name}: cos/sin {tuple(cos.shape)} do not cover ({n}, {dh})")
    if any(t.device != q.device for t in (cos, sin)):
        raise ValueError(f"{name}: operands on different devices")


def _tables(kv_lens, cos, sin, n: int):
    return (kv_lens.to(torch.int32).contiguous(), cos[:n].float().contiguous(),
            sin[:n].float().contiguous())


def _partial(rope_heads: int, heads: int) -> bool:
    """True for the launches that stand for K3/K6: RoPE on some heads only."""
    return 0 < rope_heads < heads


def rope_attention(q, k, v, kv_lens, cos, sin, rope_heads: int, return_stats: bool = False):
    """softmax(rot(q) rot(k)^T / sqrt(dh), key-length mask) v, (B, N, H, dh).

    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16
    or fp32, dh in {64, 128}) or raise. With `return_stats`, returns (out, stats):
    stats is the kernel's (row max, row 1/sum) pair, fp32 (B, H, N) each, that
    the backward takes, or None on the CPU. Not differentiable: see
    `RopeAttention`.
    """
    global launches, partial_launches, fp32_launches, fp32_partial_launches
    if q.device.type == "cpu":
        out = rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads)
        return (out, None) if return_stats else out
    _check("rope_attention", q, (k, v), kv_lens, cos, sin)
    b, n, h, dh = q.shape
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    kv_lens, cos, sin = _tables(kv_lens, cos, sin, n)
    out = torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
    stats = None
    if return_stats:
        stats = tuple(torch.empty((b, h, n), dtype=torch.float32, device=q.device)
                      for _ in range(2))
    qs, ks, _ = prep_scratch(q, 2)
    err = _lib().rope_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides(q, k, v), kv_lens.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), out.data_ptr(), stats[0].data_ptr() if stats else None,
        stats[1].data_ptr() if stats else None, qs.data_ptr(), ks.data_ptr(), b, n, h, dh,
        int(rope_heads), 1.0 / math.sqrt(dh), is_fp32(q), stream(q))
    if err != 0:
        raise RuntimeError(f"rope_attention kernel launch failed: CUDA error {err}")
    if _partial(rope_heads, h):
        if is_fp32(q):
            fp32_partial_launches += 1
        else:
            partial_launches += 1
    elif is_fp32(q):
        fp32_launches += 1
    else:
        launches += 1
    return (out, stats) if return_stats else out


def rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, rope_heads: int, out=None, stats=None):
    """(dq, dk, dv) of `rope_attention` for the output cotangent g, (B, N, H,
    dh) each. CPU tensors take the plain version, which recomputes
    everything; CUDA tensors launch the kernel, which also takes the
    forward's output `out` and its `stats`, or raise."""
    global bwd_launches, partial_bwd_launches, fp32_bwd_launches, fp32_partial_bwd_launches
    if q.device.type == "cpu":
        return rope_attention_bwd_plain(q, k, v, kv_lens, cos, sin, g, rope_heads)
    if out is None or stats is None:
        raise ValueError("rope_attention_bwd kernel needs K1's output and its row statistics")
    _check("rope_attention_bwd", q, (k, v, g, out), kv_lens, cos, sin)
    check_stats("rope_attention_bwd", q, stats)
    b, n, h, dh = q.shape
    q, k, v, g, out = (kernel_operand(t) for t in (q, k, v, g, out))
    kv_lens, cos, sin = _tables(kv_lens, cos, sin, n)
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    qs, ks, delta = prep_scratch(q, 2, delta=True)
    err = _lib().rope_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
        *strides(q, k, v, g, out), kv_lens.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), qs.data_ptr(), ks.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h, dh,
        int(rope_heads), 1.0 / math.sqrt(dh), is_fp32(q), stream(q))
    if err != 0:
        raise RuntimeError(f"rope_attention_bwd kernel launch failed: CUDA error {err}")
    if _partial(rope_heads, h):
        if is_fp32(q):
            fp32_partial_bwd_launches += 1
        else:
            partial_bwd_launches += 1
    elif is_fp32(q):
        fp32_bwd_launches += 1
    else:
        bwd_launches += 1
    return dq, dk, dv


class RopeAttention(torch.autograd.Function):
    """Differentiable RoPE attention: K1 forward, K4 backward (their plain
    versions for CPU tensors). Saves what the TPU custom_vjp saves (q, k, v,
    kv_lens, cos, sin) plus, on the card, K1's output and row statistics.

    `kept`, a dict of a checkpointed block (models/dit.py, remat policies
    save_attn and save_attn_ff), holds the first forward's output and
    statistics under "attn_out"; the recompute takes them from there and
    launches no kernel. They are fresh tensors of that call, never the
    kernels' scratch (`prep_scratch` allocates per call)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, cos, sin, rope_heads: int, kept=None):
        need = any(ctx.needs_input_grad[:3])
        if kept is not None and "attn_out" in kept:
            out, stats = kept["attn_out"]
            out = out.detach()
        elif need and q.is_cuda:
            out, stats = rope_attention(q, k, v, kv_lens, cos, sin, rope_heads, return_stats=True)
        else:
            out, stats = rope_attention(q, k, v, kv_lens, cos, sin, rope_heads), None
        if kept is not None:
            kept.setdefault("attn_out", (out.detach(), stats))
        ctx.rope_heads = rope_heads
        if need:
            ctx.save_for_backward(q, k, v, kv_lens, cos, sin, out, *(stats or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, cos, sin, out, *stats = ctx.saved_tensors
        dq, dk, dv = rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, ctx.rope_heads, out,
                                        tuple(stats) or None)
        return dq, dk, dv, None, None, None, None, None
