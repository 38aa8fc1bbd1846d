"""Fused RoPE + attention forward (K1): wrapper, plain version, launch count.

Port of f5e_tts_tpu/ops/pallas_attention.py: mha_chunked_rope. The kernel
is `csrc/rope_attention.cu` (its header says what bounds it and how it is
built); this module checks and lays out the operands, launches it on
PyTorch's current stream, and counts the launches in `launches`.

Contract: q, k, v (B, N, H, dh), kv_lens (B,) int; key column c is valid
iff c < kv_len; cos/sin (>= N, dh) fp32 half-split tables; RoPE on heads
h < rope_heads; sm_scale = 1/sqrt(dh); masked scores -1e30; normalisation
after P.V in fp32. Output (B, N, H, dh) in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from f5e_tts_tpu_torch.kernels import _build
from f5e_tts_tpu_torch.ops.rope import rot_half

launches = 0  # kernel launches since the caller last set it to 0


def rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads: int) -> torch.Tensor:
    """The same function in plain PyTorch, with the kernel's rounding points:
    q rotated in fp32, scaled and rounded to q's dtype; k rotated in fp32 and
    rounded; scores and P.V accumulate in fp32 with P rounded to q's dtype."""
    b, n, h, dh = q.shape
    dtype = q.dtype
    c = cos[:n].float()[None, :, None, :]
    s = sin[:n].float()[None, :, None, :]
    rope = (torch.arange(h, device=q.device) < rope_heads)[None, None, :, None]
    qf, kf = q.float(), k.float()
    qr = torch.where(rope, qf * c + rot_half(qf) * s, qf)
    kr = torch.where(rope, kf * c + rot_half(kf) * s, kf)
    qr = (qr * (1.0 / math.sqrt(dh))).to(dtype).float()
    kr = kr.to(dtype).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qr, kr)
    valid = torch.arange(n, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).float(), v.float())
    return (o / l.transpose(1, 2)).to(dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rope_attention")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rope_attention_fwd.argtypes = [p, p, p, ll, ll, ll, ll, ll, ll, p, p, p, p,
                                       i, i, i, i, i, ctypes.c_float, p]
    lib.rope_attention_fwd.restype = ctypes.c_int
    return lib


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it through (batch, row) strides:
    contiguous heads and last axis, 16-byte aligned rows; else a copy."""
    b, n, h, dh = x.shape
    ok = (x.stride(3) == 1 and x.stride(2) == dh and x.stride(1) % 8 == 0
          and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def rope_attention(q, k, v, kv_lens, cos, sin, rope_heads: int) -> torch.Tensor:
    """softmax(rot(q) rot(k)^T / sqrt(dh), key-length mask) v, (B, N, H, dh).

    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16,
    dh in {64, 128}) or raise.
    """
    global launches
    if q.device.type == "cpu":
        return rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads)
    if not q.is_cuda:
        raise ValueError(f"rope_attention: unsupported device {q.device}")
    b, n, h, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"rope_attention: q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"rope_attention kernel takes bf16 q/k/v, got {q.dtype}")
    if dh not in (64, 128):
        raise ValueError(f"rope_attention kernel takes dh in (64, 128), got {dh}")
    if cos.shape[0] < n or cos.shape[1] != dh or sin.shape != cos.shape:
        raise ValueError(f"rope_attention: cos/sin {tuple(cos.shape)} do not cover ({n}, {dh})")
    tensors = (q, k, v, kv_lens, cos, sin)
    if any(t.device != q.device for t in tensors):
        raise ValueError("rope_attention: operands on different devices")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    kv_lens = kv_lens.to(torch.int32).contiguous()
    cos = cos[:n].float().contiguous()
    sin = sin[:n].float().contiguous()
    out = torch.empty((b, n, h, dh), dtype=torch.bfloat16, device=q.device)
    err = _lib().rope_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), kv_lens.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), b, n, h, dh, int(rope_heads), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
