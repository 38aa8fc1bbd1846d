"""Attention without RoPE in the kernel: the key-length mask (K9 forward, K10
backward) and the joint [audio | text] mask of the MMDiT (K7 forward, K8
backward); wrappers, plain versions, launch counts and the autograd
Functions that join them. Also what `kernels/rope_attention.py` shares: the
plain core of the forward and the one plain backward, the plain twin of the
pre-pass of both directions (`attention_prep_plain`), the plain twin of
the forward's row statistics (`attention_stats_plain`), and the operand
checks.

Ports of f5e_tts_tpu/ops/pallas_attention.py: mha_fullkv (K9), mha_fullkv_bwd
(K10), mha_fullkv_joint (K7) and mha_fullkv_joint_bwd (K8). The kernels are
instantiations of `csrc/attention_core.cuh` (its header says what bounds
them and how they are built) in `csrc/masked_attention.cu` and
`csrc/joint_attention.cu`; this module checks and lays out the operands,
launches them on PyTorch's current stream, and counts the launches in
`masked_launches` (K9), `masked_bwd_launches` (K10), `joint_launches` (K7)
and `joint_bwd_launches` (K8).

Contract: q, k, v (B, N, H, dh); sm_scale = 1/sqrt(dh) folded into q in fp32
and rounded to q's dtype; masked scores -1e30; P rounded to q's dtype before
P.V; normalisation by max(l, 1e-30) after it in fp32. Output (B, N, H, dh) in
q's dtype.
- masked: kv_lens (B,) int; key column c is valid iff c < kv_len.
- joint: keys are [audio (n_audio) | text]; audio_lens (B,) int; column c is
  valid iff c < audio_len or c >= n_audio.
A row whose keys are all masked comes out as the uniform average of v, and
its dq and dk are 0. `MaskedAttention.apply` and `JointAttention.apply` are
the differentiable forms the attention layers call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from f5e_tts_tpu_torch.kernels import _build
from f5e_tts_tpu_torch.ops.rope import rot_half

masked_launches = 0  # K9 kernel launches since the caller last set it to 0
masked_bwd_launches = 0  # K10
joint_launches = 0  # K7
joint_bwd_launches = 0  # K8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def prefix_valid(lens: torch.Tensor, n: int, device) -> torch.Tensor:
    """(B, 1, 1, N) bool: column c < len."""
    col = torch.arange(n, device=device)
    return (col[None, :] < lens.to(device)[:, None])[:, None, None, :]


def joint_valid(audio_lens: torch.Tensor, n_audio: int, n: int, device) -> torch.Tensor:
    """(B, 1, 1, N) bool: column c < audio_len or c >= n_audio."""
    col = torch.arange(n, device=device)
    valid = (col[None, :] < audio_lens.to(device)[:, None]) | (col >= n_audio)[None, :]
    return valid[:, None, None, :]


def attention_prep_plain(q, k, dout=None, o=None, cos=None, sin=None, rope_heads: int = 0):
    """The kernels' pre-pass in plain PyTorch, the backward's and (without
    dout and o) the forward's: (q', k', delta) with
    their rounding points. q' = sm_scale * rot(q) formed in fp32 (fp64 for
    fp64 inputs) and rounded to q's dtype; k' = rot(k) rounded to k's dtype;
    both (B, N, H, dh) in the math dtype. rot is RoPE on heads h <
    rope_heads from the half-split tables cos/sin (>= N, dh), the identity
    without them. delta = rowsum(dO * O) in the math dtype, (B, H, N), from
    the output cotangent `dout` and the forward's output `o`; None without
    them. The forwards' plain versions take q' and k' from here too."""
    b, n, h, dh = q.shape
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf = q.to(ct), k.to(ct)
    if cos is not None:
        c, s, rope = rope_tables(cos, sin, n, h, rope_heads, ct)
        qf = torch.where(rope, qf * c + rot_half(qf) * s, qf)
        kf = torch.where(rope, kf * c + rot_half(kf) * s, kf)
    qs = (qf * (1.0 / math.sqrt(dh))).to(q.dtype).to(ct)
    ks = kf.to(k.dtype).to(ct)
    delta = None
    if dout is not None and o is not None:
        delta = (dout.to(ct) * o.to(ct)).sum(dim=-1).transpose(1, 2)
    return qs, ks, delta


def rope_tables(cos, sin, n: int, heads: int, rope_heads: int, ct):
    """(cos, sin, rotated-head mask) broadcastable against (B, N, H, dh)."""
    c = cos[:n].to(ct)[None, :, None, :]
    s = sin[:n].to(ct)[None, :, None, :]
    rope = (torch.arange(heads, device=cos.device) < rope_heads)[None, None, :, None]
    return c, s, rope


def core_plain(qs, ks, v, valid, dtype) -> torch.Tensor:
    """softmax(q'.k'^T, valid columns) v with the kernels' rounding points.
    qs, ks: q' and k' of `attention_prep_plain` in the math dtype; valid
    (B, 1, 1, N) bool; `dtype` is the operands' dtype, in which P and the
    output are rounded."""
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, ks).masked_fill(~valid, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).to(qs.dtype), v.to(qs.dtype))
    return (o / l.transpose(1, 2)).to(dtype)


def attention_stats_plain(qs, ks, valid):
    """The forward kernels' row statistics in plain PyTorch: (m, linv), each
    (B, H, N) in the math dtype, for q', k' of `attention_prep_plain` and
    valid (B, 1, 1, N) bool. m is the row max of the scores q'.k'^T with
    masked keys at -1e30, linv = 1 / max(sum_keys exp(s - m), 1e-30); so
    m - log(linv) is the row's logsumexp, and a row whose keys are all
    masked has m = -1e30 and linv = 1/N."""
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, ks).masked_fill(~valid, -1e30)
    m = scores.amax(dim=-1)
    linv = 1.0 / torch.exp(scores - m[..., None]).sum(dim=-1).clamp_min(1e-30)
    return m, linv


def core_bwd_plain(q, k, v, valid, g, cos=None, sin=None, rope_heads: int = 0):
    """(dq, dk, dv) of `core_plain` over the q', k' of
    `attention_prep_plain`, as the TPU kernels compute them
    (pallas_attention.py:709-751): P recomputed from q', k'; linv = 1 /
    max(sum p~, 1e-30); delta = linv * sum p~ dP; dS = round(p~ (dP - delta)
    linv); dV = round(p~)^T round(dO linv); dq' = sm_scale dS k' and dk' =
    dS^T q', then the RoPE adjoint x cos - rot_half(x sin) on the rotated
    heads, rounded to the operands' dtypes. dS is 0 at masked keys (the
    derivative of the mask): the same as the TPU kernels except in a row
    whose keys are all masked, whose dq and dk are 0 here, as in jax.vjp of
    the XLA reference. The one plain backward of the three kernel variants."""
    qs, ks, _ = attention_prep_plain(q, k, cos=cos, sin=sin, rope_heads=rope_heads)
    ct, dtype = qs.dtype, q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, ks).masked_fill(~valid, -1e30)
    pt = torch.exp(scores - scores.amax(dim=-1, keepdim=True))  # (B, H, Nq, Nk)
    linv = 1.0 / pt.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    gf = g.to(ct)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.to(ct))
    delta = linv * (pt * dp).sum(dim=-1, keepdim=True)
    ds = (pt * (dp - delta) * linv).masked_fill(~valid, 0.0).to(dtype).to(ct)
    dol = (gf * linv.squeeze(-1).transpose(1, 2)[..., None]).to(dtype).to(ct)
    dv = torch.einsum("bhqk,bqhd->bkhd", pt.to(dtype).to(ct), dol)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ks) * (1.0 / math.sqrt(qs.shape[-1]))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    if cos is not None:
        c, s, rope = rope_tables(cos, sin, q.shape[1], q.shape[2], rope_heads, ct)
        dq = torch.where(rope, dq * c - rot_half(dq * s), dq)
        dk = torch.where(rope, dk * c - rot_half(dk * s), dk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def masked_attention_plain(q, k, v, kv_lens) -> torch.Tensor:
    """K9 in plain PyTorch."""
    qs, ks, _ = attention_prep_plain(q, k)
    return core_plain(qs, ks, v, prefix_valid(kv_lens, q.shape[1], q.device), q.dtype)


def masked_attention_bwd_plain(q, k, v, kv_lens, g):
    """K10 in plain PyTorch: (dq, dk, dv) of `masked_attention_plain`."""
    return core_bwd_plain(q, k, v, prefix_valid(kv_lens, q.shape[1], q.device), g)


def joint_attention_core_plain(q, k, v, audio_lens, n_audio: int) -> torch.Tensor:
    """K7 in plain PyTorch."""
    qs, ks, _ = attention_prep_plain(q, k)
    return core_plain(qs, ks, v, joint_valid(audio_lens, n_audio, q.shape[1], q.device), q.dtype)


def joint_attention_core_bwd_plain(q, k, v, audio_lens, n_audio: int, g):
    """K8 in plain PyTorch: (dq, dk, dv) of `joint_attention_core_plain`."""
    return core_bwd_plain(q, k, v, joint_valid(audio_lens, n_audio, q.shape[1], q.device), g)


# ---------------------------------------------------------------------------
# operands of the kernels
# ---------------------------------------------------------------------------


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it through (batch, row) strides:
    contiguous heads and last axis, 16-byte aligned rows; else a copy."""
    b, n, h, dh = x.shape
    ok = (x.stride(3) == 1 and x.stride(2) == dh and x.stride(1) % 8 == 0
          and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def check_operands(name: str, q, others, lens) -> None:
    """Device, shape, dtype and head-width checks shared by the kernels."""
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: operand shapes differ: {[tuple(t.shape) for t in (q, *others)]}")
    if any(t.dtype != torch.bfloat16 for t in (q, *others)):
        raise ValueError(f"{name} kernel takes bf16 operands, got {q.dtype}")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"{name} kernel takes dh in (64, 128), got {q.shape[-1]}")
    if lens.shape != (q.shape[0],):
        raise ValueError(f"{name}: lengths {tuple(lens.shape)} for batch {q.shape[0]}")
    if any(t.device != q.device for t in (*others, lens)):
        raise ValueError(f"{name}: operands on different devices")


def check_stats(name: str, q, stats) -> None:
    b, n, h, _ = q.shape
    if stats is None or len(stats) != 2 or any(
            t.shape != (b, h, n) or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != q.device for t in stats):
        raise ValueError(f"{name}: stats must be two contiguous fp32 (B, H, N) tensors on q's device")


def strides(*tensors) -> list:
    """[batch stride, row stride] of each tensor, in elements."""
    return [s for t in tensors for s in (t.stride(0), t.stride(1))]


def prep_scratch(q: torch.Tensor, rotated: int, delta: bool = False):
    """What a kernel's pre-pass writes, for either direction: q' and, where
    RoPE is compiled in (rotated = 2), k', head-major (B, H, N, dh) bf16
    views of one buffer; then delta, fp32 (B, H, N), for the backward
    (`delta`), else None."""
    b, n, h, dh = q.shape
    rot = torch.empty((rotated, b, h, n, dh), dtype=torch.bfloat16, device=q.device)
    return (*rot.unbind(0),
            torch.empty((b, h, n), dtype=torch.float32, device=q.device) if delta else None)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The library of `masked_attention` or `joint_attention`, its two entry
    points typed. The joint one takes n_audio after the lengths."""
    lib = _build.library(name)
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    extra = [i] if name == "joint_attention" else []
    fwd, bwd = getattr(lib, f"{name}_fwd"), getattr(lib, f"{name}_bwd")
    fwd.argtypes = [p, p, p] + [ll] * 6 + [p] + extra + [p, p, p, p, i, i, i, i, f, p]
    bwd.argtypes = [p] * 5 + [ll] * 10 + [p] + extra + [p] * 7 + [i, i, i, i, f, p]
    fwd.restype = bwd.restype = i
    return lib


def _forward(name: str, q, k, v, lens, n_audio: Optional[int], return_stats: bool):
    check_operands(name, q, (k, v), lens)
    b, n, h, dh = q.shape
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty((b, n, h, dh), dtype=torch.bfloat16, device=q.device)
    stats = None
    if return_stats:
        stats = tuple(torch.empty((b, h, n), dtype=torch.float32, device=q.device)
                      for _ in range(2))
    qs, _ = prep_scratch(q, 1)
    extra = [] if n_audio is None else [int(n_audio)]
    err = getattr(_lib(name), f"{name}_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides(q, k, v), lens.data_ptr(), *extra,
        out.data_ptr(), stats[0].data_ptr() if stats else None,
        stats[1].data_ptr() if stats else None, qs.data_ptr(), b, n, h, dh,
        1.0 / math.sqrt(dh), stream(q))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out, stats


def _backward(name: str, q, k, v, lens, n_audio: Optional[int], g, out, stats):
    if out is None or stats is None:
        raise ValueError(f"{name}_bwd kernel needs the forward's output and its row statistics")
    check_operands(f"{name}_bwd", q, (k, v, g, out), lens)
    check_stats(f"{name}_bwd", q, stats)
    b, n, h, dh = q.shape
    q, k, v, g, out = (kernel_operand(t) for t in (q, k, v, g, out))
    lens = lens.to(torch.int32).contiguous()
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=torch.bfloat16, device=q.device)
                  for _ in range(3))
    qs, delta = prep_scratch(q, 1, delta=True)
    extra = [] if n_audio is None else [int(n_audio)]
    err = getattr(_lib(name), f"{name}_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
        *strides(q, k, v, g, out), lens.data_ptr(), *extra, stats[0].data_ptr(),
        stats[1].data_ptr(), qs.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, n, h, dh, 1.0 / math.sqrt(dh), stream(q))
    if err != 0:
        raise RuntimeError(f"{name}_bwd kernel launch failed: CUDA error {err}")
    return dq, dk, dv


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def masked_attention(q, k, v, kv_lens, return_stats: bool = False):
    """K9: softmax(q k^T / sqrt(dh), column < kv_len) v, (B, N, H, dh).

    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16,
    dh in {64, 128}) or raise. With `return_stats`, returns (out, stats): the
    kernel's (row max, row 1/sum) pair, fp32 (B, H, N) each, that K10 takes,
    or None on the CPU. Not differentiable: see `MaskedAttention`."""
    global masked_launches
    if q.device.type == "cpu":
        out, stats = masked_attention_plain(q, k, v, kv_lens), None
    else:
        out, stats = _forward("masked_attention", q, k, v, kv_lens, None, return_stats)
        masked_launches += 1
    return (out, stats) if return_stats else out


def masked_attention_bwd(q, k, v, kv_lens, g, out=None, stats=None):
    """K10: (dq, dk, dv) of `masked_attention` for the output cotangent g. CPU
    tensors take the plain version, which recomputes everything; CUDA tensors
    launch the kernel, which also takes K9's output and `stats`, or raise."""
    global masked_bwd_launches
    if q.device.type == "cpu":
        return masked_attention_bwd_plain(q, k, v, kv_lens, g)
    grads = _backward("masked_attention", q, k, v, kv_lens, None, g, out, stats)
    masked_bwd_launches += 1
    return grads


def _check_n_audio(n_audio: int, n: int) -> None:
    if not 0 <= n_audio <= n:
        raise ValueError(f"n_audio {n_audio} outside the {n} keys")


def joint_attention_core(q, k, v, audio_lens, n_audio: int, return_stats: bool = False):
    """K7: attention over keys [audio | text], column valid iff c < audio_len
    or c >= n_audio, (B, N, H, dh) with N = n_audio + text length. Devices,
    `return_stats` and differentiability as `masked_attention`."""
    global joint_launches
    _check_n_audio(n_audio, q.shape[1])
    if q.device.type == "cpu":
        out, stats = joint_attention_core_plain(q, k, v, audio_lens, n_audio), None
    else:
        out, stats = _forward("joint_attention", q, k, v, audio_lens, n_audio, return_stats)
        joint_launches += 1
    return (out, stats) if return_stats else out


def joint_attention_core_bwd(q, k, v, audio_lens, n_audio: int, g, out=None, stats=None):
    """K8: (dq, dk, dv) of `joint_attention_core`; as `masked_attention_bwd`."""
    global joint_bwd_launches
    _check_n_audio(n_audio, q.shape[1])
    if q.device.type == "cpu":
        return joint_attention_core_bwd_plain(q, k, v, audio_lens, n_audio, g)
    grads = _backward("joint_attention", q, k, v, audio_lens, n_audio, g, out, stats)
    joint_bwd_launches += 1
    return grads


class MaskedAttention(torch.autograd.Function):
    """Differentiable key-length-masked attention: K9 forward, K10 backward
    (their plain versions for CPU tensors). Saves what the TPU custom_vjp
    saves (q, k, v, kv_lens) plus, on the card, K9's output and row
    statistics."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens):
        need = any(ctx.needs_input_grad[:3])
        out, stats = masked_attention(q, k, v, kv_lens, return_stats=True) if need else (
            masked_attention(q, k, v, kv_lens), None)
        if need:
            ctx.save_for_backward(q, k, v, kv_lens, out, *(stats or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, out, *stats = ctx.saved_tensors
        dq, dk, dv = masked_attention_bwd(q, k, v, kv_lens, g, out, tuple(stats) or None)
        return dq, dk, dv, None


class JointAttention(torch.autograd.Function):
    """Differentiable joint attention: K7 forward, K8 backward (their plain
    versions for CPU tensors); saves as `MaskedAttention` does."""

    @staticmethod
    def forward(ctx, q, k, v, audio_lens, n_audio: int):
        need = any(ctx.needs_input_grad[:3])
        out, stats = joint_attention_core(q, k, v, audio_lens, n_audio, return_stats=True) if (
            need) else (joint_attention_core(q, k, v, audio_lens, n_audio), None)
        ctx.n_audio = n_audio
        if need:
            ctx.save_for_backward(q, k, v, audio_lens, out, *(stats or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, audio_lens, out, *stats = ctx.saved_tensors
        dq, dk, dv = joint_attention_core_bwd(q, k, v, audio_lens, ctx.n_audio, g, out,
                                              tuple(stats) or None)
        return dq, dk, dv, None, None
