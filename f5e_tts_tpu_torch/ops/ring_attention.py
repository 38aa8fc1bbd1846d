"""Ring attention over the mesh's "seq" axis (counterpart of
`f5e_tts_tpu/ops/ring_attention.py`): sequence / context parallelism.

Each of the S ranks of the axis holds N/S rows of q, k and v. K/V stay
sharded: at each of S steps a rank folds the K/V block it holds into the
online softmax of its own query rows, then passes the block on to the next
rank by send/recv and takes the previous rank's. No rank ever holds all of
K/V. The softmax is the safe online one in fp32, as JAX's (-1e30 masks, a
running row max, correction factors on the accumulator, masked columns
zeroed so a fully-masked block adds nothing).

JAX differentiates through its `ppermute` ring; torch cannot, so
`RingAttention` carries its own backward ring: the K/V blocks travel again,
each with the running sums of its dK and dV, and after S steps every block
is home with its whole gradient. The JAX package computes this block with
einsums outside any Pallas kernel, so the port's ring is plain torch
products too, no hand kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from f5e_tts_tpu_torch.ops.rope import apply_rotary_half
from f5e_tts_tpu_torch.parallel.mesh import GatherRows, Mesh, ScatterRows

_NEG = -1e30


def _valid(kv_lens: Optional[torch.Tensor], src: int, nb: int) -> Optional[torch.Tensor]:
    """(B, nb) key validity of the block that started on ring index `src`
    (None: every key valid)."""
    if kv_lens is None:
        return None
    cols = src * nb + torch.arange(nb, device=kv_lens.device)
    return cols[None, :] < kv_lens[:, None]


def _masked(x, valid, fill):
    return x if valid is None else x.masked_fill(~valid[:, None, None, :], fill)


def _scores(q, k, valid, scale):
    return _masked(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, valid, _NEG)


class RingAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(dh)) v over the whole ring, for this rank's query
    rows: q, k, v (B, N/S, H, dh) local shards, kv_lens (B,) global key
    lengths (None: every key valid, no mask applied). Output (B, N/S, H, dh)
    in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, mesh: Mesh, axis: str):
        s, idx = mesh.size(axis), mesh.index(axis)
        b, nb, h, dh = q.shape
        scale = 1.0 / math.sqrt(dh)
        qf = q.float()
        m = torch.full((b, h, nb), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, nb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, nb, dh), dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for t in range(s):
            valid = _valid(kv_lens, (idx - t) % s, nb)  # the block here began on idx - t
            sc = _scores(qf, kc.float(), valid, scale)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = _masked(torch.exp(sc - m_new[..., None]), valid, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc.float())
            m = m_new
            if t < s - 1:
                kc, vc = mesh.shift([kc, vc], axis)
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.mesh, ctx.axis = mesh, axis
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        s, idx = mesh.size(axis), mesh.index(axis)
        b, nb, h, dh = q.shape
        scale = 1.0 / math.sqrt(dh)
        qf, gf = q.float(), g.float()
        delta = (gf * out).sum(dim=-1).transpose(1, 2)  # (B, H, nb): rowsum(dO * O)
        dq = torch.zeros_like(qf)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for t in range(s):
            valid = _valid(kv_lens, (idx - t) % s, nb)
            kf, vf = kc.float(), vc.float()
            p = _masked(torch.exp(_scores(qf, kf, valid, scale) - lse[..., None]), valid, 0.0)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, gf)
            dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf)
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            # the block and its gradient sums move on; after S moves they are home
            if t < s - 1:
                kc, vc, dk, dv = mesh.shift([kc, vc, dk, dv], axis)
            else:
                dk, dv = mesh.shift([dk, dv], axis)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q, k, v, kv_lens: Optional[torch.Tensor], mesh: Mesh, axis: str = "seq",
                   rope_cos: Optional[torch.Tensor] = None,
                   rope_sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, H, dh) attention of q/k/v replicated over `axis` (JAX's
    ring_attention over global arrays). Each rank takes its N/S rows
    (`ScatterRows`), rotates its un-rotated q/k with the half-split RoPE
    tables (>= N, dh) at their GLOBAL positions (its rows start at index x
    N/S), runs the ring, and the rows' outputs are all-gathered into the
    replicated output (`GatherRows`); the replicated inputs' gradients come
    back whole on every rank. kv_lens (B,) over the global N (None: every
    key valid). N % S == 0."""
    idx, nb = mesh.index(axis), q.shape[1] // mesh.size(axis)
    q, k, v = (ScatterRows.apply(t, mesh, axis, 1) for t in (q, k, v))
    if rope_cos is not None:
        rows = slice(idx * nb, (idx + 1) * nb)
        cos = rope_cos[rows].float()[None, :, None, :]
        sin = rope_sin[rows].float()[None, :, None, :]
        q, k = apply_rotary_half(q, cos, sin), apply_rotary_half(k, cos, sin)
    o = RingAttention.apply(q, k, v, None if kv_lens is None else kv_lens.to(q.device), mesh,
                            axis)
    return GatherRows.apply(o, mesh, axis, 1)
