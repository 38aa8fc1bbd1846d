"""The arithmetic of the fp32 attention kernels (csrc/attention_fp32.cuh),
emulated in plain PyTorch on the CPU, against the JAX package's fp32 XLA
references (f5e_tts_tpu/ops/pallas_attention.py: _reference_rope_attn,
_reference_attn, _reference_joint_attn; gradients by jax.vjp) on the same
numpy-seeded inputs.

The kernels run every product on the tensor cores in TF32: each fp32
operand x is split as hi = tf32(x), lo = tf32(x - hi), with tf32 the
cvt.rna.tf32.f32 rounding (emulated on the int32 view: add 0x1000, clear
the 13 low bits), and a product a.b is summed as lo_a.hi_b + hi_a.lo_b +
hi_a.hi_b in fp32 (products of tf32 values are exact in fp32). The
emulation forms q' and k' as the kernels' pre-pass does
(`attention_prep_plain` in fp32), then S = q'.k'^T, P = exp(S - m),
O = (P.V) / l, and the backward's dP = dO.V^T, dS = P (dP - delta),
dV = P^T.dO, dQ = sm_scale dS.k', dK = dS^T.q' and the RoPE adjoint, each
product with 1, 2 (the lo_a.hi_b term dropped) or 3 passes.

Inputs: q, k of standard deviation 3.5 (so the scores q'.k'^T, of standard
deviation ~12, span about +-60 at these shapes; the test checks at least
+-30), v and the output cotangent of standard deviation 1, every row with a
valid key. There three passes stay within the tolerances the kernels are
held to on the card (chip_smoke.py, tests/test_torch_kernels_gpu.py: the
forward |diff| <= 2e-4 + 1e-4 |ref|, each gradient max |diff| <=
2e-4 max |ref|), and one or two passes (relative error ~2^-11 a product,
times scores of ~30) fall outside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.ops import pallas_attention as pa
from f5e_tts_tpu_torch.kernels import attention as ka
from f5e_tts_tpu_torch.ops.rope import rot_half, rotary_cos_sin_half

FP32_ATOL, FP32_RTOL, FP32_BWD_REL = 2e-4, 1e-4, 2e-4
SIGMA_QK = 3.5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away from 0."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels sum it: `passes` tf32 products into fp32, the
    small terms first."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = {1: [(ah, bh)], 2: [(ah, bl), (ah, bh)], 3: [(al, bh), (ah, bl), (ah, bh)]}[passes]
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for x, y in terms:
        acc = acc + x @ y
    return acc


def emulate(q, k, v, g, valid, passes, cos=None, sin=None, rope_heads=0):
    """(out, dq, dk, dv) of the kernels' arithmetic; tensors (B, N, H, dh)."""
    qs, ks, _ = ka.attention_prep_plain(q, k, cos=cos, sin=sin, rope_heads=rope_heads)
    qh, kh, vh, gh = (t.transpose(1, 2) for t in (qs, ks, v, g))  # (B, H, N, dh)
    s = mm(qh, kh.transpose(-1, -2), passes).masked_fill(~valid, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    linv = 1.0 / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (mm(p, vh, passes) * linv).transpose(1, 2)
    p = p * linv
    dp = mm(gh, vh.transpose(-1, -2), passes)
    delta = (g * out).sum(dim=-1).transpose(1, 2)[..., None]
    ds = torch.where(valid, p * (dp - delta), torch.zeros(()))
    dv = mm(p.transpose(-1, -2), gh, passes)
    dq = mm(ds, kh, passes) * (1.0 / q.shape[-1] ** 0.5)
    dk = mm(ds.transpose(-1, -2), qh, passes)
    dq, dk, dv = (t.transpose(1, 2) for t in (dq, dk, dv))
    if cos is not None:
        c, sn, rope = ka.rope_tables(cos, sin, q.shape[1], q.shape[2], rope_heads, torch.float32)
        dq = torch.where(rope, dq * c - rot_half(dq * sn), dq)
        dk = torch.where(rope, dk * c - rot_half(dk * sn), dk)
    return out, dq, dk, dv, s.masked_fill(~valid, 0.0).abs().max().item()


# (kind, b, n, h, dh, lens, rope_heads or n_audio)
CASES = [
    ("rope", 2, 200, 2, 64, (200, 131), 2),
    ("rope", 2, 200, 3, 128, (200, 77), 1),    # RoPE on the first head only
    ("masked", 2, 200, 2, 128, (200, 131), 0),
    ("joint", 2, 216, 2, 64, (120, 57), 192),  # 24 text keys after 192 audio
]


@pytest.fixture(scope="module")
def results():
    """{case: (JAX (out, dq, dk, dv), {passes: emulated (out, dq, dk, dv)}, span)}."""
    found = {}
    for idx, (kind, b, n, h, dh, lens, extra) in enumerate(CASES):
        rng = np.random.default_rng(100 + idx)
        q, k = ((SIGMA_QK * rng.standard_normal((b, n, h, dh))).astype(np.float32)
                for _ in range(2))
        v, g = (rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(2))
        lens_np = np.asarray(lens, np.int32)
        cos, sin = rotary_cos_sin_half(dh, n)

        def f(q, k, v):
            if kind == "rope":
                return pa._reference_rope_attn(q, k, v, jnp.asarray(lens_np), jnp.asarray(cos),
                                               jnp.asarray(sin), extra)
            if kind == "masked":
                return pa._reference_attn(q, k, v, jnp.asarray(lens_np))
            return pa._reference_joint_attn(q, k, v, jnp.asarray(lens_np), extra)

        @jax.jit
        def ref(q, k, v, g):
            out, vjp = jax.vjp(f, q, k, v)
            return (out, *vjp(g))

        want = tuple(np.asarray(t) for t in ref(q, k, v, g))
        tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
        lens_t = torch.from_numpy(lens_np)
        if kind == "joint":
            valid = ka.joint_valid(lens_t, extra, n, "cpu")
        else:
            valid = ka.prefix_valid(lens_t, n, "cpu")
        rope = dict(cos=torch.from_numpy(cos), sin=torch.from_numpy(sin), rope_heads=extra) if (
            kind == "rope") else {}
        got, span = {}, 0.0
        for passes in (1, 2, 3):
            *outs, span = emulate(tq, tk, tv, tg, valid, passes, **rope)
            got[passes] = tuple(t.numpy() for t in outs)
        found[CASES[idx]] = (want, got, span)
    return found


def excess(got, want) -> float:
    """The largest error over its limit: <= 1 within the kernels' tolerances."""
    fwd = np.max(np.abs(got[0] - want[0]) / (FP32_ATOL + FP32_RTOL * np.abs(want[0])))
    bwd = max(np.abs(x - y).max() / (FP32_BWD_REL * np.abs(y).max())
              for x, y in zip(got[1:], want[1:]))
    return float(max(fwd, bwd))


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-dh{c[4]}" for c in CASES])
def test_three_passes_within_fp32_tolerances(results, case):
    want, got, span = results[case]
    assert span >= 30.0, span  # the scores are as wide as the docstring says
    for part, x, y in zip(("out", "dq", "dk", "dv"), got[3], want):
        assert np.isfinite(x).all(), part
    fwd_err = np.abs(got[3][0] - want[0])
    assert (fwd_err <= FP32_ATOL + FP32_RTOL * np.abs(want[0])).all(), fwd_err.max()
    for part, x, y in zip(("dq", "dk", "dv"), got[3][1:], want[1:]):
        assert np.abs(x - y).max() <= FP32_BWD_REL * np.abs(y).max(), part


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-dh{c[4]}" for c in CASES])
def test_fewer_passes_fall_outside(results, case, passes):
    want, got, _ = results[case]
    assert excess(got[passes], want) > 1.0
    # and each direction alone: the forward, then the gradients
    fwd = np.abs(got[passes][0] - want[0]) - (FP32_ATOL + FP32_RTOL * np.abs(want[0]))
    assert fwd.max() > 0
    assert any(np.abs(x - y).max() > FP32_BWD_REL * np.abs(y).max()
               for x, y in zip(got[passes][1:], want[1:]))


def test_tf32_rounding_matches_the_instruction():
    """cvt.rna.tf32.f32 on a few values: ties away from zero, exact values kept,
    and hi + lo within 2^-22 of x."""
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11), 3.0 + 2.0**-10 + 2.0**-22,
                      2.0**-20, -7.25], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10), 3.0 + 2.0**-9,
                         2.0**-20, -7.25], dtype=torch.float32)
    # 1 + 2^-11 is the tie between 1 and 1 + 2^-10: away from 0; 1 + 2^-12 is
    # below it; 3 + 2^-10 + 2^-22 lies above the tie between 3 and 3 + 2^-9
    assert torch.equal(tf32(x), want)
    gen = torch.Generator().manual_seed(0)
    y = torch.randn(4096, generator=gen) * 1e3
    hi, lo = split(y)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(4096, dtype=torch.int32))
    assert ((y - hi - lo).abs() <= 2.0**-22 * y.abs()).all()
    assert ((y - hi).abs() <= 2.0**-11 * y.abs()).all()
