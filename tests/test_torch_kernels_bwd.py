"""Backward kernels of the port on the CPU: the plain versions of K4 (RoPE
attention backward) and K5 (gated AdaLN backward) against the JAX
package's Pallas kernels in interpret mode and against jax.vjp of its XLA
references, on the same numpy-seeded inputs; and torch.autograd.gradcheck
of the two autograd Functions' CPU path in float64.

Also the plain twin of the attention kernels' pre-pass
(`attention_prep_plain`): its q' and k' are bitwise the operands the
plain versions formed before it existed, and its delta = rowsum(dO * O),
with O the Pallas forward's bf16 output in interpret mode, stays within the
per-row bound that `csrc/attention_core.cuh` states against the TPU
kernels' delta = linv * sum p~ dP: 2^-8 * sum_d |dO * O| (one bf16 rounding
of O per term) plus 1e-5 * max(1, |delta|) for fp32 summation order.

Tolerances:
- fp32 vs the Pallas kernels and the XLA vjp: rtol/atol 2e-3, the tolerance
  of the JAX package's own test of mha_chunked_rope_bwd (summation order);
- bf16 vs the Pallas kernel: both round at the same points, so they differ
  by accumulation order and at most ~1 bf16 ulp of the outputs:
  atol 1e-2 * max|ref| (outputs here reach ~0.5);
- bf16 vs the XLA vjp (which rounds elsewhere): atol 3e-2 * max|ref|;
- K5 fp32 1e-5 relative/absolute (dx, dy) and 1e-4 (the (B, D) sums over
  N), against the Pallas kernel and against the XLA vjp (the latter at the
  shapes the Hopper kernel treats as edges); bf16 1e-2 relative + 2e-2
  absolute (one bf16 ulp);
- gradcheck: float64 defaults (eps 1e-6, atol 1e-5, rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.ops import pallas_attention as pa
from f5e_tts_tpu.ops import pallas_norm as pn
from f5e_tts_tpu_torch.kernels import attention as ka
from f5e_tts_tpu_torch.kernels import gated_adaln as ga
from f5e_tts_tpu_torch.kernels import rope_attention as ra
from f5e_tts_tpu_torch.ops.rope import rot_half, rotary_cos_sin_half

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, fp32_tol=2e-3, bf16_rel=1e-2):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=fp32_tol, atol=fp32_tol)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=bf16_rel * np.abs(want).max())


@pytest.fixture(scope="module")
def attn_inputs():
    rng = np.random.default_rng(0)
    b, n, h, dh = 2, 256, 4, 64
    q, k, v, g = (rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(4))
    cos, sin = rotary_cos_sin_half(dh, n)
    return q, k, v, g, np.asarray([256, 200], np.int32), cos, sin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_attention_bwd_plain_matches_pallas_chunked(attn_inputs, dtype):
    q, k, v, g, kv_lens, cos, sin = attn_inputs
    h = q.shape[2]
    jd, td = DTYPES[dtype]
    ref = pa.mha_chunked_rope_bwd(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(kv_lens),
                                  jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(g, jd), h,
                                  head_chunk=2, block_q=128, interpret=True)
    ours = ra.rope_attention_bwd(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                 torch.from_numpy(kv_lens), torch.from_numpy(cos),
                                 torch.from_numpy(sin), torch.from_numpy(g).to(td), h)
    for got, want in zip(ours, ref):
        assert got.dtype == td and got.shape == q.shape
        _close(got, _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_attention_bwd_plain_matches_reference_vjp(attn_inputs, dtype):
    q, k, v, g, kv_lens, cos, sin = attn_inputs
    h = q.shape[2]
    jd, td = DTYPES[dtype]
    lens, c, s = jnp.asarray(kv_lens), jnp.asarray(cos), jnp.asarray(sin)
    _, vjp = jax.vjp(lambda q_, k_, v_: pa._reference_rope_attn(q_, k_, v_, lens, c, s, h),
                     *(jnp.asarray(a, jd) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g, jd))
    ours = ra.rope_attention_bwd(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                 torch.from_numpy(kv_lens), torch.from_numpy(cos),
                                 torch.from_numpy(sin), torch.from_numpy(g).to(td), h)
    for got, want in zip(ours, ref):
        _close(got, _np(want), dtype, bf16_rel=3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_adaln_bwd_plain_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    b, n, d = 2, 256, 128
    x, y, g_newx, g_out = (rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(4))
    gate = rng.standard_normal((b, d)).astype(np.float32)
    scale = 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    jd, td = DTYPES[dtype]
    args = (x, y, gate, scale, g_newx, g_out)
    ref = pn._gated_adaln_bwd_impl(*(jnp.asarray(a, jd) for a in args), block_n=128,
                                   interpret=True)
    ours = ga.gated_adaln_bwd(*(torch.from_numpy(a).to(td) for a in args))
    for i, (got, want) in enumerate(zip(ours, ref)):
        assert got.dtype == td and got.shape == want.shape
        want = _np(want)
        if dtype == "float32":
            tol = 1e-5 if i < 2 else 1e-4
            np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())
        else:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=2e-2)


# the shapes the Hopper kernel treats as edges: one row, N past a multiple of
# its rows per block, lanes with unequal vector counts, column sums in
# shared memory (D > 1024)
@pytest.mark.parametrize("b,n,d", [(2, 64, 96), (2, 1, 1024), (3, 33, 256), (2, 17, 520),
                                   (1, 9, 3072)])
def test_gated_adaln_bwd_plain_matches_reference_vjp(b, n, d):
    rng = np.random.default_rng(2)
    x, y = (rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(2))
    gate, scale, shift = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(3))
    gs = tuple(rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(pn._reference_gated_adaln, *(jnp.asarray(a) for a in (x, y, gate, scale,
                                                                          shift)))
    ref = vjp(tuple(jnp.asarray(a) for a in gs))
    ours = ga.gated_adaln_bwd(*(torch.from_numpy(a) for a in (x, y, gate, scale, *gs)))
    for i, (got, want) in enumerate(zip(ours, ref)):
        want = np.asarray(want)
        tol = 1e-5 if i < 2 else 1e-4  # dx, dy; the sums over N
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def test_rope_attention_function_gradcheck_float64():
    rng = np.random.default_rng(3)
    b, n, h, dh = 2, 6, 2, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, dh))).requires_grad_()
               for _ in range(3))
    cos, sin = (torch.from_numpy(t).double() for t in rotary_cos_sin_half(dh, n))
    for lens, rope_heads in (((6, 5), h), ((0, 3), 1)):
        kv = torch.tensor(lens)
        assert torch.autograd.gradcheck(
            lambda q_, k_, v_: ra.RopeAttention.apply(q_, k_, v_, kv, cos, sin, rope_heads),
            (q, k, v))


def test_gated_adaln_function_gradcheck_float64():
    rng = np.random.default_rng(4)
    b, n, d = 2, 5, 8
    x, y = (torch.from_numpy(rng.standard_normal((b, n, d))).requires_grad_() for _ in range(2))
    mod = torch.from_numpy(rng.standard_normal((b, 3 * d))).requires_grad_()
    # gate/scale/shift as column slices of one modulation, as in the DiT block
    fn = lambda x_, y_, m_: ga.GatedAdaLN.apply(x_, y_, *m_.chunk(3, dim=-1))  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, y, mod))


def test_functions_on_cpu_count_no_launch():
    x = torch.randn(1, 64, 2, 64, requires_grad=True)
    cos, sin = (torch.from_numpy(t) for t in rotary_cos_sin_half(64, 64))
    before = (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches)
    ra.RopeAttention.apply(x, x, x, torch.tensor([64]), cos, sin, 2).sum().backward()
    y = x[:, :, 0]
    sum(t.sum() for t in ga.GatedAdaLN.apply(y, y, y[:, 0], y[:, 0], y[:, 0])).backward()
    assert (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches) == before


def test_rope_attention_bwd_fully_masked_row():
    """kv_len = 0: the output is the uniform average of v whatever q and k
    are, so dq = dk = 0 and dv = the mean of g over the queries (the TPU
    kernel gives nonzero dq and dk here; jax.vjp of its XLA reference agrees
    with the port)."""
    rng = np.random.default_rng(5)
    b, n, h, dh = 1, 16, 2, 8
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, n, h, dh)).astype(np.float32))
                  for _ in range(4))
    cos, sin = (torch.from_numpy(t) for t in rotary_cos_sin_half(dh, n))
    dq, dk, dv = ra.rope_attention_bwd(q, k, v, torch.tensor([0]), cos, sin, g, h)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, g.mean(dim=1, keepdim=True).expand_as(dv),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope_heads", [4, 1, 0])
def test_bwd_prep_plain_operands_are_the_plain_versions_own(attn_inputs, dtype, rope_heads):
    """q' and k' bitwise what the plain versions formed inline before the
    pre-pass's twin existed (rotate in the math dtype, scale q, round)."""
    q, k, _, _, _, cos, sin = attn_inputs
    td = DTYPES[dtype][1]
    qt, kt = (torch.from_numpy(a).to(td) for a in (q, k))
    c, s = (torch.from_numpy(t)[None, :, None, :] for t in (cos, sin))
    rope = (torch.arange(q.shape[2]) < rope_heads)[None, None, :, None]
    qf, kf = qt.float(), kt.float()
    want_q = (torch.where(rope, qf * c + rot_half(qf) * s, qf) * 0.125).to(td).float()
    want_k = torch.where(rope, kf * c + rot_half(kf) * s, kf).to(td).float()
    got_q, got_k, delta = ka.attention_prep_plain(qt, kt, cos=torch.from_numpy(cos),
                                                  sin=torch.from_numpy(sin),
                                                  rope_heads=rope_heads)
    assert delta is None
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    # without tables: q scaled and rounded, k as it is
    got_q, got_k, _ = ka.attention_prep_plain(qt, kt)
    assert torch.equal(got_q, (qf * 0.125).to(td).float()) and torch.equal(got_k, kf)


@pytest.mark.parametrize("rope", [True, False])
def test_bwd_prep_plain_delta_within_the_stated_bound_of_the_tpu_delta(attn_inputs, rope):
    """delta = rowsum(dO * O) from the Pallas forward's bf16 output against
    linv * sum_j p~ dP formed as the TPU backward kernels form it
    (pallas_attention.py:395-410), every row of every head."""
    q, k, v, g, kv_lens, cos, sin = attn_inputs
    b, n, h, dh = q.shape
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    lens, jc, js = jnp.asarray(kv_lens), jnp.asarray(cos), jnp.asarray(sin)
    if rope:
        o = pa.mha_chunked_rope(jq, jk, jv, lens, jc, js, h, head_chunk=2, block_q=128,
                                interpret=True)
    else:
        o = pa.mha_fullkv_rope(jq, jk, jv, lens, jc, js, 0, block_q=128, interpret=True)
    tq, tk, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, g))
    to = torch.from_numpy(np.array(_np(o))).bfloat16()
    tables = dict(cos=torch.from_numpy(cos), sin=torch.from_numpy(sin), rope_heads=h) if rope \
        else {}
    qs, ks, delta = ka.attention_prep_plain(tq, tk, tg, to, **tables)
    assert delta.shape == (b, h, n) and delta.dtype == torch.float32
    # the TPU kernels' delta, in fp32 from the same bf16 q', k', v, dO
    jqs, jks = (jnp.asarray(t.numpy()) for t in (qs, ks))
    s = jnp.einsum("bqhd,bkhd->bhqk", jqs, jks)
    s = jnp.where(jnp.arange(n)[None, None, None, :] < lens[:, None, None, None], s, -1e30)
    pt = jnp.exp(s - s.max(axis=-1, keepdims=True))
    linv = 1.0 / jnp.maximum(pt.sum(axis=-1, keepdims=True), 1e-30)
    dp = jnp.einsum("bqhd,bkhd->bhqk", jg.astype(jnp.float32), jv.astype(jnp.float32))
    want = np.asarray(linv * (pt * dp).sum(axis=-1, keepdims=True))[..., 0]
    bound = (2.0 ** -8 * (tg.float() * to.float()).abs().sum(dim=-1).transpose(1, 2).numpy()
             + 1e-5 * np.maximum(1.0, np.abs(want)))
    assert (np.abs(delta.numpy() - want) <= bound).all(), np.abs(delta.numpy() - want).max()
