"""The attention kernels' plain versions on the CPU against the JAX package's
Pallas kernels in interpret mode and its XLA references, on the same
numpy-seeded inputs: K3/K6 (RoPE on some heads), K7/K8 (the joint
[audio | text] mask), K9/K10 (the key-length mask, no RoPE) and K11a/K11b
(the packed-heads RoPE kernels, the function K1/K4 compute);
torch.autograd.gradcheck of `MaskedAttention` and `JointAttention` in float64;
and the plain twin of the forward kernels' row statistics
(`attention_stats_plain`): m - log(linv) is the logsumexp of the masked
scores formed with the JAX package's own RoPE helper.

mha_fullkv (K9) has no `interpret` argument: it runs here through its kernel
body in an interpreted pallas_call, as the JAX package's own test does, and
through `_reference_attn`. Rows past a sample's length are compared too
where the two sides define them alike (their keys are the valid ones);
outputs of a row whose keys are all masked are compared apart.

Tolerances:
- fp32 vs the Pallas kernels and the XLA references: rtol/atol 2e-3, the
  tolerance of the JAX package's own tests of these kernels (summation
  order, and the references normalise before P.V);
- bf16 vs the Pallas kernel: both round at the same points, so they differ
  by accumulation order and at most ~1 bf16 ulp: atol 1e-2 * max|ref|;
- gradcheck: float64 defaults (eps 1e-6, atol 1e-5, rtol 1e-3);
- row statistics, fp32 on both sides: 1e-5 relative (summation order).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from f5e_tts_tpu.ops import pallas_attention as pa
from f5e_tts_tpu_torch.kernels import attention as ka
from f5e_tts_tpu_torch.kernels import rope_attention as ra
from f5e_tts_tpu_torch.ops.rope import rotary_cos_sin_half

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, fp32_tol=2e-3, bf16_rel=1e-2):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=fp32_tol, atol=fp32_tol)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=bf16_rel * np.abs(want).max())


def _inputs(seed, b, n, h, dh, count=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(count))


def _torch(arrays, td):
    return tuple(torch.from_numpy(a).to(td) for a in arrays)


def _jax(arrays, jd):
    return tuple(jnp.asarray(a, jd) for a in arrays)


def _interpret_fullkv(q, k, v, kv_lens, block_q):
    """mha_fullkv's kernel body in an interpreted pallas_call (the function
    itself takes no `interpret` argument)."""
    b, n, h, dh = q.shape
    to_bh = lambda x: jnp.transpose(x, (0, 2, 1, 3)).reshape(b * h, n, dh)  # noqa: E731
    out = pl.pallas_call(
        functools.partial(pa._attn_kernel, sm_scale=1.0 / math.sqrt(dh), heads=h,
                          block_q=block_q, n=n),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(b * h, n // block_q),
            in_specs=[pl.BlockSpec((1, block_q, dh), lambda bh, iq, s_: (bh, iq, 0)),
                      pl.BlockSpec((1, n, dh), lambda bh, iq, s_: (bh, 0, 0)),
                      pl.BlockSpec((1, n, dh), lambda bh, iq, s_: (bh, 0, 0))],
            out_specs=pl.BlockSpec((1, block_q, dh), lambda bh, iq, s_: (bh, iq, 0))),
        out_shape=jax.ShapeDtypeStruct((b * h, n, dh), q.dtype),
        interpret=True,
    )(kv_lens.astype(jnp.int32), to_bh(q), to_bh(k), to_bh(v))
    return jnp.transpose(out.reshape(b, h, n, dh), (0, 2, 1, 3))


# ---------------------------------------------------------------------------
# K3 / K6 and K11a / K11b: RoPE inside the kernel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rope_case():
    b, n, h, dh = 2, 256, 4, 64
    cos, sin = rotary_cos_sin_half(dh, n)
    return (*_inputs(0, b, n, h, dh), np.asarray([n, 200], np.int32), cos, sin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,rope_heads", [("fullkv", 1), ("fullkv", 4), ("packed", 1),
                                               ("packed", 4)])
def test_rope_attention_plain_matches_pallas(rope_case, kernel, rope_heads, dtype):
    """K3 (mha_fullkv_rope) and K11a (mha_packed_rope) in interpret mode."""
    q, k, v, _, kv_lens, cos, sin = rope_case
    jd, td = DTYPES[dtype]
    fn = pa.mha_fullkv_rope if kernel == "fullkv" else pa.mha_packed_rope
    want = fn(*_jax((q, k, v), jd), jnp.asarray(kv_lens), jnp.asarray(cos), jnp.asarray(sin),
              rope_heads=rope_heads, block_q=128, interpret=True)
    got = ra.rope_attention(*_torch((q, k, v), td), torch.from_numpy(kv_lens),
                            torch.from_numpy(cos), torch.from_numpy(sin), rope_heads)
    assert got.dtype == td and got.shape == q.shape
    _close(got, _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,rope_heads", [("fullkv", 1), ("fullkv", 4), ("packed", 1),
                                               ("packed", 4)])
def test_rope_attention_bwd_plain_matches_pallas(rope_case, kernel, rope_heads, dtype):
    """K6 (mha_fullkv_rope_bwd) and K11b (mha_packed_rope_bwd) in interpret mode."""
    q, k, v, g, kv_lens, cos, sin = rope_case
    jd, td = DTYPES[dtype]
    fn = pa.mha_fullkv_rope_bwd if kernel == "fullkv" else pa.mha_packed_rope_bwd
    want = fn(*_jax((q, k, v), jd), jnp.asarray(kv_lens), jnp.asarray(cos), jnp.asarray(sin),
              jnp.asarray(g, jd), rope_heads, block_q=128, interpret=True)
    got = ra.rope_attention_bwd(*_torch((q, k, v), td), torch.from_numpy(kv_lens),
                                torch.from_numpy(cos), torch.from_numpy(sin),
                                torch.from_numpy(g).to(td), rope_heads)
    for x, y in zip(got, want):
        assert x.dtype == td and x.shape == q.shape
        _close(x, _np(y), dtype)


@pytest.mark.parametrize("rope_heads", [1, 4])
def test_partial_rope_plain_matches_reference_and_its_vjp(rope_case, rope_heads):
    q, k, v, g, kv_lens, cos, sin = rope_case
    lens, c, s = jnp.asarray(kv_lens), jnp.asarray(cos), jnp.asarray(sin)
    fn = lambda q_, k_, v_: pa._reference_rope_attn(q_, k_, v_, lens, c, s, rope_heads)  # noqa: E731
    want, vjp = jax.vjp(fn, *_jax((q, k, v), jnp.float32))
    tables = (torch.from_numpy(kv_lens), torch.from_numpy(cos), torch.from_numpy(sin))
    tq, tk, tv, tg = _torch((q, k, v, g), torch.float32)
    got = ra.rope_attention(tq, tk, tv, *tables, rope_heads)
    # rows at or past a sample's length are queries too: they see the valid keys
    _close(got, _np(want), "float32")
    for x, y in zip(ra.rope_attention_bwd(tq, tk, tv, *tables, tg, rope_heads), vjp(jnp.asarray(g))):
        _close(x, _np(y), "float32")


# ---------------------------------------------------------------------------
# K9 / K10: key-length mask, no RoPE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def masked_case():
    b, n, h, dh = 2, 256, 2, 64
    return (*_inputs(1, b, n, h, dh), np.asarray([n, 150], np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_plain_matches_pallas(masked_case, dtype):
    q, k, v, _, kv_lens = masked_case
    jd, td = DTYPES[dtype]
    want = _interpret_fullkv(*_jax((q, k, v), jd), jnp.asarray(kv_lens), block_q=128)
    got = ka.masked_attention(*_torch((q, k, v), td), torch.from_numpy(kv_lens))
    assert got.dtype == td and got.shape == q.shape
    _close(got, _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_bwd_plain_matches_pallas(masked_case, dtype):
    q, k, v, g, kv_lens = masked_case
    jd, td = DTYPES[dtype]
    want = pa.mha_fullkv_bwd(*_jax((q, k, v), jd), jnp.asarray(kv_lens), jnp.asarray(g, jd),
                             block_q=128, interpret=True)
    got = ka.masked_attention_bwd(*_torch((q, k, v), td), torch.from_numpy(kv_lens),
                                  torch.from_numpy(g).to(td))
    for x, y in zip(got, want):
        assert x.dtype == td and x.shape == q.shape
        _close(x, _np(y), dtype)


def test_masked_attention_plain_matches_reference_and_its_vjp(masked_case):
    q, k, v, g, kv_lens = masked_case
    lens = jnp.asarray(kv_lens)
    want, vjp = jax.vjp(lambda q_, k_, v_: pa._reference_attn(q_, k_, v_, lens),
                        *_jax((q, k, v), jnp.float32))
    tq, tk, tv, tg = _torch((q, k, v, g), torch.float32)
    _close(ka.masked_attention(tq, tk, tv, torch.from_numpy(kv_lens)), _np(want), "float32")
    for x, y in zip(ka.masked_attention_bwd(tq, tk, tv, torch.from_numpy(kv_lens), tg),
                    vjp(jnp.asarray(g))):
        _close(x, _np(y), "float32")


# ---------------------------------------------------------------------------
# K7 / K8: the joint mask
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def joint_case():
    b, n_audio, nt, h, dh = 2, 192, 64, 2, 64
    return (*_inputs(2, b, n_audio + nt, h, dh), np.asarray([n_audio, 100], np.int32), n_audio)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joint_attention_plain_matches_pallas(joint_case, dtype):
    q, k, v, _, audio_lens, n_audio = joint_case
    jd, td = DTYPES[dtype]
    want = pa.mha_fullkv_joint(*_jax((q, k, v), jd), jnp.asarray(audio_lens), n_audio,
                               block_q=128, interpret=True)
    got = ka.joint_attention_core(*_torch((q, k, v), td), torch.from_numpy(audio_lens), n_audio)
    assert got.dtype == td and got.shape == q.shape
    _close(got, _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joint_attention_bwd_plain_matches_pallas(joint_case, dtype):
    q, k, v, g, audio_lens, n_audio = joint_case
    jd, td = DTYPES[dtype]
    want = pa.mha_fullkv_joint_bwd(*_jax((q, k, v), jd), jnp.asarray(audio_lens),
                                   jnp.asarray(g, jd), n_audio, block_q=128, interpret=True)
    got = ka.joint_attention_core_bwd(*_torch((q, k, v), td), torch.from_numpy(audio_lens),
                                      n_audio, torch.from_numpy(g).to(td))
    for x, y in zip(got, want):
        assert x.dtype == td and x.shape == q.shape
        _close(x, _np(y), dtype)


# (n_audio, nt, audio_lens): the first is a length the TPU gate rejects
# (N + Nt a multiple of 32 only); then audio_len 0 and n_audio with n_audio
# not a multiple of 64 and a 32-token text
@pytest.mark.parametrize("n_audio,nt,audio_lens", [(160, 64, (160, 70)), (200, 32, (0, 200)),
                                                   (64, 32, (1, 33))])
def test_joint_attention_plain_matches_reference_at_ragged_lengths(n_audio, nt, audio_lens):
    b, h, dh = 2, 2, 64
    q, k, v, g = _inputs(3, b, n_audio + nt, h, dh)
    assert not pa.supported(jnp.zeros(q.shape, jnp.bfloat16), jnp.zeros(q.shape, jnp.bfloat16),
                            block_q=256)
    lens = jnp.asarray(audio_lens, jnp.int32)
    want, vjp = jax.vjp(lambda q_, k_, v_: pa._reference_joint_attn(q_, k_, v_, lens, n_audio),
                        *_jax((q, k, v), jnp.float32))
    tq, tk, tv, tg = _torch((q, k, v, g), torch.float32)
    tl = torch.tensor(audio_lens)
    _close(ka.joint_attention_core(tq, tk, tv, tl, n_audio), _np(want), "float32")
    for x, y in zip(ka.joint_attention_core_bwd(tq, tk, tv, tl, n_audio, tg), vjp(jnp.asarray(g))):
        _close(x, _np(y), "float32")


def test_padded_audio_keys_do_not_reach_the_joint_output(joint_case):
    q, k, v, _, audio_lens, n_audio = joint_case
    tq, tk, tv = _torch((q, k, v), torch.float32)
    lens = torch.from_numpy(audio_lens)
    out = ka.joint_attention_core(tq, tk, tv, lens, n_audio)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[1, 100:n_audio] = 99.0
    tv2[1, 100:n_audio] = -99.0
    assert torch.equal(out, ka.joint_attention_core(tq, tk2, tv2, lens, n_audio))


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


def _small64(seed, b, n, h, dh):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, n, h, dh))).requires_grad_()
                 for _ in range(3))


@pytest.mark.parametrize("lens", [(6, 5), (0, 3)])
def test_masked_attention_function_gradcheck_float64(lens):
    q, k, v = _small64(4, 2, 6, 2, 4)
    kv = torch.tensor(lens)
    assert torch.autograd.gradcheck(lambda q_, k_, v_: ka.MaskedAttention.apply(q_, k_, v_, kv),
                                    (q, k, v))


@pytest.mark.parametrize("lens,n_audio", [((5, 2), 5), ((0, 4), 4), ((0, 3), 7)])
def test_joint_attention_function_gradcheck_float64(lens, n_audio):
    q, k, v = _small64(5, 2, 7, 2, 4)
    al = torch.tensor(lens)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: ka.JointAttention.apply(q_, k_, v_, al, n_audio), (q, k, v))


def test_attention_functions_on_cpu_count_no_launch():
    x = torch.randn(1, 64, 2, 64, requires_grad=True)
    counts = lambda: (ka.masked_launches, ka.masked_bwd_launches, ka.joint_launches,  # noqa: E731
                      ka.joint_bwd_launches, ra.partial_launches, ra.partial_bwd_launches)
    before = counts()
    ka.MaskedAttention.apply(x, x, x, torch.tensor([64])).sum().backward()
    ka.JointAttention.apply(x, x, x, torch.tensor([20]), 32).sum().backward()
    cos, sin = (torch.from_numpy(t) for t in rotary_cos_sin_half(64, 64))
    ra.RopeAttention.apply(x, x, x, torch.tensor([64]), cos, sin, 1).sum().backward()
    assert counts() == before


@pytest.mark.parametrize("kind", ["masked", "joint"])
def test_attention_bwd_fully_masked_row(kind):
    """No valid key: the output is the uniform average of v whatever q and k
    are, so dq = dk = 0 and dv = the mean of g over the queries (the TPU
    kernels give nonzero dq and dk here; jax.vjp of the XLA reference agrees
    with the port)."""
    b, n, h, dh = 1, 16, 2, 8
    q, k, v, g = _torch(_inputs(6, b, n, h, dh), torch.float32)
    if kind == "masked":
        out = ka.masked_attention(q, k, v, torch.tensor([0]))
        dq, dk, dv = ka.masked_attention_bwd(q, k, v, torch.tensor([0]), g)
    else:  # no audio and no text
        out = ka.joint_attention_core(q, k, v, torch.tensor([0]), n)
        dq, dk, dv = ka.joint_attention_core_bwd(q, k, v, torch.tensor([0]), n, g)
    torch.testing.assert_close(out, v.mean(dim=1, keepdim=True).expand_as(out), rtol=1e-5,
                               atol=1e-5)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, g.mean(dim=1, keepdim=True).expand_as(dv), rtol=1e-5, atol=1e-5)


def test_joint_attention_refuses_n_audio_outside_the_keys():
    x = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError, match="n_audio"):
        ka.joint_attention_core(x, x, x, torch.tensor([3]), 9)


# ---------------------------------------------------------------------------
# the forward kernels' row statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule,rope_heads,lens,n_audio", [
    ("prefix", 3, (96, 40), None),  # RoPE on 3 of 4 heads, padded keys
    ("joint", 0, (70, 0), 80),      # 80 audio keys + 16 text; one sample without audio
    ("prefix", 4, (96, 0), None),   # a sample whose keys are all masked
    ("joint", 0, (50, 0), 96),      # no text: the sample without audio has every key masked
])
def test_attention_stats_plain_is_the_rows_logsumexp(rule, rope_heads, lens, n_audio):
    """m - log(linv) equals jax.nn.logsumexp of the masked scores that the
    JAX package's helpers give (RoPE by apply_rotary_half, as
    `_reference_rope_attn` applies it); a row whose keys are all masked has
    m = -1e30 and linv = 1/N."""
    from f5e_tts_tpu.ops.rope import apply_rotary_half

    b, n, h, dh = 2, 96, 4, 64
    q, k = _inputs(5, b, n, h, dh, count=2)
    cos, sin = rotary_cos_sin_half(dh, n)
    col = np.arange(n)
    valid = col[None, :] < np.asarray(lens)[:, None]
    if rule == "joint":
        valid |= (col >= n_audio)[None, :]

    flag = (jnp.arange(h) < rope_heads)[None, None, :, None]
    c, s = jnp.asarray(cos)[None, :, None, :], jnp.asarray(sin)[None, :, None, :]
    qr = jnp.where(flag, apply_rotary_half(jnp.asarray(q), c, s), q) / math.sqrt(dh)
    kr = jnp.where(flag, apply_rotary_half(jnp.asarray(k), c, s), k)
    scores = jnp.where(jnp.asarray(valid)[:, None, None, :],
                       jnp.einsum("bqhd,bkhd->bhqk", qr, kr), -1e30)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))

    qs, ks, _ = ka.attention_prep_plain(*_torch((q, k), torch.float32),
                                        cos=torch.from_numpy(cos), sin=torch.from_numpy(sin),
                                        rope_heads=rope_heads)
    m, linv = ka.attention_stats_plain(qs, ks, torch.from_numpy(valid)[:, None, None, :])
    assert m.shape == linv.shape == (b, h, n) and m.dtype == linv.dtype == torch.float32
    np.testing.assert_allclose((m - torch.log(linv)).numpy(), want, rtol=1e-5, atol=0)
    dead = torch.from_numpy(~valid.any(axis=1))
    assert (m[dead] == -1e30).all()
    assert torch.allclose(linv[dead], torch.full_like(linv[dead], 1.0 / n))
