"""Plain versions of the port's kernels (K1 fused RoPE attention, K2 gated
AdaLN) against the JAX package's Pallas kernels, run in interpret mode on
the CPU. Both sides get the same numpy-seeded inputs.

Tolerances: fp32 rtol/atol 2e-3 for K1 (the tolerance the JAX package's own
test of mha_chunked_rope uses); bf16 atol 2e-2 (about one bf16 ulp of the
unit-scale outputs); K2 fp32 1e-5/1e-4 as tests/test_pallas_norm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.ops import pallas_attention as pa
from f5e_tts_tpu.ops.pallas_norm import _gated_adaln_fwd_impl
from f5e_tts_tpu.ops.rope import rotary_cos_sin_half as jax_tables
from f5e_tts_tpu_torch.kernels import gated_adaln as ga
from f5e_tts_tpu_torch.kernels import rope_attention as ra
from f5e_tts_tpu_torch.ops.rope import rotary_cos_sin_half

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_attention_plain_matches_pallas_chunked(dtype):
    rng = np.random.default_rng(0)
    b, n, h, dh = 2, 256, 4, 64
    q, k, v = (rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(3))
    kv_lens = np.asarray([256, 200], np.int32)
    cos, sin = rotary_cos_sin_half(dh, n)
    jd, td = DTYPES[dtype]
    ref = pa.mha_chunked_rope(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                              jnp.asarray(kv_lens), jnp.asarray(cos), jnp.asarray(sin), h,
                              head_chunk=2, block_q=128, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = ra.rope_attention(_to_torch(q, td), _to_torch(k, td), _to_torch(v, td),
                             torch.from_numpy(kv_lens), torch.from_numpy(cos),
                             torch.from_numpy(sin), h)
    assert ours.dtype == td and ours.shape == (b, n, h, dh)
    ours = ours.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-2)


def test_rope_attention_tables_match_jax():
    for got, want in zip(rotary_cos_sin_half(64, 300), jax_tables(64, 300)):
        np.testing.assert_array_equal(got, want)


def test_rope_attention_fully_masked_row_is_uniform_average():
    """kv_len = 0: the TPU kernel's finite -1e30 mask gives the uniform
    average over all keys, not NaN; the plain version does the same."""
    rng = np.random.default_rng(1)
    b, n, h, dh = 1, 64, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, dh)).astype(np.float32))
               for _ in range(3))
    cos, sin = (torch.from_numpy(t) for t in rotary_cos_sin_half(dh, n))
    out = ra.rope_attention(q, k, v, torch.tensor([0]), cos, sin, h)
    torch.testing.assert_close(out, v.mean(dim=1, keepdim=True).expand_as(out),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_adaln_plain_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    b, n, d = 2, 256, 128
    x, y = (rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(2))
    gate = rng.standard_normal((b, d)).astype(np.float32)
    scale, shift = (0.1 * rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    jd, td = DTYPES[dtype]
    ref = _gated_adaln_fwd_impl(*(jnp.asarray(a, jd) for a in (x, y, gate, scale, shift)),
                                block_n=128, interpret=True)
    ours = ga.gated_adaln(*(_to_torch(a, td) for a in (x, y, gate, scale, shift)))
    for got, want, tol in zip(ours, ref, (1e-5, 1e-4)):
        assert got.dtype == td
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=2e-2)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = torch.randn(1, 64, 2, 64)
    cos, sin = (torch.from_numpy(t) for t in rotary_cos_sin_half(64, 64))
    before = (ra.launches, ga.launches)
    ra.rope_attention(x, x, x, torch.tensor([64]), cos, sin, 2)
    ga.gated_adaln(x[:, :, 0], x[:, :, 0], x[:, 0, 0], x[:, 0, 0], x[:, 0, 0])
    assert (ra.launches, ga.launches) == before
