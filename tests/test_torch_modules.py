"""Module parity: the PyTorch port's ops and DiT modules against the JAX
package on the same numpy-seeded inputs and weights, in fp32 on the CPU.

Tolerance atol 1e-4 (rtol 1e-4): fp32 on both sides, differences come from
summation order only. The bf16 `linear` case checks the rounding point: the
bias joins the fp32 accumulator before the one rounding, as in the JAX
package (tolerance: one bf16 ulp of the outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops import attention as jattn
from f5e_tts_tpu.ops import convnext as jcnx
from f5e_tts_tpu.ops import nn as jnn
from f5e_tts_tpu.ops import rope as jrope
from f5e_tts_tpu.utils.masks import lens_to_mask as jlens_to_mask
from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import attention as tattn
from f5e_tts_tpu_torch.ops import convnext as tcnx
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.ops import rope as trope
from f5e_tts_tpu_torch.utils.convert import dit_from_jax, to_tensors
from f5e_tts_tpu_torch.utils.masks import lens_to_mask

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1)
F32 = dict(rtol=1e-4, atol=1e-4)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or F32))


def randomized(tree, rng):
    """numpy copy of a JAX tree; zero-initialised leaves (AdaLN, proj_out,
    GRN) get seeded values so every weight shapes the output."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return jax.tree.map(leaf, tree)


def tiny_dit(seed=0):
    arch_j, arch_t = JDiTConfig(**TINY, dropout=0.0), DiTConfig(**TINY, dropout=0.0)
    params, _ = jdit.init_dit(jax.random.PRNGKey(seed), arch_j, 16)
    params_np = randomized(params, np.random.default_rng(seed))
    return arch_j, arch_t, params_np, dit_from_jax(params_np, arch_t)


def test_linear_fp32_and_bf16_bias_rounding():
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((48, 24)).astype(np.float32),
         "b": (100 * rng.standard_normal(24)).astype(np.float32)}
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    close(tnn.linear(to_tensors(p), torch.from_numpy(x)), jnn.linear(p, jnp.asarray(x)))
    want = jnn.linear(p, jnp.asarray(x), jnp.bfloat16).astype(jnp.float32)
    got = tnn.linear(to_tensors(p), torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=8e-3, atol=1e-2)


def test_norms_activations_and_tables():
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 7, 32))).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    p = {"g": rng.standard_normal(32).astype(np.float32),
         "b": rng.standard_normal(32).astype(np.float32)}
    close(tnn.layernorm(to_tensors(p), tx), jnn.layernorm(p, jx))
    close(tnn.layernorm(None, tx), jnn.layernorm(None, jx))
    close(tnn.gelu(tx), jnn.gelu(jx))
    close(tnn.gelu(tx, "tanh"), jnn.gelu(jx, "tanh"))
    close(tnn.mish(tx), jnn.mish(jx))
    close(tnn.silu(tx), jnn.silu(jx))
    t = rng.uniform(0, 1, 3).astype(np.float32)
    close(tnn.sinus_time_embedding(torch.from_numpy(t), 256),
          jnn.sinus_time_embedding(jnp.asarray(t), 256), rtol=1e-4, atol=2e-4)
    np.testing.assert_array_equal(tnn.precompute_freqs_cis(32, 50), jnn.precompute_freqs_cis(32, 50))
    np.testing.assert_array_equal(lens_to_mask(torch.tensor([3, 0, 7]), 6).numpy(),
                                  np.asarray(jlens_to_mask(jnp.asarray([3, 0, 7]), 6)))


@pytest.mark.parametrize("groups,padding,dilation,k", [
    (1, "SAME", 1, 7), (64, 3, 1, 7), (16, 15, 1, 31), (64, 6, 2, 7), (1, (2, 0), 1, 3)])
def test_conv1d_channels_last(groups, padding, dilation, k):
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((k, 64 // groups, 64)).astype(np.float32) * 0.2,
         "b": rng.standard_normal(64).astype(np.float32)}
    x = rng.standard_normal((2, 19, 64)).astype(np.float32)
    close(tnn.conv1d(to_tensors(p), torch.from_numpy(x), groups=groups, padding=padding,
                     dilation=dilation),
          jnn.conv1d(p, jnp.asarray(x), groups=groups, padding=padding, dilation=dilation))


def test_rope_helpers():
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(trope.half_split_perm(8), jrope.half_split_perm(8))
    w = rng.standard_normal((5, 2 * 8)).astype(np.float32)
    b = rng.standard_normal(2 * 8).astype(np.float32)
    np.testing.assert_array_equal(trope.permute_qk_weight(w, 2), jrope.permute_qk_weight(w, 2))
    np.testing.assert_array_equal(trope.permute_qk_bias(b, 2), jrope.permute_qk_bias(b, 2))
    np.testing.assert_array_equal(trope.unpermute_qk_weight(trope.permute_qk_weight(w, 2), 2), w)
    np.testing.assert_array_equal(trope.unpermute_qk_bias(trope.permute_qk_bias(b, 2), 2), b)
    cos, sin = trope.rotary_cos_sin_half(16, 9)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    got = trope.apply_rotary_half(torch.from_numpy(x), torch.from_numpy(cos)[None, :, None],
                                  torch.from_numpy(sin)[None, :, None])
    close(got, jrope.apply_rotary_half(jnp.asarray(x), jnp.asarray(cos)[None, :, None],
                                       jnp.asarray(sin)[None, :, None]))


def test_convnext_v1_and_v2():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, 32)).astype(np.float32)
    p2 = randomized(jcnx.convnext_v2_init(jax.random.PRNGKey(0), 32, 64), rng)
    close(tcnx.convnext_v2(to_tensors(p2), torch.from_numpy(x), compute_dtype=torch.float32),
          jcnx.convnext_v2(p2, jnp.asarray(x), compute_dtype=jnp.float32))
    p1 = randomized(jcnx.convnext_v1_init(jax.random.PRNGKey(1), 32, 64), rng)
    close(tcnx.convnext_v1(to_tensors(p1), torch.from_numpy(x), compute_dtype=torch.float32),
          jcnx.convnext_v1(p1, jnp.asarray(x), compute_dtype=jnp.float32))


@pytest.mark.parametrize("fused", [False, True])
def test_attention_matches_jax(fused):
    rng = np.random.default_rng(5)
    b, n, dim, heads, dh = 2, 24, 64, 2, 32
    p = randomized(jattn.attention_init(jax.random.PRNGKey(2), dim, heads, dh), rng)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    mask = np.array(jlens_to_mask(jnp.asarray([24, 17]), n))
    cos, sin = trope.rotary_cos_sin_half(dh, n)
    want = jattn.attention(p, jnp.asarray(x), heads, mask=jnp.asarray(mask),
                           rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin),
                           compute_dtype=jnp.float32)
    tp = to_tensors(p)
    if fused:
        tp = tdit._fused_attn(tp, None)
    got = tattn.attention(tp, torch.from_numpy(x), heads, mask=torch.from_numpy(mask),
                          rope_cos=torch.from_numpy(cos), rope_sin=torch.from_numpy(sin),
                          compute_dtype=torch.float32)
    close(got, want)
    assert not got[1, 17:].any()  # masked rows are zero


@pytest.mark.parametrize("nt,conv_layers", [(10, 1), (40, 1), (10, 0)])
def test_text_embed_padding_and_drop(nt, conv_layers):
    cfg = dict(TINY, conv_layers=conv_layers)
    arch_j, arch_t = JDiTConfig(**cfg), DiTConfig(**cfg)
    rng = np.random.default_rng(6)
    params, _ = jdit.init_dit(jax.random.PRNGKey(3), arch_j, 16)
    params_np = randomized(params, rng)
    ids = rng.integers(0, 16, (2, nt)).astype(np.int32)
    ids[0, nt - 3:] = -1  # padded tail
    drop = np.asarray([False, True])
    want = jdit.text_embed_fn(params_np, arch_j, jnp.asarray(ids), 2, 24, jnp.asarray(drop),
                              jnp.float32)
    got = tdit.text_embed_fn(dit_from_jax(params_np, arch_t), arch_t, torch.from_numpy(ids), 2, 24,
                             torch.from_numpy(drop), torch.float32)
    close(got, want)


def test_dit_sample_step_matches_jax():
    arch_j, arch_t, params_np, tparams = tiny_dit()
    rng = np.random.default_rng(7)
    b, n = 2, 24
    x, cond = (rng.standard_normal((b, n, 20)).astype(np.float32) for _ in range(2))
    te = rng.standard_normal((b, n, 32)).astype(np.float32)
    t = np.asarray([0.1, 0.7], np.float32)
    drop = np.asarray([False, True])
    mask = np.asarray(jlens_to_mask(jnp.asarray([24, 19]), n))
    want = jdit.dit_sample_step(params_np, {}, arch_j, x=jnp.asarray(x), cond=jnp.asarray(cond),
                                text_embed=jnp.asarray(te), time=jnp.asarray(t),
                                drop_audio_cond=jnp.asarray(drop), mask=jnp.asarray(mask),
                                compute_dtype=jnp.float32)
    args = dict(x=torch.from_numpy(x), cond=torch.from_numpy(cond), text_embed=torch.from_numpy(te),
                time=torch.from_numpy(t), drop_audio_cond=torch.from_numpy(drop),
                mask=torch.from_numpy(mask), compute_dtype=torch.float32)
    got = tdit.dit_sample_step(tparams, arch_t, **args)
    assert got.dtype == torch.float32
    close(got, want)
    # pre-fused q|k|v weights give the same result as fusing per call
    close(tdit.dit_sample_step(tdit.fuse_qkv(tparams), arch_t, **args), np.asarray(want))
