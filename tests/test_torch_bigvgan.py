"""The port's transposed conv and BigVGAN generator against the JAX package on
the CPU, seeded weights (the repo has no checkpoint), fp32.

- `conv_transpose1d` (the JAX layout: pre-flipped (k, in, out)) against
  JAX's zero-stuff + tap conv over strides 1-4 and paddings 0-3: shape
  exactly, values atol 1e-5; `conv_transpose1d_init` has torch's
  ConvTranspose1d bound 1/sqrt(out * k).
- `snake_beta` atol 1e-6, `kaiser_sinc_filter` exactly (a numpy copy),
  `aa_activation` atol 1e-5 against JAX's.
- `bigvgan_decode` of a narrow generator (16 channels, rates (4, 2), two
  AMP kernels) on the port's seeded init, whose tree is JAX's init's, with
  seeded snake parameters: relative L2
  under 1e-5 in fp32, and in bf16 against the fp32 decode within 2e-2.
- `bigvgan_from_torch` on a weight-normed torch-layout state dict written
  from those weights (weight_g / weight_v, transposed kernels in torch's
  (in, out, k) order): the same tree as JAX's converter, and so the same
  decode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.models import bigvgan as jbig
from f5e_tts_tpu.ops import nn as jnn
from f5e_tts_tpu_torch.models import bigvgan as tbig
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.utils.convert import to_tensors

t = torch.from_numpy
NARROW = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=16, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 3, 5)))


@pytest.mark.parametrize("stride,padding,k", [(1, 0, 3), (2, 1, 4), (4, 2, 8), (3, 0, 6),
                                              (4, 3, 8)])
def test_conv_transpose1d_matches_jax(stride, padding, k):
    rng = np.random.default_rng(stride * 10 + padding)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    p = {"w": rng.standard_normal((k, 6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    want = np.asarray(jnn.conv_transpose1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                           stride=stride, padding=padding))
    got = tnn.conv_transpose1d(to_tensors(p), t(x), stride=stride, padding=padding).numpy()
    assert got.shape == want.shape == (2, (9 - 1) * stride - 2 * padding + k, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    init = tnn.conv_transpose1d_init(6, 5, k, torch.Generator().manual_seed(0))
    assert init["w"].shape == (k, 6, 5) and init["b"].shape == (5,)
    assert init["w"].abs().max() <= 1 / np.sqrt(5 * k)


def test_snake_kaiser_and_aa_activation_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 4)).astype(np.float32)
    la, lb = (0.3 * rng.standard_normal(4)).astype(np.float32), \
        (0.3 * rng.standard_normal(4)).astype(np.float32)
    np.testing.assert_allclose(tbig.snake_beta(t(x), t(la), t(lb)).numpy(),
                               np.asarray(jbig.snake_beta(jnp.asarray(x), la, lb)), atol=1e-6)
    for args in ((0.25, 0.3, 12), (0.2, 0.25, 11), (0.4, 0.05, 6)):
        np.testing.assert_array_equal(tbig.kaiser_sinc_filter(*args),
                                      jbig.kaiser_sinc_filter(*args))
    f = jbig.kaiser_sinc_filter(0.25, 0.3, 12)
    got = tbig.aa_activation(t(x), t(la), t(lb), f, f).numpy()
    want = np.asarray(jbig.aa_activation(jnp.asarray(x), la, lb, f, f))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def narrow():
    """The configs, seeded fp32 weights (the port's init, as numpy), a mel,
    and the shapes of JAX's init (traced, not run)."""
    cfg_j, cfg_t = jbig.BigVGANConfig(**NARROW), tbig.BigVGANConfig(**NARROW)
    params = jax.tree.map(lambda x: x.numpy(),
                          tbig.init_bigvgan(cfg_t, torch.Generator().manual_seed(0)))
    shapes_j = jax.eval_shape(lambda k: jbig.init_bigvgan(k, cfg_j), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    # snake alpha and beta off their log-0 init, so they shape the output
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if "log_" in jax.tree_util.keystr(path) else np.asarray(a, np.float32), params)
    mel = (rng.standard_normal((2, 13, 8)) - 2.0).astype(np.float32)
    return cfg_j, cfg_t, params, mel, shapes_j


def _flat(tree, path=""):
    """{path: numpy leaf} of a nested dict/list tree (JAX's tree maps sort
    dict keys, so trees are compared by path, not by leaf order)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _shapes(x, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bigvgan_decode_matches_jax(narrow):
    cfg_j, cfg_t, params, mel, shapes_j = narrow
    want = np.asarray(jbig.bigvgan_decode(jax.tree.map(jnp.asarray, params), cfg_j,
                                          jnp.asarray(mel)))
    got = tbig.bigvgan_decode(to_tensors(params), cfg_t, t(mel)).numpy()
    assert got.shape == want.shape == (2, 13 * 4 * 2) and got.dtype == np.float32
    assert np.abs(got).max() <= 1.0
    assert _rel(got, want) < 1e-5
    bf16 = tbig.bigvgan_decode(to_tensors(params), cfg_t, t(mel), compute_dtype=torch.bfloat16)
    assert _rel(bf16.numpy(), got) < 2e-2
    assert _shapes(params) == _shapes(shapes_j)  # the port's init has JAX's tree


def _torch_layout(params, cfg, rng):
    """A published-layout state dict of `params`: every conv weight-normed
    (weight_g, weight_v with v = w / g-scale noise), transposed kernels
    unflipped in torch's (in, out, k) order, snake parameters as act.alpha/beta."""
    sd = {}

    def normed(key, w):
        v = w * (0.5 + rng.random((w.shape[0], 1, 1))).astype(np.float32)
        sd[f"{key}.weight_v"] = v
        sd[f"{key}.weight_g"] = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))

    def conv(key, p):
        normed(key, np.ascontiguousarray(np.asarray(p["w"]).transpose(2, 1, 0)))
        if "b" in p:
            sd[f"{key}.bias"] = np.asarray(p["b"])

    def act(key, a):
        sd[f"{key}.act.alpha"], sd[f"{key}.act.beta"] = a["log_alpha"], a["log_beta"]

    conv("conv_pre", params["conv_pre"])
    for i, up in enumerate(params["ups"]):
        normed(f"ups.{i}.0", np.ascontiguousarray(np.asarray(up["w"])[::-1].transpose(1, 2, 0)))
        sd[f"ups.{i}.0.bias"] = up["b"]
    n_blocks = len(cfg.resblock_kernel_sizes)
    for i, stage in enumerate(params["resblocks"]):
        for b, block in enumerate(stage):
            rb = f"resblocks.{i * n_blocks + b}"
            for j in range(len(block["convs1"])):
                conv(f"{rb}.convs1.{j}", block["convs1"][j])
                conv(f"{rb}.convs2.{j}", block["convs2"][j])
                act(f"{rb}.activations.{2 * j}", block["acts1"][j])
                act(f"{rb}.activations.{2 * j + 1}", block["acts2"][j])
    act("activation_post", params["act_post"])
    conv("conv_post", params["conv_post"])
    return sd


def test_bigvgan_from_torch_matches_jax(narrow):
    cfg_j, cfg_t, params, mel, _ = narrow
    sd = _torch_layout(params, cfg_j, np.random.default_rng(2))
    want = jbig.bigvgan_from_torch(sd, cfg_j)
    got = tbig.bigvgan_from_torch({k: t(np.array(v)) for k, v in sd.items()}, cfg_t)
    flat_g, flat_w, flat_p = _flat(got), _flat(want), _flat(params)
    assert sorted(flat_g) == sorted(flat_w) == sorted(flat_p)
    for k, g in flat_g.items():
        np.testing.assert_allclose(g, flat_w[k], rtol=1e-6, atol=1e-7, err_msg=k)
        # the weight norm folds back to the original weights
        np.testing.assert_allclose(g, flat_p[k], rtol=1e-5, atol=1e-6, err_msg=k)
    decoded = tbig.bigvgan_decode(got, cfg_t, t(mel)).numpy()
    assert _rel(decoded, tbig.bigvgan_decode(to_tensors(params), cfg_t, t(mel)).numpy()) < 1e-5
