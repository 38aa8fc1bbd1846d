"""The PPG front end of the F5E model in the port against the JAX package on
the CPU: kaldi fbank, the non-streaming Conformer encoder and the PPG
extractor, at a small Conformer (2 blocks, 32 wide, 2 heads, 64 linear
units, conv kernel 7, 20 or 80 fbank bins), fp32, seeded weights.

- `kaldi_fbank` against the JAX function: log-mel atol 1e-3 (the FFTs of
  torch and XLA round differently; 1e-3 in the log is 0.1 % of the power),
  and against its numpy twin at the JAX test's rtol 1e-3 + atol 2e-3; the
  two packages' numpy twins, windows and mel banks are equal.
- `conformer_encode` with padding masks, for each subsampling: the valid
  frames atol 1e-4, the output lengths exactly.
- `PPGExtractor.audio_to_ppg` in `ppg` and `map` modes: PPG atol 1e-4,
  lengths exactly.
- `conformer_from_torch` from a wenet-layout state dict written here, and
  `load_cmvn_file` on JSON and kaldi-text files: equal to the JAX loaders'
  results exactly.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.models import conformer as jconf
from f5e_tts_tpu.ops import kaldi as jkaldi
from f5e_tts_tpu_torch.models import conformer as tconf
from f5e_tts_tpu_torch.ops import kaldi as tkaldi

SMALL = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
             cnn_module_kernel=7)


def t(a):
    return torch.from_numpy(np.array(a))


def _speechy(n, seed):
    rng = np.random.default_rng(seed)
    x = np.arange(n) / 16_000
    return (0.2 * np.sin(2 * np.pi * (150 + 40 * seed) * x) * (1 + np.sin(2 * np.pi * 3 * x))
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _params(cfg_j, seed=0):
    """The JAX init's tree as numpy, with a non-trivial CMVN and BatchNorm."""
    params = jax.tree.map(np.asarray, jconf.init_conformer(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed)
    params["cmvn_mean"] = (rng.standard_normal(cfg_j.input_dim) * 2).astype(np.float32)
    params["cmvn_istd"] = (0.2 + rng.random(cfg_j.input_dim) * 0.1).astype(np.float32)
    for layer in params["layers"]:
        bn = layer["conv"]["bn"]
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.3 * rng.random(bn["var"].shape)).astype(np.float32)
    return params


def _tree_equal(got, want, atol=0.0):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_equal(got[k], want[k], atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w, atol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# kaldi fbank
# ---------------------------------------------------------------------------


def test_kaldi_fbank_matches_jax_and_its_numpy_twin():
    wav = np.stack([_speechy(16_000, 1), _speechy(16_000, 2)])
    want = np.asarray(jkaldi.kaldi_fbank(jnp.asarray(wav)))
    got = tkaldi.kaldi_fbank(t(wav)).numpy()
    assert got.shape == want.shape == (2, 1 + (16_000 - 400) // 160, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    twin = tkaldi.kaldi_fbank_numpy(wav[0])
    np.testing.assert_array_equal(twin, jkaldi.kaldi_fbank_numpy(wav[0]))
    np.testing.assert_allclose(got[0], twin, rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(tkaldi.povey_window(400), jkaldi.povey_window(400))
    np.testing.assert_array_equal(tkaldi.kaldi_mel_banks(80, 512, 16_000.0),
                                  jkaldi.kaldi_mel_banks(80, 512, 16_000.0))
    # a 1-D waveform is one batch row
    np.testing.assert_array_equal(tkaldi.kaldi_fbank(t(wav[0])).numpy(), got[:1])


# ---------------------------------------------------------------------------
# encoder and extractor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("subsampling", ["conv2d", "conv2d4", "linear"])
def test_conformer_encode_with_padding_matches_jax(subsampling):
    cfg_j = jconf.ConformerConfig(input_dim=20, subsampling=subsampling, **SMALL)
    cfg_t = tconf.ConformerConfig(input_dim=20, subsampling=subsampling, **SMALL)
    params = _params(cfg_j, 1)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 61, 20)).astype(np.float32)
    lens = np.asarray([61, 44, 20], np.int32)
    want, want_lens = jconf.conformer_encode(jax.tree.map(jnp.asarray, params), cfg_j,
                                             jnp.asarray(feats), jnp.asarray(lens))
    got, got_lens = tconf.conformer_encode(tconf.conformer_from_jax(params), cfg_t, t(feats),
                                           t(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    valid = (np.arange(got.shape[1])[None, :] < np.asarray(want_lens)[:, None])[:, :, None]
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0), np.where(valid, want, 0),
                               rtol=0, atol=1e-4)
    assert tconf.subsampled_time(subsampling, 61) == got.shape[1]


@pytest.mark.parametrize("output_type", ["ppg", "map"])
def test_ppg_extractor_matches_jax(output_type):
    cfg_j = jconf.ConformerConfig(input_dim=80, **SMALL)
    cfg_t = tconf.ConformerConfig(input_dim=80, **SMALL)
    params = _params(cfg_j, 3)
    rng = np.random.default_rng(4)
    extra = {}
    if output_type == "map":
        extra = dict(output_type="map", map_mix_ratio=0.7,
                     phn_center=rng.standard_normal((9, 32)).astype(np.float32),
                     ce_w=rng.standard_normal((9, 32)).astype(np.float32),
                     ce_b=rng.standard_normal(9).astype(np.float32))
    wav = np.zeros((2, 16_000), np.float32)
    wav[0] = _speechy(16_000, 3)
    wav[1, :11_000] = _speechy(11_000, 4)
    lens = np.asarray([16_000, 11_000], np.int32)
    ext_j = jconf.PPGExtractor(params=jax.tree.map(jnp.asarray, params), cfg=cfg_j, **extra)
    want, want_lens = ext_j.audio_to_ppg(jnp.asarray(wav), jnp.asarray(lens))
    ext_t = tconf.PPGExtractor(params=tconf.conformer_from_jax(params), cfg=cfg_t, device="cpu",
                               **extra)
    got, got_lens = ext_t.audio_to_ppg(wav, lens)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert got.shape[-1] == 32 and not got[1, int(got_lens[1]):].any()
    # without lengths every row is full: 98 fbank frames // 2 = 49, clamped to the 48 frames
    full, full_lens = ext_t.audio_to_ppg(t(wav))
    assert full_lens.tolist() == [full.shape[1]] * 2 == [48, 48]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tconf.PPGExtractor(params=tconf.conformer_from_jax(params), cfg=cfg_t)


# ---------------------------------------------------------------------------
# weights: wenet checkpoints and CMVN files
# ---------------------------------------------------------------------------


def _to_wenet(params, cfg) -> dict:
    """A wenet ASR checkpoint's keys and layouts from a conformer tree (the
    inverse of conformer_from_torch)."""
    sd = {}

    def lin(k, p):
        sd[f"{k}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
        if "b" in p:
            sd[f"{k}.bias"] = np.asarray(p["b"])

    def ln(k, p):
        sd[f"{k}.weight"], sd[f"{k}.bias"] = np.asarray(p["g"]), np.asarray(p["b"])

    for i, conv in enumerate(params["embed_convs"]):
        sd[f"encoder.embed.conv.{2 * i}.weight"] = np.ascontiguousarray(
            np.asarray(conv["w"]).transpose(3, 2, 0, 1))
        sd[f"encoder.embed.conv.{2 * i}.bias"] = np.asarray(conv["b"])
    lin("encoder.embed.out.0", params["embed_out"])
    sd["encoder.global_cmvn.mean"] = params["cmvn_mean"]
    sd["encoder.global_cmvn.istd"] = params["cmvn_istd"]
    for i, layer in enumerate(params["layers"]):
        k = f"encoder.encoders.{i}"
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff", "norm_final"):
            ln(f"{k}.{name}", layer[name])
        for src, dst in (("ff_macaron", "feed_forward_macaron"), ("ff", "feed_forward")):
            lin(f"{k}.{dst}.w_1", layer[src]["w1"])
            lin(f"{k}.{dst}.w_2", layer[src]["w2"])
        for name in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            lin(f"{k}.self_attn.{name}", layer["attn"][name])
        sd[f"{k}.self_attn.pos_bias_u"] = layer["attn"]["pos_bias_u"]
        sd[f"{k}.self_attn.pos_bias_v"] = layer["attn"]["pos_bias_v"]
        cm, conv = f"{k}.conv_module", layer["conv"]
        sd[f"{cm}.pointwise_conv1.weight"] = np.asarray(conv["pw1"]["w"]).T[:, :, None]
        sd[f"{cm}.pointwise_conv1.bias"] = conv["pw1"]["b"]
        sd[f"{cm}.depthwise_conv.weight"] = np.asarray(conv["dw"]["w"]).transpose(2, 1, 0)
        sd[f"{cm}.depthwise_conv.bias"] = conv["dw"]["b"]
        sd[f"{cm}.pointwise_conv2.weight"] = np.asarray(conv["pw2"]["w"]).T[:, :, None]
        sd[f"{cm}.pointwise_conv2.bias"] = conv["pw2"]["b"]
        for src, dst in (("g", "weight"), ("b", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            sd[f"{cm}.norm.{dst}"] = conv["bn"][src]
    ln("encoder.after_norm", params["after_norm"])
    lin("linear", params["content_linear"])
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in sd.items()}


def test_conformer_from_torch_and_cmvn_files_match_jax(tmp_path):
    cfg_j = jconf.ConformerConfig(input_dim=20, **SMALL)
    cfg_t = tconf.ConformerConfig(input_dim=20, **SMALL)
    params = _params(cfg_j, 5)
    sd = _to_wenet(params, cfg_j)
    want = jconf.conformer_from_torch(sd, cfg_j)
    got = tconf.conformer_from_torch({k: t(v) for k, v in sd.items()}, cfg_t)
    _tree_equal(jax.tree.map(lambda x: x.numpy(), got, is_leaf=torch.is_tensor), want)
    _tree_equal(jax.tree.map(lambda x: x.numpy(), got, is_leaf=torch.is_tensor), params)

    rng = np.random.default_rng(6)
    mean_stat = rng.standard_normal(20) * 50
    var_stat = rng.random(20) * 1000 + mean_stat ** 2 / 10 + 10
    path = tmp_path / "global_cmvn.json"
    path.write_text(json.dumps({"mean_stat": mean_stat.tolist(), "var_stat": var_stat.tolist(),
                                "frame_num": 10}))
    kaldi = tmp_path / "global_cmvn"
    kaldi.write_text(" [\n " + " ".join(f"{v:.6f}" for v in mean_stat) + " 10\n "
                     + " ".join(f"{v:.6f}" for v in var_stat) + " 0 ]\n")
    for file in (path, kaldi):
        m_t, s_t = tconf.load_cmvn_file(str(file))
        m_j, s_j = jconf.load_cmvn_file(str(file))
        np.testing.assert_array_equal(m_t, m_j)
        np.testing.assert_array_equal(s_t, s_j)
    cmvn = tconf.load_cmvn_file(str(kaldi))
    with_cmvn = tconf.conformer_from_torch(sd, cfg_t, cmvn)
    np.testing.assert_array_equal(with_cmvn["cmvn_istd"].numpy(), cmvn[1])
    with pytest.raises(KeyError, match="conv stack"):
        tconf.conformer_from_torch(sd, tconf.ConformerConfig(input_dim=20, subsampling="conv2d4",
                                                             **SMALL))
    with pytest.raises(ValueError, match="unsupported"):
        tconf.subsampling_spec("conv2d3")
