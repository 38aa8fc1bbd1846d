"""Mel frontend and Vocos parity: the port against the JAX package on the
same seeded waveforms and weights, fp32 on the CPU, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.models import vocos as jvocos
from f5e_tts_tpu.ops import mel as jmel
from f5e_tts_tpu_torch.config import MelConfig
from f5e_tts_tpu_torch.models import vocos as tvocos
from f5e_tts_tpu_torch.ops import mel as tmel
from f5e_tts_tpu_torch.utils.convert import to_tensors, vocos_from_jax

F32 = dict(rtol=1e-4, atol=1e-4)


def test_filterbanks_and_window_match_jax():
    for scale, norm in (("htk", None), ("slaney", "slaney")):
        np.testing.assert_array_equal(tmel.mel_filterbank(24000, 1024, 100, scale=scale, norm=norm),
                                      jmel.mel_filterbank(24000, 1024, 100, scale=scale, norm=norm))
    np.testing.assert_array_equal(tmel.hann_window(1024), jmel.hann_window(1024))


@pytest.mark.parametrize("flavour", ["vocos", "bigvgan"])
def test_mel_spectrogram_matches_jax(flavour):
    wav = (0.3 * np.random.default_rng(0).standard_normal((2, 6000))).astype(np.float32)
    want = jmel.mel_spectrogram(jnp.asarray(wav), JMelConfig(mel_spec_type=flavour))
    got = tmel.mel_spectrogram(torch.from_numpy(wav), MelConfig(mel_spec_type=flavour))
    assert got.shape == want.shape
    assert got.shape[1] == tmel.num_frames(6000, MelConfig(mel_spec_type=flavour))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_stft_istft_match_jax():
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((1, 2048)).astype(np.float32)
    np.testing.assert_allclose(tmel.stft_magnitude(torch.from_numpy(wav), 256, 64, 256).numpy(),
                               np.asarray(jmel.stft_magnitude(jnp.asarray(wav), 256, 64, 256)),
                               rtol=1e-4, atol=2e-4)
    re, im = (rng.standard_normal((2, 17, 33)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tmel.istft(torch.from_numpy(re), torch.from_numpy(im), 64, 16, 64).numpy(),
        np.asarray(jmel.istft(jnp.asarray(re), jnp.asarray(im), 64, 16, 64)), **F32)


def test_vocos_decode_matches_jax_and_torch_layout_loader():
    cfg_j = jvocos.VocosConfig(input_channels=20, dim=32, intermediate_dim=64, num_layers=2,
                               n_fft=64, hop_length=16)
    cfg_t = tvocos.VocosConfig(input_channels=20, dim=32, intermediate_dim=64, num_layers=2,
                               n_fft=64, hop_length=16)
    params = jax.tree.map(np.asarray, jvocos.init_vocos(jax.random.PRNGKey(0), cfg_j))
    mel = np.random.default_rng(2).standard_normal((1, 30, 20)).astype(np.float32)
    want = np.asarray(jvocos.vocos_decode(params, cfg_j, jnp.asarray(mel)))
    got = tvocos.vocos_decode(vocos_from_jax(params, cfg_t), cfg_t, torch.from_numpy(mel))
    assert got.shape == want.shape == (1, (30 - 1) * 16)
    np.testing.assert_allclose(got.numpy(), want, **F32)

    # a vocos pip-package state dict (torch layouts) loads to the same weights
    sd = {"backbone.embed.weight": params["embed"]["w"].transpose(2, 1, 0),
          "backbone.embed.bias": params["embed"]["b"],
          "backbone.norm.weight": params["norm"]["g"], "backbone.norm.bias": params["norm"]["b"],
          "backbone.final_layer_norm.weight": params["final_norm"]["g"],
          "backbone.final_layer_norm.bias": params["final_norm"]["b"],
          "head.out.weight": params["head"]["w"].T, "head.out.bias": params["head"]["b"]}
    for i, blk in enumerate(params["blocks"]):
        k = f"backbone.convnext.{i}"
        sd[f"{k}.dwconv.weight"] = blk["dwconv"]["w"].transpose(2, 1, 0)
        sd[f"{k}.dwconv.bias"] = blk["dwconv"]["b"]
        sd[f"{k}.norm.weight"], sd[f"{k}.norm.bias"] = blk["norm"]["g"], blk["norm"]["b"]
        for name in ("pwconv1", "pwconv2"):
            sd[f"{k}.{name}.weight"], sd[f"{k}.{name}.bias"] = blk[name]["w"].T, blk[name]["b"]
        sd[f"{k}.gamma"] = blk["gamma"]
    loaded = tvocos.vocos_from_torch({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, cfg_t)
    np.testing.assert_array_equal(tvocos.vocos_decode(loaded, cfg_t, torch.from_numpy(mel)).numpy(),
                                  got.numpy())
    assert torch.equal(to_tensors(params)["head"]["w"], loaded["head"]["w"])
