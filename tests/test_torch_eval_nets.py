"""The port's evaluation nets against the JAX package on the CPU, fp32, seeded
weights (no checkpoint ships with the repo; nothing is downloaded):

- ECAPA: `combine_hidden_states` and `ecapa_embed` over `ecapa_from_torch`
  of the torch twin of tests/test_ecapa.py (BatchNorm statistics seeded)
  against JAX's on the same state dict: atol 2e-5 (and the twin, 2e-4, the
  JAX test's own bound); `init_ecapa` gives the converter's tree;
  `load_wavlm_ecapa` over a tiny WavLM written by
  `save_pretrained` and a tiny ECAPA .pth: the embedding of a written wav
  equals the head over the front end's hidden states within 1e-5.
- UTMOS: `w2v2_from_hf` of a tiny transformers Wav2Vec2Model and
  `w2v2_encode` against the model (2e-4, the JAX test's bound) and JAX's
  (1e-4); `blstm` against JAX's scan and torch.nn.LSTM (1e-5);
  `utmos_from_torch` + `utmos_forward` against JAX's on the twin of
  tests/test_utmos.py (1e-4); `init_utmos` has JAX's shapes;
  `make_native_utmos_scorer` on a written 24 kHz wav against JAX's scorer
  on the same weights (1e-4), and `score_utmos` over it.
- Each entry point (`load_wavlm_ecapa`, `make_native_utmos_scorer`) raises
  without a card unless asked for the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.eval import ecapa as jecapa
from f5e_tts_tpu.eval import utmos as jutmos
from f5e_tts_tpu_torch.eval import ecapa as tecapa
from f5e_tts_tpu_torch.eval import utmos as tutmos
from f5e_tts_tpu_torch.utils.convert import to_tensors
from tests.test_ecapa import CFG as JECAPA_CFG
from tests.test_ecapa import _randomize_bn, _Twin
from tests.test_utmos import TINY as JW2V2
from tests.test_utmos import _hf_model, _TorchUTMOS

ECAPA_CFG = tecapa.ECAPAConfig(**{f: getattr(JECAPA_CFG, f) for f in
                                  JECAPA_CFG.__dataclass_fields__})
W2V2 = tutmos.W2V2Config(**{f: getattr(JW2V2, f) for f in JW2V2.__dataclass_fields__})
UTMOS_KW = dict(domain_dim=8, judge_dim=8, blstm_hidden=16, proj_hidden=24, domain_id=1,
                judge_id=3)
t = torch.from_numpy


def _ecapa_twin(seed=0):
    torch.manual_seed(seed)
    twin = _Twin(JECAPA_CFG).eval()
    with torch.no_grad():
        _randomize_bn(twin, np.random.default_rng(seed))
    return twin


def test_ecapa_embed_and_combine_match_jax():
    twin = _ecapa_twin()
    sd = {k: v.detach().numpy().astype(np.float32) for k, v in twin.state_dict().items()}
    hidden = np.random.default_rng(1).standard_normal(
        (JECAPA_CFG.num_feat_layers, 2, 24, JECAPA_CFG.feat_dim)).astype(np.float32)
    pj = jax.tree.map(jnp.asarray, jecapa.ecapa_from_torch(sd, JECAPA_CFG))
    feats_j = jecapa.combine_hidden_states(pj["feature_weight"], jnp.asarray(hidden))
    want = np.asarray(jecapa.ecapa_embed(pj, JECAPA_CFG, feats_j))
    pt = tecapa.ecapa_from_torch(twin.state_dict(), ECAPA_CFG)
    feats = tecapa.combine_hidden_states(pt["feature_weight"], t(hidden))
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_j), atol=1e-5)
    got = tecapa.ecapa_embed(pt, ECAPA_CFG, feats).numpy()
    assert got.shape == (2, JECAPA_CFG.emb_dim)
    np.testing.assert_allclose(got, want, atol=2e-5)
    with torch.no_grad():
        np.testing.assert_allclose(got, twin(t(hidden)).numpy(), rtol=2e-4, atol=2e-4)
    ours = tecapa.init_ecapa(ECAPA_CFG, torch.Generator().manual_seed(0))
    assert _flat(ours) == _flat(pt)


def test_load_wavlm_ecapa_on_a_tiny_local_wavlm(tmp_path):
    from transformers import WavLMConfig, WavLMModel

    from f5e_tts_tpu_torch.infer.audio import read_wav, resample, write_wav

    torch.manual_seed(0)
    wavlm = WavLMModel(WavLMConfig(
        hidden_size=JECAPA_CFG.feat_dim, num_hidden_layers=JECAPA_CFG.num_feat_layers - 1,
        num_attention_heads=2, intermediate_size=32, conv_dim=(16, 16), conv_stride=(5, 2),
        conv_kernel=(10, 3), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
        num_buckets=8, max_bucket_distance=20, do_stable_layer_norm=False,
        feat_extract_norm="group", apply_spec_augment=False)).eval()
    wavlm.save_pretrained(str(tmp_path / "wavlm"))
    twin = _ecapa_twin(2)
    sd = dict(twin.state_dict())
    sd["feature_extract.model.dummy"] = torch.zeros(3)  # the front end's keys are ignored
    torch.save({"model": sd}, str(tmp_path / "ecapa.pth"))
    wav = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12_000) / 24_000)).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), wav, 24_000)

    embed = tecapa.load_wavlm_ecapa(str(tmp_path / "ecapa.pth"), str(tmp_path / "wavlm"),
                                    ECAPA_CFG, device="cpu")
    got = embed(str(tmp_path / "a.wav"))
    w, sr = read_wav(str(tmp_path / "a.wav"))
    with torch.no_grad():
        hidden = torch.stack(wavlm(t(resample(w, sr, 16_000)[None]),
                                   output_hidden_states=True).hidden_states)
    pt = tecapa.ecapa_from_torch(twin.state_dict(), ECAPA_CFG)
    want = tecapa.ecapa_embed(pt, ECAPA_CFG, tecapa.combine_hidden_states(
        pt["feature_weight"], hidden))[0].numpy()
    assert got.shape == (JECAPA_CFG.emb_dim,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        tecapa.load_wavlm_ecapa(str(tmp_path / "none.pth"), str(tmp_path / "wavlm"),
                                ECAPA_CFG, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tecapa.load_wavlm_ecapa(str(tmp_path / "ecapa.pth"), str(tmp_path / "wavlm"),
                                    ECAPA_CFG)


def test_w2v2_from_hf_and_encode_match_transformers_and_jax():
    model = _hf_model(JW2V2)
    wav = np.random.default_rng(0).standard_normal((2, 2000)).astype(np.float32)
    with torch.no_grad():
        ref = model(input_values=t(wav)).last_hidden_state.numpy()
    got = tutmos.w2v2_encode(tutmos.w2v2_from_hf(model.state_dict(), W2V2), W2V2, t(wav)).numpy()
    want = np.asarray(jax.jit(lambda p, w: jutmos.w2v2_encode(p, JW2V2, w))(
        jutmos.w2v2_from_hf(model.state_dict(), JW2V2), jnp.asarray(wav)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 2e-4
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_blstm_matches_jax_and_torch_lstm():
    torch.manual_seed(1)
    m = torch.nn.LSTM(12, 8, batch_first=True, bidirectional=True).eval()
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    p = {"w_ih": sd["weight_ih_l0"], "w_hh": sd["weight_hh_l0"], "b_ih": sd["bias_ih_l0"],
         "b_hh": sd["bias_hh_l0"], "w_ih_r": sd["weight_ih_l0_reverse"],
         "w_hh_r": sd["weight_hh_l0_reverse"], "b_ih_r": sd["bias_ih_l0_reverse"],
         "b_hh_r": sd["bias_hh_l0_reverse"]}
    x = np.random.default_rng(2).standard_normal((3, 17, 12)).astype(np.float32)
    got = tutmos.blstm(to_tensors(p), t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jutmos.blstm(jax.tree.map(jnp.asarray, p),
                                                            jnp.asarray(x))), atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(got, m(t(x))[0].numpy(), atol=1e-5)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


def test_utmos_forward_matches_jax_and_init_shapes():
    cfg_j = jutmos.UTMOSConfig(ssl=JW2V2, **UTMOS_KW)
    cfg_t = tutmos.UTMOSConfig(ssl=W2V2, **UTMOS_KW)
    torch.manual_seed(3)
    twin = _TorchUTMOS(_hf_model(JW2V2, seed=3), cfg_j).eval()
    wav = np.random.default_rng(4).standard_normal((2, 3200)).astype(np.float32)
    got = tutmos.utmos_forward(tutmos.utmos_from_torch(twin.state_dict(), cfg_t), cfg_t,
                               t(wav)).numpy()
    want = np.asarray(jax.jit(lambda p, w: jutmos.utmos_forward(p, cfg_j, w))(
        jutmos.utmos_from_torch(twin.state_dict(), cfg_j), jnp.asarray(wav)))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(got, twin(t(wav)).numpy(), atol=2e-4)
    with pytest.raises(KeyError):
        tutmos.utmos_from_torch({"wav2vec2.x": torch.zeros(1)}, cfg_t)
    ours = tutmos.init_utmos(cfg_t, torch.Generator().manual_seed(0), num_domains=3,
                             num_judges=10)
    assert _flat(ours) == _flat(jax.eval_shape(  # JAX's init, traced, not run
        lambda k: jutmos.init_utmos(k, cfg_j, num_domains=3, num_judges=10),
        jax.random.PRNGKey(0)))


def test_native_utmos_scorer_matches_jax_on_a_written_wav(tmp_path):
    from f5e_tts_tpu_torch.eval.scorers import score_utmos
    from f5e_tts_tpu_torch.infer.audio import write_wav

    cfg_j = jutmos.UTMOSConfig(ssl=JW2V2, **{**UTMOS_KW, "judge_id": 1, "domain_id": 0})
    cfg_t = tutmos.UTMOSConfig(ssl=W2V2, **{**UTMOS_KW, "judge_id": 1, "domain_id": 0})
    params = jax.tree.map(lambda x: x.numpy(), tutmos.init_utmos(
        cfg_t, torch.Generator().manual_seed(1), num_domains=2, num_judges=4))
    sr = 24_000
    wav = (0.2 * np.sin(2 * np.pi * 220 * np.arange(sr // 4) / sr)).astype(np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, wav, sr)
    scorer = tutmos.make_native_utmos_scorer(to_tensors(params), cfg_t, device="cpu")
    got = scorer(path)
    np.testing.assert_allclose(got, jutmos.make_native_utmos_scorer(
        jax.tree.map(jnp.asarray, params), cfg_j)(path), atol=1e-4)
    res = score_utmos([path], scorer, results_path=str(tmp_path / "res.jsonl"))
    assert res["n"] == 1 and res["utmos"] == got
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tutmos.make_native_utmos_scorer(to_tensors(params), cfg_t)
