"""Pipeline helpers, tokenizers and host audio utilities of the port against
the JAX package (equal outputs on the same inputs), plus a tiny end-to-end
`TTSEngine.infer` on the CPU against the JAX engine's wav length."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import InferConfig as JInferConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.infer import audio as jaudio
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.models import vocos as jvocos
from f5e_tts_tpu.utils import text as jtext
from f5e_tts_tpu_torch.config import DiTConfig, InferConfig, MelConfig
from f5e_tts_tpu_torch.infer import audio as taudio
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import vocos as tvocos
from f5e_tts_tpu_torch.utils import text as ttext
from f5e_tts_tpu_torch.utils.convert import dit_from_jax, vocos_from_jax

TEXTS = [
    "Hello world. This is a test, of the chunker! Does it work? Yes; it does: nicely.",
    "短句。还有一个句子，很长很长很长很长很长很长。Mixed English too.",
    "",
    "no punctuation at all " * 12,
]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("max_chars", [10, 40, 135])
def test_chunk_text_matches_jax(text, max_chars):
    assert tpipe.chunk_text(text, max_chars) == jpipe.chunk_text(text, max_chars)


def test_duration_bucket_and_stitch_match_jax():
    for args in ((472, "ref text here. ", "gen", 1.0, None), (472, "ref. ", "a longer gen text", 0.8, None),
                 (300, "", "x" * 50, 1.0, None), (472, "r", "g", 1.0, 15.11)):
        assert tpipe.estimate_duration(*args) == jpipe.estimate_duration(*args)
    for d in (1, 256, 257, 1416, 4096, 9999):
        assert tpipe.pick_bucket(d) == jpipe.pick_bucket(d)
    assert tpipe.DEFAULT_BUCKETS == jpipe.DEFAULT_BUCKETS
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (5000, 300, 4000)]
    for xf in (0.0, 0.15, 0.5):
        np.testing.assert_array_equal(tpipe.cross_fade_stitch(waves, 8000, xf),
                                      jpipe.cross_fade_stitch(waves, 8000, xf))


def test_tokenizers_match_jax(tmp_path):
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("".join(f"{c}\n" for c in " abcdefghijklmnopqrstuvwxyz.,"), "utf-8")
    assert ttext.load_vocab_file(str(vocab_file)) == jtext.load_vocab_file(str(vocab_file))
    assert ttext.get_tokenizer(str(vocab_file), "custom") == jtext.get_tokenizer(str(vocab_file), "custom")
    assert ttext.get_tokenizer("", "byte") == jtext.get_tokenizer("", "byte")
    vocab = ttext.load_vocab_file(str(vocab_file))
    texts = ["hello, world.", "Zebra!", ""]
    np.testing.assert_array_equal(ttext.list_str_to_idx([list(t) for t in texts], vocab),
                                  jtext.list_str_to_idx([list(t) for t in texts], vocab))
    np.testing.assert_array_equal(ttext.list_str_to_bytes(texts + ["中文"]),
                                  jtext.list_str_to_bytes(texts + ["中文"]))
    # the pinyin vocab is a dataset's vocab.txt: absent here, in both packages
    for mod in (jtext, ttext):
        with pytest.raises(FileNotFoundError):
            mod.get_tokenizer("Emilia_ZH_EN", "pinyin", data_dir=str(tmp_path))


def test_audio_utils_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    sr = 8000
    x = np.concatenate([np.zeros(3000), 0.3 * rng.standard_normal(sr), np.zeros(2000)]).astype(np.float32)
    path = str(tmp_path / "a.wav")
    taudio.write_wav(path, x, sr)
    got, got_sr = taudio.read_wav(path)
    want, want_sr = jaudio.read_wav(path)
    np.testing.assert_array_equal(got, want)
    assert got_sr == want_sr == sr
    np.testing.assert_array_equal(taudio.resample(x, sr, 24000), jaudio.resample(x, sr, 24000))
    for target in (0.01, 0.5):
        a, ra = taudio.normalize_rms(x, target)
        b, rb = jaudio.normalize_rms(x, target)
        np.testing.assert_array_equal(a, b)
        assert ra == rb
    np.testing.assert_array_equal(taudio.remove_silence_edges(x, sr), jaudio.remove_silence_edges(x, sr))
    assert taudio.detect_leading_silence(x, sr) == jaudio.detect_leading_silence(x, sr)

    # a long reference is clipped at a silence, and the text gets punctuation
    long = np.concatenate([x] * 5)
    for text in ("some words", "ends with a dot.", "末尾。"):
        tw, tt = tpipe.preprocess_ref_audio_text(long, sr, text, show_info=lambda *_: None)
        jw, jt = jpipe.preprocess_ref_audio_text(long, sr, text, show_info=lambda *_: None)
        np.testing.assert_array_equal(tw, jw)
        assert tt == jt
    with pytest.raises(RuntimeError):
        tpipe.preprocess_ref_audio_text(x, sr, "  ")


def test_tiny_engine_infer_matches_jax_length():
    tiny = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
                conv_layers=1, dropout=0.0)
    mel = dict(n_fft=64, hop_length=16, win_length=64, n_mel_channels=20, target_sample_rate=4000)
    voc = dict(input_channels=20, dim=32, intermediate_dim=64, num_layers=2, n_fft=64, hop_length=16)
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**tiny), 256)
    params = jax.tree.map(np.asarray, params)
    params["proj_out"]["w"] = (0.05 * np.random.default_rng(2).standard_normal(
        params["proj_out"]["w"].shape)).astype(np.float32)
    vparams = jax.tree.map(np.asarray, jvocos.init_vocos(jax.random.PRNGKey(1), jvocos.VocosConfig(**voc)))
    buckets = (128, 256, 512)
    wav = (0.1 * np.random.default_rng(3).standard_normal(6000)).astype(np.float32)
    call = ("hello there.", "good morning to you all, and welcome.")

    jeng = jpipe.TTSEngine(
        params=params, state={}, arch=JDiTConfig(**tiny), vocab=None, mel=JMelConfig(**mel),
        infer_cfg=JInferConfig(nfe_steps=4), tokenizer="byte", compute_dtype=jnp.float32,
        buckets=buckets,
        vocoder_decode=lambda m: np.asarray(jvocos.vocos_decode(vparams, jvocos.VocosConfig(**voc), m)))
    want, want_sr, want_mel = jeng.infer(wav, 6000, *call, seed=1)

    tcfg = tvocos.VocosConfig(**voc)
    tv = vocos_from_jax(vparams, tcfg)
    teng = tpipe.TTSEngine(
        params=dit_from_jax(params, DiTConfig(**tiny)), arch=DiTConfig(**tiny), vocab=None,
        mel=MelConfig(**mel), infer_cfg=InferConfig(nfe_steps=4), compute_dtype=torch.float32,
        buckets=buckets, device="cpu",
        vocoder_decode=lambda m: tvocos.vocos_decode(tv, tcfg, m).numpy())
    got, got_sr, got_mel = teng.infer(wav, 6000, *call, seed=1)
    assert got_sr == want_sr
    assert got.shape == want.shape and got_mel.shape == want_mel.shape
    assert np.isfinite(got).all() and np.sqrt(np.mean(got ** 2)) > 0


def test_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.TTSEngine(params={}, arch=DiTConfig(), vocab=None)
