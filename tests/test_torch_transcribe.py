"""Whisper transcription in the port (`infer/transcribe.py`, `F5TTS(asr_model=)`,
`F5TTS.transcribe`, the CLI's `--asr_model`) against the JAX module's
behaviour, on the CPU, through a stand-in pipeline as tests/test_transcribe.py
does: no Whisper weights are in the repository and none are downloaded.

- The unconfigured and missing-weights errors are the JAX module's.
- `transcribe` hands the stand-in the same audio and keyword arguments as
  `f5e_tts_tpu.infer.transcribe.transcribe` does, and strips the text.
- `make_cached_transcriber`: one pipeline call per distinct audio (md5).
- `F5TTS(asr_model=)`: an empty ref_text is transcribed once and cached,
  then synthesized; a `transcribe=` callable takes precedence; the CLI's
  `--asr_model` transcribes a voice's empty ref_text.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from f5e_tts_tpu.infer import transcribe as jtr
from f5e_tts_tpu_torch import api as tapi
from f5e_tts_tpu_torch.infer import cli as tcli
from f5e_tts_tpu_torch.infer import transcribe as ttr
from tests.test_torch_infer_paths import TINY_F5, ref_file


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.delenv("F5E_ASR_MODEL", raising=False)
    monkeypatch.setattr(ttr, "_asr_pipe", None)
    monkeypatch.setattr(ttr, "_asr_key", None)
    monkeypatch.setattr(jtr, "_asr_pipe", None)
    monkeypatch.setattr(jtr, "_asr_dir", None)


class _FakePipe:
    def __init__(self):
        self.calls = []

    def __call__(self, audio, **kwargs):
        self.calls.append((audio, kwargs))
        return {"text": "  stub transcription "}


def _install(monkeypatch, tmp_path, module=ttr):
    """A stand-in for the transformers pipeline; returns it and a model dir."""
    fake = _FakePipe()
    model_dir = tmp_path / "whisper"
    model_dir.mkdir(exist_ok=True)
    devices = []

    def fake_init(model_dir_arg=None, device=-1):
        devices.append(device)
        module._asr_pipe = fake
        return fake

    monkeypatch.setattr(module, "initialize_asr_pipeline", fake_init)
    fake.devices = devices
    return fake, str(model_dir)


def test_unconfigured_and_missing_weights_raise_as_in_jax(tmp_path, monkeypatch):
    for mod in (ttr, jtr):
        with pytest.raises(RuntimeError, match="F5E_ASR_MODEL"):
            mod.initialize_asr_pipeline()
        assert mod.make_cached_transcriber() is None
    monkeypatch.setenv("F5E_ASR_MODEL", str(tmp_path / "nope"))
    for mod in (ttr, jtr):
        with pytest.raises(FileNotFoundError, match="ASR weights not found"):
            mod.initialize_asr_pipeline()
    assert ttr.asr_model_dir() == jtr.asr_model_dir() == str(tmp_path / "nope")
    assert ttr.asr_model_dir("x") == jtr.asr_model_dir("x") == "x"


@pytest.mark.parametrize("language", [None, "en"])
def test_transcribe_calls_the_pipeline_as_jax_does(monkeypatch, tmp_path, language):
    fake_t, model_dir = _install(monkeypatch, tmp_path, ttr)
    fake_j, _ = _install(monkeypatch, tmp_path, jtr)
    audio = {"array": np.linspace(-1, 1, 1600, dtype=np.float32), "sampling_rate": 16000}
    got = ttr.transcribe(audio, language=language, model_dir=model_dir, device="cpu")
    want = jtr.transcribe(audio, language=language, model_dir=model_dir)
    assert got == want == "stub transcription"
    (a_t, kw_t), (a_j, kw_j) = fake_t.calls[0], fake_j.calls[0]
    assert a_t is a_j and kw_t == kw_j
    assert kw_t["generate_kwargs"] == ({"task": "transcribe"} if language is None else
                                       {"task": "transcribe", "language": language})
    assert fake_t.devices == ["cpu"]


def test_cached_transcriber_md5_cache(monkeypatch, tmp_path):
    fake, model_dir = _install(monkeypatch, tmp_path)
    monkeypatch.setenv("F5E_ASR_MODEL", model_dir)
    tr = ttr.make_cached_transcriber(device="cpu")
    wav = np.zeros(1600, np.float32)
    assert tr(wav, 16000) == tr(wav.copy(), 16000) == "stub transcription"
    assert len(fake.calls) == 1
    audio = fake.calls[0][0]
    assert audio["sampling_rate"] == 16000 and audio["array"].dtype == np.float32
    tr(np.ones(1600, np.float32), 16000)  # other audio: a new call
    assert len(fake.calls) == 2


def _tiny_tts(**kw):
    tts = tapi.F5TTS(model_cfg=TINY_F5, compute_dtype=torch.float32, device="cpu", **kw)
    tts.engine.buckets = (256,)
    return tts


def test_api_asr_model_transcribes_an_empty_ref_text_once(monkeypatch, tmp_path):
    fake, model_dir = _install(monkeypatch, tmp_path)
    tts = _tiny_tts(asr_model=model_dir)
    path = ref_file(tmp_path)
    for seed in (1, 2):  # the second request hits the md5 cache
        wav, sr, _ = tts.infer(path, "", "well hello.", nfe_step=2, seed=seed)
        assert sr == 24000 and np.isfinite(wav).all() and len(wav) > 0
    assert len(fake.calls) == 1 and fake.devices == [torch.device("cpu")]
    assert tts.transcribe(path) == "stub transcription"  # through the same pipeline
    assert fake.calls[1][0] == path
    assert tts.transcribe(path, language="de", asr_model_path=model_dir) == "stub transcription"
    assert fake.calls[2][1]["generate_kwargs"]["language"] == "de"


def test_api_transcribe_callable_takes_precedence(monkeypatch, tmp_path):
    fake, model_dir = _install(monkeypatch, tmp_path)
    seen = []
    tts = _tiny_tts(asr_model=model_dir,
                    transcribe=lambda wav, sr: seen.append(sr) or "from the callable")
    tts.infer(ref_file(tmp_path), "", "hi.", nfe_step=2, seed=1)
    assert seen == [24000] and not fake.calls


def test_api_without_asr_raises_on_an_empty_ref_text(tmp_path):
    with pytest.raises(RuntimeError):
        _tiny_tts().infer(ref_file(tmp_path), "", "hi.", nfe_step=2, seed=1)


def test_cli_asr_model_transcribes_a_voice(monkeypatch, tmp_path):
    fake, model_dir = _install(monkeypatch, tmp_path)
    monkeypatch.setattr(tapi, "F5TTS", functools.partial(tapi.F5TTS, model_cfg=TINY_F5,
                                                         compute_dtype=torch.float32))
    out = tcli.main(["-r", ref_file(tmp_path), "-s", "", "-t", "hi.", "--asr_model", model_dir,
                     "-o", str(tmp_path / "out"), "--nfe_step", "2", "--device", "cpu"])
    assert out.endswith(".wav") and len(fake.calls) == 1
