"""The rest of the JAX package's tool surface in the port, against the JAX
modules on the CPU: `utils/seed.py`, `utils/profiling.py`, `scripts.py`,
`data/prepare.py`, `native.py` and `infer/voice_chat.py`.

- seed: `seed_everything` leaves Python's, numpy's and torch's generators
  where the JAX package's leaves them (the same next draws, exactly).
- profiling: `dit_flops` and `count_params` equal the JAX package's (exact
  integers and floats); `report_model_stats` of a tiny DiT equals the JAX
  one; `trace` writes a Chrome trace holding an `annotate` range;
  `start_server` raises, naming `trace`.
- scripts: `count_max_epoch` prints the JAX CLI's JSON; `count_params` and
  `edit` run with --device cpu (`edit` on a tiny stand-in model, its wav the
  one `edit_speech` gives on the same engine, bit for bit).
- prepare: the csv corpus through both packages with the char tokenizer
  gives the same Arrow rows, duration.json and vocab.txt, and with the
  pinyin tokenizer the same vocab.txt (without pypinyin both take the
  characters).
- native: every name against the JAX module's Python fallbacks (its C++
  library not loaded), exactly.
- voice chat: `VoiceChat` over a tiny port engine with a stand-in LLM and
  transcriber, as tests/test_voice_chat.py drives the JAX one.
"""

import json
import os
import random
import sys

import jax
import numpy as np
import pytest
import torch

from f5e_tts_tpu import native as jnative
from f5e_tts_tpu import scripts as jscripts
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.data import prepare as jprep
from f5e_tts_tpu.models import backbone as jbb
from f5e_tts_tpu.utils import profiling as jprof
from f5e_tts_tpu.utils import seed as jseed
from f5e_tts_tpu_torch import native as tnative
from f5e_tts_tpu_torch import scripts as tscripts
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, InferConfig, MelConfig, preset
from f5e_tts_tpu_torch.data import prepare as tprep
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.infer.audio import write_wav
from f5e_tts_tpu_torch.infer.voice_chat import DEFAULT_SYSTEM_PROMPT, VoiceChat, load_chat_model
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.utils import profiling as tprof
from f5e_tts_tpu_torch.utils import seed as tseed

TINY = dict(dim=32, depth=1, heads=1, dim_head=32, ff_mult=2, mel_dim=12, text_dim=16,
            conv_layers=0, dropout=0.0)
MEL = MelConfig(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12,
                target_sample_rate=8000)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.!")}


def _draws():
    return (random.random(), np.random.rand(3).tolist(), torch.rand(3).tolist())


def test_seed_everything_matches_jax():
    jseed.seed_everything(11)
    want = _draws()
    tseed.seed_everything(11)
    assert _draws() == want and os.environ["PYTHONHASHSEED"] == "11"


def test_flops_params_and_stats_match_jax():
    for name in ("F5TTS_v1_Base", "F5TTS_Base", "F5TTS_Small"):
        arch = preset(name).arch
        assert tprof.dit_flops(arch, 1875) == jprof.dit_flops(arch, 1875)
    got = tprof.report_model_stats(DiTConfig(**TINY), vocab_size=30, seconds=2.0, device="cpu")
    want = jprof.report_model_stats(JDiTConfig(**TINY), vocab_size=30, seconds=2.0)
    assert got == pytest.approx(want, rel=0, abs=0)
    params, _ = jbb.init_backbone(jax.random.PRNGKey(0), JDiTConfig(**TINY), 30)
    made = tdit.init_dit(DiTConfig(**TINY), 30, tprng.prng_key(0))
    assert tprof.count_params(made) == jprof.count_params(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.report_model_stats(DiTConfig(**TINY))  # the card by default


def test_trace_annotate_wallclock_and_server(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        with tprof.annotate("proxy_range"):
            torch.ones(64).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "proxy_range" for e in events)
    times = {}
    with tprof.wallclock("block", times):
        pass
    assert times["block"] >= 0.0
    with pytest.raises(NotImplementedError, match="trace"):
        tprof.start_server(9999)


def test_script_commands(tmp_path, capsys, monkeypatch):
    argv = ["--total_hours", "120.5", "--frames_per_batch", "38400"]
    jscripts.count_max_epoch(argv)
    want = capsys.readouterr().out
    assert tscripts.count_max_epoch(argv) == json.loads(want)
    assert capsys.readouterr().out == want

    from f5e_tts_tpu_torch import config as tconfig

    monkeypatch.setattr(tconfig, "preset", lambda name: tconfig.ModelConfig(
        name=name, backbone="DiT", arch=DiTConfig(**TINY)))
    stats = tscripts.main(["count_params", "--seconds", "2", "--vocab_size", "30",
                           "--device", "cpu"])
    assert stats == jprof.report_model_stats(JDiTConfig(**TINY), vocab_size=30, seconds=2.0)
    with pytest.raises(SystemExit):
        tscripts.main(["nope"])


def test_edit_cli_on_a_stand_in_model(tmp_path, monkeypatch):
    from f5e_tts_tpu_torch import api
    from f5e_tts_tpu_torch.infer.speech_edit import edit_speech

    engine = _engine()
    seen = {}

    class StandIn:
        def __init__(self, **kw):
            seen.update(kw)
            self.engine = engine

    monkeypatch.setattr(api, "F5TTS", StandIn)
    ref = str(tmp_path / "ref.wav")
    write_wav(ref, (0.2 * np.sin(2 * np.pi * 220 * np.arange(12000) / 8000)).astype(np.float32),
              8000)
    out = str(tmp_path / "edited.wav")
    wav, sr = tscripts.main(["edit", "--ref", ref, "--orig", "a b c.", "--target", "a d c.",
                             "--spans", "0.4:0.8", "--nfe", "2", "--out", out, "--device", "cpu"])
    assert seen["device"] == "cpu" and os.path.exists(out)
    from f5e_tts_tpu_torch.infer.audio import read_wav

    want, want_sr = edit_speech(engine, *read_wav(ref), "a b c.", "a d c.", [(0.4, 0.8)],
                                nfe_steps=2)
    assert sr == want_sr and np.array_equal(wav, want)


def test_prepare_csv_matches_jax(tmp_path, monkeypatch):
    sr = 8000
    for i in range(3):
        write_wav(str(tmp_path / f"w{i}.wav"),
                  (0.2 * np.sin(2 * np.pi * 220 * np.arange(sr * (i + 1)) / sr)).astype(
                      np.float32), sr)
    (tmp_path / "metadata.csv").write_text(
        "audio_file|text\n" + "".join(f"w{i}.wav|hello world {i}!\n" for i in range(3)))
    outs = {}
    for name, mod in (("jax", jprep), ("torch", tprep)):
        out = tmp_path / name
        stats = mod.prepare(mod.rows_from_csv(str(tmp_path)), str(out), tokenizer="char",
                            workers=1)
        from datasets import Dataset

        rows = Dataset.from_file(str(out / "raw.arrow")).to_list()
        outs[name] = (stats, [{**r, "audio_path": os.path.basename(r["audio_path"])}
                              for r in rows],
                      (out / "duration.json").read_text(), (out / "vocab.txt").read_text())
    assert outs["torch"] == outs["jax"] and outs["torch"][0]["rows"] == 3
    monkeypatch.setitem(sys.modules, "pypinyin", None)  # the JAX package's fall-through
    vocabs = []
    for name, mod in (("jax", jprep), ("torch", tprep)):
        mod.prepare(mod.rows_from_csv(str(tmp_path)), str(tmp_path / f"p_{name}"), workers=1)
        vocabs.append((tmp_path / f"p_{name}" / "vocab.txt").read_bytes())
    assert vocabs[0] == vocabs[1] == outs["jax"][3].encode()


def test_native_names_match_jax_fallbacks(monkeypatch):
    monkeypatch.setattr(jnative, "load_library", lambda: None)  # the Python fallbacks
    rng = np.random.default_rng(2)
    x = (0.6 * rng.standard_normal(4000)).astype(np.float32)
    assert np.array_equal(tnative.resample(x, 16000, 24000), jnative.resample(x, 16000, 24000))
    waves = [rng.standard_normal(500).astype(np.float32) for _ in range(3)]
    assert np.array_equal(tnative.crossfade_stitch(waves, 100, 0.5),
                          jnative.crossfade_stitch(waves, 100, 0.5))
    lens = rng.integers(10, 400, 200).astype(np.int32).tolist()
    kw = dict(frames_threshold=1000, max_samples=8, min_frames=20, max_frames=350)
    assert tnative.pack_batches(lens, **kw) == jnative.pack_batches(lens, **kw)
    data = jnative.f32_to_pcm16_bytes(x)
    assert tnative.f32_to_pcm16_bytes(x) == data
    assert np.array_equal(tnative.pcm16_bytes_to_f32(data), jnative.pcm16_bytes_to_f32(data))


def _engine():
    arch = DiTConfig(**TINY)
    params = tdit.init_dit(arch, len(VOCAB), tprng.prng_key(0))
    return tpipe.TTSEngine(params=params, arch=arch, vocab=VOCAB, mel=MEL, cfm=CFMConfig(),
                           infer_cfg=InferConfig(nfe_steps=2, max_duration=512),
                           tokenizer="char",
                           vocoder_decode=lambda m: 0.02 + np.zeros(
                               (m.shape[0], m.shape[1] * 64), np.float32),
                           compute_dtype=torch.float32, buckets=(128, 256), device="cpu")


def test_voice_chat_with_a_stand_in_llm(tmp_path):
    seen, heard = [], []

    def respond(messages):
        seen.append(list(messages))
        assert messages[0]["role"] == "system"
        return f"echo. {messages[-1]['content']}"

    def transcribe(path):
        heard.append(path)
        return "spoken words."

    ref = (0.2 * np.sin(2 * np.pi * 220 * np.arange(6000) / 8000)).astype(np.float32)
    vc = VoiceChat(_engine(), ref, 8000, "a ref.", respond_fn=respond, transcribe_fn=transcribe,
                   nfe_steps=2)
    reply, wav, sr = vc.chat(text="hello there.")
    assert reply == "echo. hello there." and sr == 8000 and wav.size > 0
    assert np.isfinite(wav).all() and seen[0][0]["content"] == DEFAULT_SYSTEM_PROMPT
    wav_path = str(tmp_path / "user.wav")
    write_wav(wav_path, np.zeros(8000, np.float32), 8000)
    reply, _, _ = vc.chat(audio_path=wav_path)
    assert heard == [wav_path] and reply == "echo. spoken words."
    assert [m["role"] for m in vc.messages] == ["user", "assistant"] * 2
    assert len(seen[1]) == 1 + 3  # the second call saw the whole history
    vc.clear()
    assert vc.chat(text="   ") == (None, None, None) and vc.messages == []
    with pytest.raises(ValueError, match="no assistant reply"):
        vc.speak()
    with pytest.raises(FileNotFoundError, match="chat model weights"):
        load_chat_model(str(tmp_path / "missing"), device="cpu")
