"""The headless cores of the inference UI (`infer/gradio_app.py`) in the port,
against the JAX module on the same inputs: the style-marker parser, txt
upload, style validation, the model switcher's persistence, multi-style
generation (with its seeds, speeds, fall-back to Regular and metadata) and
the mono/float conversion; `build_app` raises ImportError naming gradio
when it is absent (counterparts of tests/test_gradio_app.py and
tests/test_misc.py::test_parse_speechtypes).
"""

import json
import sys

import numpy as np
import pytest

from f5e_tts_tpu.infer import gradio_app as jga
from f5e_tts_tpu_torch.infer import gradio_app as tga
from f5e_tts_tpu_torch.infer.voice_chat import DEFAULT_SYSTEM_PROMPT


def test_public_names_and_constants_match_jax():
    public = lambda m: {n for n in vars(m) if not n.startswith("__")}  # noqa: E731
    assert public(jga) - {"_DEFAULT_SYSTEM_PROMPT"} <= public(tga)
    assert tga.MAX_SPEECH_TYPES == jga.MAX_SPEECH_TYPES
    assert tga.DEFAULT_CUSTOM_CFG == jga.DEFAULT_CUSTOM_CFG
    assert tga._DEFAULT_SYSTEM_PROMPT == DEFAULT_SYSTEM_PROMPT == jga._DEFAULT_SYSTEM_PROMPT


@pytest.mark.parametrize("script", [
    "{Regular} Hello. {Shouting} HEY! {Regular} ok",
    "plain text",
    '{"name": "Whisper", "seed": 7, "speed": 0.8} soft. then more.',
    '{"name": "A"} one {B} two {"seed": 3} three {} four',
    "", "   {Only}   ",
])
def test_parse_speechtypes_matches_jax(script):
    got = tga.parse_speechtypes_text(script)
    assert got == jga.parse_speechtypes_text(script)
    if script.startswith("{Regular}"):
        assert [(s["name"], s["text"]) for s in got] == [
            ("Regular", "Hello."), ("Shouting", "HEY!"), ("Regular", "ok")]
        assert all(s["seed"] == -1 and s["speed"] == 1.0 for s in got)


def test_load_text_from_file(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("  hello there \n")
    for mod in (jga, tga):
        assert mod.load_text_from_file(str(p)) == "hello there"
        assert mod.load_text_from_file(None) == "" and mod.load_text_from_file("") == ""


@pytest.mark.parametrize("names", [("Regular", "Shouting"), ("Regular",),
                                   ("Regular", "", "Shouting", ""), ()])
def test_validate_speech_types(names):
    text = "{Regular} hi {Shouting} HEY"
    assert tga.validate_speech_types(text, *names) == jga.validate_speech_types(text, *names)
    assert tga.validate_speech_types(text, *names) == ("Shouting" in names)


def test_model_choice_persistence(tmp_path):
    cfg = json.dumps({"dim": 64, "depth": 2})
    states = []
    for mod in (jga, tga):
        cache = str(tmp_path / mod.__name__ / "last.txt")
        mc = mod.ModelChoice("F5TTS_v1_Base", cache_path=cache)
        assert mc.load_last_used_custom() == mod.DEFAULT_CUSTOM_CFG  # fresh cache
        mc.set_custom("/x/model.safetensors", "/x/vocab.txt", cfg)
        assert mc.choice == ("Custom", "/x/model.safetensors", "/x/vocab.txt", cfg)
        mc2 = mod.ModelChoice("F5TTS_v1_Base", cache_path=cache)
        assert mc2.load_last_used_custom() == ["/x/model.safetensors", "/x/vocab.txt", cfg]
        assert mc2.switch("E2-TTS") is None and mc2.choice == "E2-TTS"
        assert mc2.switch("Custom") == ("/x/model.safetensors", "/x/vocab.txt", cfg)
        # a cache of one line is filled from the defaults
        with open(cache, "w", encoding="utf-8") as f:
            f.write("/only/ckpt\n")
        states.append((mc2.choice, mc2.load_last_used_custom(),
                       open(cache, "rb").read()))
    assert states[0] == states[1]
    assert tga.ModelChoice().cache_path.endswith("last_used_custom_model_info_v1.txt")


def _fake_infer(calls):
    def infer(audio, ref_text, text, seed, speed, remove_silence):
        calls.append(dict(audio=audio, text=text, seed=seed, speed=speed, rm=remove_silence))
        return np.full(4, len(calls), np.float32), 24000, ref_text + "!"

    return infer


def test_generate_multistyle_core_matches_jax():
    script = ('{Regular} one {"name": "Shout", "seed": 5, "speed": 1.5} two '
              "{Missing} three")
    outs = []
    for mod in (jga, tga):
        calls = []
        voices = {"Regular": {"audio": "A", "ref_text": "ra"},
                  "Shout": {"audio": "B", "ref_text": "rb"}}
        outs.append((mod.generate_multistyle_core(_fake_infer(calls), script, voices,
                                                  remove_silence=True, seed_fn=lambda: 42),
                     calls))
    (wav, sr, voices_out, meta), calls = outs[1]
    (jwav, jsr, jvoices, jmeta), jcalls = outs[0]
    np.testing.assert_array_equal(wav, jwav)
    assert (sr, voices_out, meta, calls) == (jsr, jvoices, jmeta, jcalls)
    assert sr == 24000 and len(wav) == 12
    assert [c["text"] for c in calls] == ["one", "two", "three"]
    assert calls[0]["seed"] == 42 and calls[1]["seed"] == 5 and calls[1]["speed"] == 1.5
    assert calls[2]["audio"] == "A" and all(c["rm"] for c in calls)  # Missing -> Regular
    assert voices_out["Regular"]["ref_text"] == "ra!!"
    lines = meta.strip().split("\n")
    assert len(lines) == 3 and json.loads(lines[1].split("} ")[0] + "}")["seed"] == 5


def test_generate_multistyle_default_seeds_and_empty_script():
    np.random.seed(11)
    calls = []
    tga.generate_multistyle_core(_fake_infer(calls), "a {X} b", {"Regular": {"audio": "A"}})
    np.random.seed(11)
    jcalls = []
    jga.generate_multistyle_core(_fake_infer(jcalls), "a {X} b", {"Regular": {"audio": "A"}})
    assert calls == jcalls and 0 <= calls[0]["seed"] < 2**31 - 1
    for mod in (jga, tga):
        wav, sr, voices, meta = mod.generate_multistyle_core(_fake_infer([]), "", {})
        assert wav.dtype == np.float32 and wav.size == 0 and sr is None and meta == ""


def test_generate_multistyle_no_regular_raises():
    for mod in (jga, tga):
        with pytest.raises(ValueError, match="no reference"):
            mod.generate_multistyle_core(lambda *a: (np.zeros(1), 24000, ""), "{Nope} hi", {})


@pytest.mark.parametrize("wav", [
    np.asarray([0.1, -0.2, 0.3], np.float32),
    np.asarray([[1000, 3000], [-2000, 0]], np.int16),
    np.asarray([[0.5, 0.1], [0.2, 0.2]], np.float64),
])
def test_as_mono_float_matches_jax(wav):
    got = tga._as_mono_float(wav)
    np.testing.assert_array_equal(got, jga._as_mono_float(wav))
    assert got.dtype == np.float32 and got.ndim == 1


def test_build_app_raises_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        tga.build_app()
