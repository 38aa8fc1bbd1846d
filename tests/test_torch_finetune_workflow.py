"""The headless cores of the finetuning UI (`train/finetune_gradio.py`) in the
port, against the JAX module on the same inputs: the audio slicer, the
vocab tools, checkpoint pruning and embedding growth, project settings,
dataset transcription and metadata, the training process manager, the
hyperparameter suggestion and the device list; `build_app` raises
ImportError naming gradio when it is absent (counterparts of
tests/test_finetune_workflow.py and tests/test_misc.py:28-80).
"""

import json
import os
import stat
import sys
import time
import types

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from f5e_tts_tpu.train import finetune_gradio as jfg
from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.infer.audio import write_wav
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.train import finetune_gradio as tfg
from f5e_tts_tpu_torch.utils.convert import dit_to_reference_state_dict, load_state_dict
from f5e_tts_tpu_torch.utils.text import load_vocab_file


def test_public_names_match_jax():
    public = lambda m: {n for n in vars(m) if not n.startswith("__")}  # noqa: E731
    assert public(jfg) <= public(tfg)
    assert tfg.DEFAULT_SETTINGS == jfg.DEFAULT_SETTINGS


# ---------------------------------------------------------------------------
# slicer and vocab tools (tests/test_misc.py:38-62)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(min_length_ms=2000), dict(), dict(threshold_db=-20.0,
                                                                      min_interval_ms=100)])
def test_slice_audio_matches_jax(kw):
    sr = 8000
    sil = np.zeros(sr)
    tone = 0.5 * np.sin(2 * np.pi * 220 * np.arange(6 * sr) / sr)
    wav = np.concatenate([tone, sil, tone, 0.5 * sil, tone[: sr]]).astype(np.float32)
    got, want = tfg.slice_audio(wav, sr, **kw), jfg.slice_audio(wav, sr, **kw)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if kw == dict(min_length_ms=2000):
        assert len(got) >= 2 and sum(len(s) for s in got) <= len(wav) + sr
    short = np.ones(5, np.float32)  # fewer samples than one window: the wav whole
    assert [s.tolist() for s in tfg.slice_audio(short, sr)] == [short.tolist()]


def test_vocab_tools(tmp_path, monkeypatch):
    vpath = str(tmp_path / "vocab.txt")
    with open(vpath, "w") as f:
        f.write(" \na\nb\n")
    vocab = load_vocab_file(vpath)
    missing = tfg.vocab_check(["abc", "abd"], vocab, tokenizer="char")
    assert missing == jfg.vocab_check(["abc", "abd"], vocab, tokenizer="char") == ["c", "d"]
    outs = []
    for name, mod in (("jax", jfg), ("torch", tfg)):
        out = str(tmp_path / f"vocab_{name}.txt")
        assert mod.vocab_extend(vpath, missing + ["a"], out) == 5
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    v2 = load_vocab_file(str(tmp_path / "vocab_torch.txt"))
    assert "c" in v2 and v2[" "] == 0

    # the pinyin tokens of a text, through stand-in jieba / pypinyin
    jieba = types.ModuleType("jieba")
    jieba.cut = lambda text: iter(text.split(" "))
    jieba.dt = types.SimpleNamespace(initialized=True)
    pypinyin = types.ModuleType("pypinyin")
    pypinyin.Style = types.SimpleNamespace(TONE3="tone3", TONE="tone")
    pypinyin.lazy_pinyin = lambda text, style=None, tone_sandhi=False: [
        {"你": "ni3", "好": "hao3"}.get(c, c) for c in text]
    monkeypatch.setitem(sys.modules, "jieba", jieba)
    monkeypatch.setitem(sys.modules, "pypinyin", pypinyin)
    texts = ["你好 ab", "好 c"]
    got = tfg.vocab_check(texts, vocab, tokenizer="pinyin")
    assert got == jfg.vocab_check(texts, vocab, tokenizer="pinyin") == ["c", "hao3", "ni3"]


# ---------------------------------------------------------------------------
# checkpoints (tests/test_misc.py:65-80)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny DiT's EMA export, as a training run writes it."""
    cfg = DiTConfig(dim=32, depth=1, heads=1, dim_head=32, ff_mult=2, mel_dim=8, text_dim=16,
                    conv_layers=0, dropout=0.0)
    params = tdit.init_dit(cfg, 10, tprng.prng_key(0))
    sd = {k: v.numpy() for k, v in dit_to_reference_state_dict(params, cfg).items()}
    path = str(tmp_path_factory.mktemp("ckpt") / "in.safetensors")
    save_file({f"ema_model.{k}": v for k, v in sd.items()}, path)
    return path, sd, cfg


def test_prune_checkpoint_matches_jax(ckpt, tmp_path):
    src, sd, _ = ckpt
    for name, mod in (("jax", jfg), ("torch", tfg)):
        mod.prune_checkpoint(src, str(tmp_path / f"{name}.safetensors"))
    got = load_file(str(tmp_path / "torch.safetensors"))
    want = load_file(str(tmp_path / "jax.safetensors"))
    assert got.keys() == want.keys() == {f"ema_model.{k}" for k in sd}
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert set(load_state_dict(str(tmp_path / "torch.safetensors"))) == set(sd)


@pytest.mark.parametrize("new_vocab_size,added", [(15, 5), (10, 0), (4, 0)])
def test_expand_embeddings_matches_jax(ckpt, tmp_path, new_vocab_size, added):
    src, sd, cfg = ckpt
    key = "ema_model.transformer.text_embed.text_embed.weight"
    outs = {}
    for name, mod in (("jax", jfg), ("torch", tfg)):
        out = str(tmp_path / f"{name}.safetensors")
        assert mod.expand_embeddings_for_vocab(src, out, new_vocab_size=new_vocab_size) == added
        outs[name] = load_file(out)
    assert outs["torch"].keys() == outs["jax"].keys()
    for k in outs["jax"]:
        np.testing.assert_array_equal(outs["torch"][k], outs["jax"][k], err_msg=k)  # the bits
    assert outs["torch"][key].shape == (max(11, new_vocab_size + 1), cfg.text_dim)
    np.testing.assert_array_equal(outs["torch"][key][:11],
                                  sd["transformer.text_embed.text_embed.weight"])


# ---------------------------------------------------------------------------
# settings, transcription, metadata (tests/test_finetune_workflow.py)
# ---------------------------------------------------------------------------


def test_settings_roundtrip(tmp_path):
    for mod in (jfg, tfg):
        proj = str(tmp_path / mod.__name__)
        assert "saved" in mod.save_settings(proj, {"learning_rate": 3e-5, "epochs": 7})
        s = mod.load_settings(proj)
        assert s["learning_rate"] == 3e-5 and s["epochs"] == 7
        assert s["exp_name"] == "F5TTS_v1_Base"  # defaults filled
        assert mod.load_settings(str(tmp_path / "nope")) == mod.DEFAULT_SETTINGS
    assert (open(tmp_path / tfg.__name__ / "setting.json", "rb").read()
            == open(tmp_path / jfg.__name__ / "setting.json", "rb").read())


@pytest.mark.parametrize("tokenizer", ["char", "pinyin"])
def test_transcribe_all_and_create_metadata_match_jax(tmp_path, monkeypatch, tokenizer):
    from concurrent.futures import ThreadPoolExecutor

    from f5e_tts_tpu.data import prepare as jprep
    from f5e_tts_tpu_torch.data import prepare as tprep

    monkeypatch.setitem(sys.modules, "pypinyin", None)  # pinyin takes the characters
    for mod in (jprep, tprep):  # prepare's 4 workers as threads: no fork under JAX's threads
        monkeypatch.setattr(mod, "ProcessPoolExecutor", ThreadPoolExecutor)
    sr = 24000
    src_dir = tmp_path / "raw"
    src_dir.mkdir()
    files = []
    for i in range(3):
        p = str(src_dir / f"utt{i}.wav")
        write_wav(p, (0.1 * np.sin(2 * np.pi * (200 + 50 * i) * np.arange(sr) / sr)).astype(
            np.float32), sr)
        files.append(p)
    files.append(str(src_dir / "missing.wav"))  # an error collected, not fatal
    texts = {f"utt{i}.wav": f"sentence number {i}" for i in range(3)}

    def stub_transcriber(path):
        name = os.path.basename(path)
        if name not in texts:
            raise FileNotFoundError(path)
        return texts[name]

    results = {}
    for name, mod in (("jax", jfg), ("torch", tfg)):
        proj = str(tmp_path / name / "proj")
        out = mod.transcribe_all(proj, files, transcriber=stub_transcriber)
        assert out["transcribed"] == 3 and len(out["errors"]) == 1
        assert out["metadata"] == os.path.join(proj, "metadata.csv")
        meta = open(out["metadata"], "rb").read()
        # the rows name the copies without their wavs/ folder, so the csv
        # adapter finds none of them, in both packages; with it, all three
        stats = [mod.create_metadata(proj, str(tmp_path / name / "ds0"), tokenizer=tokenizer)]
        with open(out["metadata"], "w", encoding="utf-8") as f:
            f.write(meta.decode().replace("\nutt", "\nwavs/utt"))
        ds_dir = str(tmp_path / name / "ds")
        stats.append(mod.create_metadata(proj, ds_dir, tokenizer=tokenizer))
        results[name] = (out["errors"], meta, stats,
                         sorted(os.listdir(os.path.join(proj, "wavs"))),
                         open(os.path.join(ds_dir, "duration.json"), "rb").read(),
                         open(os.path.join(ds_dir, "vocab.txt"), "rb").read())
    assert results["torch"] == results["jax"]
    meta = results["torch"][1].decode().strip().split("\n")
    assert meta[0] == "audio_file|text" and meta[1] == "utt0.wav|sentence number 0"
    assert [st["rows"] for st in results["torch"][2]] == [0, 3]


def test_transcribe_all_defaults_to_the_port_whisper_on_its_device(tmp_path, monkeypatch):
    from f5e_tts_tpu_torch.infer import transcribe as ttranscribe

    calls = []
    monkeypatch.setattr(ttranscribe, "transcribe",
                        lambda path, language=None, device=None: calls.append(
                            (os.path.basename(path), language, device)) or "words")
    wav = str(tmp_path / "a.wav")
    write_wav(wav, np.zeros(800, np.float32), 8000)
    out = tfg.transcribe_all(str(tmp_path / "p"), [wav], language="chinese", device="cpu")
    assert out["transcribed"] == 1 and calls == [("a.wav", "chinese", "cpu")]


# ---------------------------------------------------------------------------
# the training process
# ---------------------------------------------------------------------------


def _stand_in_python(tmp_path, sleep: float):
    """An executable that prints its arguments and sleeps: the manager's
    `python=` in place of the interpreter, so no training runs."""
    path = tmp_path / "python"
    path.write_text(f"#!/bin/sh\necho \"$@\"\nsleep {sleep}\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _wait_for_lines(mgr):
    for _ in range(100):
        if mgr.lines:
            return
        time.sleep(0.05)


def test_training_manager_lifecycle(tmp_path):
    mgr = tfg.TrainingManager()
    assert mgr.status()["state"] == "idle" and mgr.stop() == "train not running !"
    pid = mgr.start("c.yaml", data_dir="d", dataset_name="n", pretrained="p.pt", max_updates=3,
                    extra_args=["--no_resume"], python=_stand_in_python(tmp_path, 20),
                    device="cpu")
    _wait_for_lines(mgr)
    st = mgr.status()
    assert st["state"] == "running" and st["pid"] == pid and mgr.is_running()
    assert mgr.lines[0] == ("-m f5e_tts_tpu_torch.train.train --config c.yaml --data_dir d "
                            "--device cpu --dataset_name n --pretrained p.pt --max_updates 3 "
                            "--no_resume")
    with pytest.raises(RuntimeError, match="already in progress"):
        mgr.start("whatever.yaml")
    assert mgr.stop() == "train stopped !"
    assert not mgr.is_running() and mgr.stop() == "train not running !"
    assert mgr.status()["state"].startswith("exited(")


def test_training_manager_runs_to_its_end_on_the_card_by_default(tmp_path):
    mgr = tfg.TrainingManager()
    mgr.start("c.yaml", python=_stand_in_python(tmp_path, 0))
    assert mgr.wait(timeout=30) == 0
    _wait_for_lines(mgr)
    mgr._pump.join(timeout=5)
    assert mgr.lines == ["-m f5e_tts_tpu_torch.train.train --config c.yaml --data_dir data "
                         "--device cuda"]
    assert mgr.status()["state"] == "exited(0)" and mgr.status()["tail"] == mgr.lines


# ---------------------------------------------------------------------------
# hyperparameters and devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_chips=4, hbm_gb_per_chip=16.0), dict(n_chips=1),
                                dict(n_chips=2, batch_size_type="sample", finetune=False),
                                dict(n_chips=1, hbm_gb_per_chip=80.0)])
@pytest.mark.parametrize("n", [40, 100])
def test_calculate_train_matches_jax(tmp_path, kw, n):
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "duration.json").write_text(json.dumps({"duration": [5.0 + 0.1 * (i % 7)
                                                               for i in range(n)]}))
    out = tfg.calculate_train(str(ds), **kw)
    assert out == jfg.calculate_train(str(ds), **kw)
    assert out["total_samples"] == n and out["epochs"] > 0
    if n < 64:
        assert out["max_samples"] == n // 4  # < 64 samples -> 25%
    assert "error" in tfg.calculate_train(str(tmp_path / "nope"))


def test_calculate_train_counts_the_cuda_devices(tmp_path, monkeypatch):
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "duration.json").write_text(json.dumps({"duration": [5.0] * 40}))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)  # the CPU: one device
    assert tfg.calculate_train(str(ds)) == jfg.calculate_train(str(ds), n_chips=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tfg.calculate_train(str(ds)) == jfg.calculate_train(str(ds), n_chips=4)


def test_system_stats(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tfg.system_stats() == {"devices": []}  # no CPU row dressed as a device
    props = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3", total_memory=85 * 2**30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 1000 * (i + 1))
    rows = tfg.system_stats()["devices"]
    assert rows == [{"kind": "NVIDIA H100 80GB HBM3", "id": i, "platform": "gpu",
                     "bytes_in_use": 1000 * (i + 1), "bytes_limit": 85 * 2**30}
                    for i in range(2)]
    jrow = jfg.system_stats()["devices"][0]  # the JAX row's keys, on its CPU devices
    assert set(jrow) <= set(rows[0])


def test_build_app_raises_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        tfg.build_app()
