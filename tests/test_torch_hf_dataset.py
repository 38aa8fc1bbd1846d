"""The hub dataset and the dataset factory of the port against the JAX
package on the CPU, with an in-memory `datasets.Dataset` (the hub is never
reached: `datasets.load_dataset` is monkeypatched where a CLI calls it).

- `HFSpeechDataset`: frame lengths from the array lengths, the skip-forward
  past items outside [0.3, 30] s (and the raise when none is left), and the
  resample to the mel rate: each item's audio equal to JAX's within 1e-6
  (both resample with scipy's resample_poly), its text exactly.
- `load_speech_dataset` for CustomDataset (raw and audio_type="mel"),
  CustomDatasetPath and HFDataset (the hub name split into repo and split,
  cached under data_root) gives JAX's items; an unknown type raises.
- The YAML training CLI on an HFDataset config, both CLIs from one
  --pretrained checkpoint with the JAX step's draws in fp32: the first loss
  within 1e-5 relative (the port's CLI raised for any dataset_type but
  CustomDataset before).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from f5e_tts_tpu import config as jconfig
from f5e_tts_tpu.data import dataset as jdata
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.data import dataset as tdata
from f5e_tts_tpu_torch.train import trainer as ttrainer
from tests.test_torch_train_cli import _draws, _pretrained, _write_yaml

MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=8, target_sample_rate=8000)
SECONDS = (0.5, 0.2, 0.8, 31.0, 0.6, 0.25)  # two too short and one too long to train on


def _hub(seconds=SECONDS):
    """An in-memory hub dataset: rows {audio: {array, sampling_rate}, text} at
    16 and 8 kHz."""
    from datasets import Dataset

    rng = np.random.default_rng(0)
    audio, text = [], []
    for i, sec in enumerate(seconds):
        sr = 16_000 if i % 2 else 8000
        audio.append({"array": (0.1 * rng.standard_normal(int(sec * sr))).astype(np.float32),
                      "sampling_rate": sr})
        text.append("abc def gh"[: 3 + i])
    return Dataset.from_dict({"audio": audio, "text": text})


def test_hf_speech_dataset_matches_jax():
    hub = _hub()
    got = tdata.HFSpeechDataset(hub, tconfig.MelConfig(**MEL_KW))
    want = jdata.HFSpeechDataset(hub, jconfig.MelConfig(**MEL_KW))
    assert len(got) == len(want) == len(SECONDS)
    assert [got.get_frame_len(i) for i in range(len(got))] == [
        want.get_frame_len(i) for i in range(len(want))] == [62, 25, 100, 3875, 75, 31]
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g["text"] == w["text"]
        np.testing.assert_allclose(g["audio"], w["audio"], atol=1e-6)
    # 1 (0.2 s) skips to 2, 3 (31 s) to 4, 5 (0.25 s) wraps round to 0
    assert [got[i]["text"] for i in (1, 3, 5)] == [hub[2]["text"], hub[4]["text"], hub[0]["text"]]
    assert len(got[2]["audio"]) == int(0.8 * 8000)
    with pytest.raises(ValueError, match=r"\[0.3, 30\]"):
        tdata.HFSpeechDataset(_hub((0.1, 0.2)), tconfig.MelConfig(**MEL_KW))[0]


def _custom_dir(root, name="Toy", tokenizer="byte"):
    from datasets import Dataset as ArrowDataset

    d = os.path.join(root, f"{name}_{tokenizer}")
    rng = np.random.default_rng(1)
    rows = [{"audio": {"array": (0.1 * rng.standard_normal(4000 + 800 * i)).astype(np.float32),
                       "sampling_rate": 8000}, "text": "abcd"[: 2 + i % 3],
             "mel_spec": rng.standard_normal((8, 60 + i)).astype(np.float32)} for i in range(4)]
    ArrowDataset.from_list(rows).save_to_disk(os.path.join(d, "raw"))
    with open(os.path.join(d, "duration.json"), "w") as f:
        json.dump({"duration": [len(r["audio"]["array"]) / 8000 for r in rows]}, f)
    return d


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(got)):
        assert got.get_frame_len(i) == want.get_frame_len(i)
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in g:
            if k == "text":
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(g[k], w[k], atol=1e-6)


def test_load_speech_dataset_matches_jax_for_each_type(tmp_path, monkeypatch):
    import datasets

    d = _custom_dir(str(tmp_path))
    mt, mj = tconfig.MelConfig(**MEL_KW), jconfig.MelConfig(**MEL_KW)
    for audio_type in ("raw", "mel"):
        got = tdata.load_speech_dataset("Toy", "byte", "CustomDataset", str(tmp_path), mt,
                                        audio_type=audio_type)
        want = jdata.load_speech_dataset("Toy", "byte", "CustomDataset", str(tmp_path), mj,
                                         audio_type=audio_type)
        assert got.preprocessed_mel == (audio_type == "mel")
        _same_items(got, want)
    _same_items(tdata.load_speech_dataset(d, dataset_type="CustomDatasetPath", mel=mt),
                jdata.load_speech_dataset(d, dataset_type="CustomDatasetPath", mel=mj))
    calls = []
    monkeypatch.setattr(datasets, "load_dataset",
                        lambda repo, split, cache_dir: calls.append((repo, split, cache_dir))
                        or _hub())
    got = tdata.load_speech_dataset("Emilia_EN", dataset_type="HFDataset", data_root="cache",
                                    mel=mt)
    assert isinstance(got, tdata.HFSpeechDataset)
    assert calls == [("Emilia/Emilia", "train.EN", "cache")]
    _same_items(got, jdata.load_speech_dataset("Emilia_EN", dataset_type="HFDataset", mel=mj,
                                               hf_dataset=_hub()))
    # a dataset handed over is not loaded again
    tdata.load_speech_dataset("x", dataset_type="HFDataset", hf_dataset=_hub())
    assert len(calls) == 1
    with pytest.raises(ValueError, match="unknown dataset_type"):
        tdata.load_speech_dataset("x", dataset_type="Parquet")


def test_train_cli_on_an_hf_dataset_matches_jax_cli(tmp_path, monkeypatch):
    import datasets

    from f5e_tts_tpu.train import train as jtrain_cli
    from f5e_tts_tpu.train import trainer as jtrainer
    from f5e_tts_tpu_torch.train import train as ttrain_cli

    monkeypatch.setattr(datasets, "load_dataset", lambda repo, split, cache_dir: _hub(
        (0.5, 0.6, 0.7, 0.5, 0.6, 0.7)))
    swap = {"name: Toy": "name: Hub_train\n  dataset_type: HFDataset",
            "tokenizer: char": "tokenizer: byte"}
    y_j = _write_yaml(tmp_path / "j.yaml", str(tmp_path / "run_j"), **swap)
    y_t = _write_yaml(tmp_path / "t.yaml", str(tmp_path / "run_t"), **swap)
    ckpt = _pretrained(tmp_path, jconfig.load_yaml(y_j).arch, vocab=256)
    jl, tl = jconfig.load_train_yaml, tconfig.load_train_yaml
    monkeypatch.setattr(jconfig, "load_train_yaml",
                        lambda p: dataclasses.replace(jl(p), compute_dtype="float32"))
    monkeypatch.setattr(tconfig, "load_train_yaml",
                        lambda p: dataclasses.replace(tl(p), compute_dtype="float32"))
    seen = {"jax": [], "port": []}

    class JRecording(jtrainer.Trainer):
        def __post_init__(self):
            inner = self.log_fn
            self.log_fn = lambda m, u: (seen["jax"].append(m["loss"]), inner(m, u))
            super().__post_init__()

    class TRecording(ttrainer.Trainer):
        def __post_init__(self):
            inner = self.log_fn
            self.log_fn = lambda m, u: (seen["port"].append(m["loss"]), inner(m, u))
            super().__post_init__()

        def make_step(self):
            step, cfm, seed = super().make_step(), self.cfm, self.train_cfg.seed

            def with_jax_draws(ts, batch, generator, draws=None):
                key = jax.random.fold_in(jax.random.PRNGKey(seed), ts.micro + ts.skipped)
                b, n = batch["audio"].shape[0], batch["audio"].shape[1] // 64
                return step(ts, batch, generator, _draws(key, b, n, 8, cfm))

            return with_jax_draws

    monkeypatch.setattr(jtrainer, "Trainer", JRecording)
    monkeypatch.setattr(ttrainer, "Trainer", TRecording)
    args = ["--data_dir", str(tmp_path / "data"), "--max_updates", "1", "--no_resume",
            "--pretrained", ckpt]
    jtrain_cli.main(["--config", y_j, *args])
    ts = ttrain_cli.main(["--config", y_t, *args, "--device", "cpu"])
    assert ts.update == 1 and len(seen["port"]) == len(seen["jax"]) == 1
    np.testing.assert_allclose(seen["port"][0], seen["jax"][0], rtol=1e-5)
