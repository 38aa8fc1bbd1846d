"""The ASR data pipeline and the waveform augmentation in the port against
the JAX package on the CPU, over wavs, a raw list and a tar shard written
here (the recipe of tests/test_asr_dataset.py; the wavs are the speech-like
signal with a noise floor of tests/test_torch_conformer.py).

Every stage that the JAX package runs in numpy (sources, tokenize, filter,
resample, speed_perturb, wav_distortion, spec_aug, shuffle, sort, batch,
padding) gives the same samples exactly for the same seeds; the fbank, and
so the features of `asr_data_pipeline`, at the port's kaldi tolerance (atol
1e-3, tests/test_torch_conformer.py). The port's copy of `wav_augment` gives
the JAX module's arrays exactly.
"""

from __future__ import annotations

import json
import random
import tarfile
import wave

import jax.numpy as jnp  # noqa: F401  (the JAX side's fbank runs on jax)
import numpy as np
import pytest

from f5e_tts_tpu.data import asr_dataset as jad
from f5e_tts_tpu.data import wav_augment as jaug
from f5e_tts_tpu_torch.data import asr_dataset as tad
from f5e_tts_tpu_torch.data import wav_augment as taug
from tests.test_torch_conformer import _speechy

SYMS = {c: i + 3 for i, c in enumerate("abcdefgh ")}
SYMS["<unk>"] = 1


def _write_corpus(tmp_path, n=5):
    from f5e_tts_tpu_torch.infer.audio import write_wav

    lines = []
    for i in range(n):
        sr = 16_000 if i % 2 == 0 else 22_050
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, _speechy(int(sr * (0.3 + 0.2 * i)), i), sr)
        lines.append(json.dumps({"key": f"u{i}", "wav": path, "txt": "abc def gaZ"[: 4 + i]}))
    lst = tmp_path / "data.list"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


def _write_shard(tmp_path):
    tar_path = tmp_path / "shard0.tar"
    with tarfile.open(tar_path, "w") as tf:
        for i in range(3):
            wav_path = tmp_path / f"s{i}.wav"
            pcm = (3000 * np.sin(np.arange(8000 + 800 * i) / (5.0 + i))).astype(np.int16)
            with wave.open(str(wav_path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16_000)
                w.writeframes(pcm.tobytes())
            (tmp_path / f"s{i}.txt").write_text(f"ab c{i}")
            tf.add(wav_path, arcname=f"s{i}.wav")
            tf.add(tmp_path / f"s{i}.txt", arcname=f"s{i}.txt")
    lst = tmp_path / "shards.list"
    lst.write_text(f"{tar_path}\n")
    return str(lst)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def test_numpy_stages_match_jax(tmp_path):
    lst = _write_corpus(tmp_path)
    assert tad.read_lists(lst) == jad.read_lists(lst)
    raw_t = list(tad.parse_raw(tad.read_lists(lst)))
    raw_j = list(jad.parse_raw(jad.read_lists(lst)))
    _same(raw_t, raw_j)
    shard = _write_shard(tmp_path)
    _same(list(tad.tar_shards(tad.read_lists(shard))), list(jad.tar_shards(jad.read_lists(shard))))
    tok_t = list(tad.tokenize(raw_t, SYMS))
    _same(tok_t, list(jad.tokenize(raw_j, SYMS)))
    _same(list(tad.tokenize(raw_t, SYMS, split_with_space=True)),
          list(jad.tokenize(raw_j, SYMS, split_with_space=True)))
    for kw in ({}, dict(min_length=40, token_max_length=6), dict(max_output_input_ratio=0.05)):
        _same(list(tad.filter_samples(tok_t, **kw)), list(jad.filter_samples(tok_t, **kw)))
    res = list(tad.resample(tok_t, 16_000))
    _same(res, list(jad.resample(tok_t, 16_000)))
    _same(list(tad.speed_perturb(res, rng=random.Random(3))),
          list(jad.speed_perturb(res, rng=random.Random(3))))
    for kind, conf in (("quad_distortion", None), ("gain_db", {"db": -3}),
                       ("jag_distortion", {"mask_number": 2})):
        got = list(tad.wav_distortion([dict(s) for s in res], kind, conf, prob=0.7,
                                      rng=random.Random(4)))
        _same(got, list(jad.wav_distortion([dict(s) for s in res], kind, conf, prob=0.7,
                                           rng=random.Random(4))))
    feats = [dict(key=f"k{i}", label=[3] * (i + 1),
                  feat=np.random.default_rng(i).standard_normal((n, 6)).astype(np.float32))
             for i, n in enumerate([30, 10, 20, 40, 5, 17])]
    _same(list(tad.spec_aug(feats, max_t=8, max_f=3, rng=random.Random(5))),
          list(jad.spec_aug(feats, max_t=8, max_f=3, rng=random.Random(5))))
    _same(list(tad.shuffle(feats, 4, rng=random.Random(6))),
          list(jad.shuffle(feats, 4, rng=random.Random(6))))
    _same(list(tad.sort_by_feat_len(feats, 4)), list(jad.sort_by_feat_len(feats, 4)))
    for kind, kw in (("static", dict(batch_size=4)), ("dynamic", dict(max_frames_in_batch=60))):
        bt, bj = list(tad.batch(feats, kind, **kw)), list(jad.batch(feats, kind, **kw))
        assert [[s["key"] for s in b] for b in bt] == [[s["key"] for s in b] for b in bj]
    with pytest.raises(ValueError, match="unsupported batch type"):
        list(tad.batch(feats, "bucket"))
    _same(list(tad.padding(tad.batch(feats, "static", 4), len_multiple=16)),
          list(jad.padding(jad.batch(feats, "static", 4), len_multiple=16)))


def test_fbank_and_pipeline_match_jax(tmp_path):
    lst = _write_corpus(tmp_path)
    sample = next(tad.resample(tad.tokenize(tad.parse_raw(tad.read_lists(lst)), SYMS)))
    got = list(tad.compute_fbank([sample]))[0]
    want = list(jad.compute_fbank([sample]))[0]
    assert got["key"] == want["key"] and got["label"] == want["label"]
    np.testing.assert_allclose(got["feat"], want["feat"], rtol=0, atol=1e-3)
    for training, conf in ((True, {"batch": {"type": "static", "size": 2}, "len_multiple": 8,
                                   "speed_perturb": True, "distortion": {"prob": 0.5}}),
                           (False, {"batch": {"type": "dynamic", "max_frames_in_batch": 200}})):
        bt = list(tad.asr_data_pipeline(lst, SYMS, training=training, conf=conf, seed=9))
        bj = list(jad.asr_data_pipeline(lst, SYMS, training=training, conf=conf, seed=9))
        assert len(bt) == len(bj) and sum(b["feats"].shape[0] for b in bt) == 5
        for g, w in zip(bt, bj):
            assert g["keys"] == w["keys"]
            for k in ("feat_lens", "labels", "label_lens"):
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_allclose(g["feats"], w["feats"], rtol=0, atol=1e-3)


def test_wav_augment_copy_matches_jax():
    x = (np.random.default_rng(7).standard_normal(4000) * 0.3).astype(np.float32)
    x[::97] = 0.0
    for make in ("make_quad_distortion",):
        np.testing.assert_array_equal(getattr(taug, make)()(x), getattr(jaug, make)()(x))
    np.testing.assert_array_equal(taug.make_poly_distortion({"a": 2, "m": 1.5, "n": 0.5})(x),
                                  jaug.make_poly_distortion({"a": 2, "m": 1.5, "n": 0.5})(x))
    np.testing.assert_array_equal(taug.make_max_distortion({"max_db": -6})(x),
                                  jaug.make_max_distortion({"max_db": -6})(x))
    np.testing.assert_array_equal(taug.make_gain_db({"db": 4})(x), jaug.make_gain_db({"db": 4})(x))
    for kind in ("fence_distortion", "jag_distortion"):
        for conf in ({"mask_number": 0, "max_db": -3}, {"mask_number": 3, "max_db": -3}):
            np.testing.assert_array_equal(
                taug.distort_wav_conf(x, kind, conf, rate=0.6, rng=np.random.default_rng(1)),
                jaug.distort_wav_conf(x, kind, conf, rate=0.6, rng=np.random.default_rng(1)))
    np.testing.assert_array_equal(
        taug.distort_chain(x, [taug.make_quad_distortion(), taug.make_gain_db({"db": -2})],
                           rng=np.random.default_rng(2)),
        jaug.distort_chain(x, [jaug.make_quad_distortion(), jaug.make_gain_db({"db": -2})],
                           rng=np.random.default_rng(2)))
    noise = [np.sin(np.arange(n) / 3.0).astype(np.float32) for n in (3000, 6000, 4000)]
    aug_t = taug.AugmentWav(lambda cat, n: noise[:n], lambda: noise[1][:500],
                            rng=np.random.default_rng(3))
    aug_j = jaug.AugmentWav(lambda cat, n: noise[:n], lambda: noise[1][:500],
                            rng=np.random.default_rng(3))
    for cat in ("noise", "speech", "music"):
        np.testing.assert_array_equal(aug_t.additive_noise(cat, x), aug_j.additive_noise(cat, x))
    np.testing.assert_array_equal(aug_t.reverberate(x), aug_j.reverberate(x))
