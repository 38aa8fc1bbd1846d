"""The port's data pipeline, checkpoint export and Trainer loop on the CPU.

- `pack_batches`, `FramePackedSampler` and `collate` give exactly what the
  JAX package's give on the same inputs (integer and copied data: no
  tolerance).
- `dit_to_reference_state_dict` equals f5e_tts_tpu.utils.torch_ckpt:
  dit_to_torch exactly, fused or not, and round-trips through the loader.
- The Trainer's loop, checkpoint, rotation and resume, as the JAX package's
  tests/test_train.py:84-128, with device="cpu"; the default device is the
  card, so without one the Trainer raises.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.data import dataset as jdata
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.utils.torch_ckpt import dit_to_torch
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, MelConfig, ModelConfig, TrainConfig
from f5e_tts_tpu_torch.data import dataset as tdata
from f5e_tts_tpu_torch.models.dit import fuse_qkv
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, dit_from_reference_state_dict,
                                             dit_to_reference_state_dict, load_state_dict)
from f5e_tts_tpu_torch.utils.text import list_str_to_idx

MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12,
              target_sample_rate=8000)
MEL = MelConfig(**MEL_KW)
ARCH = DiTConfig(dim=32, depth=1, heads=1, dim_head=32, ff_mult=2, mel_dim=12, text_dim=16,
                 conv_layers=0, dropout=0.0)
VOCAB = {c: i for i, c in enumerate(" abcdefgh")}


def _tokenize(texts):
    return list_str_to_idx([list(t) for t in texts], VOCAB)


def _rows(n=12, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        dur = 0.5 + 0.1 * (i % 5)
        rows.append({"audio": {"array": (0.1 * rng.standard_normal(int(dur * 8000)))
                               .astype(np.float32), "sampling_rate": 8000},
                     "text": "abc def gh"[: 4 + i % 6], "duration": dur})
    return rows


def _toy_dataset(n=12):
    rows = _rows(n)
    return tdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows], mel=MEL)


def test_packing_and_collate_match_jax():
    rng = np.random.default_rng(1)
    lens = rng.integers(10, 600, 50).tolist()
    for kw in (dict(frames_threshold=900, max_samples=4), dict(frames_threshold=500),
               dict(frames_threshold=700, max_samples=3, min_frames=40, max_frames=550)):
        assert tdata.pack_batches(lens, **kw) == jdata.pack_batches(lens, **kw)
    batches = tdata.pack_batches(lens, 900, 4)
    t_s, j_s = tdata.FramePackedSampler(batches, seed=3), jdata.FramePackedSampler(batches, seed=3)
    for epoch in (0, 1):
        t_s.set_epoch(epoch)
        j_s.set_epoch(epoch)
        assert list(t_s) == list(j_s)

    jmel = JMelConfig(**MEL_KW)
    t_items = [tdata.ArrowSpeechDataset(_rows(), mel=MEL)[i] for i in (0, 3, 7)]
    j_items = [jdata.ArrowSpeechDataset(_rows(), mel=jmel)[i] for i in (0, 3, 7)]
    mel_items = [{"mel": rng.standard_normal((n, 12)).astype(np.float32), "text": t}
                 for n, t in ((40, "ab"), (75, "cdefg"))]
    for ti, ji, kw in ((t_items, j_items, dict(len_multiple=32, text_multiple=8)),
                       (mel_items, mel_items, dict(len_multiple=16, batch_multiple=4))):
        got, want = tdata.collate(ti, _tokenize, MEL, **kw), jdata.collate(ji, _tokenize, jmel, **kw)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    ds = _toy_dataset()
    assert [ds.get_frame_len(i) for i in range(len(ds))] == [
        jdata.frame_len_of(r["duration"], jmel) for r in _rows()]
    jds = jdata.ArrowSpeechDataset(_rows(), durations=[r["duration"] for r in _rows()], mel=jmel)
    got = tdata.build_loader(ds, _tokenize, 300, max_samples=3, seed=1)
    want = jdata.build_loader(jds, _tokenize, 300, max_samples=3, seed=1, batch_size_type="frame")
    assert got.sampler.batches == want.sampler.batches and len(got) == len(want)


def test_reference_export_matches_jax_dit_to_torch():
    cfg = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
               conv_layers=2)
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**cfg), 32)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
                          .astype(np.float32), params)
    want = dit_to_torch(params, {}, JDiTConfig(**cfg))
    port = dit_from_jax(params, DiTConfig(**cfg))
    for tree in (port, fuse_qkv(port)):
        got = dit_to_reference_state_dict(tree, DiTConfig(**cfg))
        assert got.keys() == want.keys()  # both carry the "transformer." prefix
        for k, v in want.items():
            assert got[k].is_contiguous()
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back, port = _flat(dit_from_reference_state_dict(got, DiTConfig(**cfg))), _flat(port)
    assert back.keys() == port.keys() and all(torch.equal(back[k], port[k]) for k in port)


def _flat(tree, prefix=""):
    """{dotted path: tensor} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _trainer(tmp, **kw):
    train_cfg = TrainConfig(**{**dict(learning_rate=1e-3, num_warmup_updates=2,
                                      batch_size_per_device=300, save_per_updates=1000,
                                      last_per_updates=4, keep_last_n_checkpoints=2,
                                      save_dir=str(tmp), seed=0, compute_dtype="float32"),
                               **kw})
    model_cfg = ModelConfig(name="tiny", backbone="DiT", arch=ARCH, mel=MEL, cfm=CFMConfig())
    return model_cfg, train_cfg


def test_trainer_loop_checkpoint_and_resume(tmp_path):
    loader = tdata.build_loader(_toy_dataset(), _tokenize, frames_threshold=300, max_samples=2,
                                len_multiple=32)
    model_cfg, train_cfg = _trainer(tmp_path / "ckpts")
    logs = []
    trainer = Trainer(model_cfg, train_cfg, vocab_size=len(VOCAB), tokenize=_tokenize,
                      log_fn=lambda m, u: logs.append((u, m)), device="cpu")
    ts, info = trainer.train(loader, epochs=1, resume=False, max_updates=5)
    assert ts.update == 5 and info["updates"] == 5 and len(logs) == 5
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for _, m in logs)
    last = tmp_path / "ckpts" / "model_last.pt"
    assert last.exists() and (tmp_path / "ckpts" / "model_last.meta.json").exists()
    # the EMA export in the reference layout re-ingests as the EMA params
    ema = _flat(dit_from_reference_state_dict(load_state_dict(str(last)), ARCH))
    want = _flat(ts.ema_params)
    assert ema.keys() == want.keys() and all(torch.equal(ema[k], want[k]) for k in want)

    # resume continues from update 5 (the loader fast-forwards the consumed batches)
    trainer2 = Trainer(model_cfg, train_cfg, vocab_size=len(VOCAB), tokenize=_tokenize,
                       device="cpu")
    restored = trainer2.load_checkpoint(trainer2.init_state(total_updates=7))
    assert (restored.update, restored.micro) == (ts.update, ts.micro)
    for a, b in zip(tstep.tree_leaves(restored.opt_state.state_dict()),
                    tstep.tree_leaves(ts.opt_state.state_dict())):
        assert not isinstance(a, torch.Tensor) or torch.equal(a, b)
    ts2, _ = trainer2.train(loader, epochs=10, resume=True, max_updates=7)
    assert ts2.update == 7


def test_trainer_rotation_accumulation_and_device(tmp_path):
    loader = tdata.build_loader(_toy_dataset(6), _tokenize, frames_threshold=300, max_samples=2,
                                len_multiple=32)
    model_cfg, train_cfg = _trainer(tmp_path / "ck", save_per_updates=1, last_per_updates=100,
                                    grad_accumulation_steps=2)
    trainer = Trainer(model_cfg, train_cfg, vocab_size=len(VOCAB), tokenize=_tokenize,
                      device="cpu")
    ts, _ = trainer.train(loader, epochs=4, resume=False, max_updates=4)
    assert (ts.update, ts.micro) == (4, 8)
    kept = sorted(n for n in os.listdir(tmp_path / "ck") if re.match(r"model_\d+\.pt$", n))
    assert kept == ["model_3.pt", "model_4.pt"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model_cfg, train_cfg, vocab_size=len(VOCAB), tokenize=_tokenize)
