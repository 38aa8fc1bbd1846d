"""The port's model configs and entry points over the other backbones
against the JAX package on the CPU, fp32 (split from test_torch_unett.py,
whose tiny UNetT and helpers they share).

- the long-skip DiT forward vs JAX at atol 1e-4, and its converters exactly.
- `load_yaml` / `load_train_yaml` field by field against the JAX loaders
  (the `mesh:` section too).
- the duration predictor, its style encoder and helpers vs JAX at atol 1e-4.
- `F5TTS(config_file=<a tiny UNetT YAML>, device="cpu")`, `Trainer` over a
  UNetTConfig and the CLI's `--model_cfg` on the CPU; `F5TTS.infer` takes
  `target_rms=` as the JAX one does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from f5e_tts_tpu import config as jconfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import UNetTConfig as JUNetTConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.models import durpred as jdur
from f5e_tts_tpu.models import unett as junett
from f5e_tts_tpu.utils.torch_ckpt import dit_from_torch, dit_to_torch, unett_to_torch
from f5e_tts_tpu_torch import api as tapi
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, MelConfig, ModelConfig, UNetTConfig
from f5e_tts_tpu_torch.infer import audio as taudio
from f5e_tts_tpu_torch.infer import cli as tcli
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.models import durpred as tdur
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.train.trainer import Trainer
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, dit_from_reference_state_dict,
                                             dit_to_reference_state_dict, to_tensors,
                                             unett_from_jax, unett_from_reference_state_dict)
from f5e_tts_tpu_torch.utils.text import list_str_to_bytes
from tests.test_torch_convert import _flat
from tests.test_torch_unett import B, N, TINY, VOCAB, _batch, t

# ---------------------------------------------------------------------------
# the long-skip DiT
# ---------------------------------------------------------------------------

LONG = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=10, text_dim=16,
            conv_layers=1, dropout=0.0, long_skip_connection=True)


def test_long_skip_dit_forward_and_converters_match_jax():
    arch_j, arch_t = JDiTConfig(**LONG), DiTConfig(**LONG)
    params_np, _ = jdit.init_dit(jax.random.PRNGKey(0), arch_j, VOCAB)
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                             .astype(np.float32), params_np)
    assert "long_skip" in params_np and "b" not in params_np["long_skip"]
    x, cond, ids, time = _batch(np.random.default_rng(1))
    f = np.zeros(B, bool)
    mask = np.arange(N)[None, :] < np.asarray([N, 15])[:, None]
    want, _ = jdit.dit_forward(params_np, {}, arch_j, x=jnp.asarray(x), cond=jnp.asarray(cond),
                               text_ids=jnp.asarray(ids), time=jnp.asarray(time),
                               drop_audio_cond=jnp.asarray(f), drop_text=jnp.asarray(f),
                               drop_ppg=jnp.asarray(f), mask=jnp.asarray(mask),
                               compute_dtype=jnp.float32)
    params = dit_from_jax(params_np, arch_t)
    got = tdit.dit_forward(params, arch_t, x=t(x), cond=t(cond), text_ids=t(ids), time=t(time),
                           drop_audio_cond=t(f), drop_text=t(f), mask=t(mask),
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # the reference layout's long_skip_connection, both ways, and init's leaf order
    sd = dit_to_torch(params_np, {}, arch_j)
    assert "transformer.long_skip_connection.weight" in sd
    ours = dit_to_reference_state_dict(params, arch_t)
    assert ours.keys() == sd.keys()
    assert all(np.array_equal(ours[k].numpy(), v) for k, v in sd.items())
    back = _flat(dit_from_reference_state_dict(sd, arch_t))
    direct = _flat(dit_from_jax(jax.tree.map(np.asarray, dit_from_torch(sd, arch_j)[0]), arch_t))
    assert list(back) == list(_flat(tdit.init_dit(arch_t, VOCAB, tprng.prng_key(0))))
    assert back.keys() == direct.keys() and all(torch.equal(back[k], direct[k]) for k in back)


# ---------------------------------------------------------------------------
# YAML configs
# ---------------------------------------------------------------------------


def _same_fields(got, want):
    """Every field of the port's dataclass equals the JAX one's of that name."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b)
        else:
            assert a == b, (f.name, a, b)


def _write_yaml(path, data):
    path.write_text(yaml.safe_dump(data), "utf-8")
    return str(path)


UNETT_YAML = {"model": {"name": "tiny_e2", "backbone": "UNetT", "tokenizer": "byte",
                        "arch": {**{k: v for k, v in TINY.items() if k != "mel_dim"},
                                 "mel_dim": 100, "skip_connect_type": "add"},
                        "mel_spec": {"target_sample_rate": 24000, "n_mel_channels": 100}}}


@pytest.mark.parametrize("which", ["example", "unett", "mmdit_bare"])
def test_load_yaml_matches_jax_field_by_field(which, tmp_path):
    path = {"example": "configs/example.yaml",
            "unett": _write_yaml(tmp_path / "u.yaml", UNETT_YAML),
            "mmdit_bare": _write_yaml(tmp_path / "m.yaml", {"backbone": "MMDiT",
                                                            "arch": {"depth": 3}})}[which]
    got, want = tconfig.load_yaml(path), jconfig.load_yaml(path)
    assert type(got.arch).__name__ == type(want.arch).__name__
    _same_fields(got, want)
    if which == "example":  # the reference's ppg_config / codebook_config keys, mapped
        assert got.arch.ppg.use_ppg and got.arch.ppg.ppg_dim == 256
        assert got.arch.codebook.use_perplex_loss and got.arch.codebook.perplex_loss_prob == 0.1
        assert got.arch.ppg.combined_cond_drop_prob == (0.3, 0.1, 0.5, 0.1)


def test_load_train_yaml_matches_jax_field_by_field(tmp_path):
    got = tconfig.load_train_yaml("configs/example.yaml")
    want = jconfig.load_train_yaml("configs/example.yaml")
    names = {f.name for f in dataclasses.fields(want)}
    assert {f.name for f in dataclasses.fields(got)} <= names
    _same_fields(got, want)
    assert got.save_dir == "ckpts/libritts_ppg_codebook" and got.epochs == 890
    # 8-bit AdamW, sample-count batches and the logger are read as JAX reads them
    for extra in ({"optim": {"bnb_optimizer": True}}, {"datasets": {"batch_size_type": "sample"}},
                  {"ckpts": {"logger": "wandb", "log_samples_per_updates": 7}}):
        path = _write_yaml(tmp_path / "t.yaml", extra)
        _same_fields(tconfig.load_train_yaml(path), jconfig.load_train_yaml(path))
    assert tconfig.load_train_yaml(_write_yaml(tmp_path / "t.yaml", {
        "optim": {"bnb_optimizer": True}, "datasets": {"batch_size_type": "sample"}})
    ).bnb_optimizer is True
    # a mesh over more than one device is read as JAX reads it
    meshed = _write_yaml(tmp_path / "t.yaml", {"mesh": {"fsdp": 2}})
    _same_fields(tconfig.load_train_yaml(meshed), jconfig.load_train_yaml(meshed))
    assert tconfig.load_train_yaml(meshed).mesh.fsdp == 2
    bare = _write_yaml(tmp_path / "bare.yaml", {"mesh": None})
    _same_fields(tconfig.load_train_yaml(bare), jconfig.load_train_yaml(bare))


# ---------------------------------------------------------------------------
# entry points over the UNetT
# ---------------------------------------------------------------------------


def _ref_file(tmp_path, seconds=1.0, sr=24000):
    path = str(tmp_path / "ref.wav")
    tt = np.arange(int(seconds * sr)) / sr
    taudio.write_wav(path, (0.2 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), sr)
    return path


def test_f5tts_from_a_unett_yaml_end_to_end(tmp_path):
    cfg_path = _write_yaml(tmp_path / "e2.yaml", UNETT_YAML)
    tts = tapi.F5TTS(config_file=cfg_path, compute_dtype=torch.float32, device="cpu")
    assert isinstance(tts.engine.arch, UNetTConfig) and tts.model_cfg.name == "tiny_e2"
    assert tts.engine.arch.skip_connect_type == "add"
    assert all("to_qkv" in layer["attn"] for layer in tts.engine.params["first_half"])
    path = _ref_file(tmp_path)
    wav, sr, spec = tts.infer(path, "hi there.", "well hello.", nfe_step=2, seed=7)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all() and spec.shape[1] == 100
    # the reference's loudness keyword is taken, as by the JAX F5TTS, and the
    # engine's InferConfig.target_rms governs either way
    again, _, _ = tts.infer(path, "hi there.", "well hello.", nfe_step=2, seed=7, target_rms=0.05)
    np.testing.assert_array_equal(again, wav)
    # model_cfg overrides reach a UNetT; a reference-layout checkpoint loads by config type
    over = tapi.F5TTS(config_file=cfg_path, model_cfg={"skip_connect_type": "concat"},
                      compute_dtype=torch.float32, device="cpu")
    assert "skip_proj" in over.engine.params["second_half"][0]
    arch_j = JUNetTConfig(**{**TINY, "mel_dim": 100, "skip_connect_type": "add"})
    params_np, _ = junett.init_unett(jax.random.PRNGKey(1), arch_j, 256)
    ckpt = str(tmp_path / "e2.pt")
    torch.save({k: t(v) for k, v in unett_to_torch(jax.tree.map(np.asarray, params_np), {},
                                                   arch_j).items()}, ckpt)
    loaded = tapi.F5TTS(config_file=cfg_path, ckpt_file=ckpt, use_ema=False,
                        compute_dtype=torch.float32, device="cpu")
    want = _flat(tbb.fuse_qkv(unett_from_jax(jax.tree.map(np.asarray, params_np),
                                             loaded.engine.arch), loaded.engine.arch))
    got = _flat(loaded.engine.params)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_f5tts_infer_takes_target_rms_like_jax(tmp_path):
    """The JAX F5TTS.infer accepts target_rms= and leaves it unused; so does
    the port's, on the same tiny YAML."""
    from f5e_tts_tpu.api import F5TTS as JF5TTS
    from f5e_tts_tpu.config import InferConfig as JInferConfig

    tiny = {"model": {"name": "tiny", "backbone": "DiT", "tokenizer": "byte",
                      "arch": {"dim": 32, "depth": 1, "heads": 1, "dim_head": 32, "ff_mult": 2,
                               "mel_dim": 100, "text_dim": 16, "conv_layers": 0,
                               "dropout": 0.0}}}
    cfg_path = _write_yaml(tmp_path / "tiny.yaml", tiny)
    path = _ref_file(tmp_path)
    jtts = JF5TTS(config_file=cfg_path, compute_dtype=jnp.float32)
    jtts.engine.infer_cfg = JInferConfig(nfe_steps=2, max_duration=256)
    jtts.engine.buckets = (128, 256)
    ttts = tapi.F5TTS(config_file=cfg_path, compute_dtype=torch.float32, device="cpu")
    for tts in (jtts, ttts):
        kw = dict(nfe_step=2, seed=3, fix_duration=1.5)
        plain = tts.infer(path, "hi there.", "well hello.", **kw)[0]
        quiet = tts.infer(path, "hi there.", "well hello.", target_rms=0.05, **kw)[0]
        assert np.isfinite(quiet).all()
        np.testing.assert_array_equal(quiet, plain)


def test_trainer_trains_a_unett_on_the_cpu(tmp_path):
    from f5e_tts_tpu_torch.config import TrainConfig
    from f5e_tts_tpu_torch.data import dataset as tdata
    from f5e_tts_tpu_torch.utils.convert import load_state_dict

    arch = UNetTConfig(**{**TINY, "mel_dim": 20})
    mel_cfg = MelConfig(n_fft=256, hop_length=64, win_length=256, n_mel_channels=20,
                        target_sample_rate=8000)
    rng = np.random.default_rng(0)
    rows = [{"audio": {"array": (0.1 * rng.standard_normal(int((0.5 + 0.1 * (i % 5)) * 8000)))
                       .astype(np.float32), "sampling_rate": 8000},
             "text": "abc def gh"[: 4 + i % 6], "duration": 0.5 + 0.1 * (i % 5)} for i in range(6)]
    ds = tdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows], mel=mel_cfg)
    loader = tdata.build_loader(ds, list_str_to_bytes, frames_threshold=300, max_samples=2,
                                len_multiple=32)
    train_cfg = TrainConfig(learning_rate=1e-3, num_warmup_updates=2, save_per_updates=100,
                            last_per_updates=100, save_dir=str(tmp_path / "ckpts"), seed=0)
    model_cfg = ModelConfig(name="tiny_e2", backbone="UNetT", arch=arch, mel=mel_cfg,
                            cfm=CFMConfig())
    logs = []
    trainer = Trainer(model_cfg, train_cfg, vocab_size=256, tokenize=list_str_to_bytes,
                      log_fn=lambda m, u: logs.append(m), device="cpu")
    ts, info = trainer.train(loader, epochs=1, resume=False, max_updates=2)
    assert ts.update == 2 and info["updates"] == 2
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logs)
    # the EMA export is in the reference UNetT layout and re-ingests as the EMA
    sd = load_state_dict(str(tmp_path / "ckpts" / "model_last.pt"))
    assert "transformer.layers.2.0.weight" in sd and "transformer.norm_out.g" in sd
    ema, want = _flat(unett_from_reference_state_dict(sd, arch)), _flat(ts.ema_params)
    assert ema.keys() == want.keys() and all(torch.equal(ema[k], want[k]) for k in want)


def test_cli_runs_a_model_yaml_on_the_cpu(tmp_path, monkeypatch):
    import functools
    import os

    monkeypatch.setattr(tapi, "F5TTS", functools.partial(tapi.F5TTS, compute_dtype=torch.float32))
    cfg_path = _write_yaml(tmp_path / "e2.yaml", UNETT_YAML)
    path = _ref_file(tmp_path)
    out_dir = str(tmp_path / "out")
    out = tcli.main(["-r", path, "-s", "hello there", "-t", "Hi.", "-o", out_dir, "-w", "o.wav",
                     "--nfe_step", "2", "--model_cfg", cfg_path, "--device", "cpu"])
    assert out == os.path.join(out_dir, "o.wav")
    wav, sr = taudio.read_wav(out)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    with pytest.raises(SystemExit, match="ASR weights not found at whisper"):
        tcli.main(["-r", path, "-t", "x", "--device", "cpu", "--asr_model", "whisper"])


# ---------------------------------------------------------------------------
# the duration predictor
# ---------------------------------------------------------------------------


def test_duration_predictor_and_style_encoder_match_jax():
    rng = np.random.default_rng(0)
    scfg = jdur.StyleEncoderConfig(n_mel_channels=10, style_hidden=16, style_vector_dim=12)
    dcfg = jdur.DurPredConfig(in_channels=8, filter_channels=16, style_vector_dim=12)
    sp = jax.tree.map(np.asarray, jdur.init_style_encoder(jax.random.PRNGKey(0), scfg))
    dp = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                      .astype(np.float32), jdur.init_duration_predictor(jax.random.PRNGKey(1),
                                                                          dcfg))
    mel = rng.standard_normal((2, 20, 10)).astype(np.float32)
    mel_lens = np.asarray([20, 13], np.int32)
    x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    x_mask = np.arange(7)[None, :] < np.asarray([7, 5])[:, None]
    tscfg = tdur.StyleEncoderConfig(**dataclasses.asdict(scfg))
    tdcfg = tdur.DurPredConfig(**dataclasses.asdict(dcfg))
    for lens in (mel_lens, None):
        want = jdur.style_encoder(sp, scfg, jnp.asarray(mel),
                                  None if lens is None else jnp.asarray(lens))
        got = tdur.style_encoder(to_tensors(sp), tscfg, t(mel), None if lens is None else t(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    style = np.asarray(want)
    want = jdur.duration_predictor(dp, dcfg, jnp.asarray(x), jnp.asarray(x_mask),
                                   jnp.asarray(style))
    got = tdur.duration_predictor(to_tensors(dp), tdcfg, t(x), t(x_mask), t(style))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    dur = np.asarray([[2, 3, 1, 0], [1, 1, 4, 2]], np.int32)
    mask = np.ones((2, 4, 9), np.float32)
    mask[1, 3] = 0.0
    np.testing.assert_array_equal(tdur.generate_path(t(dur), t(mask)).numpy(),
                                  np.asarray(jdur.generate_path(jnp.asarray(dur), jnp.asarray(mask))))
    logw, logw_hat = rng.standard_normal((2, 4)), rng.standard_normal((2, 4))
    np.testing.assert_allclose(
        tdur.duration_loss(t(logw), t(logw_hat), torch.tensor([4, 3])).item(),
        float(jdur.duration_loss(jnp.asarray(logw), jnp.asarray(logw_hat), jnp.asarray([4, 3]))),
        rtol=1e-6)
    # init shapes follow the JAX init
    for got_p, want_p in ((tdur.init_style_encoder(tscfg, torch.Generator()), sp),
                          (tdur.init_duration_predictor(tdcfg, torch.Generator()), dp)):
        assert {k: tuple(v.shape) for k, v in _flat(got_p).items()} == \
            {k: tuple(v.shape) for k, v in _flat(to_tensors(want_p)).items()}
