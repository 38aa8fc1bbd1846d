"""The training leftovers in the port against the JAX package on the CPU:
8-bit AdamW, the YAML training CLI and what it reads.

- `AdamW8bit` against `f5e_tts_tpu.train.adamw8bit.adamw8bit` over three
  updates with the same gradients and a warm-up schedule: int8 codes within
  1, scales at rtol 1e-5, params at atol 1e-6; `state_bytes` equal to JAX's,
  and under 0.3x the fp32 AdamW state's for a model-sized tensor.
- `load_train_yaml` field by field on a YAML with bnb_optimizer, sample
  batches, a logger and a sample cadence; `make_optimizer` takes 8-bit
  AdamW when `bnb_optimizer` is set.
- `build_loader(batch_size_type="sample")` over `ArrowSpeechDataset(
  preprocessed_mel=True)`: the JAX loader's batches exactly.
- `Trainer.init_state(pretrained_path=)`: the params and the EMA equal the
  file's EMA weights exactly; the sample hook (`make_sample_logger`) writes
  update_N_gen_mel.npy every log_samples_per_updates updates.
- `train.main` end to end with --device cpu over a tiny YAML and an on-disk
  Arrow dataset (the recipe of tests/test_train_cli.py), both CLIs starting
  from the same --pretrained checkpoint in fp32 with the JAX step's draws:
  the loss of the first update within 1e-5 relative of the JAX CLI's; a
  resumed run continues at the next update; and the run with bnb_optimizer.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f5e_tts_tpu import config as jconfig
from f5e_tts_tpu.data import dataset as jdata
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.train import adamw8bit as j8
from f5e_tts_tpu.utils.torch_ckpt import dit_to_torch
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.data import dataset as tdata
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.train import adamw8bit as t8
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train import trainer as ttrainer
from f5e_tts_tpu_torch.utils.convert import dit_from_reference_state_dict, load_state_dict


def _sched_j(count):
    return 1e-3 + 9e-3 * jnp.minimum(count, 10) / 10


def _sched_t(count):
    return 1e-3 + 9e-3 * min(count, 10) / 10


def test_adamw8bit_matches_jax():
    rng = np.random.default_rng(0)
    p0 = {"b": rng.standard_normal(32).astype(np.float32),
          "w": rng.standard_normal((64, 130)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (1 + i)).astype(np.float32)
              for k, v in p0.items()} for i in range(3)]
    opt = j8.adamw8bit(_sched_j, weight_decay=0.01)
    pj = jax.tree.map(jnp.asarray, p0)
    st = opt.init(pj)
    for g in grads:
        up, st = opt.update(jax.tree.map(jnp.asarray, g), st, pj)
        pj = optax.apply_updates(pj, up)

    pt = [torch.from_numpy(p0[k].copy()) for k in ("b", "w")]
    optimizer = t8.AdamW8bit(_sched_t, max_grad_norm=float("inf"), weight_decay=0.01)
    state = optimizer.init(pt)
    for g in grads:
        assert optimizer.update_(state, pt, [torch.from_numpy(g[k]) for k in ("b", "w")])
    assert state.count == 3
    for i, k in enumerate(("b", "w")):
        np.testing.assert_allclose(pt[i].numpy(), np.asarray(pj[k]), rtol=0, atol=1e-6)
        for got, want in ((state.mu[i], st.mu[k]), (state.nu[i], st.nu[k])):
            if k == "b":  # under min_quantize_size: fp32 moments
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
                continue
            assert got["codes"].dtype == torch.int8
            diff = got["codes"].numpy().astype(np.int32) - np.asarray(want.codes).astype(np.int32)
            assert np.abs(diff).max() <= 1
            np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want.scale), rtol=1e-5)
    assert t8.state_bytes(state) == j8.state_bytes(st)
    big = [torch.zeros(1024, 768)]
    fp32 = tstep.AdamW(_sched_t, 1.0).init(big)
    assert t8.state_bytes(optimizer.init(big)) < 0.3 * t8.state_bytes(fp32)


YAML = """
datasets:
  name: Toy
  batch_size_per_gpu: 300
  batch_size_type: frame
  max_samples: 2

optim:
  epochs: 1
  learning_rate: 1.0e-3
  num_warmup_updates: 2
  grad_accumulation_steps: 1
  max_grad_norm: 1.0

model:
  name: tiny
  tokenizer: char
  backbone: DiT
  arch:
    dim: 32
    depth: 1
    heads: 1
    dim_head: 32
    ff_mult: 2
    mel_dim: 8
    text_dim: 16
    conv_layers: 0
    dropout: 0.0
  mel_spec:
    target_sample_rate: 8000
    n_mel_channels: 8
    hop_length: 64
    win_length: 256
    n_fft: 256
    mel_spec_type: vocos

ckpts:
  save_per_updates: 100
  last_per_updates: 2
  keep_last_n_checkpoints: 2
  save_dir: {save_dir}

mesh:
  data: 1
"""


def _write_yaml(path, save_dir, **replace):
    text = YAML.format(save_dir=save_dir)
    for old, new in replace.items():
        text = text.replace(old, new)
    path.write_text(text)
    return str(path)


def test_load_train_yaml_and_make_optimizer(tmp_path):
    path = _write_yaml(tmp_path / "t.yaml", "run", **{
        "batch_size_type: frame": "batch_size_type: sample",
        "max_grad_norm: 1.0": "max_grad_norm: 1.0\n  bnb_optimizer: true",
        "save_per_updates: 100": "save_per_updates: 100\n  logger: tensorboard\n"
                                 "  log_samples_per_updates: 3"})
    got, want = tconfig.load_train_yaml(path), jconfig.load_train_yaml(path)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.bnb_optimizer, got.batch_size_type, got.logger, got.log_samples_per_updates) == (
        True, "sample", "tensorboard", 3)
    assert isinstance(tstep.make_optimizer(got, 10), t8.AdamW8bit)
    assert type(tstep.make_optimizer(dataclasses.replace(got, bnb_optimizer=False), 10)) is \
        tstep.AdamW


MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=8, target_sample_rate=8000)


def test_sample_batches_over_preprocessed_mel_match_jax():
    rng = np.random.default_rng(1)
    rows = []
    for i in range(7):
        n = 40 + 9 * i
        mel = rng.standard_normal((8, n) if i % 2 else (n, 8)).astype(np.float32)
        rows.append({"mel_spec": mel, "text": "abc def"[: 3 + i % 4],
                     "duration": n * 64 / 8000})
    durs = [r["duration"] for r in rows]
    tok = lambda texts: np.asarray([[ord(c) for c in t.ljust(8)] for t in texts], np.int32)  # noqa
    kw = dict(frames_threshold=300, max_samples=3, seed=5, len_multiple=16,
              batch_size_type="sample")
    lt = tdata.build_loader(tdata.ArrowSpeechDataset(rows, durs, tconfig.MelConfig(**MEL_KW),
                                                     preprocessed_mel=True), tok, **kw)
    lj = jdata.build_loader(jdata.ArrowSpeechDataset(rows, durs, jconfig.MelConfig(**MEL_KW),
                                                     preprocessed_mel=True), tok, **kw)
    assert lt.sampler.batches == lj.sampler.batches and len(lt) == 3
    for epoch in (0, 1):
        lt.sampler.set_epoch(epoch)
        lj.sampler.set_epoch(epoch)
        for bt, bj in zip(lt, lj):
            assert sorted(bt) == sorted(bj) and "mel" in bt
            for k in bj:
                np.testing.assert_array_equal(bt[k], bj[k])


def _make_dataset_dir(root, name="Toy", tokenizer="char", n=6, sr=8000):
    """data/{name}_{tokenizer}/ with raw/ (Arrow rows), duration.json, vocab.txt."""
    from datasets import Dataset as ArrowDataset

    ds_dir = os.path.join(root, f"{name}_{tokenizer}")
    os.makedirs(ds_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    rows, durations = [], []
    for i in range(n):
        dur = 0.5 + 0.1 * (i % 3)
        rows.append({"audio": {"array": (0.1 * rng.standard_normal(int(dur * sr)))
                               .astype(np.float32), "sampling_rate": sr},
                     "text": "abc def gh"[: 4 + i % 5], "duration": dur})
        durations.append(dur)
    ArrowDataset.from_list(rows).save_to_disk(os.path.join(ds_dir, "raw"))
    with open(os.path.join(ds_dir, "duration.json"), "w") as f:
        json.dump({"duration": durations}, f)
    with open(os.path.join(ds_dir, "vocab.txt"), "w") as f:
        f.write(" \n" + "\n".join("abcdefgh") + "\n")
    return ds_dir


def _pretrained(tmp_path, arch_j, vocab=10):
    """A reference-layout EMA checkpoint of the JAX init with perturbed
    weights (AdaLN-zero would leave the blocks identities)."""
    from safetensors.numpy import save_file

    params, _ = jdit.init_dit(jax.random.PRNGKey(3), arch_j, vocab)
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                          .astype(np.float32), params)
    sd = {f"ema_model.{k}": np.ascontiguousarray(v) for k, v in
          dit_to_torch(params, {}, arch_j).items()}
    path = str(tmp_path / "pretrained.safetensors")
    save_file(sd, path)
    return path


def test_init_state_pretrained_and_sample_hook(tmp_path):
    yaml_path = _write_yaml(tmp_path / "t.yaml", str(tmp_path / "run"))
    model_cfg, train_cfg = tconfig.load_yaml(yaml_path), tconfig.load_train_yaml(yaml_path)
    ckpt = _pretrained(tmp_path, jconfig.load_yaml(yaml_path).arch, vocab=256)
    train_cfg = dataclasses.replace(train_cfg, log_samples_per_updates=2, compute_dtype="float32")
    ref_mel = np.random.default_rng(5).standard_normal((20, 8)).astype(np.float32)
    sample_fn = ttrainer.make_sample_logger(model_cfg, None, "byte", train_cfg.save_dir, "hello",
                                            ref_mel, "abc", nfe=2, device="cpu")
    tok = lambda texts: np.asarray([list(t.encode().ljust(10)) for t in texts], np.int32)  # noqa
    trainer = ttrainer.Trainer(model_cfg, train_cfg, vocab_size=256, tokenize=tok, device="cpu",
                               sample_fn=sample_fn)
    ts = trainer.init_state(4, pretrained_path=ckpt)
    want = dit_from_reference_state_dict(load_state_dict(ckpt), model_cfg.arch)
    for tree in (ts.params, ts.ema_params):
        for got, w in zip(tstep.tree_leaves(tree), tstep.tree_leaves(want)):
            assert torch.equal(got.detach(), w)
    rows = [{"audio": {"array": np.random.default_rng(i).standard_normal(4000).astype(np.float32)
                       * 0.1, "sampling_rate": 8000}, "text": "abcd", "duration": 0.5}
            for i in range(4)]
    loader = tdata.build_loader(tdata.ArrowSpeechDataset(rows, [0.5] * 4, model_cfg.mel), tok,
                                frames_threshold=130, max_samples=1, len_multiple=32)
    ts, _ = trainer.train(loader, resume=False, max_updates=4)
    written = sorted(n for n in os.listdir(train_cfg.save_dir) if n.endswith("_gen_mel.npy"))
    assert written == ["update_2_gen_mel.npy", "update_4_gen_mel.npy"]
    mel = np.load(os.path.join(train_cfg.save_dir, written[0]))
    assert mel.shape == (20, 8) and np.isfinite(mel).all()


def _draws(key, b, n, mel_dim, cfm):
    """The draws of f5e_tts_tpu.models.cfm.cfm_loss for `key`, in its split order."""
    r_frac, r_span, r_time, r_noise, r_drop1, r_drop2, _ = jax.random.split(key, 7)
    lo, hi = cfm.frac_lengths_mask
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return tcfm.LossDraws(
        frac=t(jax.random.uniform(r_frac, (b,), minval=lo, maxval=hi)),
        span=t(jax.random.uniform(r_span, (b,))),
        x0=t(jax.random.normal(r_noise, (b, n, mel_dim), jnp.float32)),
        time=t(jax.random.uniform(r_time, (b,), jnp.float32)),
        u1=t(jax.random.uniform(r_drop1)), u2=t(jax.random.uniform(r_drop2)))


def test_train_cli_matches_jax_cli(tmp_path, monkeypatch):
    from f5e_tts_tpu.train import train as jtrain_cli
    from f5e_tts_tpu.train import trainer as jtrainer
    from f5e_tts_tpu_torch.train import train as ttrain_cli

    data_dir = str(tmp_path / "data")
    _make_dataset_dir(data_dir)
    y_j = _write_yaml(tmp_path / "j.yaml", str(tmp_path / "run_j"))
    y_t = _write_yaml(tmp_path / "t.yaml", str(tmp_path / "run_t"))
    ckpt = _pretrained(tmp_path, jconfig.load_yaml(y_j).arch)
    seen = {"jax": [], "port": []}
    # both CLIs in fp32 (the YAML has no compute dtype)
    monkeypatch.setattr(jconfig, "load_train_yaml", lambda p: dataclasses.replace(
        _jl(p), compute_dtype="float32"))
    monkeypatch.setattr(tconfig, "load_train_yaml", lambda p: dataclasses.replace(
        _tl(p), compute_dtype="float32"))

    class JRecording(jtrainer.Trainer):
        def __post_init__(self):
            inner = self.log_fn
            self.log_fn = lambda m, u: (seen["jax"].append((u, m["loss"])), inner(m, u))
            super().__post_init__()

    class TRecording(ttrainer.Trainer):
        def __post_init__(self):
            inner = self.log_fn
            self.log_fn = lambda m, u: (seen["port"].append((u, m["loss"])), inner(m, u))
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
    args = ["--data_dir", data_dir, "--max_updates", "1", "--no_resume", "--pretrained", ckpt]
    jtrain_cli.main(["--config", y_j, *args])
    ts = ttrain_cli.main(["--config", y_t, *args, "--device", "cpu"])
    assert ts.update == 1 and [u for u, _ in seen["port"]] == [1]
    np.testing.assert_allclose(seen["port"][0][1], seen["jax"][0][1], rtol=1e-5)
    assert os.path.exists(tmp_path / "run_t" / "model_last.pt")

    # resume: the next run continues at update 2, then 8-bit AdamW trains too
    ts = ttrain_cli.main(["--config", y_t, "--data_dir", data_dir, "--max_updates", "2",
                          "--device", "cpu"])
    assert ts.update == 2 and [u for u, _ in seen["port"]] == [1, 2]
    y_8 = _write_yaml(tmp_path / "8.yaml", str(tmp_path / "run_8"), **{
        "max_grad_norm: 1.0": "max_grad_norm: 1.0\n  bnb_optimizer: true"})
    ts = ttrain_cli.main(["--config", y_8, "--data_dir", data_dir, "--max_updates", "2",
                          "--no_resume", "--device", "cpu"])
    assert ts.update == 2 and isinstance(ts.opt_state.nu[0], (dict, torch.Tensor))
    assert all(np.isfinite(loss) for _, loss in seen["port"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain_cli.main(["--config", y_8, "--data_dir", data_dir, "--max_updates", "1"])


_jl, _tl = jconfig.load_train_yaml, tconfig.load_train_yaml


def test_train_cli_on_a_ppg_yaml_trains_on_zero_ppg_and_needs_ppg_lengths_for_a_codebook(
        tmp_path):
    """The CLIs build the Trainer without a PPG extractor: a use_ppg YAML
    trains on zero PPG, and with the codebook on the step needs the PPG
    lengths no batch carries, so both packages' CLIs fail there (JAX's
    assert in dit_forward, the port's ValueError)."""
    import yaml

    from f5e_tts_tpu.train import train as jtrain_cli
    from f5e_tts_tpu_torch.train import train as ttrain_cli

    data_dir = str(tmp_path / "data")
    _make_dataset_dir(data_dir)
    for codebook in (False, True):
        path = _write_yaml(tmp_path / f"p{codebook}.yaml", str(tmp_path / f"run{codebook}"))
        raw = yaml.safe_load(open(path))
        raw["model"].update(use_ppg=True, use_codebook=codebook,
                            ppg_config={"dim": 16, "frame_length": 20, "mel_frame_shift": 10},
                            codebook_config={"num_vars": 10, "groups": 2, "codebook_prob": 0.1,
                                             "codebook_loss_weight": 0.1})
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        args = ["--config", path, "--data_dir", data_dir, "--max_updates", "1", "--no_resume"]
        if codebook:
            with pytest.raises(AssertionError):
                jtrain_cli.main(args)
            with pytest.raises(ValueError, match="text_len and ppg_len"):
                ttrain_cli.main(args + ["--device", "cpu"])
        else:
            ts = ttrain_cli.main(args + ["--device", "cpu"])
            assert ts.update == 1 and "ppg_bn" in ts.model_state
