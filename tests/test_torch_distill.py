"""CFG distillation in the port against the JAX package on the CPU: the
loss, `init_distill` / `make_distill_step`, the Trainer's teacher route and
the distillation and finetune CLIs, on a tiny DiT (dim 32, depth 2, 2 x 16
heads, mel 8), fp32, dropout 0, with the JAX step's draws injected (torch
cannot reproduce JAX's PRNG streams; the test repeats the JAX split order of
f5e_tts_tpu/train/distill.py:80-81 and cfm.py:410-429 on the same key).

- `cfg_distill_loss` at cfg 2: the loss (rtol 1e-5), the teacher's flow
  (atol 1e-5) and every student gradient (atol 1e-5 * max|grad| + rtol
  1e-3, as tests/test_torch_training.py) against `jax.value_and_grad`; at
  cfg 0 with the student the teacher, the loss is under 1e-10 in both and
  every gradient under 1e-6.
- `make_distill_step` over `init_distill` (the Trainer's update on a
  TrainState): three SGD steps of lr 0.1 against the same steps over
  JAX's gradients (what JAX's make_distill_step does with optax.sgd):
  losses rtol 1e-5, params atol 2e-6; the student is a copy and the
  teacher's tensors stay bitwise unchanged.
- `distill_cli.main` (--device cpu) through `Trainer.set_teacher` (a
  checkpoint path in both packages) and the distill route against the JAX
  CLI and Trainer in distill mode (tests/test_distill.py:100,
  tests/test_train_cli.py:127), over the same data, checkpoint and draws:
  two updates at cfg 2, the losses within 1e-5 relative, then 1e-4 after
  an update; the teacher bit for bit the file's weights after the steps,
  sharing no storage with the student; the student's model_last re-ingests.
- `finetune_cli.main` (--device cpu) against the JAX CLI: the first loss
  within 1e-5 relative; the run
  copies pretrained_* into ckpts/<dataset>/ of the working directory and
  trains with 8-bit AdamW under --bnb_optimizer. Without a card each CLI
  raises unless asked for the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu import config as jconfig
from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.train import distill as jdist
from f5e_tts_tpu.utils.torch_ckpt import dit_to_torch
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.train import distill as tdist
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train import trainer as ttrainer
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, dit_from_reference_state_dict,
                                             load_state_dict)

TINY = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=8, text_dim=16,
            conv_layers=1, dropout=0.0)
VOCAB = 12
B, N = 3, 24
t = torch.from_numpy


def _randomized(tree, seed, scale=0.0):
    """numpy copy of a JAX tree; zero leaves (AdaLN-zero, proj_out) get seeded
    values so every weight shapes the flow, and with `scale` every leaf is
    perturbed by that much noise."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        if not a.any():
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def model():
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**TINY), VOCAB)
    teacher = _randomized(params, 1)
    student = _randomized(params, 2, scale=0.05)
    return JDiTConfig(**TINY), DiTConfig(**TINY), teacher, student


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, N, TINY["mel_dim"])).astype(np.float32)
    ids = rng.integers(0, VOCAB, (B, 7)).astype(np.int32)
    ids[2, 5:] = -1
    return mel, np.asarray([N, 20, 16], np.int32), ids


def distill_draws(key, b, n, mel_dim, cfm) -> tcfm.LossDraws:
    """The draws of f5e_tts_tpu.train.distill.cfg_distill_loss for `key`."""
    r_frac, r_span, r_time, r_noise, _ = jax.random.split(key, 5)
    lo, hi = cfm.frac_lengths_mask
    a = lambda x: t(np.array(x))  # noqa: E731
    return tcfm.LossDraws(frac=a(jax.random.uniform(r_frac, (b,), minval=lo, maxval=hi)),
                          span=a(jax.random.uniform(r_span, (b,))),
                          x0=a(jax.random.normal(r_noise, (b, n, mel_dim), jnp.float32)),
                          time=a(jax.random.uniform(r_time, (b,), jnp.float32)))


def _close_trees(got, want, rtol, atol_frac):
    for g, w in zip(tstep.tree_leaves(got), tstep.tree_leaves(want)):
        w = w.numpy()
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=rtol,
                                   atol=atol_frac * max(np.abs(w).max(), 1e-12))


@pytest.fixture(scope="module")
def jax_distill(model):
    """jit(value_and_grad) of JAX's cfg_distill_loss on `_batch()`, with the
    student, the teacher, the key and the guidance as arguments: one compile
    serves every case below."""
    arch_j = model[0]
    mel, lens, ids = _batch()

    def loss_fn(sp, tp, key, cfg):
        out = jdist.cfg_distill_loss(sp, tp, {}, arch_j, JCFMConfig(), mel=jnp.asarray(mel),
                                     mel_lens=jnp.asarray(lens), text_ids=jnp.asarray(ids),
                                     rng=key, cfg_strength=cfg, training=True,
                                     compute_dtype=jnp.float32)
        return out.loss, out.teacher_flow

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return lambda sp, tp, key, cfg: fn(sp, tp, key, jnp.float32(cfg))


@pytest.mark.parametrize("cfg", [2.0, 0.0])
def test_cfg_distill_loss_flow_and_grads_match_jax(model, jax_distill, cfg):
    """At cfg 0 the student is the teacher: its single pass is the target,
    so the loss is under 1e-10 in both packages (tests/test_distill.py:40)."""
    arch_j, arch_t, teacher, student = model
    if cfg == 0.0:
        student = teacher
    mel, lens, ids = _batch()
    key = jax.random.PRNGKey(7)
    (want, flow_j), grads_j = jax_distill(student, teacher, key, cfg)
    sp = tstep.tree_map(lambda x: x.requires_grad_(True), dit_from_jax(student, arch_t))
    tp = dit_from_jax(teacher, arch_t)
    out = tdist.cfg_distill_loss(sp, tp, arch_t, CFMConfig(), mel=t(mel), mel_lens=t(lens),
                                 text_ids=t(ids), draws=distill_draws(key, B, N, 8, JCFMConfig()),
                                 cfg_strength=cfg, training=True, compute_dtype=torch.float32)
    out.loss.backward()
    np.testing.assert_allclose(out.teacher_flow.numpy(), np.asarray(flow_j), atol=1e-5)
    assert not out.teacher_flow.requires_grad
    assert all(p.grad is None for p in tstep.tree_leaves(tp))
    grads_t = tstep.tree_map(lambda x: x.grad, sp)
    if cfg == 0.0:
        assert float(want) < 1e-10 and out.loss.item() < 1e-10
        assert max(g.abs().max().item() for g in tstep.tree_leaves(grads_t)) < 1e-6
        return
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    _close_trees(grads_t, dit_from_jax(jax.tree.map(np.asarray, grads_j), arch_t), 1e-3, 1e-5)


class _SGD:
    """Plain SGD in the optimizer interface `make_distill_step` takes: the
    step is lr x the gradient, so the params hold the gradients' parity
    (Adam would divide near-zero gradients by their own magnitude)."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update_(self, state, params, grads):
        torch._foreach_add_(params, grads, alpha=-self.lr)
        return True


def test_make_distill_step_matches_jax_and_keeps_the_teacher(model, jax_distill):
    """Three SGD steps of lr 0.1 from the teacher, each on `_batch()` under a
    key of its own, against the same steps over JAX's gradients (what
    JAX's make_distill_step does with optax.sgd)."""
    arch_j, arch_t, teacher, _ = model
    sp_j = jax.tree.map(jnp.asarray, teacher)
    tp = dit_from_jax(teacher, arch_t)
    before = [x.clone() for x in tstep.tree_leaves(tp)]
    opt_t = _SGD(0.1)
    ds_t = tdist.init_distill(tp, opt_t)
    assert not any(a.data_ptr() == b.data_ptr() for a, b in
                   zip(tstep.tree_leaves(ds_t.params), tstep.tree_leaves(tp)))
    step_t = tdist.make_distill_step(tp, arch_t, CFMConfig(), opt_t, cfg_strength=2.0,
                                     compute_dtype=torch.float32)
    mel, lens, ids = _batch()
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        (loss_j, _), grads_j = jax_distill(sp_j, teacher, key, 2.0)
        sp_j = jax.tree.map(lambda p, g: p - 0.1 * g, sp_j, grads_j)
        ds_t, m = step_t(ds_t, t(mel), t(lens), t(ids),
                         draws=distill_draws(key, B, N, 8, JCFMConfig()))
        np.testing.assert_allclose(m.loss, float(loss_j), rtol=1e-5)
    assert ds_t.update == 3
    for g, w in zip(tstep.tree_leaves(ds_t.params),
                    tstep.tree_leaves(dit_from_jax(jax.tree.map(np.asarray, sp_j), arch_t))):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=2e-6)
    assert all(torch.equal(a, b) for a, b in zip(tstep.tree_leaves(tp), before))


# ---------------------------------------------------------------------------
# the Trainer's teacher route and the CLIs
# ---------------------------------------------------------------------------

MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=8, target_sample_rate=8000)


def _checkpoint(path, params_np, arch_j):
    from safetensors.numpy import save_file

    save_file({f"ema_model.{k}": np.ascontiguousarray(v)
               for k, v in dit_to_torch(params_np, {}, arch_j).items()}, str(path))
    return str(path)


def _rows(n=6, sr=8000):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        dur = 0.5 + 0.1 * (i % 3)
        rows.append({"audio": {"array": (0.1 * rng.standard_normal(int(dur * sr)))
                               .astype(np.float32), "sampling_rate": sr},
                     "text": "abc def gh"[: 4 + i % 5], "duration": dur})
    return rows


def _jax_key_draws(seed, b, n, cfm, distill=True):
    """draws(ts) of the JAX Trainer's step for (micro + skipped) of ts."""
    def draws(ts):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ts.micro + ts.skipped)
        if distill:
            return distill_draws(key, b, n, 8, cfm)
        r_frac, r_span, r_time, r_noise, r_d1, r_d2, _ = jax.random.split(key, 7)
        lo, hi = cfm.frac_lengths_mask
        a = lambda x: t(np.array(x))  # noqa: E731
        return tcfm.LossDraws(frac=a(jax.random.uniform(r_frac, (b,), minval=lo, maxval=hi)),
                              span=a(jax.random.uniform(r_span, (b,))),
                              x0=a(jax.random.normal(r_noise, (b, n, 8), jnp.float32)),
                              time=a(jax.random.uniform(r_time, (b,), jnp.float32)),
                              u1=a(jax.random.uniform(r_d1)), u2=a(jax.random.uniform(r_d2)))
    return draws


def _recording(base, seen, draws_of=None):
    """A Trainer subclass that logs (update, loss) into `seen` and, with
    `draws_of`, injects the JAX step's draws (the batch's shape decides b, n)."""

    class Recording(base):
        def __post_init__(self):
            inner = self.log_fn
            self.log_fn = lambda m, u: (seen.append((u, m["loss"])), inner and inner(m, u))
            super().__post_init__()

        if draws_of is not None:
            def make_step(self):
                step, seed, cfm = super().make_step(), self.train_cfg.seed, self.cfm

                def with_jax_draws(ts, batch, generator, draws=None):
                    b, n = batch["audio"].shape[0], batch["audio"].shape[1] // 64
                    return step(ts, batch, generator, draws_of(seed, b, n, cfm)(ts))

                return with_jax_draws

    return Recording


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
    depth: 2
    heads: 2
    dim_head: 16
    ff_mult: 2
    mel_dim: 8
    text_dim: 16
    conv_layers: 1
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
  last_per_updates: 100
  keep_last_n_checkpoints: 2
  save_dir: {save_dir}

mesh:
  data: 1
"""


def _dataset_dir(root, name="Toy", tokenizer="char"):
    """{root}/{name}_{tokenizer}/ with raw/ (Arrow rows), duration.json and a
    char vocab.txt of 12 symbols."""
    from datasets import Dataset as ArrowDataset

    ds_dir = os.path.join(root, f"{name}_{tokenizer}")
    os.makedirs(ds_dir, exist_ok=True)
    rows = _rows()
    ArrowDataset.from_list(rows).save_to_disk(os.path.join(ds_dir, "raw"))
    with open(os.path.join(ds_dir, "duration.json"), "w") as f:
        json.dump({"duration": [r["duration"] for r in rows]}, f)
    with open(os.path.join(ds_dir, "vocab.txt"), "w") as f:
        f.write(" \n" + "\n".join("abcdefghijk") + "\n")
    return ds_dir


_jl, _tl = jconfig.load_train_yaml, tconfig.load_train_yaml


def test_trainer_set_teacher_and_distill_cli_match_the_jax_cli(tmp_path, model, monkeypatch):
    """distill_cli.main -> Trainer.set_teacher(checkpoint path) and the
    distill route, in both packages from the same teacher file, the student
    starting from it: two updates at cfg 2 with the JAX step's draws."""
    from f5e_tts_tpu.train import distill_cli as jcli
    from f5e_tts_tpu.train import trainer as jtrainer
    from f5e_tts_tpu_torch.train import distill_cli as tcli

    arch_j, arch_t, teacher, _ = model
    data_dir = str(tmp_path / "data")
    _dataset_dir(data_dir)
    ckpt = _checkpoint(tmp_path / "teacher.safetensors", teacher, arch_j)
    y_j, y_t = tmp_path / "j.yaml", tmp_path / "t.yaml"
    y_j.write_text(YAML.format(save_dir=tmp_path / "run_j"))
    y_t.write_text(YAML.format(save_dir=tmp_path / "run_t"))
    monkeypatch.setattr(jconfig, "load_train_yaml",
                        lambda p: dataclasses.replace(_jl(p), compute_dtype="float32"))
    monkeypatch.setattr(tconfig, "load_train_yaml",
                        lambda p: dataclasses.replace(_tl(p), compute_dtype="float32"))
    seen_j, seen_t = [], []
    monkeypatch.setattr(jtrainer, "Trainer", _recording(jtrainer.Trainer, seen_j))
    trainers = []

    class Kept(_recording(ttrainer.Trainer, seen_t, _jax_key_draws)):
        def set_teacher(self, teacher, cfg_strength=None):
            super().set_teacher(teacher, cfg_strength)
            trainers.append(self)
            self.kept = [x.clone() for x in tstep.tree_leaves(self.teacher_params)]

    monkeypatch.setattr(ttrainer, "Trainer", Kept)
    args = ["--data_dir", data_dir, "--teacher", ckpt, "--max_updates", "2", "--no_resume",
            "--cfg_strength", "2.0"]
    jcli.main(["--config", str(y_j), *args])
    ts = tcli.main(["--config", str(y_t), *args, "--device", "cpu"])
    assert ts.update == 2 and [u for u, _ in seen_t] == [1, 2]
    np.testing.assert_allclose(seen_t[0][1], seen_j[0][1], rtol=1e-5)
    np.testing.assert_allclose(seen_t[1][1], seen_j[1][1], rtol=1e-4)
    # the teacher: bit for bit the file's EMA weights after the steps, a copy
    # that shares no storage with the student
    tr = trainers[0]
    assert tr.distill_cfg_strength == 2.0
    assert all(torch.equal(a, b) for a, b in zip(tstep.tree_leaves(tr.teacher_params), tr.kept))
    want = dit_from_reference_state_dict(load_state_dict(ckpt, use_ema=True), arch_t)
    assert all(torch.equal(a, b) for a, b in zip(tstep.tree_leaves(tr.teacher_params),
                                                 tstep.tree_leaves(want)))
    ptrs = {x.data_ptr() for x in tstep.tree_leaves(ts.params)}
    assert not any(x.data_ptr() in ptrs for x in tstep.tree_leaves(tr.teacher_params))
    student = dit_from_reference_state_dict(
        load_state_dict(str(tmp_path / "run_t" / "model_last.pt"), use_ema=True), arch_t)
    assert all(torch.isfinite(v).all() for v in tstep.tree_leaves(student))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--config", str(y_t), *args])


def test_finetune_cli_matches_the_jax_cli(tmp_path, model, monkeypatch):
    from f5e_tts_tpu.train import finetune_cli as jcli
    from f5e_tts_tpu.train import trainer as jtrainer
    from f5e_tts_tpu_torch.train import finetune_cli as tcli
    from f5e_tts_tpu_torch.train.adamw8bit import AdamW8bit

    arch_j, arch_t, _, _ = model
    data_dir = str(tmp_path / "data")
    _dataset_dir(data_dir, tokenizer="byte")
    params, _ = jdit.init_dit(jax.random.PRNGKey(3), arch_j, 256)  # the byte vocabulary
    ckpt = _checkpoint(tmp_path / "model_9.safetensors", _randomized(params, 4), arch_j)
    # the finetune presets cut to the tiny DiT, the step in fp32
    monkeypatch.setattr(jconfig, "preset", lambda name: jconfig.ModelConfig(
        name=name, backbone="DiT", arch=arch_j, mel=jconfig.MelConfig(**MEL_KW)))
    monkeypatch.setattr(tconfig, "preset", lambda name: tconfig.ModelConfig(
        name=name, backbone="DiT", arch=arch_t, mel=tconfig.MelConfig(**MEL_KW)))
    monkeypatch.setattr(jconfig, "TrainConfig", functools.partial(
        jconfig.TrainConfig, compute_dtype="float32",
        mesh=jconfig.MeshConfig(data=1, model=1, seq=1)))
    monkeypatch.setattr(tconfig, "TrainConfig",
                        functools.partial(tconfig.TrainConfig, compute_dtype="float32"))
    seen_j, seen_t = [], []
    monkeypatch.setattr(jtrainer, "Trainer", _recording(jtrainer.Trainer, seen_j))
    monkeypatch.setattr(ttrainer, "Trainer",
                        _recording(ttrainer.Trainer, seen_t,
                                   functools.partial(_jax_key_draws, distill=False)))
    args = ["--dataset_name", "Toy", "--data_dir", data_dir, "--tokenizer", "byte", "--finetune",
            "--pretrain", ckpt, "--learning_rate", "1e-3", "--batch_size_per_gpu", "300",
            "--max_samples", "2", "--num_warmup_updates", "2", "--epochs", "1",
            "--max_updates", "1"]
    for sub in ("j", "t", "t8"):
        (tmp_path / sub).mkdir()
    monkeypatch.chdir(tmp_path / "j")
    jcli.main(args)
    monkeypatch.chdir(tmp_path / "t")
    ts = tcli.main(args + ["--device", "cpu"])
    run = tmp_path / "t" / "ckpts" / "Toy"
    assert ts.update == 1 and (run / "pretrained_model_9.safetensors").exists()
    assert (run / "model_last.pt").exists()
    np.testing.assert_allclose(seen_t[0][1], seen_j[0][1], rtol=1e-5)
    monkeypatch.chdir(tmp_path / "t8")
    ts = tcli.main(args + ["--device", "cpu", "--bnb_optimizer"])
    assert ts.update == 1 and isinstance(ts.opt_state.nu[-1], (dict, torch.Tensor))
    assert np.isfinite(seen_t[-1][1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(args)
    assert isinstance(tstep.make_optimizer(tconfig.TrainConfig(bnb_optimizer=True), 2), AdamW8bit)
