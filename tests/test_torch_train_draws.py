"""Training's draws of the port against the JAX package on the CPU, with
nothing injected: each side draws from its own threefry key (ops/prng.py in
the port, jax.random in JAX) for the same seed. The seeded init of each
backbone, Vocos and `F5TTS` is held to JAX's in tests/test_torch_prng.py.

- A seeded `Trainer.train` of a tiny DiT at dropout 0.1, fp32: its initial
  weights are JAX's Trainer's; two updates, a SIGTERM that saves model_last,
  and a resumed run's third update give JAX's losses over its three updates
  within 1e-4 relative and its params within 2e-6 (as
  tests/test_torch_training.py's steps: fp32 on both sides, sums in
  another order).
- Remat "block" at dropout 0.1: the recompute draws the forward's masks
  from the block's key, so loss and gradients equal the unchecked run's
  bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import signal

import jax
import numpy as np
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.config import MeshConfig as JMeshConfig
from f5e_tts_tpu.config import ModelConfig as JModelConfig
from f5e_tts_tpu.config import TrainConfig as JTrainConfig
from f5e_tts_tpu.train import trainer as jtrainer
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, MelConfig, ModelConfig, TrainConfig
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer
from f5e_tts_tpu_torch.utils.convert import dit_from_jax
from tests.test_torch_prng import assert_jax_init

VOCAB = 30
DIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=8, text_dim=16,
           conv_layers=1)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the Trainer: seeded init, two updates, a resume
# ---------------------------------------------------------------------------

MEL = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=8, target_sample_rate=8000)
TC = dict(learning_rate=1e-3, num_warmup_updates=1, compute_dtype="float32", seed=3,
          save_per_updates=10 ** 9, last_per_updates=10 ** 9)
B, N, NT, UPDATES = 2, 24, 6, 3


class _Loader:
    """Seeded mel batches; the Trainers' epoch hook is a no-op."""

    class sampler:
        @staticmethod
        def set_epoch(epoch):
            pass

    def __init__(self):
        r = np.random.default_rng(11)
        self.batches = [{"mel": r.standard_normal((B, N, 8)).astype(np.float32),
                         "mel_lens": np.asarray([N, 19], np.int32),
                         "text_ids": r.integers(0, VOCAB, (B, NT)).astype(np.int32)}
                        for _ in range(UPDATES)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _jax_trainer(save_dir, log_fn):
    model = JModelConfig(name="tiny", backbone="DiT", tokenizer="custom", tokenizer_path=None,
                         arch=JDiTConfig(**DIT, dropout=0.1), mel=JMelConfig(**MEL),
                         cfm=JCFMConfig(), vocab_size=VOCAB)
    tc = JTrainConfig(**TC, save_dir=save_dir, mesh=JMeshConfig(data=1))
    return jtrainer.Trainer(model, tc, vocab_size=VOCAB,
                            tokenize=lambda x: x, log_fn=log_fn)


def _port_trainer(save_dir, log_fn):
    model = ModelConfig(name="tiny", backbone="DiT", arch=DiTConfig(**DIT, dropout=0.1),
                        mel=MelConfig(**MEL), cfm=CFMConfig())
    return Trainer(model, TrainConfig(**TC, save_dir=save_dir), vocab_size=VOCAB, tokenize=None,
                   log_fn=log_fn, device="cpu")


def test_seeded_trainer_matches_jax_over_two_updates_and_a_resume(tmp_path):
    loader = _Loader()
    jax_losses = {}
    jtr = _jax_trainer(str(tmp_path / "jax"), lambda m, u: jax_losses.__setitem__(u, m["loss"]))
    # the seeded initial weights
    init_j = jtr.init_state(UPDATES, rng_seed=TC["seed"])
    ptr = _port_trainer(str(tmp_path / "port"), None)
    init_t = ptr.init_state(UPDATES, rng_seed=TC["seed"])
    assert_jax_init(init_t.params, dit_from_jax(_np(init_j.params), ptr.arch))  # bitwise, 4 ulp
    ts_j, _ = jtr.train(loader, epochs=1, resume=False, max_updates=UPDATES)

    losses = {}

    def stop_at_2(m, u):
        losses[u] = m["loss"]
        if u == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    ptr = _port_trainer(str(tmp_path / "port"), stop_at_2)
    ts, info = ptr.train(loader, epochs=1, resume=False, max_updates=UPDATES)
    assert info["preempted"] and ts.update == 2
    ptr = _port_trainer(str(tmp_path / "port"), lambda m, u: losses.__setitem__(u, m["loss"]))
    ts, info = ptr.train(loader, epochs=1, resume=True, max_updates=UPDATES)
    assert ts.update == UPDATES and info["updates"] == 1
    assert sorted(losses) == sorted(jax_losses) == [1, 2, 3]
    for u in losses:
        np.testing.assert_allclose(losses[u], jax_losses[u], rtol=1e-4, err_msg=str(u))
    got, want = dict(_flat(ts.params)), dict(_flat(dit_from_jax(_np(ts_j.params), ptr.arch)))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], rtol=0, atol=2e-6,
                                   err_msg=k)


def test_remat_block_keeps_the_dropout_masks():
    arch = DiTConfig(**DIT, dropout=0.1)
    params = tbb.init_backbone(arch, VOCAB, tprng.prng_key(1))
    r = np.random.default_rng(2)
    for blk in params["blocks"]:  # AdaLN-zero would make the blocks identities
        blk["attn_norm"]["w"] = torch.from_numpy(0.1 * r.standard_normal(
            blk["attn_norm"]["w"].shape).astype(np.float32))
    params["proj_out"]["w"] = torch.from_numpy(0.1 * r.standard_normal(
        params["proj_out"]["w"].shape).astype(np.float32))
    batch = _Loader().batches[0]

    def run(a):
        p = tstep.tree_map(lambda t: t.clone().requires_grad_(True), params)
        out = tcfm.cfm_loss(p, a, CFMConfig(), mel=torch.from_numpy(batch["mel"]),
                            mel_lens=torch.from_numpy(batch["mel_lens"]),
                            text_ids=torch.from_numpy(batch["text_ids"]),
                            rng=tprng.prng_key(5), compute_dtype=torch.float32)
        out.loss.backward()
        return out.loss, [t.grad for t in tstep.tree_leaves(p)]

    loss, grads = run(arch)
    loss_r, grads_r = run(dataclasses.replace(arch, checkpoint_activations=True,
                                              remat_policy="block"))
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    # dropout acted
    assert not torch.equal(run(dataclasses.replace(arch, dropout=0.0))[0], loss)
