"""The Gumbel temperature of the codebook in training, port against the JAX
trainer on the CPU.

The JAX trainer's loss (f5e_tts_tpu/train/trainer.py: loss_with_device_mel)
passes no `vq_temperature`, so `cfm_loss` takes its default 2.0 whatever the
codebook's `temp_start`. The port's `loss_with_device_mel` must do the same:
at `temp_start` 0.5 the forward value barely moves (the straight-through
one-hot is the argmax either way), but every gradient that flows through the
soft assignment scales with 1 / temperature. So the loss and every gradient
are held against jax.value_and_grad of the JAX trainer's loss, with the
draws of its key handed over and dropout 0, at the training tests'
tolerances (values rtol 1e-5, gradients atol 1e-5 * max|grad| + rtol 1e-3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.train import trainer as jtrainer
from f5e_tts_tpu_torch.config import CFMConfig, MelConfig
from f5e_tts_tpu_torch.train import trainer as ttrainer
from tests.test_torch_codebook import (VOCAB, _close_grads, _inputs, _key_in_cell, _loss_draws,
                                       _randomized, _torch_params, configs, t)


def _arch(arch, temp_start):
    """One block, the codebook with its perplexity loss at `temp_start`; no
    align loss or cross mask (their MAS does not see the temperature)."""
    return dataclasses.replace(
        arch, depth=1, ppg=dataclasses.replace(arch.ppg, use_cross_mask=False),
        codebook=dataclasses.replace(arch.codebook, temp_start=temp_start, use_align_loss=False))


def test_trainer_loss_uses_the_jax_trainers_temperature():
    arch_j, arch_t = (_arch(a, 0.5) for a in configs())
    params_np, _ = jax.jit(jdit.init_dit, static_argnums=(1, 2))(jax.random.PRNGKey(0), arch_j,
                                                                VOCAB)
    params_np = _randomized(params_np, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    state_np = {"ppg_bn": [{"mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
                            "var": (1 + 0.2 * rng.random(16)).astype(np.float32),
                            "count": np.asarray(3, np.int32)} for _ in range(3)]}
    batch = _inputs(4)
    key = _key_in_cell(0.0, 0.3)  # both codebook branches kept

    def loss_j(p):
        out = jtrainer.loss_with_device_mel(
            p, jax.tree.map(jnp.asarray, state_np), arch_j, JCFMConfig(), JMelConfig(),
            {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32)
        return out.loss, out

    (want, out_j), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_np)
    params, state = _torch_params(params_np, state_np, arch_t)
    out = ttrainer.loss_with_device_mel(params, arch_t, CFMConfig(), MelConfig(),
                                        {k: t(v) for k, v in batch.items()},
                                        draws=_loss_draws(key, arch_j),
                                        compute_dtype=torch.float32, state=state)
    out.loss.backward()
    assert out.extra_loss.item() > 0  # the codebook branches ran
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(out.extra_loss), float(out_j.extra_loss), rtol=1e-5,
                               atol=1e-6)
    _close_grads(params, grads_j, arch_t, state_np)
