"""Training path of the port against the JAX package on the CPU, at a tiny
DiT (dim 64, depth 2, heads 2 x 32), fp32, dropout 0.

- `cfm_loss`: value and every parameter's gradient vs jax.value_and_grad of
  f5e_tts_tpu.models.cfm.cfm_loss, each side drawing from the same key
  (ops/prng.py: JAX's threefry). Tolerance: loss rtol 1e-5; gradients atol 1e-5 * max|grad| + rtol 1e-3
  (fp32 on both sides, the attention's softmax and the sums over N and D
  run in another order; the JAX side's attention is jax.nn.dot_product_attention).
- `train_step`: 3 optimizer updates with grad accumulation 2 and one NaN
  micro-step vs the JAX train_step under one key, each folding the
  micro-steps consumed into it: params and EMA to atol 2e-6 (an Adam
  step moves a weight by ~lr = 1e-3; the tolerance is 0.2% of it), and the
  counters exactly.
- dropout and the span mask: shapes, rates and bounds, and their draws
  bit for bit JAX's for the key.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import TrainConfig as JTrainConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops import nn as jfnn
from f5e_tts_tpu.train import step as jstep
from f5e_tts_tpu.utils import masks as jmasks
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, TrainConfig
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.utils import masks as tmasks
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0)
B, N = 2, 32


def _randomized(tree, rng):
    """numpy copy of a JAX tree; zero-initialised leaves (AdaLN, proj_out,
    GRN) get seeded values so every weight shapes the loss."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def model():
    arch_j, arch_t = JDiTConfig(**TINY), DiTConfig(**TINY)
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), arch_j, 16)
    return arch_j, arch_t, _randomized(params, np.random.default_rng(0))


def _batch(rng, nan=False):
    mel = rng.standard_normal((B, N, TINY["mel_dim"])).astype(np.float32)
    if nan:
        mel[0, 3, 4] = np.nan
    ids = rng.integers(0, 16, (B, 12)).astype(np.int32)
    ids[1, 9:] = -1
    return {"mel": mel, "mel_lens": np.asarray([N, 27], np.int32), "text_ids": ids}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got: dict, want: dict, rtol, atol_frac=None, atol=None):
    flat_g, flat_w = tstep.tree_leaves(got), tstep.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        w = w.numpy()
        a = atol if atol is not None else atol_frac * max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=rtol, atol=a)


@pytest.mark.parametrize("cfm_kw", [{}, {"cond_drop_prob": 1.0}])
def test_cfm_loss_and_grads_match_jax(model, cfm_kw):
    arch_j, arch_t, params_np = model
    cfm_j, cfm_t = JCFMConfig(**cfm_kw), CFMConfig(**cfm_kw)
    batch = _batch(np.random.default_rng(1))
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return jcfm.cfm_loss(p, {}, arch_j, cfm_j, mel=jnp.asarray(batch["mel"]),
                             mel_lens=jnp.asarray(batch["mel_lens"]),
                             text_ids=jnp.asarray(batch["text_ids"]), rng=key, training=True,
                             compute_dtype=jnp.float32).loss

    want, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params_np)
    params = tstep.tree_map(lambda t: t.requires_grad_(True), dit_from_jax(params_np, arch_t))
    tb = _torch_batch(batch)
    out = tcfm.cfm_loss(params, arch_t, cfm_t, mel=tb["mel"], mel_lens=tb["mel_lens"],
                        text_ids=tb["text_ids"], rng=tprng.prng_key(3),
                        compute_dtype=torch.float32)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    grads_t = tstep.tree_map(lambda t: t.grad, params)
    _assert_tree_close(grads_t, dit_from_jax(jax.tree.map(np.asarray, grads_j), arch_t),
                       rtol=1e-3, atol_frac=1e-5)


def test_train_step_matches_jax(model):
    """3 updates (grad accumulation 2) with a NaN micro-step between them."""
    arch_j, arch_t, params_np = model
    lr_kw = dict(learning_rate=1e-3, num_warmup_updates=2, grad_accumulation_steps=2,
                 max_grad_norm=1.0)
    opt_j = jstep.make_optimizer(JTrainConfig(**lr_kw), total_updates=3)
    ema_j = jstep.EMASettings(beta=0.99, update_after_step=0, update_every=1)
    ts_j = jstep.init_train_state(jax.tree.map(jnp.asarray, params_np), {}, opt_j)
    step_j = jax.jit(partial(jstep.train_step, arch=arch_j, cfm=JCFMConfig(), optimizer=opt_j,
                             ema=ema_j, grad_accum=2, compute_dtype=jnp.float32))

    opt_t = tstep.make_optimizer(TrainConfig(**lr_kw), total_updates=3)
    ema_t = tstep.EMASettings(beta=0.99, update_after_step=0, update_every=1)
    ts_t = tstep.init_train_state(dit_from_jax(params_np, arch_t), opt_t)

    rng, key = np.random.default_rng(2), jax.random.PRNGKey(11)
    for i in range(7):
        batch = _batch(rng, nan=(i == 2))
        ts_j, m_j = step_j(ts_j, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        ts_t, m_t = tstep.train_step(ts_t, _torch_batch(batch), arch=arch_t, cfm=CFMConfig(),
                                     optimizer=opt_t, ema=ema_t, rng=tprng.prng_key(11),
                                     compute_dtype=torch.float32)
        assert m_t.skipped == int(m_j.skipped) == int(i == 2)
        if i != 2:
            np.testing.assert_allclose(m_t.loss, float(m_j.loss), rtol=1e-4)
            np.testing.assert_allclose(m_t.grad_norm, float(m_j.grad_norm), rtol=1e-4)
    assert (ts_t.update, ts_t.micro, ts_t.skipped) == (int(ts_j.update), int(ts_j.micro),
                                                       int(ts_j.skipped)) == (3, 6, 1)
    assert ts_t.opt_state.count == 3
    for mine, theirs in ((ts_t.params, ts_j.params), (ts_t.ema_params, ts_j.ema_params)):
        _assert_tree_close(mine, dit_from_jax(jax.tree.map(np.asarray, theirs), arch_t),
                           rtol=0, atol=2e-6)
    # the EMA took a decayed average at update 3, not a copy
    assert not torch.equal(tstep.tree_leaves(ts_t.ema_params)[0],
                           tstep.tree_leaves(ts_t.params)[0])


def test_schedule_and_ema_decay_match_jax():
    tc_kw = dict(learning_rate=1e-3, num_warmup_updates=4)
    sched_j = jstep.make_schedule(JTrainConfig(**tc_kw), total_updates=10)
    sched_t = tstep.make_schedule(TrainConfig(**tc_kw), total_updates=10)
    for c in range(12):
        # the JAX schedule runs in fp32: (lr - 1e-8) * frac + 1e-8 loses ~1e-11 near the end
        np.testing.assert_allclose(sched_t(c), float(sched_j(c)), rtol=1e-6, atol=1e-10)
    ema = dict(beta=0.999, update_after_step=5, update_every=2)
    for u in range(1, 40):
        np.testing.assert_allclose(
            tstep.ema_decay_at(u, tstep.EMASettings(**ema)),
            float(jstep.ema_decay_at(jnp.asarray(u), jstep.EMASettings(**ema))), atol=1e-6)


def test_dropout_and_span_mask():
    key, jkey = tprng.prng_key(0), jax.random.PRNGKey(0)
    x = torch.ones(4, 256, 64)
    y = tnn.dropout(key, x, 0.1, True)
    assert set(torch.unique(y).tolist()) <= {0.0, torch.tensor(1.0 / 0.9).item()}
    assert abs((y == 0).float().mean().item() - 0.1) < 0.01
    assert tnn.dropout(key, x, 0.1, False) is x and tnn.dropout(key, x, 0.0, True) is x
    want = jfnn.dropout(jkey, jnp.ones((4, 256, 64)), 0.1, True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))

    lens = torch.tensor([100, 37, 1])
    frac = torch.tensor([0.7, 1.0, 0.85])
    span = tmasks.mask_from_frac_lengths(key, lens, frac, 128)
    np.testing.assert_array_equal(span.numpy(), np.asarray(jmasks.mask_from_frac_lengths(
        jkey, jnp.asarray(lens.numpy()), jnp.asarray(frac.numpy()), 128)))
    assert span.sum(1).tolist() == [70, 37, 0]
    assert not span[:, 100:].any() and not span[1, 37:].any()
    span = tmasks.mask_from_frac_lengths(None, lens, frac, 128,
                                         rand=torch.tensor([0.999, 0.0, 0.5]))
    # start = floor(0.999 * (100 - 70)) = 29
    assert span[0, 29:99].all() and span.sum(1).tolist() == [70, 37, 0] and span[1, :37].all()
