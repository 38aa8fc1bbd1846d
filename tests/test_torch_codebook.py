"""The F5E model's codebook branch in the port against the JAX package on
the CPU, at a tiny PPG + codebook DiT (dim 64, depth 2, heads 2 x 32, text
dim 32, PPG dim 16, 2 groups x 10 codes), fp32.

- `gumbel_vq_apply` in eval and in training, the gumbel uniforms drawn from
  the JAX key and handed over: the output, and both perplexities, atol 1e-5.
- `maximum_path` and `neg_cent_grid`: the path equal bit for bit on ragged
  lengths (the JAX grid is the input of both), the grid to 1e-4 relative.
- `dit_forward` with the align loss, the perplexity loss and the cross mask
  on: pred and every extra, and the gradients of pred + extras against
  jax.value_and_grad. The draws (PPG dropout keeps, gumbel uniforms,
  permutations, cross-mask uniforms) repeat the JAX split order on the same
  key (dit.py:476-533), dropout 0 in the trunk. Tolerances as the training tests':
  values rtol 1e-5 (atol 1e-6), gradients atol 1e-5 * max|grad| + rtol 1e-3.
- `cfm_loss` in each of the four cells of the drop table (keep both, drop
  the text, drop the PPG, drop everything): loss, extras, new BatchNorm
  state and gradients against the JAX function.
- Remat: with dropout 0.1 the loss and every gradient under each policy
  equal those without (bit for bit in fp32), and the kernel wrappers run as
  derived: under `block` K3 and K2 twice a block, under `save_attn` and
  `save_attn_ff` K3 once and K2 twice.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import CodebookConfig as JCodebookConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import PPGConfig as JPPGConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops import mas as jmas
from f5e_tts_tpu.ops import vq as jvq
from f5e_tts_tpu_torch.config import CFMConfig, CodebookConfig, DiTConfig, PPGConfig
from f5e_tts_tpu_torch.kernels import gated_adaln as tga
from f5e_tts_tpu_torch.kernels import rope_attention as tra
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import mas as tmas
from f5e_tts_tpu_torch.ops import vq as tvq
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

PPG = dict(use_ppg=True, ppg_dim=16, use_cross_mask=True, cross_mask_prob=0.5)
CB = dict(use_codebook=True, num_vars=10, groups=2, use_perplex_loss=True, perplex_loss_prob=0.25,
          perplex_loss_weight=0.1, use_align_loss=True, align_loss_weight=1.0)
TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0, text_mask_padding=False, pe_attn_head=1)
B, N, NP, VOCAB = 2, 40, 22, 16


def t(a):
    return torch.from_numpy(np.array(a))


def configs(**over):
    arch_j = JDiTConfig(**TINY, ppg=JPPGConfig(**PPG), codebook=JCodebookConfig(**CB))
    arch_t = DiTConfig(**TINY, ppg=PPGConfig(**PPG), codebook=CodebookConfig(**CB))
    return dataclasses.replace(arch_j, **over), dataclasses.replace(arch_t, **over)


def _randomized(tree, rng):
    """numpy copy of a JAX tree; zero-initialised leaves (AdaLN, proj_out,
    GRN) get seeded values so every weight shapes the loss."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def model():
    arch_j, arch_t = configs()
    params, state = jdit.init_dit(jax.random.PRNGKey(0), arch_j, VOCAB)
    params = _randomized(params, np.random.default_rng(0))
    # a non-trivial running state, as after some training
    rng = np.random.default_rng(1)
    state = {"ppg_bn": [{"mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
                         "var": (1 + 0.2 * rng.random(16)).astype(np.float32),
                         "count": np.asarray(3, np.int32)} for _ in range(3)]}
    return arch_j, arch_t, params, state


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, 14)).astype(np.int32)
    ids[1, 9:] = -1
    return dict(mel=rng.standard_normal((B, N, 20)).astype(np.float32),
                mel_lens=np.asarray([N, 33], np.int32), text_ids=ids,
                text_lens=np.asarray([14, 9], np.int32),
                ppg=rng.standard_normal((B, NP, 16)).astype(np.float32),
                ppg_lens=np.asarray([NP, 17], np.int32))


def _dit_draws(key, arch_j, b=B, n=N) -> tdit.DiTDraws:
    """The draws of f5e_tts_tpu dit_forward for `key`, in its split order."""
    r_vq_t, r_vq_p, r_perm_t, r_perm_p, r_cross, r_ppgdrop, _ = jax.random.split(key, 7)
    cb = arch_j.codebook
    shape = (b * n * cb.groups, cb.num_vars)
    keeps, rng = [], r_ppgdrop
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        keeps.append(t(jax.random.bernoulli(sub, 0.5, (b, n, arch_j.ppg.ppg_dim))))
    r_apply, r_mask = jax.random.split(r_cross)
    r1, r2 = jax.random.split(r_mask)
    return tdit.DiTDraws(
        ppg_keep=keeps,
        gumbel_text=t(jax.random.uniform(r_vq_t, shape, jnp.float32, 1e-10, 1.0)),
        gumbel_ppg=t(jax.random.uniform(r_vq_p, shape, jnp.float32, 1e-10, 1.0)),
        perm_text=t(jax.random.permutation(r_perm_t, n)).long(),
        perm_ppg=t(jax.random.permutation(r_perm_p, n)).long(),
        cross_apply=t(jax.random.uniform(r_apply)), cross_ratio=t(jax.random.uniform(r1, (b,))),
        cross_start=t(jax.random.uniform(r2, (b,))))


def _loss_draws(key, arch_j) -> tcfm.LossDraws:
    """The draws of f5e_tts_tpu cfm_loss for `key` (cfm.py:410-460), the
    model's own from its key."""
    r_frac, r_span, r_time, r_noise, r_drop1, r_drop2, r_model = jax.random.split(key, 7)
    lo, hi = JCFMConfig().frac_lengths_mask
    return tcfm.LossDraws(
        frac=t(jax.random.uniform(r_frac, (B,), minval=lo, maxval=hi)),
        span=t(jax.random.uniform(r_span, (B,))),
        x0=t(jax.random.normal(r_noise, (B, N, 20), jnp.float32)),
        time=t(jax.random.uniform(r_time, (B,), jnp.float32)),
        u1=t(jax.random.uniform(r_drop1)), u2=t(jax.random.uniform(r_drop2)),
        **_dit_draws(r_model, arch_j)._asdict())


def _close_tree(got, want, rtol=1e-3, atol_frac=1e-5, floor=0.0):
    """Leaf by leaf by key (jax.tree.map sorts a dict's keys): atol
    atol_frac * max|leaf|, at least `floor`."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close_tree(got[k], want[k], rtol, atol_frac, floor)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, rtol, atol_frac, floor)
    else:
        w = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=rtol,
                                   atol=max(atol_frac * np.abs(w).max(), floor, 1e-12))


def _close_grads(params, grads_j, arch_t, state_np):
    """Each parameter's gradient against JAX's, atol 1e-5 * max|grad| per
    leaf. The PPG convs' biases feed a BatchNorm in training mode, which
    subtracts their mean again: their gradient is zero analytically and
    rounding noise (~1e-9) on both sides, so the atol's floor is 1e-5 x the
    model's largest gradient."""
    want = dit_from_jax(jax.tree.map(np.asarray, grads_j), arch_t, state_np)[0]
    top = max(float(np.abs(np.asarray(w)).max()) for w in tstep.tree_leaves(want))
    _close_tree(tstep.tree_map(lambda p: p.grad, params), want, floor=1e-5 * top)


def _torch_params(params_np, state_np, arch_t):
    params, state = dit_from_jax(params_np, arch_t, state_np)
    return tstep.tree_map(lambda x: x.requires_grad_(True), params), state


# ---------------------------------------------------------------------------
# Gumbel VQ and MAS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_gumbel_vq_matches_jax(training, depth):
    cb_j = JCodebookConfig(**CB, weight_proj_depth=depth, weight_proj_factor=2)
    cb_t = CodebookConfig(**CB, weight_proj_depth=depth, weight_proj_factor=2)
    params = jax.tree.map(np.asarray, jvq.gumbel_vq_init(jax.random.PRNGKey(4), cb_j, 32))
    x = np.random.default_rng(5).standard_normal((2, 12, 32)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jvq.gumbel_vq_apply(params, cb_j, jnp.asarray(x), training=training, temperature=2.0,
                               rng=key)
    uniform = t(jax.random.uniform(key, (2 * 12 * 2, 10), jnp.float32, 1e-10, 1.0))
    from f5e_tts_tpu_torch.utils.convert import to_tensors
    got = tvq.gumbel_vq_apply(to_tensors(params), cb_t, t(x), training=training, temperature=2.0,
                              uniform=uniform)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)
    for name in ("code_perplexity", "prob_perplexity"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-5)
    assert got.num_vars == want.num_vars == 20
    assert tvq.decayed_temperature(cb_t, 1000) == pytest.approx(
        float(jvq.decayed_temperature(cb_j, 1000)), rel=1e-6)


@pytest.mark.parametrize("shape,t_ys,t_xs", [((3, 17, 9), [17, 12, 5], [9, 4, 5]),
                                             ((2, 24, 24), [24, 19], [11, 24])])
def test_maximum_path_matches_jax_exactly(shape, t_ys, t_xs):
    rng = np.random.default_rng(7)
    text = rng.standard_normal((shape[0], shape[2], 8)).astype(np.float32)
    ppg = rng.standard_normal((shape[0], shape[1], 8)).astype(np.float32)
    grid_j = np.asarray(jmas.neg_cent_grid(jnp.asarray(text), jnp.asarray(ppg)))
    grid_t = tmas.neg_cent_grid(t(text), t(ppg)).numpy()
    np.testing.assert_allclose(grid_t, grid_j, rtol=1e-4, atol=1e-3)
    want = np.asarray(jmas.maximum_path(jnp.asarray(grid_j), jnp.asarray(t_ys),
                                        jnp.asarray(t_xs)))
    got = tmas.maximum_path(t(grid_j), torch.tensor(t_ys), torch.tensor(t_xs)).numpy()
    np.testing.assert_array_equal(got, want)
    # one-hot in every valid row, monotonic, ending at (t_y - 1, t_x - 1)
    for i, (ty, tx) in enumerate(zip(t_ys, t_xs)):
        assert (got[i, :ty].sum(axis=1) == 1).all() and not got[i, ty:].any()
        cols = got[i, :ty].argmax(axis=1)
        assert (np.diff(cols) >= 0).all() and cols[-1] == tx - 1


# ---------------------------------------------------------------------------
# dit_forward with the codebook branch, and cfm_loss
# ---------------------------------------------------------------------------


def test_dit_forward_codebook_branch_value_and_grads_match_jax(model):
    arch_j, arch_t, params_np, state_np = model
    inp = _inputs()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, N, 20)).astype(np.float32)
    cond = rng.standard_normal((B, N, 20)).astype(np.float32)
    time = np.asarray([0.3, 0.8], np.float32)
    keep = np.zeros(B, bool)
    key = jax.random.PRNGKey(9)

    def fwd_j(p):
        pred, ex = jdit.dit_forward(
            p, jax.tree.map(jnp.asarray, state_np), arch_j, x=jnp.asarray(x),
            cond=jnp.asarray(cond), text_ids=jnp.asarray(inp["text_ids"]),
            time=jnp.asarray(time), drop_audio_cond=jnp.asarray(keep),
            drop_text=jnp.asarray(keep), drop_ppg=jnp.asarray(keep), ppg=jnp.asarray(inp["ppg"]),
            text_len=jnp.asarray(inp["text_lens"]), ppg_len=jnp.asarray(inp["ppg_lens"]),
            training=True, rng=key, vq_temperature=2.0, compute_dtype=jnp.float32)
        return jnp.mean(pred * jnp.asarray(cond)) + ex.extra_loss, (pred, ex)

    (want, (pred_j, ex_j)), grads_j = jax.value_and_grad(fwd_j, has_aux=True)(params_np)
    params, state = _torch_params(params_np, state_np, arch_t)
    pred, ex = tdit.dit_forward(
        params, arch_t, x=t(x), cond=t(cond), text_ids=t(inp["text_ids"]), time=t(time),
        drop_audio_cond=t(keep), drop_text=t(keep), drop_ppg=t(keep), ppg=t(inp["ppg"]),
        text_len=t(inp["text_lens"]), ppg_len=t(inp["ppg_lens"]), training=True, state=state,
        vq_temperature=2.0, draws=_dit_draws(key, arch_j), compute_dtype=torch.float32,
        return_extras=True)
    loss = (pred * t(cond)).mean() + ex.extra_loss
    loss.backward()
    assert float(ex_j.align_loss) > 0 and float(ex_j.perplex_loss) > 0
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j), rtol=1e-5, atol=1e-5)
    for name in ("extra_loss", "align_loss", "perplex_loss"):
        np.testing.assert_allclose(float(getattr(ex, name).detach()), float(getattr(ex_j, name)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _close_tree(ex.new_state, jax.tree.map(np.asarray, ex_j.new_state), rtol=1e-5, atol_frac=1e-6)
    _close_grads(params, grads_j, arch_t, state_np)


def _key_in_cell(lo: float, hi: float):
    """The first PRNGKey(s) whose cfm_loss draws keep the audio (u1 >= 0.3)
    and put u2 in [lo, hi)."""
    for s in range(1000):
        key = jax.random.PRNGKey(s)
        r_drop1, r_drop2 = jax.random.split(key, 7)[4:6]
        u1, u2 = float(jax.random.uniform(r_drop1)), float(jax.random.uniform(r_drop2))
        if u1 >= 0.3 and lo <= u2 < hi:
            return key
    raise AssertionError("no key found")


# the cells of combined_cond_drop_prob (0.3, 0.1, 0.5, 0.1) by the u2 they take
@pytest.mark.parametrize("cell,lo,hi", [("keep both", 0.0, 0.3), ("drop text", 0.3, 0.4),
                                        ("drop ppg", 0.4, 0.9), ("drop all", 0.9, 1.0)])
def test_cfm_loss_drop_table_cells_match_jax(model, cell, lo, hi):
    arch_j, arch_t, params_np, state_np = model
    inp = _inputs(3)
    key = _key_in_cell(lo, hi)

    def loss_j(p):
        out = jcfm.cfm_loss(p, jax.tree.map(jnp.asarray, state_np), arch_j, JCFMConfig(),
                            mel=jnp.asarray(inp["mel"]), mel_lens=jnp.asarray(inp["mel_lens"]),
                            text_ids=jnp.asarray(inp["text_ids"]),
                            text_lens=jnp.asarray(inp["text_lens"]), ppg=jnp.asarray(inp["ppg"]),
                            ppg_lens=jnp.asarray(inp["ppg_lens"]), rng=key, training=True,
                            vq_temperature=2.0, compute_dtype=jnp.float32)
        return out.loss, out

    (want, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params_np)
    params, state = _torch_params(params_np, state_np, arch_t)
    out = tcfm.cfm_loss(params, arch_t, CFMConfig(), mel=t(inp["mel"]),
                        mel_lens=t(inp["mel_lens"]), text_ids=t(inp["text_ids"]),
                        draws=_loss_draws(key, arch_j), compute_dtype=torch.float32, state=state,
                        text_lens=t(inp["text_lens"]), ppg=t(inp["ppg"]),
                        ppg_lens=t(inp["ppg_lens"]), vq_temperature=2.0)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    for name in ("flow_loss", "extra_loss"):
        np.testing.assert_allclose(float(getattr(out, name)), float(getattr(out_j, name)),
                                   rtol=1e-5, atol=1e-6)
    # the perplexity loss of each kept modality; the align loss only with both kept
    assert (float(out.extra_loss) > 0) == (cell != "drop all")
    assert (float(out.align_loss) > 0) == (cell == "keep both")
    _close_tree(out.new_state, jax.tree.map(np.asarray, out_j.new_state), rtol=1e-5,
                atol_frac=1e-6)
    _close_grads(params, grads_j, arch_t, state_np)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["block", "save_attn", "save_attn_ff"])
def test_remat_equals_no_remat_with_dropout(model, policy, monkeypatch):
    _, arch_t, params_np, state_np = model
    arch_t = dataclasses.replace(arch_t, dropout=0.1)
    inp = _inputs(4)
    calls = {"attn": 0, "adaln": 0}
    real_attn, real_adaln = tra.rope_attention, tga.gated_adaln

    def counting_attn(*a, **kw):
        calls["attn"] += 1
        return real_attn(*a, **kw)

    def counting_adaln(*a, **kw):
        calls["adaln"] += 1
        return real_adaln(*a, **kw)

    monkeypatch.setattr(tra, "rope_attention", counting_attn)
    monkeypatch.setattr(tga, "gated_adaln", counting_adaln)

    def run(arch):
        params, state = _torch_params(params_np, state_np, arch)
        calls.update(attn=0, adaln=0)
        out = tcfm.cfm_loss(params, arch, CFMConfig(), mel=t(inp["mel"]),
                            mel_lens=t(inp["mel_lens"]), text_ids=t(inp["text_ids"]),
                            generator=torch.Generator().manual_seed(5),
                            draws=tcfm.LossDraws(u1=torch.tensor(0.9), u2=torch.tensor(0.1)),
                            compute_dtype=torch.float32, state=state,
                            text_lens=t(inp["text_lens"]), ppg=t(inp["ppg"]),
                            ppg_lens=t(inp["ppg_lens"]))
        out.loss.backward()
        return out, tstep.tree_leaves(tstep.tree_map(lambda p: p.grad, params)), dict(calls)

    base, grads, calls_off = run(arch_t)
    remat, grads_r, calls_on = run(dataclasses.replace(arch_t, checkpoint_activations=True,
                                                       remat_policy=policy))
    depth = arch_t.depth
    assert calls_off == {"attn": depth, "adaln": depth}
    assert calls_on == {"attn": (2 if policy == "block" else 1) * depth, "adaln": 2 * depth}
    assert torch.equal(remat.loss, base.loss) and float(base.extra_loss) > 0
    assert len(grads) == len(grads_r) and all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    # dropout acted: another generator gives another loss
    other = tcfm.cfm_loss(*_torch_params(params_np, state_np, arch_t)[:1], arch_t, CFMConfig(),
                          mel=t(inp["mel"]), mel_lens=t(inp["mel_lens"]),
                          text_ids=t(inp["text_ids"]), generator=torch.Generator().manual_seed(6),
                          draws=tcfm.LossDraws(u1=torch.tensor(0.9), u2=torch.tensor(0.1)),
                          compute_dtype=torch.float32, state=_torch_params(
                              params_np, state_np, arch_t)[1], text_lens=t(inp["text_lens"]),
                          ppg=t(inp["ppg"]), ppg_lens=t(inp["ppg_lens"]))
    assert not torch.equal(other.loss, base.loss)


def test_unknown_remat_policy_raises(model):
    _, arch_t, params_np, state_np = model
    arch = dataclasses.replace(arch_t, checkpoint_activations=True, remat_policy="nope")
    params, state = _torch_params(params_np, state_np, arch)
    inp = _inputs()
    with pytest.raises(ValueError, match="remat_policy"):
        tcfm.cfm_loss(params, arch, CFMConfig(), mel=t(inp["mel"]), mel_lens=t(inp["mel_lens"]),
                      text_ids=t(inp["text_ids"]), generator=torch.Generator().manual_seed(0),
                      compute_dtype=torch.float32, state=state, text_lens=t(inp["text_lens"]),
                      ppg=t(inp["ppg"]), ppg_lens=t(inp["ppg_lens"]))
