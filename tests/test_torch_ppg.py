"""The F5E model's PPG conditioning in the port against the JAX package on
the CPU, at a tiny PPG + codebook DiT (dim 64, depth 2, heads 2 x 32, text
dim 32, PPG dim 16), fp32, each side drawing its noise and draws from one key.

- `batchnorm` in training (batch statistics over (B, N), the running
  statistics moved with the unbiased variance, count + 1) and in eval:
  atol 1e-5, the state to 1e-6.
- `ppg_embed_fn` in eval and in training with the dropout keeps drawn from
  the JAX key, for a PPG shorter and longer than the mel, and None: atol
  1e-5.
- `sample`, `sample_tts` and `sample_vc` over a PPG model with a PPG: atol
  1e-3 over 6 fp32 Euler steps, prompt frames exact (the earlier slices'
  sampler tolerance).
- `synthesize_chunk(mode="vc")` hands `sample_vc` the chunk's inputs and
  PPG and never a captured engine; plain CFG with a PPG runs eagerly too.
- `train_step` over the PPG model against the JAX step under one key (its
  PPG dropout, gumbel noise and permutations drawn on each side), with a NaN
  micro-step: params, EMA and the BatchNorm state to atol 2e-6, the state
  untouched by the NaN step.
- The Trainer with a stub extractor over `with_16k_audio` batches: the
  extractor fills the PPG; the BatchNorm state moves, goes into model_last
  and its reference-layout EMA export, and comes back on resume.
- The DiT converters' PPG and codebook layouts against
  f5e_tts_tpu.utils.torch_ckpt.dit_to_torch, exactly, and back.
- The collate of 16 kHz audio against the JAX collate, exactly.
- `configs/example.yaml` is the F5E config chip_smoke.py builds in code,
  but for the tokenizer.
"""

from __future__ import annotations

import dataclasses
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import CodebookConfig as JCodebookConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.config import PPGConfig as JPPGConfig
from f5e_tts_tpu.config import TrainConfig as JTrainConfig
from f5e_tts_tpu.data import dataset as jdata
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops import nn as jnn
from f5e_tts_tpu.train import step as jstep
from f5e_tts_tpu.utils.torch_ckpt import dit_to_torch
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.config import (CFMConfig, CodebookConfig, DiTConfig, InferConfig,
                                      MelConfig, ModelConfig, PPGConfig, TrainConfig)
from f5e_tts_tpu_torch.data import dataset as tdata
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, dit_from_reference_state_dict,
                                             dit_to_reference_state_dict, load_state_dict,
                                             to_tensors)
from f5e_tts_tpu_torch.utils.text import list_str_to_bytes

ROOT = Path(__file__).resolve().parents[1]
PPG = dict(use_ppg=True, ppg_dim=16)
CB = dict(use_codebook=True, num_vars=10, groups=2, use_perplex_loss=True, perplex_loss_prob=0.25,
          perplex_loss_weight=0.1)
TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0, text_mask_padding=False, pe_attn_head=1)
B, N, NP, VOCAB = 2, 40, 22, 256


def t(a):
    return torch.from_numpy(np.array(a))


def _seeded(tree, seed):
    """numpy copy of a JAX tree; zero leaves (AdaLN-zero, proj_out) get
    seeded values so every weight shapes the output."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if np.asarray(a).any()
                        else (0.1 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


def _state(seed=1):
    rng = np.random.default_rng(seed)
    return {"ppg_bn": [{"mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
                        "var": (1 + 0.2 * rng.random(16)).astype(np.float32),
                        "count": np.asarray(3, np.int32)} for _ in range(3)]}


@pytest.fixture(scope="module")
def model():
    arch_j = JDiTConfig(**TINY, ppg=JPPGConfig(**PPG), codebook=JCodebookConfig(**CB))
    arch_t = DiTConfig(**TINY, ppg=PPGConfig(**PPG), codebook=CodebookConfig(**CB))
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), arch_j, VOCAB)
    params = _seeded(params, 0)
    return arch_j, arch_t, params, _state()


def _sorted_keys_equal(got, want, atol):
    """A torch state tree against a JAX one (whose dicts jax.tree.map sorts)."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _sorted_keys_equal(got[k], want[k], atol)
    elif isinstance(got, (list, tuple)):
        for g, w in zip(got, want, strict=True):
            _sorted_keys_equal(g, w, atol)
    else:
        np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# batchnorm and the PPG embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_jax(training):
    rng = np.random.default_rng(2)
    x = (3 + 2 * rng.standard_normal((3, 17, 8))).astype(np.float32)
    p_j, s_j = jnn.batchnorm_init(8)
    p_j = {"g": np.linspace(0.5, 1.5, 8, dtype=np.float32), "b": np.linspace(-1, 1, 8,
                                                                              dtype=np.float32)}
    s_j = {**jax.tree.map(np.asarray, s_j), "mean": np.full(8, 0.5, np.float32)}
    y_j, ns_j = jnn.batchnorm(p_j, s_j, jnp.asarray(x), training=training)
    y_t, ns_t = tnn.batchnorm(to_tensors(p_j), to_tensors(s_j), t(x), training=training)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    _sorted_keys_equal(ns_t, jax.tree.map(np.asarray, ns_j), atol=1e-6)
    assert int(ns_t["count"]) == int(training)
    p0, s0 = tnn.batchnorm_init(8)
    assert torch.equal(p0["g"], torch.ones(8)) and torch.equal(s0["var"], torch.ones(8))


@pytest.mark.parametrize("np_len,training,none", [(NP, False, False), (NP, True, False),
                                                  (N + 7, True, False), (NP, False, True)])
def test_ppg_embed_fn_matches_jax(model, np_len, training, none):
    arch_j, arch_t, params_np, state_np = model
    rng = np.random.default_rng(3)
    ppg = None if none else rng.standard_normal((B, np_len, 16)).astype(np.float32)
    drop = np.asarray([False, True])
    key = jax.random.PRNGKey(4)
    want, ns_j = jdit.ppg_embed_fn(params_np, jax.tree.map(jnp.asarray, state_np), arch_j,
                                   None if none else jnp.asarray(ppg), B, N, jnp.asarray(drop),
                                   training=training, rng=key, compute_dtype=jnp.float32)
    keeps, r = [], key
    for _ in range(3):
        r, sub = jax.random.split(r)
        keeps.append(t(jax.random.bernoulli(sub, 0.5, (B, N, 16))))
    params, state = dit_from_jax(params_np, arch_t, state_np)
    got, ns_t = tdit.ppg_embed_fn(params, state, arch_t, None if none else t(ppg), B, N, t(drop),
                                  training=training, keep=keeps if training else None,
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    _sorted_keys_equal(ns_t, jax.tree.map(np.asarray, ns_j), atol=1e-6)


def test_init_dit_shapes_match_jax(model):
    arch_j, arch_t, params_np, _ = model
    made = tdit.init_dit(arch_t, VOCAB, tprng.prng_key(0))
    params, state = tbb.split_state(arch_t, made)
    want, want_state = jdit.init_dit(jax.random.PRNGKey(0), arch_j, VOCAB)
    mine = dit_from_jax(jax.tree.map(np.asarray, want), arch_t, jax.tree.map(np.asarray,
                                                                               want_state))
    def shapes(tree):
        return {k: tuple(v.shape) for k, v in _flat(tree).items()}

    assert shapes(params) == shapes(mine[0]) and shapes(state) == shapes(mine[1])
    assert params["input_embed"]["proj"]["w"].shape == (2 * 20 + 2 * 32, 64)
    assert tbb.split_state(DiTConfig(**TINY), {"a": 1}) == ({"a": 1}, {})


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _sampler_inputs(seed=5, nt=12, ppg_len=NP):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((1, 14, 20)).astype(np.float32)
    ids = rng.integers(0, 200, (1, nt)).astype(np.int32)
    ppg = rng.standard_normal((1, ppg_len, 16)).astype(np.float32)
    return ref, ids, ppg


@pytest.mark.parametrize("which", ["sample", "sample_tts", "sample_vc"])
def test_samplers_with_ppg_match_jax(model, which):
    arch_j, arch_t, params_np, state_np = model
    ref, ids, ppg = _sampler_inputs()
    key, steps, dur = jax.random.PRNGKey(6), 6, 33
    j_in = jcfm.prepare_inputs(jnp.asarray(ref), jnp.asarray([14]), jnp.asarray([dur]), N,
                               text_ids=jnp.asarray(ids), ppg=jnp.asarray(ppg))
    kw_j = {"sample": dict(cfg_strength=2.0, sway_coef=-1.0),
            "sample_tts": dict(alpha_spk=2.0, alpha_txt=1.5, sway_coef=-1.0),
            "sample_vc": dict(alpha_spk=1.5, alpha_ppg=2.0, sway_coef=-1.0)}[which]
    want, _ = getattr(jcfm, which)(params_np, jax.tree.map(jnp.asarray, state_np), arch_j,
                                   JCFMConfig(), j_in, key, steps=steps,
                                   compute_dtype=jnp.float32, **kw_j)
    y0 = t(np.asarray(jcfm.noise_like(key, 1, N, 20, jnp.asarray([dur]))))
    params, state = dit_from_jax(params_np, arch_t, state_np)
    t_in = tcfm.prepare_inputs(t(ref), torch.tensor([14]), torch.tensor([dur]), N,
                               text_ids=t(ids), ppg=t(ppg))
    got, traj = getattr(tcfm, which)(params, arch_t, CFMConfig(), t_in, steps=steps, y0=y0,
                                     compute_dtype=torch.float32, device="cpu", state=state,
                                     **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_array_equal(got[0, :14].numpy(), np.asarray(want)[0, :14])
    assert traj.shape == (steps + 1, 1, N, 20)
    with pytest.raises(ValueError, match="state"):
        getattr(tcfm, which)(params, arch_t, CFMConfig(), t_in, steps=2, y0=y0, device="cpu")


def test_sample_vc_needs_a_ppg_model():
    arch = DiTConfig(**TINY)
    params = tdit.init_dit(arch, VOCAB, tprng.prng_key(0))
    inputs = tcfm.prepare_inputs(torch.zeros(1, 4, 20), torch.tensor([4]), torch.tensor([8]), 16)
    with pytest.raises(ValueError, match="PPG DiT"):
        tcfm.sample_vc(params, arch, CFMConfig(), inputs, steps=2, y0=torch.zeros(1, 16, 20),
                       device="cpu")


def test_synthesize_chunk_vc_mode(model):
    _, arch_t, params_np, state_np = model
    params, state = dit_from_jax(params_np, arch_t, state_np)
    engine = tpipe.TTSEngine(params=params, state=state, arch=arch_t, vocab=None,
                             mel=MelConfig(n_mel_channels=20), infer_cfg=InferConfig(nfe_steps=4),
                             compute_dtype=torch.float32, buckets=(64, 128), device="cpu")
    ref_mel, _, ppg = _sampler_inputs(7, ppg_len=30)
    text = "some text."
    padded = np.full((1, 32), -1, np.int32)
    ids = engine.tokenize([text])
    padded[0, : ids.shape[1]] = ids[0]
    inputs = tcfm.prepare_inputs(t(ref_mel), torch.tensor([14]), torch.tensor([50]), 64,
                                 text_ids=t(padded), ppg=t(ppg))
    common = dict(steps=4, sway_coef=-1.0, compute_dtype=torch.float32, device="cpu",
                  state=state)

    class Engine:  # a captured engine of this bucket: plain CFG with no PPG only
        def sample(self, *a):
            raise AssertionError("reached the captured engine")

    engine.engines = {"sampler_nfe4_b64": Engine()}
    got = engine.synthesize_chunk(ref_mel, text, 50, seed=5, mode="vc", alpha_spk=1.5,
                                  alpha_ppg=2.0, ppg=ppg, device_out=True)[0]
    want, _ = tcfm.sample_vc(params, arch_t, CFMConfig(), inputs, alpha_spk=1.5, alpha_ppg=2.0,
                             key=tprng.prng_key(5), **common)
    assert torch.equal(got, want) and torch.equal(got[0, :14], inputs.cond[0, :14])
    # plain CFG with a PPG runs eagerly, with the PPG
    cfg = engine.synthesize_chunk(ref_mel, text, 50, seed=5, mode="cfg", ppg=ppg,
                                  device_out=True)[0]
    want, _ = tcfm.sample(params, arch_t, CFMConfig(), inputs, cfg_strength=2.0,
                          key=tprng.prng_key(5), **common)
    assert torch.equal(cfg, want)
    # without a PPG, plain CFG replays the captured engine
    with pytest.raises(AssertionError, match="captured"):
        engine.synthesize_chunk(ref_mel, text, 50, seed=5, mode="cfg")


# ---------------------------------------------------------------------------
# training: the step, the Trainer, the converters
# ---------------------------------------------------------------------------


def _batch(rng, nan=False):
    mel = rng.standard_normal((B, N, 20)).astype(np.float32)
    if nan:
        mel[0, 3, 4] = np.nan
    ids = rng.integers(0, 200, (B, 12)).astype(np.int32)
    ids[1, 9:] = -1
    return {"mel": mel, "mel_lens": np.asarray([N, 31], np.int32), "text_ids": ids,
            "text_lens": np.asarray([12, 9], np.int32),
            "ppg": rng.standard_normal((B, NP, 16)).astype(np.float32),
            "ppg_lens": np.asarray([NP, 15], np.int32)}


def _ppg_conv_biases(params_t):
    return [c["b"].detach().clone() for c in params_t["ppg_embed"]["convs"]]


def test_train_step_keeps_bn_state_like_jax(model):
    """3 micro-steps, the second with a NaN: params, EMA and BatchNorm state.

    Each PPG conv feeds a training-mode BatchNorm, which takes its bias out
    again: the bias's gradient is zero analytically and rounding noise
    (~1e-9) on each side, which Adam scales up to steps of up to the
    learning rate in directions of its own. So those biases are held to
    2 x lr, and each running mean, which adds 0.1 x the bias of the step's
    forward, to 2e-6 after the two sides' bias difference is taken out;
    every other leaf to 2e-6."""
    arch_j, arch_t, params_np, state_np = model
    lr_kw = dict(learning_rate=1e-3, num_warmup_updates=2, max_grad_norm=1.0)
    opt_j = jstep.make_optimizer(JTrainConfig(**lr_kw), total_updates=3)
    ema_j = jstep.EMASettings(beta=0.99, update_after_step=0, update_every=1)
    ts_j = jstep.init_train_state(jax.tree.map(jnp.asarray, params_np),
                                  jax.tree.map(jnp.asarray, state_np), opt_j)
    step_j = jax.jit(partial(jstep.train_step, arch=arch_j, cfm=JCFMConfig(), optimizer=opt_j,
                             ema=ema_j, compute_dtype=jnp.float32))
    opt_t = tstep.make_optimizer(TrainConfig(**lr_kw), total_updates=3)
    ema_t = tstep.EMASettings(beta=0.99, update_after_step=0, update_every=1)
    params, state = dit_from_jax(params_np, arch_t, state_np)
    ts_t = tstep.init_train_state(params, opt_t, state)
    rng, key = np.random.default_rng(8), jax.random.PRNGKey(9)
    mean_gap = [torch.zeros(16) for _ in range(3)]  # what the bias differences put in the means
    for i in range(3):
        batch = _batch(rng, nan=(i == 1))
        before = tstep.tree_map(lambda x: x.clone(), ts_t.model_state)
        bias_t = _ppg_conv_biases(ts_t.params)
        bias_j = _ppg_conv_biases(dit_from_jax(jax.tree.map(np.asarray, ts_j.params), arch_t,
                                               state_np)[0])
        ts_j, m_j = step_j(ts_j, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        ts_t, m_t = tstep.train_step(ts_t, {k: t(v) for k, v in batch.items()}, arch=arch_t,
                                     cfm=CFMConfig(), optimizer=opt_t, ema=ema_t,
                                     rng=tprng.prng_key(9),
                                     compute_dtype=torch.float32)
        assert m_t.skipped == int(m_j.skipped) == int(i == 1)
        moved = [not torch.equal(a, b) for a, b in zip(tstep.tree_leaves(before),
                                                       tstep.tree_leaves(ts_t.model_state))]
        assert any(moved) == (i != 1)
        if i != 1:
            np.testing.assert_allclose(m_t.loss, float(m_j.loss), rtol=1e-4)
            np.testing.assert_allclose(m_t.extra_loss, float(m_j.extra_loss), rtol=1e-4,
                                       atol=1e-7)
            mean_gap = [0.9 * g + 0.1 * (bt - bj) for g, bt, bj in zip(mean_gap, bias_t, bias_j)]
        want = jax.tree.map(np.asarray, ts_j.model_state)
        for layer, (got_l, want_l) in enumerate(zip(ts_t.model_state["ppg_bn"], want["ppg_bn"])):
            np.testing.assert_allclose(got_l["var"].numpy(), want_l["var"], rtol=0, atol=2e-6)
            np.testing.assert_allclose((got_l["mean"] - mean_gap[layer]).numpy(), want_l["mean"],
                                       rtol=0, atol=2e-6)
            assert int(got_l["count"]) == int(want_l["count"])
    assert int(ts_t.model_state["ppg_bn"][0]["count"]) == 3 + 2
    for mine, theirs in ((ts_t.params, ts_j.params), (ts_t.ema_params, ts_j.ema_params)):
        want = dit_from_jax(jax.tree.map(np.asarray, theirs), arch_t, state_np)[0]
        for conv_t, conv_j in zip(mine["ppg_embed"]["convs"], want["ppg_embed"]["convs"]):
            np.testing.assert_allclose(conv_t["b"].detach().numpy(), conv_j["b"].numpy(),
                                       rtol=0, atol=2 * lr_kw["learning_rate"])
        rest_t = {**mine, "ppg_embed": {**mine["ppg_embed"], "convs": [
            {"w": c["w"]} for c in mine["ppg_embed"]["convs"]]}}
        rest_j = {**want, "ppg_embed": {**want["ppg_embed"], "convs": [
            {"w": c["w"]} for c in want["ppg_embed"]["convs"]]}}
        for a, b in zip(tstep.tree_leaves(rest_t), tstep.tree_leaves(rest_j), strict=True):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0, atol=2e-6)


MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=20,
              target_sample_rate=8000)


def _rows(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"audio": {"array": (0.1 * rng.standard_normal(int((0.5 + 0.1 * i) * 8000)))
                       .astype(np.float32), "sampling_rate": 8000},
             "text": "abc def gh"[: 4 + i % 6], "duration": 0.5 + 0.1 * i} for i in range(n)]


class StubExtractor:
    """audio_to_ppg of the right shapes: 20 ms frames of 16 kHz audio, each a
    fixed projection of the frame's samples' statistics."""

    def __init__(self):
        self.calls = 0
        self.proj = torch.linspace(-1, 1, 16)

    def audio_to_ppg(self, wav, lens):
        self.calls += 1
        frames = wav[:, : wav.shape[1] // 320 * 320].reshape(wav.shape[0], -1, 320)
        ppg = frames.std(dim=-1, keepdim=True) * 10 * self.proj + frames.mean(dim=-1,
                                                                              keepdim=True)
        return ppg, (lens // 320).to(torch.int32)


def test_trainer_ppg_extractor_bn_state_checkpoint_and_resume(tmp_path):
    arch = DiTConfig(**{**TINY, "dim": 32, "depth": 1, "heads": 1}, ppg=PPGConfig(**PPG),
                     codebook=CodebookConfig(**CB))
    mel = MelConfig(**MEL_KW)
    ds = tdata.ArrowSpeechDataset(_rows(), durations=[r["duration"] for r in _rows()], mel=mel,
                                  with_16k_audio=True)
    loader = tdata.build_loader(ds, list_str_to_bytes, frames_threshold=300, max_samples=2,
                                len_multiple=32)
    tc = TrainConfig(learning_rate=1e-3, num_warmup_updates=2, save_per_updates=1000,
                     last_per_updates=100, save_dir=str(tmp_path), seed=0,
                     compute_dtype="float32")
    model_cfg = ModelConfig(name="tiny", arch=arch, mel=mel, cfm=CFMConfig())
    stub, logs = StubExtractor(), []
    trainer = Trainer(model_cfg, tc, vocab_size=VOCAB, tokenize=list_str_to_bytes,
                      log_fn=lambda m, u: logs.append(m), device="cpu", ppg_extractor=stub)
    ts, _ = trainer.train(loader, epochs=1, resume=False, max_updates=3)
    assert ts.update == 3 and stub.calls == 3
    assert all(np.isfinite(m["loss"]) and m["loss"] == pytest.approx(
        m["flow_loss"] + m["extra_loss"], rel=1e-5) for m in logs)
    assert int(ts.model_state["ppg_bn"][0]["count"]) == 3
    assert not torch.equal(ts.model_state["ppg_bn"][0]["mean"], torch.zeros(16))
    # model_last carries the state; its EMA export the running statistics
    path = tmp_path / "model_last.pt"
    params, state = dit_from_reference_state_dict(load_state_dict(str(path)), arch)
    for got, want in zip(state["ppg_bn"], ts.model_state["ppg_bn"]):
        assert torch.equal(got["mean"], want["mean"]) and torch.equal(got["var"], want["var"])
    restored = Trainer(model_cfg, tc, vocab_size=VOCAB, tokenize=list_str_to_bytes,
                       device="cpu").load_checkpoint(trainer.init_state(total_updates=5))
    assert all(torch.equal(a, b) for a, b in zip(tstep.tree_leaves(restored.model_state),
                                                 tstep.tree_leaves(ts.model_state)))
    # a batch without 16 kHz audio cannot be extracted
    with pytest.raises(ValueError, match="16 kHz"):
        trainer.device_batch({"mel_lens": np.ones(2, np.int32)})


def test_collate_16k_audio_matches_jax():
    def tok(texts):
        return list_str_to_bytes(texts)

    mel_t, mel_j = MelConfig(**MEL_KW), JMelConfig(**MEL_KW)
    t_items = [tdata.ArrowSpeechDataset(_rows(), mel=mel_t, with_16k_audio=True)[i] for i in (0, 3)]
    j_items = [jdata.ArrowSpeechDataset(_rows(), mel=mel_j, with_16k_audio=True)[i]
               for i in (0, 3)]
    got = tdata.collate(t_items, tok, mel_t, len_multiple=32, text_multiple=8)
    want = jdata.collate(j_items, tok, mel_j, len_multiple=32, text_multiple=8)
    assert got.keys() == want.keys() and "audio_16k_lens" in got
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("depth", [1, 2])
def test_dit_converters_ppg_codebook_match_jax_dit_to_torch(model, depth):
    arch_j, arch_t, _, state_np = model
    arch_j = dataclasses.replace(arch_j, codebook=dataclasses.replace(
        arch_j.codebook, weight_proj_depth=depth))
    arch_t = dataclasses.replace(arch_t, codebook=dataclasses.replace(
        arch_t.codebook, weight_proj_depth=depth))
    params_np, _ = jdit.init_dit(jax.random.PRNGKey(1), arch_j, VOCAB)
    params_np = _seeded(params_np, 2)
    want = dit_to_torch(params_np, state_np, arch_j)
    port, state = dit_from_jax(params_np, arch_t, state_np)
    got = dit_to_reference_state_dict(tdit.fuse_qkv(port), arch_t, state=state)
    if depth == 1:  # the JAX export writes a one-layer weight_proj only
        assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert "ppg_embed.ppg_proj.7.running_var" in "".join(got) and "transformer.quantizer.vars" in got
    back, back_state = dit_from_reference_state_dict(got, arch_t)
    a, b = _flat(back), _flat(port)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for g, w in zip(back_state["ppg_bn"], state["ppg_bn"]):
        assert torch.equal(g["mean"], w["mean"]) and torch.equal(g["var"], w["var"])
    with pytest.raises(ValueError, match="state"):
        dit_to_reference_state_dict(port, arch_t)


def _flat(tree, prefix=""):
    """{dotted path: tensor} of a nested dict/list tree, whatever the key order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_example_yaml_is_the_chip_smoke_f5e_config():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    want = tconfig.load_yaml(str(ROOT / "configs" / "example.yaml"))
    got = chip_smoke.f5e_model_config()
    assert got.arch == want.arch and got.mel == want.mel
    assert (want.tokenizer, got.tokenizer, got.vocab_size) == ("pinyin", "byte", 256)
    assert got.arch.checkpoint_activations and got.arch.remat_policy == "block"
    assert (got.arch.dim, got.arch.depth, got.arch.heads, got.arch.ppg.ppg_dim) == (768, 18, 12,
                                                                                     256)
