"""The partial-RoPE DiT presets (`F5TTS_Base`, `F5TTS_Small`: pe_attn_head=1,
text_mask_padding=False) in the port against the JAX package on the CPU, at
a tiny DiT of that shape (dim 64, depth 2, heads 2 x 32, RoPE on the first
head only), fp32, on the same numpy-seeded inputs.

- the presets' fields equal the JAX package's;
- `dit_forward` (the training forward) vs JAX: atol 1e-4;
- `cfm_loss` value and every gradient vs jax.value_and_grad, draws derived
  from the JAX key: loss rtol 1e-5, gradients rtol 1e-3 + atol 5e-5 * max|grad|
  (fp32 on both sides; a tensor's near-zero elements carry the summation
  noise of its largest, ~2e-5 of it here);
- `sample` with injected noise: atol 1e-3 over 8 fp32 Euler steps;
- `F5TTS(model="F5TTS_Base")` and `Trainer(preset("F5TTS_Base"))` run on the
  CPU at a narrowed width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu import config as jconfig
from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.api import F5TTS
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, MelConfig, TrainConfig
from f5e_tts_tpu_torch.data import dataset as tdata
from f5e_tts_tpu_torch.infer import audio as taudio
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer
from f5e_tts_tpu_torch.utils.convert import dit_from_jax
from f5e_tts_tpu_torch.utils.text import list_str_to_bytes

# F5TTS_Base's shape, narrowed: RoPE on one head of two, unmasked text padding
TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0, pe_attn_head=1, text_mask_padding=False)
B, N = 2, 32


@pytest.fixture(scope="module")
def model():
    arch_j, arch_t = JDiTConfig(**TINY), DiTConfig(**TINY)
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), arch_j, 16)
    rng = np.random.default_rng(0)

    def leaf(a):
        a = np.asarray(a, np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a

    return arch_j, arch_t, jax.tree.map(leaf, params)


def _batch(rng):
    mel = rng.standard_normal((B, N, TINY["mel_dim"])).astype(np.float32)
    ids = rng.integers(0, 16, (B, 12)).astype(np.int32)
    ids[1, 9:] = -1
    return mel, np.asarray([N, 27], np.int32), ids


@pytest.mark.parametrize("name", ["F5TTS_v1_Base", "F5TTS_Base", "F5TTS_Small"])
def test_presets_equal_the_jax_presets(name):
    ours, theirs = tconfig.preset(name), jconfig.preset(name)
    assert ours.backbone == theirs.backbone == "DiT"
    theirs_arch = dataclasses.asdict(theirs.arch)
    for field, value in dataclasses.asdict(ours.arch).items():
        assert theirs_arch[field] == value, field
    if name != "F5TTS_v1_Base":
        assert ours.arch.pe_attn_head == 1 and not ours.arch.text_mask_padding


def test_mmdit_config_equals_the_jax_config():
    assert dataclasses.asdict(tconfig.MMDiTConfig()) == dataclasses.asdict(jconfig.MMDiTConfig())


@pytest.mark.parametrize("masked", [True, False])
def test_partial_rope_dit_forward_matches_jax(model, masked):
    arch_j, arch_t, params_np = model
    rng = np.random.default_rng(1)
    x, _, ids = _batch(rng)
    cond = rng.standard_normal(x.shape).astype(np.float32)
    time = np.asarray([0.3, 0.9], np.float32)
    drop_a, drop_t = np.asarray([False, True]), np.asarray([True, False])
    mask = (np.arange(N)[None, :] < np.asarray([N, 21])[:, None]) if masked else None
    want, _ = jdit.dit_forward(
        params_np, {}, arch_j, x=jnp.asarray(x), cond=jnp.asarray(cond), text_ids=jnp.asarray(ids),
        time=jnp.asarray(time), drop_audio_cond=jnp.asarray(drop_a), drop_text=jnp.asarray(drop_t),
        drop_ppg=jnp.zeros((B,), bool), mask=None if mask is None else jnp.asarray(mask),
        compute_dtype=jnp.float32)
    t = torch.from_numpy
    got = tdit.dit_forward(dit_from_jax(params_np, arch_t), arch_t, x=t(x), cond=t(cond),
                           text_ids=t(ids), time=t(time), drop_audio_cond=t(drop_a),
                           drop_text=t(drop_t), mask=None if mask is None else t(mask),
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_partial_rope_differs_from_full_rope(model):
    """pe_attn_head reaches the attention: RoPE on every head gives another flow."""
    _, arch_t, params_np = model
    x, _, ids = _batch(np.random.default_rng(2))
    t = torch.from_numpy
    f = torch.zeros(B, dtype=torch.bool)
    kw = dict(x=t(x), cond=t(x), text_ids=t(ids), time=torch.tensor([0.3, 0.9]),
              drop_audio_cond=f, drop_text=f, compute_dtype=torch.float32)
    params = dit_from_jax(params_np, arch_t)
    one = tdit.dit_forward(params, arch_t, **kw)
    full = tdit.dit_forward(params, dataclasses.replace(arch_t, pe_attn_head=None), **kw)
    assert (one - full).abs().max() > 1e-3


def test_partial_rope_cfm_loss_and_grads_match_jax(model):
    arch_j, arch_t, params_np = model
    mel, mel_lens, ids = _batch(np.random.default_rng(3))
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jcfm.cfm_loss(p, {}, arch_j, JCFMConfig(), mel=jnp.asarray(mel),
                             mel_lens=jnp.asarray(mel_lens), text_ids=jnp.asarray(ids), rng=key,
                             training=True, compute_dtype=jnp.float32).loss

    want, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params_np)
    params = tstep.tree_map(lambda t: t.requires_grad_(True), dit_from_jax(params_np, arch_t))
    out = tcfm.cfm_loss(params, arch_t, CFMConfig(), mel=torch.from_numpy(mel),
                        mel_lens=torch.from_numpy(mel_lens), text_ids=torch.from_numpy(ids),
                        rng=tprng.prng_key(5), compute_dtype=torch.float32)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    got = tstep.tree_leaves(tstep.tree_map(lambda t: t.grad, params))
    ref = tstep.tree_leaves(dit_from_jax(jax.tree.map(np.asarray, grads_j), arch_t))
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=5e-5 * max(np.abs(w).max(), 1e-12))


@pytest.mark.parametrize("cfg", [2.0, 0.0])
def test_partial_rope_sample_matches_jax_with_injected_noise(model, cfg):
    arch_j, arch_t, params_np = model
    cond = np.random.default_rng(4).standard_normal((1, 40, TINY["mel_dim"])).astype(np.float32)
    ids = np.asarray([[1, 2, 3, 3, 4, 0, 5, -1]], np.int32)
    n, steps = 64, 8
    key = jax.random.PRNGKey(1)
    j_in = jcfm.prepare_inputs(jnp.asarray(cond), jnp.asarray([40]), jnp.asarray([57]), n,
                               text_ids=jnp.asarray(ids))
    want, _ = jcfm.sample(params_np, {}, arch_j, JCFMConfig(), j_in, key, steps=steps,
                          cfg_strength=cfg, sway_coef=-1.0, compute_dtype=jnp.float32)
    y0 = np.array(jcfm.noise_like(key, 1, n, TINY["mel_dim"], j_in.duration))
    t_in = tcfm.prepare_inputs(torch.from_numpy(cond), torch.tensor([40]), torch.tensor([57]), n,
                               text_ids=torch.from_numpy(ids))
    got, _ = tcfm.sample(dit_from_jax(params_np, arch_t), arch_t, CFMConfig(), t_in, steps=steps,
                         cfg_strength=cfg, sway_coef=-1.0, y0=torch.from_numpy(y0),
                         compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])


NARROW = dict(dim=64, depth=2, heads=2, dim_head=32, text_dim=32, conv_layers=1)


def test_f5tts_base_api_runs_on_the_cpu(tmp_path):
    tts = F5TTS(model="F5TTS_Base", model_cfg=NARROW, device="cpu", compute_dtype=torch.float32,
                seed=0)
    arch = tts.engine.arch
    assert (arch.pe_attn_head, arch.text_mask_padding, arch.dim, arch.depth) == (1, False, 64, 2)
    with torch.no_grad():
        w = tts.engine.params["proj_out"]["w"]
        w.copy_(0.05 * torch.randn(w.shape, generator=torch.Generator().manual_seed(1)))
    ref = tmp_path / "ref.wav"
    t = np.arange(int(1.2 * 24_000)) / 24_000
    taudio.write_wav(str(ref), (0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 24_000)
    wav, sr, mel = tts.infer(str(ref), "hello there.", "good morning to you.", nfe_step=2, seed=3)
    assert sr == 24_000 and mel.shape[1] == 100 and mel.shape[0] > 0
    assert len(wav) == mel.shape[0] * 256 and np.isfinite(wav).all()
    assert np.sqrt(np.mean(wav ** 2)) > 0


def test_trainer_with_the_f5tts_base_preset_runs_on_the_cpu(tmp_path):
    mel_cfg = MelConfig(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12,
                        target_sample_rate=8000)
    base = tconfig.preset("F5TTS_Base")
    model_cfg = dataclasses.replace(
        base, tokenizer="byte", vocab_size=256, mel=mel_cfg,
        arch=dataclasses.replace(base.arch, **NARROW, mel_dim=12, dropout=0.0))
    rng = np.random.default_rng(5)
    rows = [{"audio": {"array": (0.1 * rng.standard_normal(int((0.5 + 0.1 * i) * 8000)))
                       .astype(np.float32), "sampling_rate": 8000},
             "text": "abc def gh"[: 4 + i], "duration": 0.5 + 0.1 * i} for i in range(4)]
    ds = tdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows], mel=mel_cfg)
    loader = tdata.build_loader(ds, list_str_to_bytes, frames_threshold=300, max_samples=2,
                                len_multiple=32)
    tc = TrainConfig(learning_rate=1e-3, num_warmup_updates=1, save_per_updates=100,
                     last_per_updates=100, save_dir=str(tmp_path / "ck"), seed=0)
    logs = []
    trainer = Trainer(model_cfg, tc, vocab_size=256, tokenize=list_str_to_bytes,
                      log_fn=lambda m, u: logs.append(m), device="cpu")
    ts, info = trainer.train(loader, epochs=1, resume=False, max_updates=2)
    assert ts.update == 2 and len(logs) == 2
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logs)
    assert (tmp_path / "ck" / "model_last.pt").exists()
