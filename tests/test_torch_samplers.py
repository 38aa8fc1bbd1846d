"""The port's other sampler modes against the JAX package on the CPU: the
dual-alpha TTS sampler, the edit mask and `no_ref_audio` of `prepare_inputs`,
and speech editing, on a tiny DiT (dim 64, depth 2, 2 x 32 heads, mel 20)
and a tiny UNetT, fp32, with the noise injected (drawn with the JAX
`noise_like` under the key the JAX sampler gets).

- `prepare_inputs(edit_mask=, no_ref_audio=)`: exact.
- `sample_tts` vs JAX: atol 1e-3 over 8 fp32 Euler steps, prompt frames
  exact; with alpha_spk = alpha_txt = 1 + cfg it is the plain CFG `sample`
  (the text-only branch has weight 0): atol 1e-5 in fp32.
- `synthesize_chunk(mode="tts")` runs `sample_tts` (never a captured
  engine); `mode="vc"` raises for a model without PPG (the PPG model's vc
  mode is held in tests/test_torch_ppg.py); the CTC span derivation
  (`token_spans_from_alignment`, `derive_edit_spans`) equals JAX's exactly.
- `build_edit_mask` exactly; `edit_speech`'s cond mel (rtol 1e-4 + atol
  1e-4, the mel front ends' own parity tolerance), mask, duration and text
  exactly, and its sampler output, each side drawing its own noise for the
  seed (nothing injected), at atol 1e-3 with every kept frame equal to the
  cond mel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.config import UNetTConfig as JUNetTConfig
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.infer import speech_edit as jedit
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.models import unett as junett
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, InferConfig, MelConfig, UNetTConfig
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.infer import speech_edit as tedit
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.utils.convert import dit_from_jax, unett_from_jax

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0)
TINY_U = dict(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=20, dropout=0.0)
t = torch.from_numpy


def _seeded(params, seed):
    """numpy copy of a JAX tree; zero leaves (AdaLN-zero, proj_out) get
    seeded values so every weight shapes the output."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).any()
                        else (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def dit():
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**TINY), 256)
    params = _seeded(params, 0)
    return JDiTConfig(**TINY), DiTConfig(**TINY), params, dit_from_jax(params, DiTConfig(**TINY))


@pytest.fixture(scope="module")
def unett():
    params, _ = junett.init_unett(jax.random.PRNGKey(1), JUNetTConfig(**TINY_U), 256)
    params = jax.tree.map(np.asarray, params)
    arch_t = UNetTConfig(**TINY_U)
    return JUNetTConfig(**TINY_U), arch_t, params, unett_from_jax(params, arch_t)


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((1, 40, 20)).astype(np.float32)
    ids = np.asarray([[1, 2, 3, 3, 4, 0, 5, -1]], np.int32)
    j_in = jcfm.prepare_inputs(jnp.asarray(cond), jnp.asarray([40]), jnp.asarray([57]), n,
                               text_ids=jnp.asarray(ids))
    t_in = tcfm.prepare_inputs(t(cond), torch.tensor([40]), torch.tensor([57]), n,
                               text_ids=t(ids))
    return j_in, t_in


@pytest.mark.parametrize("edit,no_ref", [(True, False), (False, True), (True, True),
                                         (False, False)])
def test_prepare_inputs_edit_mask_and_no_ref_audio_match_jax(edit, no_ref):
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((2, 30, 20)).astype(np.float32)
    lens, dur, ids = np.asarray([30, 21]), np.asarray([50, 40]), np.asarray([[1, 2, -1], [3, 4, 5]])
    edit_mask = rng.random((2, 37)) < 0.7 if edit else None
    want = jcfm.prepare_inputs(jnp.asarray(cond), jnp.asarray(lens), jnp.asarray(dur), 48,
                               text_ids=jnp.asarray(ids),
                               edit_mask=None if edit_mask is None else jnp.asarray(edit_mask),
                               no_ref_audio=no_ref)
    got = tcfm.prepare_inputs(t(cond), t(lens), t(dur), 48, text_ids=t(ids),
                              edit_mask=None if edit_mask is None else t(edit_mask),
                              no_ref_audio=no_ref)
    for name in ("cond", "cond_mask", "duration", "text_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.cond_mask.dtype == torch.bool and got.cond.shape == (2, 48, 20)


@pytest.mark.parametrize("backbone", ["dit", "unett"])
@pytest.mark.parametrize("alphas,sway,grid", [((1.0, 1.0), None, None), ((2.5, 1.5), -1.0, None),
                                              ((0.5, 3.0), None, (0, 2, 5, 8))])
def test_sample_tts_matches_jax_with_injected_noise(backbone, alphas, sway, grid, request):
    arch_j, arch_t, params_np, params = request.getfixturevalue(backbone)
    j_in, t_in = _inputs()
    n, steps = 64, 8
    timesteps = None if grid is None else jcfm.pruned_sway_timesteps(grid, base_steps=8)
    key = jax.random.PRNGKey(2)
    want, _ = jcfm.sample_tts(params_np, {}, arch_j, JCFMConfig(), j_in, key, steps=steps,
                              alpha_spk=alphas[0], alpha_txt=alphas[1], sway_coef=sway,
                              timesteps=timesteps, compute_dtype=jnp.float32)
    y0 = np.array(jcfm.noise_like(key, 1, n, 20, j_in.duration))
    got, traj = tcfm.sample_tts(params, arch_t, CFMConfig(), t_in, steps=steps,
                                alpha_spk=alphas[0], alpha_txt=alphas[1], sway_coef=sway,
                                y0=t(y0), timesteps=timesteps, compute_dtype=torch.float32,
                                device="cpu")
    assert traj.shape[0] == (steps if grid is None else len(grid) - 1) + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])


def test_sample_tts_with_equal_alphas_is_plain_cfg(dit):
    """Weights [1 - a, 0, a] with a = 1 + cfg: the null and speaker+text
    branches with plain CFG's weights, the text branch at 0."""
    _, arch_t, _, params = dit
    _, t_in = _inputs(seed=3)
    y0 = torch.randn((1, 64, 20), generator=torch.Generator().manual_seed(0))
    kw = dict(steps=6, sway_coef=-1.0, y0=y0, compute_dtype=torch.float32, device="cpu")
    plain, _ = tcfm.sample(params, arch_t, CFMConfig(), t_in, cfg_strength=2.0, **kw)
    tts, _ = tcfm.sample_tts(params, arch_t, CFMConfig(), t_in, alpha_spk=3.0, alpha_txt=3.0, **kw)
    assert tcfm.tts_branches(3.0, 3.0)[1] == [-2.0, 0.0, 3.0]
    np.testing.assert_allclose(tts.numpy(), plain.numpy(), rtol=0, atol=1e-5)


def test_synthesize_chunk_tts_mode(dit):
    _, arch_t, _, params = dit
    engine = tpipe.TTSEngine(params=params, arch=arch_t, vocab=None, mel=MelConfig(n_mel_channels=20),
                             infer_cfg=InferConfig(nfe_steps=4), compute_dtype=torch.float32,
                             buckets=(64, 128), device="cpu")
    ref_mel = np.random.default_rng(4).standard_normal((1, 30, 20)).astype(np.float32)
    kw = dict(seed=5, mode="tts", alpha_spk=2.0, alpha_txt=1.5)
    got = engine.synthesize_chunk(ref_mel, "some text.", 50, device_out=True, **kw)[0]
    # what the chunk hands the sampler, drawn from the chunk's seed
    padded = np.full((1, 32), -1, np.int32)
    ids = engine.tokenize(["some text."])
    padded[0, :ids.shape[1]] = ids[0]
    inputs = tcfm.prepare_inputs(t(ref_mel), torch.tensor([30]), torch.tensor([50]), 64,
                                 text_ids=t(padded))
    want, _ = tcfm.sample_tts(params, arch_t, CFMConfig(), inputs, steps=4, alpha_spk=2.0,
                              alpha_txt=1.5, sway_coef=-1.0,
                              key=tprng.prng_key(5), compute_dtype=torch.float32, device="cpu")
    assert torch.equal(got, want)

    class Engine:  # a captured engine of this bucket: plain CFG only, never tts
        def sample(self, *a):
            raise AssertionError("the tts mode reached a captured engine")

    engine.engines = {"sampler_nfe4_b64": Engine()}
    again = engine.synthesize_chunk(ref_mel, "some text.", 50, device_out=True, **kw)[0]
    assert torch.equal(again, got)
    with pytest.raises(AssertionError, match="captured"):
        engine.synthesize_chunk(ref_mel, "some text.", 50, seed=5)
    with pytest.raises(ValueError, match="PPG DiT"):
        engine.synthesize_chunk(ref_mel, "some text.", 50, mode="vc")
    with pytest.raises(ValueError, match="mode"):
        engine.synthesize_chunk(ref_mel, "some text.", 50, mode="ttz")


# ---------------------------------------------------------------------------
# speech editing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts,fix", [([(0.3, 0.55)], None), ([(0.1, 0.2), (0.5, 0.8)], None),
                                       ([(0.1, 0.2), (0.5, 0.8)], [0.3, 0.05]),
                                       ([(0.0, 0.4)], [0.6])])
def test_build_edit_mask_matches_jax(parts, fix):
    for got, want in zip(tedit.build_edit_mask(parts, 24_000, MelConfig(), fix),
                         jedit.build_edit_mask(parts, 24_000, JMelConfig(), fix)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    mask = jedit.build_edit_mask(parts, 24_000, JMelConfig(), fix)[1]
    assert tedit._runs(mask) == jedit._runs(mask)


def test_span_derivation_waits_for_ctc_alignment():
    """Span derivation from CTC posteriors, now on the port's
    ctc_forced_align: per-token spans and edit spans equal JAX's exactly,
    and they feed build_edit_mask as JAX's do."""
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((50, 6)) * 3
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    tokens = [2, 5, 5, 1, 3, 4]
    assert (tedit.token_spans_from_alignment(lp, tokens, 0.02)
            == jedit.token_spans_from_alignment(lp, tokens, 0.02))
    spans = tedit.derive_edit_spans(lp, tokens, [(1, 2), (4, 5)], 0.02)
    assert spans == jedit.derive_edit_spans(lp, tokens, [(1, 2), (4, 5)], 0.02)
    mel = MelConfig(n_mel_channels=20)
    for got, want in zip(tedit.build_edit_mask(spans, 16_000, mel),
                         jedit.build_edit_mask(spans, 16_000, JMelConfig(n_mel_channels=20))):
        np.testing.assert_array_equal(got, want)


def test_edit_speech_matches_jax(dit, monkeypatch):
    arch_j, arch_t, params_np, params = dit
    mel_j, mel_t = JMelConfig(n_mel_channels=20), MelConfig(n_mel_channels=20)
    rng = np.random.default_rng(6)
    sr = 16_000
    wav = (0.2 * np.sin(2 * np.pi * 180 * np.arange(sr) / sr)
           + 0.02 * rng.standard_normal(sr)).astype(np.float32)
    parts, fix = [(0.3, 0.5)], [0.35]
    kw = dict(fix_durations=fix, seed=3, nfe_steps=4, cfg_strength=2.0, sway=-1.0)
    jeng = jpipe.TTSEngine(params=params_np, state={}, arch=arch_j, vocab=None, mel=mel_j,
                           tokenizer="byte", compute_dtype=jnp.float32)
    teng = tpipe.TTSEngine(params=params, arch=arch_t, vocab=None, mel=mel_t,
                           compute_dtype=torch.float32, device="cpu")
    seen = {}
    j_sample, t_sample = jcfm.sample, tcfm.sample

    def j_record(p, s, a, c, inputs, key, **k):
        out = j_sample(p, s, a, c, inputs, key, **k)
        seen["j"] = (inputs, out[0])
        return out

    def t_record(p, a, c, inputs, **k):
        out = t_sample(p, a, c, inputs, **k)
        seen["t"] = (inputs, out[0])
        return out

    monkeypatch.setattr(jcfm, "sample", j_record)
    jwav, jsr = jedit.edit_speech(jeng, wav, sr, "orig", "new text here", parts, **kw)
    monkeypatch.setattr(tcfm, "sample", t_record)
    twav, tsr = tedit.edit_speech(teng, wav, sr, "orig", "new text here", parts, **kw)
    j_in, j_out = seen["j"]
    t_in, t_out = seen["t"]
    assert tsr == jsr == 24_000 and twav.shape == jwav.shape and np.isfinite(twav).all()
    # the mel front ends' own parity tolerance (tests/test_torch_audio.py)
    np.testing.assert_allclose(t_in.cond.numpy(), np.asarray(j_in.cond), rtol=1e-4, atol=1e-4)
    for name in ("cond_mask", "duration", "text_ids"):
        np.testing.assert_array_equal(getattr(t_in, name).numpy(), np.asarray(getattr(j_in, name)),
                                      err_msg=name)
    assert not t_in.cond_mask.all() and t_in.cond_mask.any()  # the span is generated
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(t_out)
    assert torch.equal(t_out[keep], t_in.cond[keep])


def test_backbone_sample_step_over_unett_is_its_forward(unett):
    """The sampler's step (text embedding precomputed) is the full forward."""
    _, arch_t, _, params = unett
    rng = np.random.default_rng(7)
    x, cond = (t(rng.standard_normal((2, 16, 20)).astype(np.float32)) for _ in range(2))
    ids, time = torch.tensor([[1, 2, 3, -1], [4, 5, 6, 7]]), torch.tensor([0.1, 0.6])
    f = torch.tensor([False, True])
    mask = torch.arange(16)[None] < torch.tensor([[16], [11]])
    te = tbb.precompute_text_embed(params, arch_t, ids, 2, 16, torch.zeros(2, dtype=torch.bool),
                                   torch.float32)
    step = tbb.sample_step(params, arch_t, x=x, cond=cond, text_embed=te, time=time,
                           drop_audio_cond=f, mask=mask, compute_dtype=torch.float32)
    full = tbb.forward_train(params, arch_t, x=x, cond=cond, text_ids=ids, time=time,
                             drop_audio_cond=f, drop_text=torch.zeros(2, dtype=torch.bool),
                             mask=mask, compute_dtype=torch.float32)
    assert torch.equal(step, full)
