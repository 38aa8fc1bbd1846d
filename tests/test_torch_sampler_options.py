"""The samplers' options in the port against the JAX package on the CPU, fp32,
at tiny DiTs (dim 64, depth 2, heads 2 x 32; a PPG + codebook one for the VC
sampler), with the noise injected: the JAX `noise_like` of the key the JAX
sampler gets is handed to the port as `y0`.

- `sample(use_mask=False)`: no key mask reaches the trunk.
- The duplicate_test probe: `sample(t_start=, test_cond=)` cuts the steps to
  max(int(steps (1 - t_start)), 1), starts the sway grid at t_start and the
  ODE at (1 - t_start) y0 + t_start test_cond.
- `sample_tts` / `sample_vc` with `use_mask=False`.
  Tolerance atol 1e-3 after 8 fp32 Euler steps, as test_torch_sampler.py.
- Per-request seeds (`seeds=`): torch cannot reproduce JAX's streams, so
  what is held is the JAX docstring's contract (f5e_tts_tpu/models/cfm.py:
  noise_like): a seeded sample's noise has the same bits alone and in any
  slot of a batch of three, and equals the batch-of-one draw of
  `TTSEngine.synthesize_chunk(seed=)`; the sampler's output for that sample
  agrees alone and batched within 1e-5 (another batch size may sum the
  products in another order).
"""

from __future__ import annotations

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
from f5e_tts_tpu_torch.config import CFMConfig, CodebookConfig, DiTConfig, PPGConfig
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0)
N, STEPS = 64, 8
REF_LENS, DURS = (40, 20), (57, 45)


def t(a):
    return torch.from_numpy(np.array(a))


def _seeded(tree, rng):
    """numpy copy of a JAX tree; zero leaves (AdaLN-zero, proj_out) seeded."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if np.asarray(a).any()
                        else (0.1 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


def _init(arch_j, vocab):
    params, state = jax.jit(jdit.init_dit, static_argnums=(1, 2))(jax.random.PRNGKey(0), arch_j,
                                                                 vocab)
    return _seeded(params, np.random.default_rng(0)), jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def tiny():
    params, _ = _init(JDiTConfig(**TINY), 8)
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((2, 40, 20)).astype(np.float32)
    ids = np.asarray([[1, 2, 3, 3, 4, 0, 5, -1], [4, 4, 2, 1, -1, -1, -1, -1]], np.int32)
    return params, dit_from_jax(params, DiTConfig(**TINY)), cond, ids


def _inputs(cond, ids, batch=2):
    j_in = jcfm.prepare_inputs(jnp.asarray(cond[:batch]), jnp.asarray(REF_LENS[:batch]),
                               jnp.asarray(DURS[:batch]), N, text_ids=jnp.asarray(ids[:batch]))
    t_in = tcfm.prepare_inputs(t(cond[:batch]), torch.tensor(REF_LENS[:batch]),
                               torch.tensor(DURS[:batch]), N, text_ids=t(ids[:batch]))
    return j_in, t_in


@pytest.mark.parametrize("opts", [dict(use_mask=False), dict(use_mask=False, cfg_strength=0.0),
                                  dict(t_start=0.25, test_cond=True), dict(t_start=0.5),
                                  dict(t_start=0.9, test_cond=True)],
                         ids=["no-mask", "no-mask-cfg0", "t_start-test_cond", "t_start",
                              "t_start-one-step"])
def test_sample_options_match_jax(tiny, opts):
    params_np, params, cond, ids = tiny
    opts = dict(opts)
    cfg = opts.pop("cfg_strength", 2.0)
    key = jax.random.PRNGKey(3)
    j_in, t_in = _inputs(cond, ids)
    test_cond = None
    if opts.pop("test_cond", False):  # the probe's shifted ground truth
        test_cond = np.random.default_rng(2).standard_normal((2, N, 20)).astype(np.float32)
    want, _ = jcfm.sample(params_np, {}, JDiTConfig(**TINY), JCFMConfig(), j_in, key, steps=STEPS,
                          cfg_strength=cfg, sway_coef=-1.0, compute_dtype=jnp.float32,
                          test_cond=None if test_cond is None else jnp.asarray(test_cond), **opts)
    y0 = t(jcfm.noise_like(key, 2, N, 20, j_in.duration))
    got, traj = tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), t_in, steps=STEPS,
                            cfg_strength=cfg, sway_coef=-1.0, y0=y0, compute_dtype=torch.float32,
                            device="cpu", test_cond=None if test_cond is None else t(test_cond),
                            **opts)
    steps = max(int(STEPS * (1 - opts.get("t_start", 0.0))), 1)
    assert traj.shape == (steps + 1, 2, N, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])


def test_the_mask_changes_the_output(tiny):
    """use_mask=False is not a no-op here: the frames past each duration are
    keys of the unmasked trunk."""
    _, params, cond, ids = tiny
    _, t_in = _inputs(cond, ids)
    y0 = tcfm.noise_like(None, 2, N, 20, t_in.duration, seeds=[1, 2])
    runs = [tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), t_in, steps=2, y0=y0,
                        compute_dtype=torch.float32, device="cpu", use_mask=m)[0]
            for m in (True, False)]
    assert (runs[0] - runs[1]).abs().max() > 1e-4


@pytest.fixture(scope="module")
def ppg_model():
    ppg = dict(use_ppg=True, ppg_dim=16)
    cb = dict(use_codebook=True, num_vars=10, groups=2)
    tiny = {**TINY, "text_mask_padding": False, "pe_attn_head": 1}
    arch_j = JDiTConfig(**tiny, ppg=JPPGConfig(**ppg), codebook=JCodebookConfig(**cb))
    arch_t = DiTConfig(**tiny, ppg=PPGConfig(**ppg), codebook=CodebookConfig(**cb))
    params, state = _init(arch_j, 16)
    return arch_j, arch_t, params, state


@pytest.mark.parametrize("which", ["sample_tts", "sample_vc"])
def test_tts_and_vc_samplers_without_the_mask_match_jax(ppg_model, which):
    arch_j, arch_t, params_np, state_np = ppg_model
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((1, 14, 20)).astype(np.float32)
    ids = rng.integers(0, 16, (1, 12)).astype(np.int32)
    ppg = rng.standard_normal((1, 22, 16)).astype(np.float32)
    key, dur = jax.random.PRNGKey(6), 33
    kw = {"sample_tts": dict(alpha_spk=2.0, alpha_txt=1.5),
          "sample_vc": dict(alpha_spk=1.5, alpha_ppg=2.0)}[which]
    j_in = jcfm.prepare_inputs(jnp.asarray(ref), jnp.asarray([14]), jnp.asarray([dur]), N,
                               text_ids=jnp.asarray(ids), ppg=jnp.asarray(ppg))
    want, _ = getattr(jcfm, which)(params_np, jax.tree.map(jnp.asarray, state_np), arch_j,
                                   JCFMConfig(), j_in, key, steps=6, sway_coef=-1.0,
                                   use_mask=False, compute_dtype=jnp.float32, **kw)
    y0 = t(jcfm.noise_like(key, 1, N, 20, jnp.asarray([dur])))
    params, state = dit_from_jax(params_np, arch_t, state_np)
    t_in = tcfm.prepare_inputs(t(ref), torch.tensor([14]), torch.tensor([dur]), N,
                               text_ids=t(ids), ppg=t(ppg))
    got, _ = getattr(tcfm, which)(params, arch_t, CFMConfig(), t_in, steps=6, sway_coef=-1.0,
                                  use_mask=False, y0=y0, compute_dtype=torch.float32,
                                  device="cpu", state=state, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


# ---------------------------------------------------------------------------
# per-request seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slot", [0, 1, 2])
def test_seeded_noise_is_the_same_alone_and_in_any_slot(slot):
    seed, others = 1234, [7, 99]
    durations = torch.tensor([50, 64, 31])
    alone = tcfm.noise_like(None, 1, N, 20, durations[slot:slot + 1], seeds=[seed])
    # the pipeline's batch-of-one draw (TTSEngine.synthesize_chunk(seed=))
    pipe = tcfm.noise_like(torch.Generator().manual_seed(seed), 1, N, 20,
                           durations[slot:slot + 1])
    assert torch.equal(alone, pipe)
    seeds = others[:slot] + [seed] + others[slot:]
    batch = tcfm.noise_like(None, 3, N, 20, durations, seeds=torch.tensor(seeds))
    assert torch.equal(batch[slot:slot + 1], alone)
    for i, s in enumerate(seeds):  # every slot is its own seed's draw, zero past its duration
        assert torch.equal(batch[i], tcfm.noise_like(None, 1, N, 20, durations[i:i + 1],
                                                     seeds=[s])[0])
        assert not batch[i, int(durations[i]):].any()
    with pytest.raises(ValueError, match="2 seeds for a batch of 3"):
        tcfm.noise_like(None, 3, N, 20, durations, seeds=[1, 2])


def test_a_seeded_request_samples_the_same_alone_and_batched(tiny):
    _, params, cond, ids = tiny
    cond3 = np.concatenate([cond, cond[:1] * 0.5])
    ids3 = np.concatenate([ids, ids[1:]])
    t3 = tcfm.prepare_inputs(t(cond3), torch.tensor([40, 20, 30]), torch.tensor([57, 45, 60]), N,
                             text_ids=t(ids3))
    kw = dict(steps=4, compute_dtype=torch.float32, device="cpu")
    batch, _ = tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), t3, seeds=[5, 21, 8], **kw)
    one = tcfm.SamplerInputs(*(x[1:2] for x in t3[:4]))
    alone, _ = tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), one, seeds=[21], **kw)
    np.testing.assert_allclose(batch[1:2].numpy(), alone.numpy(), rtol=0, atol=1e-5)
    # y0 takes precedence over seeds and the generator
    y0 = tcfm.noise_like(None, 1, N, 20, one.duration, seeds=[3])
    a, _ = tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), one, y0=y0, seeds=[21],
                       generator=torch.Generator().manual_seed(21), **kw)
    b, _ = tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), one, seeds=[3], **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="seeds, a generator or an explicit y0"):
        tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), one, **kw)


def test_synthesize_chunk_noise_is_the_seeds_draw(tiny):
    """A request through the engine with seed s samples what `sample(seeds=[s])`
    samples for its inputs: the serving batcher's per-request noise."""
    _, params, cond, _ = tiny
    engine = tpipe.TTSEngine(params=params, arch=DiTConfig(**TINY), vocab={"a": 1, "b": 2},
                             tokenizer="custom", compute_dtype=torch.float32, buckets=(N,),
                             device="cpu")
    engine.infer_cfg = type(engine.infer_cfg)(nfe_steps=3, max_duration=N)
    out, ref_frames, duration = engine.synthesize_chunk(cond[:1, :20], "ab", 50, seed=77,
                                                        device_out=True)
    text = np.full((1, engine.text_pad_to), -1, np.int32)
    text[0, :2] = engine.tokenize(["ab"])[0]
    inputs = tcfm.prepare_inputs(t(cond[:1, :20]), torch.tensor([ref_frames]),
                                 torch.tensor([duration]), N, text_ids=t(text[:, :N]))
    want, _ = tcfm.sample(params, DiTConfig(**TINY), CFMConfig(), inputs, steps=3, seeds=[77],
                          compute_dtype=torch.float32, device="cpu")
    assert torch.equal(out, want)
