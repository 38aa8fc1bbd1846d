"""JAX's threefry PRNG in the port (`f5e_tts_tpu_torch/ops/prng.py`) against
`jax.random` on the CPU, and the port's seeded inference against the JAX
package's with nothing injected: each side draws its own noise for the seed.

- `prng_key`, `fold_in`, `split`, `random_bits` and `uniform` bit for bit
  against `jax.random` (PRNGKey, fold_in, split, bits, uniform) for seeds 0,
  1, 42, 2**31 - 1 and -1 at shapes (1,), (7,), (3, 5, 7) and (1536, 100);
  `normal` within 4 ulp (XLA's f32 erf_inv, whose log1p rounds differently
  from torch's); the batched forms against `jax.vmap`; a seed outside int64
  raises OverflowError in both.
- `cfm.noise_like` against JAX's on the key path and the `seeds` path: zero
  past each duration, 4 ulp inside.
- End to end, fp32, the port on the JAX weights (`utils/convert.py`) and a
  stand-in vocoder (a frame's mean over its hop) on both sides, within
  atol 1e-4 (the g2p-mix synthesis test's tolerance):
  `F5TTS.infer(seed=)` over a tiny DiT YAML, one chunk and two (chunk i
  draws under seed + i; 2**31 - 1 + 1 wraps as JAX wraps it), wav and mel;
  `TTSEngine.synthesize_chunk(seed=)` in modes cfg, tts and vc on a tiny
  PPG DiT. Speech editing, the batcher, the eval harness, the MMDiT engine
  replay and the g2p-mix synthesis draw their own noise the same way in
  test_torch_samplers.py, test_torch_batcher.py,
  test_torch_eval_harness.py, test_torch_mmdit_engines.py and
  test_torch_text_frontend.py.
- Training's draws: `bernoulli`, `permutation` (n = 1000 and 2304: one
  and two sort rounds), the codebook's gumbel uniforms on [1e-10, 1) and a
  block at an offset of a larger draw (a mesh rank's rows or columns), bit
  for bit against `jax.random`; dropout on bf16 divides by 1 - rate in
  bf16, as JAX's weakly typed scalar: with the keep mask read off JAX's
  output, the port's output is JAX's bit for bit (the parent port divided
  in f32 and missed it by a bf16 ulp).
- The seeded init weights, with nothing injected: `init_backbone` of a
  DiT, the F5E model's DiT (PPG embedding and codebook), a UNetT and an
  MMDiT, `init_vocos`, and `F5TTS` with no checkpoint, against JAX's under
  the same key: every uniform-initialised tensor bit for bit, the normal
  ones (the text embedding, a one-layer codebook projection) within 4 ulp.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from f5e_tts_tpu.api import F5TTS as JF5TTS
from f5e_tts_tpu.config import CodebookConfig as JCodebookConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import InferConfig as JInferConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.config import MMDiTConfig as JMMDiTConfig
from f5e_tts_tpu.config import PPGConfig as JPPGConfig
from f5e_tts_tpu.config import UNetTConfig as JUNetTConfig
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.models import backbone as jbb
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.models import vocos as jvocos
from f5e_tts_tpu.ops import nn as jfnn
from f5e_tts_tpu_torch import api as tapi
from f5e_tts_tpu_torch.config import (CodebookConfig, DiTConfig, InferConfig, MelConfig,
                                      MMDiTConfig, PPGConfig, UNetTConfig)
from f5e_tts_tpu_torch.infer import audio as taudio
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import vocos as tvocos
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.ops import vq as tvq
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, mmdit_from_jax, unett_from_jax,
                                             vocos_from_jax)

SEEDS = (0, 1, 42, 2**31 - 1, -1)
SHAPES = ((1,), (7,), (3, 5, 7), (1536, 100))
MAX_ULP = 4
ATOL = 1e-4


def _ulp(a, b) -> int:
    """The largest distance in float32 ulps between a and b."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _words(jax_key) -> np.ndarray:
    return np.asarray(jax.random.key_data(jax_key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(tprng.prng_key(seed).numpy(), _words(key))
    for data in (0, 3, 2**32 - 1):
        np.testing.assert_array_equal(tprng.fold_in(tprng.prng_key(seed), data).numpy(),
                                      _words(jax.random.fold_in(key, data)))
    np.testing.assert_array_equal(tprng.split(tprng.prng_key(seed), 5).numpy(),
                                  _words(jax.random.split(key, 5)))


def test_a_seed_outside_int64_raises_as_in_jax():
    for seed in (2**63, -2**63 - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            tprng.prng_key(seed)
    np.testing.assert_array_equal(tprng.prng_key(2**40 + 7).numpy(),
                                  _words(jax.random.PRNGKey(2**40 + 7)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniforms_and_normals_match_jax(seed, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    key = tprng.fold_in(tprng.prng_key(seed), 0)
    np.testing.assert_array_equal(tprng.random_bits(key, shape).numpy(),
                                  np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    got = tprng.uniform(key, shape, -2.0, 3.0).numpy()
    want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, -2.0, 3.0))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got = tprng.normal(key, shape)
    assert got.dtype == torch.float32 and got.shape == shape
    assert _ulp(got.numpy(), jax.random.normal(jkey, shape, jnp.float32)) <= MAX_ULP


def test_batched_draws_match_vmap():
    seeds = [5, 2**31 - 1, 0, 17]
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(s), 0))(
        jnp.asarray(seeds, jnp.int32))
    keys = tprng.fold_in(tprng.prng_keys(seeds), 0)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    np.testing.assert_array_equal(
        tprng.random_bits(keys, (6, 5)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (6, 5), jnp.uint32))(jkeys)))
    want = jax.vmap(lambda k: jax.random.normal(k, (64, 20)))(jkeys)
    assert _ulp(tprng.normal(keys, (64, 20)).numpy(), want) <= MAX_ULP
    # fold_in over a batch of data under one key, as JAX's vmap over the slot
    jkey = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(
        tprng.fold_in(tprng.prng_key(9), torch.arange(4)).numpy(),
        np.asarray(jax.vmap(lambda i: jax.random.fold_in(jkey, i))(jnp.arange(4))).astype(np.int64))


@pytest.mark.parametrize("path", ["key", "seeds"])
def test_noise_like_matches_jax(path):
    durations = [64, 40, 1, 57]
    seeds = [3, 2**31 - 1, 0, 12345] if path == "seeds" else None
    want = jcfm.noise_like(jax.random.PRNGKey(11), 4, 64, 20, jnp.asarray(durations),
                           seeds=None if seeds is None else jnp.asarray(seeds, jnp.int32))
    got = tcfm.noise_like(tprng.prng_key(11), 4, 64, 20, torch.tensor(durations), seeds=seeds)
    want = np.asarray(want)
    assert got.shape == want.shape == (4, 64, 20)
    for i, d in enumerate(durations):
        assert not got[i, d:].any()
    assert _ulp(got.numpy(), want) <= MAX_ULP


# ---------------------------------------------------------------------------
# end to end, nothing injected
# ---------------------------------------------------------------------------

HOP = 256
F5_ARCH = {"dim": 32, "depth": 1, "heads": 1, "dim_head": 32, "ff_mult": 2, "mel_dim": 100,
           "text_dim": 16, "conv_layers": 0, "dropout": 0.0}
REF_TEXT = "hi."
LONG_TEXT = ("the quick brown fox jumps over the lazy dog by the river. "
             "then a small grey cat sleeps in the warm sun all day.")


def _hop_vocoder(m):
    """A stand-in vocoder: each frame's mean over its hop, scaled."""
    return np.repeat(0.01 * np.asarray(m, np.float32).mean(-1), HOP, axis=1)


def _filled(tree, seed):
    """numpy copy of a JAX tree; zero leaves (AdaLN-zero, proj_out) get
    seeded values so every weight shapes the output."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if np.asarray(a).any()
                        else (0.1 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def f5tts_pair(tmp_path_factory):
    """(JAX F5TTS, port F5TTS, reference wav path) over one tiny DiT YAML,
    the port on the JAX weights, both on the stand-in vocoder, one bucket
    and 2 steps."""
    root = tmp_path_factory.mktemp("prng")
    path = root / "tiny.yaml"
    path.write_text(yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT",
                                              "tokenizer": "byte", "arch": F5_ARCH}}), "utf-8")
    jtts = JF5TTS(config_file=str(path), compute_dtype=jnp.float32)
    ttts = tapi.F5TTS(config_file=str(path), compute_dtype=torch.float32, device="cpu")
    jtts.initial_params, ttts.initial_params = jtts.engine.params, ttts.engine.params
    params = _filled(jtts.engine.params, 0)
    jtts.engine.params = jax.tree.map(jnp.asarray, params)
    ttts.engine.params = dit_from_jax(params, ttts.engine.arch)
    for tts in (jtts, ttts):
        tts.engine.vocoder_decode = _hop_vocoder
        tts.engine.buckets = (256,)
    jtts.engine.infer_cfg = JInferConfig(nfe_steps=2, max_duration=256)
    ttts.engine.infer_cfg = InferConfig(nfe_steps=2, max_duration=256)
    ref = str(root / "ref.wav")
    tt = np.arange(24000) / 24000
    # a tone in broadband noise: no mel bin near the log floor, where the two
    # mel front ends differ most
    taudio.write_wav(ref, (0.2 * np.sin(2 * np.pi * 220 * tt) + 0.05 * np.random.default_rng(
        0).standard_normal(tt.size)).astype(np.float32), 24000)
    return jtts, ttts, ref


@pytest.mark.parametrize("seed,text,chunks", [(42, "well hello.", 1),
                                              (2**31 - 1, LONG_TEXT, 2)],
                         ids=["one_chunk", "two_chunks"])
def test_f5tts_infer_with_a_seed_matches_jax(f5tts_pair, monkeypatch, seed, text, chunks):
    jtts, ttts, ref = f5tts_pair
    seen = {"j": [], "t": []}
    for side, tts in (("j", jtts), ("t", ttts)):
        def record(*a, _run=tts.engine.synthesize_chunk, _seen=seen[side], **k):
            _seen.append(k["seed"])
            return _run(*a, **k)
        monkeypatch.setattr(tts.engine, "synthesize_chunk", record)
    kw = dict(nfe_step=2, seed=seed, fix_duration=2.0)
    want_wav, want_sr, want_mel = jtts.infer(ref, REF_TEXT, text, **kw)
    got_wav, got_sr, got_mel = ttts.infer(ref, REF_TEXT, text, **kw)
    assert got_sr == want_sr and ttts.seed == jtts.seed == seed
    assert seen["t"] == seen["j"] == [seed + i for i in range(chunks)]
    assert got_mel.shape == np.asarray(want_mel).shape
    assert got_wav.shape == np.asarray(want_wav).shape and np.isfinite(got_wav).all()
    np.testing.assert_allclose(got_mel, np.asarray(want_mel), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_wav, np.asarray(want_wav), rtol=0, atol=ATOL)


PPG_ARCH = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
                conv_layers=1, dropout=0.0, text_mask_padding=False, pe_attn_head=1)


@pytest.fixture(scope="module")
def ppg_engines():
    """(JAX TTSEngine, port TTSEngine) on one tiny PPG DiT, 4 steps, bucket 64."""
    arch_j = JDiTConfig(**PPG_ARCH, ppg=JPPGConfig(use_ppg=True, ppg_dim=16))
    arch_t = DiTConfig(**PPG_ARCH, ppg=PPGConfig(use_ppg=True, ppg_dim=16))
    params, state = jdit.init_dit(jax.random.PRNGKey(0), arch_j, 256)
    params, state = _filled(params, 1), jax.tree.map(np.asarray, state)
    jeng = jpipe.TTSEngine(params=jax.tree.map(jnp.asarray, params),
                           state=jax.tree.map(jnp.asarray, state), arch=arch_j, vocab=None,
                           mel=JMelConfig(n_mel_channels=20), infer_cfg=JInferConfig(nfe_steps=4),
                           tokenizer="byte", compute_dtype=jnp.float32, buckets=(64,))
    made, made_state = dit_from_jax(params, arch_t, state_np=state)
    teng = tpipe.TTSEngine(params=made, state=made_state, arch=arch_t, vocab=None,
                           mel=MelConfig(n_mel_channels=20), infer_cfg=InferConfig(nfe_steps=4),
                           compute_dtype=torch.float32, buckets=(64,), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("mode", ["cfg", "tts", "vc"])
def test_synthesize_chunk_with_a_seed_matches_jax(ppg_engines, mode):
    jeng, teng = ppg_engines
    rng = np.random.default_rng(4)
    ref_mel = rng.standard_normal((1, 14, 20)).astype(np.float32)
    ppg = rng.standard_normal((1, 30, 16)).astype(np.float32)
    kw = dict(seed=1234567, mode=mode, alpha_spk=1.5, alpha_txt=2.0, alpha_ppg=2.0, ppg=ppg)
    want = np.asarray(jeng.synthesize_chunk(ref_mel, "some text.", 50, **kw))
    got = teng.synthesize_chunk(ref_mel, "some text.", 50, **kw)
    assert got.shape == want.shape == (36, 20) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# training's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 42))
def test_bernoulli_permutation_and_gumbel_uniforms_match_jax(seed):
    jkey, key = jax.random.PRNGKey(seed), tprng.prng_key(seed)
    np.testing.assert_array_equal(tprng.bernoulli(key, 0.9, (33, 17)).numpy(),
                                  np.asarray(jax.random.bernoulli(jkey, 0.9, (33, 17))))
    for n in (1000, 2304):
        np.testing.assert_array_equal(tprng.permutation(key, n).numpy(),
                                      np.asarray(jax.random.permutation(jkey, n)))
    shape = (2 * 64 * 2, 320)  # (B * N * groups, num_vars)
    got = tvq.gumbel_uniform(key, shape, "cpu").numpy()
    want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, 1e-10, 1.0))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_a_block_at_an_offset_draws_its_part_of_the_global_draw():
    jkey, key = jax.random.PRNGKey(5), tprng.prng_key(5)
    glob, off, shape = (6, 10, 12), (3, 4, 7), (2, 3, 5)
    part = tuple(slice(o, o + n) for o, n in zip(off, shape))
    np.testing.assert_array_equal(tprng.random_bits(key, shape, glob, off).numpy(),
                                  np.asarray(jax.random.bits(jkey, glob, jnp.uint32))[part])
    want = np.asarray(jax.random.uniform(jkey, glob, jnp.float32, -0.5, 0.5))[part]
    np.testing.assert_array_equal(tprng.uniform(key, shape, -0.5, 0.5, glob, off).numpy(), want)
    assert _ulp(tprng.normal(key, shape, glob, off).numpy(),
                np.asarray(jax.random.normal(jkey, glob))[part]) <= MAX_ULP
    x = np.random.default_rng(1).standard_normal(glob).astype(np.float32)
    want = np.asarray(jfnn.dropout(jkey, jnp.asarray(x), 0.1, True))[part]
    got = tnn.dropout(key, torch.from_numpy(x[part]), 0.1, True, glob, off)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_dropout_divides_by_the_rate_in_bf16():
    x = (3.0 * np.random.default_rng(2).standard_normal((64, 257))).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jfnn.dropout(jax.random.PRNGKey(4), xj, 0.1, True).astype(jnp.float32))
    keep = torch.from_numpy(want != 0)
    got = tnn.dropout(None, torch.from_numpy(x).bfloat16(), 0.1, True, keep=keep)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# the seeded init weights
# ---------------------------------------------------------------------------

INIT_VOCAB = 30
INIT_DIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=8, text_dim=16,
                conv_layers=1)
INIT_PPG = dict(use_ppg=True, ppg_dim=16)
INIT_CB = dict(use_codebook=True, num_vars=10, groups=2)
INIT_UNETT = dict(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=8, text_dim=16,
                  conv_layers=1, skip_connect_type="concat")
INIT_MMDIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=8)
INIT_VOCOS = dict(input_channels=8, dim=32, intermediate_dim=48, num_layers=2, n_fft=64,
                  hop_length=16)
# the normal-initialised leaves (N(0, 1)): the text embedding, a one-layer
# codebook projection
NORMAL_LEAVES = ("text_embed/embed/w", "quantizer/weight_proj/layer_0/w")
INIT_CASES = {
    "dit": (JDiTConfig(**INIT_DIT), DiTConfig(**INIT_DIT), dit_from_jax),
    "f5e_dit": (JDiTConfig(**INIT_DIT, ppg=JPPGConfig(**INIT_PPG),
                           codebook=JCodebookConfig(**INIT_CB)),
                DiTConfig(**INIT_DIT, ppg=PPGConfig(**INIT_PPG),
                          codebook=CodebookConfig(**INIT_CB)), dit_from_jax),
    "unett": (JUNetTConfig(**INIT_UNETT), UNetTConfig(**INIT_UNETT), unett_from_jax),
    "mmdit": (JMMDiTConfig(**INIT_MMDIT), MMDiTConfig(**INIT_MMDIT), mmdit_from_jax),
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def assert_jax_init(got, want) -> None:
    """Two port trees of one layout: the normal-initialised leaves within
    MAX_ULP, every other leaf bit for bit."""
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].detach().cpu().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith(NORMAL_LEAVES):
            assert _ulp(g, w) <= MAX_ULP, k
        else:
            np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                          np.atleast_1d(w).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("name", list(INIT_CASES))
def test_init_backbone_matches_jax(name):
    arch_j, arch_t, convert = INIT_CASES[name]
    params, state = jbb.init_backbone(jax.random.PRNGKey(7), arch_j, INIT_VOCAB)
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    made = tbb.init_backbone(arch_t, INIT_VOCAB, tprng.prng_key(7))
    if name == "f5e_dit":
        want = convert(params, arch_j, state)
        assert_jax_init(made[1], want[1])
        made, want = made[0], want[0]
    else:
        want = convert(params, arch_j)
    assert_jax_init(made, want)


def test_init_vocos_matches_jax():
    cfg_j, cfg_t = jvocos.VocosConfig(**INIT_VOCOS), tvocos.VocosConfig(**INIT_VOCOS)
    params = jax.tree.map(np.asarray, jvocos.init_vocos(jax.random.PRNGKey(0), cfg_j))
    assert_jax_init(tvocos.init_vocos(cfg_t, tprng.prng_key(0)), vocos_from_jax(params, cfg_t))


def test_f5tts_without_a_checkpoint_has_jax_initial_weights(f5tts_pair):
    jtts, ttts, _ = f5tts_pair
    want = dit_from_jax(jax.tree.map(np.asarray, jtts.initial_params), ttts.engine.arch)
    assert_jax_init(ttts.initial_params, tbb.fuse_qkv(want, ttts.engine.arch))
