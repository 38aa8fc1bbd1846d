"""The port's serving batcher (`f5e_tts_tpu_torch/serving/batcher.py`) against
the JAX package's on the CPU, fp32, at the JAX tests' tiny sizes
(tests/test_batcher.py: a 1-block DiT of width 32, 12 mel channels, buckets
128 and 256) with seeded weights on both sides (`dit_from_jax`,
`vocos_from_jax` of one numpy tree, AdaLN-zero and `proj_out` leaves seeded).

- Batcher against batcher: the same requests and seeds through the JAX
  `DynamicBatcher` and the port's, with the port's noise replaced by the JAX
  `noise_like(seeds=)` draw (`draw_noise` monkeypatched; nothing in the JAX
  package changes): a batch of 3 padded to 4, then a batch of 2 in the other
  bucket, each finish (host vocoder, device vocoder, fused slice + decode).
  Tolerance: mel atol 1e-3 (2 fp32 Euler steps, as test_torch_sampler.py),
  wav atol 1e-3 (a Vocos of width 32 over that mel; the JAX and port decodes
  of one mel agree to 1e-5, test_torch_audio.py).
- Seed invariance: a request alone and in slot 1 of a co-batch give the same
  mel bits (the port's own noise), and the same wav within 1e-6 (the
  vocoder's products at batch 2 may sum in another order on the CPU).
- `TTSEngine.infer` through the batcher against the direct path, bitwise; a
  request whose nfe is not the batcher's bypasses it; `enable_batching`.
- The wire variants: int16 within one PCM16 step (1/32767) and one float32
  ulp of the clipped float32 wav, `xfer_chunks` the same wavs, `return_mel=
  False` (wav, None); the PCM copies against the JAX package's numpy
  fallbacks, exactly.
- `SamplerGraph` of a batch > 1 refuses an engine on the CPU.
"""

from __future__ import annotations

import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu import native as jnative
from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import InferConfig as JInferConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.models import vocos as jvocos
from f5e_tts_tpu.serving import batcher as jbatcher
from f5e_tts_tpu_torch.api import make_vocoder
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, InferConfig, MelConfig
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import vocos as tvocos
from f5e_tts_tpu_torch.serving import batcher as tbatcher
from f5e_tts_tpu_torch.serving import pcm as tpcm
from f5e_tts_tpu_torch.utils import aot as taot
from f5e_tts_tpu_torch.utils.convert import dit_from_jax, vocos_from_jax

MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12,
              target_sample_rate=8000)
ARCH_KW = dict(dim=32, depth=1, heads=1, dim_head=32, ff_mult=2, mel_dim=12, text_dim=16,
               conv_layers=0, dropout=0.0)
VOC_KW = dict(input_channels=12, dim=32, intermediate_dim=64, num_layers=2, n_fft=256,
              hop_length=64, sample_rate=8000)
VOCAB = {c: i for i, c in enumerate(" abcdefgh")}
BUCKETS = (128, 256)
NFE = 2
MEL_ATOL = WAV_ATOL = 1e-3


def _seeded(tree, rng):
    """numpy copy of a JAX tree; zero leaves (AdaLN-zero, proj_out) seeded."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if np.asarray(a).any()
                        else (0.1 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**ARCH_KW), len(VOCAB))
    voc = jvocos.init_vocos(jax.random.PRNGKey(1), jvocos.VocosConfig(**VOC_KW))
    rng = np.random.default_rng(0)
    return _seeded(params, rng), jax.tree.map(np.asarray, voc)


def _jax_vocoder(voc, variant):
    """The JAX package's `load_vocoder` callables (f5e_tts_tpu/api.py:40-90)
    over the tiny Vocos: host decode, `.device`, the fused `.device_sliced`."""
    cfg = jvocos.VocosConfig(**VOC_KW)
    jitted = jax.jit(lambda p, m: jvocos.vocos_decode(p, cfg, m, compute_dtype=jnp.float32))

    def decode(mel):
        return np.asarray(jitted(voc, jnp.asarray(mel, jnp.float32)), np.float32)

    if variant in ("device", "fused"):
        decode.device = lambda mel: jitted(voc, mel.astype(jnp.float32))
    if variant == "fused":
        @partial(jax.jit, static_argnames=("L",))
        def sliced(p, out, starts, gen_lens, L):
            mel = jpipe.slice_gen_core(out, starts, gen_lens, L)
            return jvocos.vocos_decode(p, cfg, mel, compute_dtype=jnp.float32), mel

        decode.device_sliced = lambda out, s, g, L: sliced(voc, out, s, g, L)
    return decode


def _port_vocoder(voc, variant):
    """The port's `make_vocoder` over the same Vocos, with the callables of
    `variant` only."""
    full = make_vocoder(vocos_from_jax(voc, None), tvocos.VocosConfig(**VOC_KW), torch.float32,
                        "cpu")

    def decode(mel):
        return full(mel)

    if variant in ("device", "fused"):
        decode.device = full.device
    if variant == "fused":
        decode.device_sliced = full.device_sliced
        decode.device_sliced_i16 = full.device_sliced_i16
    return decode


def jax_engine(weights, variant="fused"):
    params, voc = weights
    return jpipe.TTSEngine(params=params, state={}, arch=JDiTConfig(**ARCH_KW), vocab=VOCAB,
                           mel=JMelConfig(**MEL_KW), cfm=JCFMConfig(),
                           infer_cfg=JInferConfig(nfe_steps=NFE, max_duration=512),
                           tokenizer="char", vocoder_decode=_jax_vocoder(voc, variant),
                           compute_dtype=jnp.float32, buckets=BUCKETS)


def port_engine(weights, variant="fused"):
    params, voc = weights
    return tpipe.TTSEngine(params=dit_from_jax(params, DiTConfig(**ARCH_KW)),
                           arch=DiTConfig(**ARCH_KW), vocab=VOCAB, mel=MelConfig(**MEL_KW),
                           cfm=CFMConfig(), infer_cfg=InferConfig(nfe_steps=NFE, max_duration=512),
                           tokenizer="char", vocoder_decode=_port_vocoder(voc, variant),
                           compute_dtype=torch.float32, buckets=BUCKETS, device="cpu")


def jax_noise(batch, length, channels, durations, seeds):
    """The JAX batcher's noise for these slots, as a torch tensor."""
    y0 = jcfm.noise_like(jax.random.PRNGKey(0), batch, length, channels,
                         jnp.asarray(durations.numpy()), seeds=jnp.asarray(seeds, jnp.int32))
    return torch.from_numpy(np.array(y0))


def _ids(text):
    return np.asarray([VOCAB[c] for c in text], np.int32)


# (ref frames, text, duration, seed): a batch of three in bucket 128 (padded to
# 4; the middle one asks for fewer frames than its prompt + 1), then a batch of
# two in bucket 256
GROUPS = (((40, "abc gh", 100, 5), (48, "h gfe", 44, 9), (36, "gg ab", 120, 2**31 + 3)),
          ((52, "fe dc ba", 200, 11), (44, "a", 160, 0)))


def _requests(group, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rf, 12)).astype(np.float32), _ids(text), dur, s)
            for rf, text, dur, s in group]


def _run(batcher, requests):
    futs = [batcher.submit(ref, ids, dur, seed=s) for ref, ids, dur, s in requests]
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("variant", ["host", "device", "fused"])
def test_batcher_matches_jax_with_its_noise(weights, variant, monkeypatch):
    monkeypatch.setattr(tbatcher, "draw_noise", jax_noise)
    groups = [_requests(g, i) for i, g in enumerate(GROUPS)]
    jb = jbatcher.DynamicBatcher(jax_engine(weights, variant), max_batch=4, window_ms=500,
                                 nfe_steps=NFE)
    tb = tbatcher.DynamicBatcher(port_engine(weights, variant), max_batch=4, window_ms=500,
                                 nfe_steps=NFE)
    got = []
    try:
        for reqs in groups:
            want = _run(jb, reqs)
            got.append(_run(tb, reqs))
            for (wav_j, mel_j), (wav_t, mel_t) in zip(want, got[-1]):
                assert mel_t.shape == mel_j.shape and wav_t.shape == wav_j.shape
                assert wav_t.dtype == mel_t.dtype == np.float32
                np.testing.assert_allclose(mel_t, np.asarray(mel_j), rtol=0, atol=MEL_ATOL)
                np.testing.assert_allclose(wav_t, np.asarray(wav_j), rtol=0, atol=WAV_ATOL)
        assert tb.batch_sizes == jb.batch_sizes == [3, 2]
        assert [s["fold"] for s in tb.stage_times] == [3, 2]
        assert set(tb.stage_times[0]) == set(jb.stage_times[0])
    finally:
        jb.stop()
        tb.stop()
    # the middle request of the first batch generates one frame (its duration
    # is clamped to its prompt + 1)
    assert got[0][1][1].shape == (1, 12)


def test_padding_slot_is_finite_and_leaves_the_real_slots(weights):
    """A batch of 3 runs at 4: the padding slot (one empty prompt frame,
    duration 2, no text, seed 0) gives finite output, and the three real
    slots are what they are in a batch of exactly 3 (the sampler called
    directly with the same noise)."""
    eng = port_engine(weights, "fused")
    seen = []
    sample = tbatcher.fcfm.sample

    def spy(params, arch, cfm, inputs, **kw):
        out = sample(params, arch, cfm, inputs, **kw)
        seen.append((inputs, kw, out[0]))
        return out

    tbatcher.fcfm.sample = spy
    try:
        b = tbatcher.DynamicBatcher(eng, max_batch=4, window_ms=500, nfe_steps=NFE)
        _run(b, _requests(GROUPS[0]))
        b.stop()
    finally:
        tbatcher.fcfm.sample = sample
    (inputs, kw, out), = seen
    assert out.shape[0] == 4 and torch.isfinite(out).all()
    assert int(inputs.duration[3]) == 2 and not inputs.cond_mask[3, 1:].any()
    three = tbatcher.fcfm.SamplerInputs(*(t[:3] for t in inputs[:4]))
    alone, _ = sample(eng.params, eng.arch, eng.cfm, three, **{**kw, "y0": kw["y0"][:3]})
    np.testing.assert_allclose(out[:3].numpy(), alone.numpy(), rtol=0, atol=1e-5)


def test_seed_invariance_alone_and_in_slot_1(weights):
    eng = port_engine(weights)
    ref_a, ids_a, _, _ = _requests(GROUPS[0])[0]
    ref_b, ids_b, _, _ = _requests(GROUPS[0])[1]
    alone = tbatcher.DynamicBatcher(eng, max_batch=4, window_ms=1, nfe_steps=NFE)
    wav_alone, mel_alone = alone.submit(ref_a, ids_a, 100, seed=7).result(timeout=300)
    alone.stop()
    co = tbatcher.DynamicBatcher(eng, max_batch=4, window_ms=500, nfe_steps=NFE)
    fut_b = co.submit(ref_b, ids_b, 100, seed=99)
    fut_a = co.submit(ref_a, ids_a, 100, seed=7)
    wav_co, mel_co = fut_a.result(timeout=300)
    _, mel_b = fut_b.result(timeout=300)
    co.stop()
    assert alone.batch_sizes == [1] and co.batch_sizes == [2]
    np.testing.assert_array_equal(mel_co, mel_alone)
    # the vocoder's products at batch 2 may sum in another order on the CPU
    np.testing.assert_allclose(wav_co, wav_alone, rtol=0, atol=1e-6)
    assert not np.array_equal(mel_b[: mel_alone.shape[0]], mel_alone)


def _ref_wav(seconds=2.0, sr=8000):
    return (0.2 * np.sin(2 * np.pi * 220 * np.arange(int(seconds * sr)) / sr)).astype(np.float32)


@pytest.mark.parametrize("variant", ["host", "fused"])
def test_infer_through_the_batcher_is_the_direct_path(weights, variant):
    ref = _ref_wav()
    direct = port_engine(weights, variant)
    wav_d, sr_d, mel_d = direct.infer(ref, 8000, "abc def", "gh abc", seed=3)
    batched = port_engine(weights, variant)
    bt = batched.enable_batching(max_batch=4, window_ms=10)
    assert batched.batcher is bt and bt.nfe == NFE and bt.text_pad_to == batched.text_pad_to
    wav_b, sr_b, mel_b = batched.infer(ref, 8000, "abc def", "gh abc", seed=3)
    assert bt.batch_sizes == [1], "the request never went through the batcher"
    assert sr_b == sr_d
    np.testing.assert_array_equal(mel_b, mel_d)
    np.testing.assert_array_equal(wav_b, wav_d)
    # another nfe, cfg or sway, or a grid, takes the direct path
    for kw in (dict(nfe_steps=4), dict(cfg_strength=0.0), dict(sway=0.5),
               dict(timesteps=(0.0, 0.5, 1.0))):
        batched.infer(ref, 8000, "abc def", "gh", seed=1, **kw)
    assert bt.batch_sizes == [1]
    # the batcher's own values, given explicitly, take it
    batched.infer(ref, 8000, "abc def", "gh", seed=1, nfe_steps=NFE, cfg_strength=2.0, sway=-1.0)
    assert bt.batch_sizes == [1, 1]
    bt.stop()


def test_concurrent_infers_fold_into_one_batch(weights):
    ref = _ref_wav()
    eng = port_engine(weights)
    eng.enable_batching(max_batch=4, window_ms=500)
    results = {}
    barrier = threading.Barrier(2)

    def run(tag, text, seed):
        barrier.wait()
        results[tag] = eng.infer(ref, 8000, "abc def", text, seed=seed)

    threads = [threading.Thread(target=run, args=a) for a in (("a", "gh abc", 3),
                                                               ("b", "cba hg", 7))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    eng.batcher.stop()
    assert eng.batcher.batch_sizes == [2]
    solo = port_engine(weights).infer(ref, 8000, "abc def", "gh abc", seed=3)
    np.testing.assert_array_equal(results["a"][2], solo[2])
    np.testing.assert_allclose(results["a"][0], solo[0], rtol=0, atol=1e-6)


def _wire_run(weights, **kw):
    b = tbatcher.DynamicBatcher(port_engine(weights), max_batch=4, window_ms=500, nfe_steps=NFE,
                                **kw)
    try:
        out = _run(b, _requests(GROUPS[0]) + _requests(GROUPS[1])[:1])
        assert b.batch_sizes == [4] and b.stage_times
        return out
    finally:
        b.stop()


def test_int16_wire_is_the_f32_wav_within_one_pcm16_step(weights):
    f32 = _wire_run(weights)
    i16 = _wire_run(weights, wire_dtype="int16")
    for (wav_f, mel_f), (wav_q, mel_q) in zip(f32, i16):
        assert wav_q.dtype == np.float32 and wav_q.shape == wav_f.shape
        clipped = np.clip(wav_f, -1.0, 1.0)
        assert np.abs(wav_q - clipped).max() <= 1 / 32767 + np.spacing(np.float32(1.0))
        np.testing.assert_array_equal(mel_q, mel_f)
    # the rounding is half to even, as jnp.round's
    wav = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 40000.0, -40000.0]) / 32767.0
    got = torch.round(wav * 32767.0).clamp(-32768, 32767).to(torch.int16)
    want = np.clip(np.round(wav.numpy() * 32767.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_copy_and_wav_only(weights):
    full = _wire_run(weights, return_mel=False)
    chunked = _wire_run(weights, return_mel=False, xfer_chunks=3)
    with_mel = _wire_run(weights)
    for (w1, m1), (w3, m3), (wm, mm) in zip(full, chunked, with_mel):
        assert m1 is None and m3 is None and mm is not None
        np.testing.assert_array_equal(w3, w1)
        np.testing.assert_array_equal(w1, wm)
    # the request of prompt + 1 frames: one frame of audio
    assert full[1][0].shape == (64,)


@pytest.mark.parametrize("n", [0, 1, 7, 4096])
def test_pcm_copies_match_the_jax_fallbacks(n, monkeypatch):
    monkeypatch.setattr(jnative, "load_library", lambda: None)  # the numpy fallbacks
    x = np.random.default_rng(n).uniform(-1.3, 1.3, n).astype(np.float32)
    data = tpcm.f32_to_pcm16_bytes(x)
    assert data == jnative.f32_to_pcm16_bytes(x)
    np.testing.assert_array_equal(tpcm.pcm16_bytes_to_f32(data), jnative.pcm16_bytes_to_f32(data))


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_sampler_graph_refuses_a_cpu_engine(weights, batch):
    eng = port_engine(weights)
    grid = tbatcher.fcfm.sway_timesteps(NFE, -1.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        taot.SamplerGraph(eng, 128, grid, 2.0, batch=batch)
    with pytest.raises(RuntimeError, match="CUDA device"):
        taot.capture_sampler_buckets(eng, buckets=(128,), nfe=NFE, batches=(batch,))
    assert eng.engines == {}


def test_batched_engine_names_and_lookup():
    assert taot.engine_name(NFE, 128, batch=4) == f"sampler_nfe{NFE}_b128_x4"
    assert taot.engine_name(NFE, 128) == f"sampler_nfe{NFE}_b128"
    engines = {taot.engine_name(NFE, 128, batch=2): object()}
    assert taot.find_sampler_engine(engines, NFE, 128, batch=2) is not None
    assert taot.find_sampler_engine(engines, NFE, 128) is None
    assert tbatcher.batch_sizes_served(4) == [1, 2, 4]
    assert tbatcher.batch_sizes_served(3) == [1, 2, 3]
    assert tbatcher.batch_sizes_served(1) == [1]
