"""The MMDiT's sampler engines (f5e_tts_tpu_torch/utils/aot.py) against the
JAX package's exported ones on the CPU, at the tiny MMDiT of
tests/test_torch_mmdit.py (dim 64, depth 3, heads 2 x 32, 20 mels), fp32,
bucket 64, NFE 8, cfg 2.

An MMDiT's text length is a shape of its engine: the JAX package exports one
file per text length (`export_sampler_buckets(text_len=)`, files
`..._t{text_len}.jaxexport`) and its pipeline widens a request's padded ids
with -1 to the length of the engine it picks. The widened positions are not
filler for the MMDiT (they enter the joint attention), so the engine's
output is not the eager sampler's at the request's own length.

- (a) JAX's `TTSEngine(engine_dir=)` replaying its exported `_t16` engine
  against the port's replay path: a stand-in engine of text length 16 that
  runs the port's eager sampler on the inputs it is handed (the CPU cannot
  capture), which must be the text widened by the port's own
  `widen_text_ids`; each side draws its own noise for the seed (the JAX
  engine inside, under `PRNGKey(seed)`; the port under `prng_key(seed)`, the
  same threefry stream; nothing injected). Tolerance: atol
  1e-3 (8 fp32 Euler steps, as test_torch_mmdit.py's sampler test).
- (b) the same request on the port's eager path, at its padded length 8,
  differs from (a) by more than that tolerance, and equals the JAX jit path
  at that length within it.
- (c) the engine a request picks, for text lengths under, between and above
  the engines', is the file JAX's `find_sampler_engine` picks.
- (d) `engine_dir_variants` keeps the text length for an MMDiT and merges it
  for a DiT; `capture_engine_dir` captures one engine per text length.
- (e) the serving batcher replays an MMDiT engine only at the batch's own
  padded text length (JAX's batcher computes at that length, never widens).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import InferConfig as JInferConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.utils import aot as jaot
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, InferConfig, MelConfig
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.serving.batcher import DynamicBatcher
from f5e_tts_tpu_torch.utils import aot as taot
from f5e_tts_tpu_torch.utils.convert import mmdit_from_jax
from tests.test_torch_mmdit import TINY, _made

NFE, BUCKET, REF, DURATION, SEED = 8, 64, 24, 57, 5
ATOL = 1e-3
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmn.")}  # the tiny MMDiT's 16 ids
TEXT = "a bad.."  # 7 ids: padded to 8 (text_pad_to 8), widened to 16
MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=TINY["mel_dim"],
              target_sample_rate=8000)
ENGINE_KW = dict(vocab=VOCAB, tokenizer="char", vocoder_decode=None, buckets=(BUCKET,),
                 text_pad_to=8)


def _ref_mel():
    return np.random.default_rng(3).standard_normal((1, REF, TINY["mel_dim"])).astype(np.float32)


def _jax_engine(engine_dir=None):
    arch_j, _, params = _made(None, 0)
    return jpipe.TTSEngine(params=params, state={}, arch=arch_j, mel=JMelConfig(**MEL_KW),
                           cfm=JCFMConfig(), infer_cfg=JInferConfig(nfe_steps=NFE),
                           compute_dtype=jnp.float32, engine_dir=engine_dir, **ENGINE_KW)


def _port_engine():
    _, arch_t, params = _made(None, 0)
    return tpipe.TTSEngine(params=mmdit_from_jax(params, arch_t), arch=arch_t,
                           mel=MelConfig(**MEL_KW), cfm=CFMConfig(),
                           infer_cfg=InferConfig(nfe_steps=NFE), compute_dtype=torch.float32,
                           device="cpu", **ENGINE_KW)


class EagerEngine:
    """Stands in for a captured engine of `text_len` on the CPU: runs the
    port's eager sampler on the inputs it is handed, and records their text
    length."""

    def __init__(self, engine, text_len: int, batch: int = 1):
        self.engine, self.text_len, self.batch = engine, text_len, batch
        self.text_lens = []

    def sample(self, inputs, y0):
        self.text_lens.append(inputs.text_ids.shape[1])
        e = self.engine
        return tcfm.sample(e.params, e.arch, e.cfm, inputs, steps=NFE, cfg_strength=2.0,
                           sway_coef=-1.0, y0=y0, compute_dtype=torch.float32, device="cpu")[0]


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """(the JAX engine-file output at text length 16, the JAX jit output at the
    request's padded length 8) of the request, generated frames only."""
    engine_dir = str(tmp_path_factory.mktemp("engines"))
    paths = jaot.export_sampler_buckets(_jax_engine(), REF, engine_dir, nfe=NFE, text_len=16)
    assert [os.path.basename(p) for p in paths] == [f"sampler_nfe{NFE}_ref{REF}_b{BUCKET}"
                                                    "_t16.jaxexport"]
    aot = _jax_engine(engine_dir)
    replayed = aot.synthesize_chunk(_ref_mel(), TEXT, DURATION, seed=SEED)
    assert aot._aot_cache[(NFE, REF, BUCKET, None, None)][1] == 16  # the engine ran
    eager = _jax_engine().synthesize_chunk(_ref_mel(), TEXT, DURATION, seed=SEED)
    return replayed, eager


@pytest.fixture
def port_run():
    """synthesize_chunk of the request on the port's engine, which draws
    the JAX engine's noise for the seed."""
    engine = _port_engine()
    return engine, lambda: engine.synthesize_chunk(_ref_mel(), TEXT, DURATION, seed=SEED)


def test_replay_path_matches_the_jax_engine_file(jax_outputs, port_run):
    engine, run = port_run
    stand_in = EagerEngine(engine, 16)
    engine.engines = {taot.engine_name(NFE, BUCKET, text_len=16): stand_in}
    got = run()
    assert stand_in.text_lens == [16]  # widened by the pipeline from 8 to 16
    assert got.shape == (DURATION - REF, TINY["mel_dim"])
    np.testing.assert_allclose(got, jax_outputs[0], rtol=0, atol=ATOL)


def test_eager_path_keeps_the_padded_length_and_differs(jax_outputs, port_run):
    engine, run = port_run
    eager = run()  # no engine: the text at its padded length 8
    np.testing.assert_allclose(eager, jax_outputs[1], rtol=0, atol=ATOL)
    # the widening moves the output by more than the tolerance of (a)
    moved = np.abs(eager - jax_outputs[0]).max()
    assert moved > 10 * ATOL, moved


def test_widen_text_ids():
    padded = np.asarray([[3, 4, -1, -1], [5, -1, -1, -1]], np.int32)
    wide = tpipe.widen_text_ids(padded, 7)
    assert wide.shape == (2, 7) and wide.dtype == np.int32
    np.testing.assert_array_equal(wide[:, :4], padded)
    assert (wide[:, 4:] == -1).all()
    np.testing.assert_array_equal(tpipe.widen_text_ids(padded, 4), padded)
    with pytest.raises(ValueError, match="does not fit"):
        tpipe.widen_text_ids(padded, 3)


TEXT_LENS = (16, 64, 128)


@pytest.mark.parametrize("nt", [8, 16, 17, 64, 100, 128, 129, 512])
def test_engine_lookup_matches_jax_find_sampler_engine(tmp_path, nt):
    """Over the same text lengths, the port picks the engine JAX picks: the
    smallest text length >= nt, None above them all. Engines of another
    guidance weight or batch are never picked."""
    engines = {}
    for tl in TEXT_LENS:
        (tmp_path / f"sampler_nfe{NFE}_ref{REF}_b{BUCKET}_t{tl}.jaxexport").touch()
        engines[taot.engine_name(NFE, BUCKET, text_len=tl)] = tl
    (tmp_path / f"sampler_nfe{NFE}_cfg0_ref{REF}_b{BUCKET}_t{nt}.jaxexport").touch()
    engines[taot.engine_name(NFE, BUCKET, cfg_strength=0.0, text_len=nt)] = -1
    engines[taot.engine_name(NFE, BUCKET, batch=2, text_len=nt)] = -2
    want = jaot.find_sampler_engine(str(tmp_path), NFE, REF, BUCKET, nt)
    got = taot.find_sampler_engine(engines, NFE, BUCKET, text_len=nt)
    assert (got is None) == (want is None)
    if got is not None:
        assert engines[got] == want[1]
        assert got + ".jaxexport" == os.path.basename(want[0]).replace(f"_ref{REF}", "")
    # the TTSEngine's lookup for an MMDiT passes nt; the batcher's takes nt only
    engine = _port_engine()
    engine.engines = engines
    assert engine._aot_sampler(NFE, BUCKET, text_len=nt) == (engines[got] if got else None)
    icfg = engine.infer_cfg
    batcher = SimpleNamespace(engine=engine, nfe=NFE, timesteps=None, sway=icfg.sway_sampling_coef,
                              cfg_strength=icfg.cfg_strength)
    exact = DynamicBatcher.engine_for(batcher, 1, BUCKET, nt)
    assert exact == (nt if nt in TEXT_LENS else None)


def test_engine_names_carry_the_text_length_for_an_mmdit_only():
    assert taot.engine_name(NFE, BUCKET, text_len=256) == f"sampler_nfe{NFE}_b{BUCKET}_t256"
    assert taot.engine_name(NFE, BUCKET, cfg_strength=0.0, batch=2, text_len=64) == (
        f"sampler_nfe{NFE}_cfg0_b{BUCKET}_t64_x2")
    assert taot.engine_name(NFE, BUCKET) == f"sampler_nfe{NFE}_b{BUCKET}"
    assert "mmdit" in taot.CAPTURED_KINDS and taot.DEFAULT_TEXT_LEN == 256
    assert taot.text_shaped(_port_engine().arch)
    # a DiT engine's lookup ignores the text length
    dit = tpipe.TTSEngine(params={}, arch=DiTConfig(), vocab=None, device="cpu")
    assert not taot.text_shaped(dit.arch)
    dit.engines = {taot.engine_name(NFE, 128): "dit"}
    assert dit._aot_sampler(NFE, 128, text_len=999) == "dit"


def _write(tmp_path, entries):
    for nfe, cfg, ref, bucket, tl in entries:
        (tmp_path / f"sampler_nfe{nfe}{jaot._variant_tag(None, cfg)}_ref{ref}_b{bucket}_t{tl}"
                    ".jaxexport").touch()
    return str(tmp_path)


ENTRIES = [(NFE, None, 100, 64, 256), (NFE, None, 472, 64, 128), (NFE, None, 100, 64, 128),
           (NFE, 0.0, 100, 64, 256), (NFE, None, 100, 128, 256)]


def test_engine_dir_variants_keep_the_text_length_for_an_mmdit(tmp_path):
    engine_dir = _write(tmp_path, ENTRIES)
    assert taot.engine_dir_variants(engine_dir) == [
        (NFE, 64, None, None), (NFE, 64, None, 0.0), (NFE, 128, None, None)]
    assert taot.engine_dir_variants(engine_dir, text_lengths=True) == [
        (NFE, 64, None, None, 128), (NFE, 64, None, None, 256), (NFE, 64, None, 0.0, 256),
        (NFE, 128, None, None, 256)]


def test_capture_engine_dir_captures_each_text_length(tmp_path, monkeypatch):
    engine_dir = _write(tmp_path, ENTRIES)
    calls = []

    def capture(engine, buckets=None, nfe=32, timesteps=None, cfg_strength=None,
                text_len=taot.DEFAULT_TEXT_LEN):
        calls.append((tuple(buckets), cfg_strength, text_len))
        names = [taot.engine_name(nfe, b, timesteps, cfg_strength, text_len=text_len)
                 for b in buckets]
        engine.engines.update({n: object() for n in names})
        return names

    monkeypatch.setattr(taot, "capture_sampler_buckets", capture)
    engine = _port_engine()
    names = taot.capture_engine_dir(engine, engine_dir)
    assert sorted(calls, key=repr) == sorted(
        [((64,), None, 128), ((64, 128), None, 256), ((64,), 0.0, 256)], key=repr)
    assert sorted(names) == sorted(engine.engines) and len(names) == 4
    # a request of padded text length 100 at bucket 64 finds the _t128 engine
    assert taot.find_sampler_engine(engine.engines, NFE, 64, text_len=100) == (
        f"sampler_nfe{NFE}_b64_t128")


def test_capture_on_the_cpu_raises():
    with pytest.raises(RuntimeError, match="CUDA device"):
        taot.capture_sampler_buckets(_port_engine(), buckets=(BUCKET,), nfe=NFE, text_len=16)


def test_batcher_replays_an_mmdit_engine_only_at_its_text_length(monkeypatch):
    """Two requests of 7 ids pad to 8: a (2, 64) engine of text length 16 is
    not replayed (the batch runs eagerly at 8), one of text length 8 is,
    with the eager batch's mels."""
    engine = _port_engine()
    ids = np.asarray(engine.tokenize([TEXT])[0])
    bt = engine.enable_batching(max_batch=2, window_ms=2000, nfe_steps=NFE)
    try:
        def batch():
            futs = [bt.submit(_ref_mel()[0], ids, DURATION, seed=s) for s in (1, 2)]
            return [f.result(timeout=300)[1] for f in futs]

        eager = batch()
        wide = EagerEngine(engine, 16, batch=2)
        engine.engines = {taot.engine_name(NFE, BUCKET, batch=2, text_len=16): wide}
        assert bt.engine_for(2, BUCKET, 8) is None
        np.testing.assert_array_equal(np.stack(batch()), np.stack(eager))
        assert wide.text_lens == []  # not replayed
        exact = EagerEngine(engine, 8, batch=2)
        engine.engines[taot.engine_name(NFE, BUCKET, batch=2, text_len=8)] = exact
        assert bt.engine_for(2, BUCKET, 8) is exact
        np.testing.assert_array_equal(np.stack(batch()), np.stack(eager))
        assert exact.text_lens == [8] and wide.text_lens == []
        assert bt.batch_sizes == [2, 2, 2]
    finally:
        bt.stop()
