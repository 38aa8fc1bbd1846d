"""The rest of the zero-shot serving path of the port against the JAX
package: explicit ODE grids (`pruned_sway_timesteps`, `sample(timesteps=)`),
`get_pos_embed_indices`, the pure-Python text helpers, `slice_gen`,
`CachedTranscriber`, `preprocess_ref_audio_text(clip_short=)`, the engine's
reference-mel cache, streaming, grids and device-resident decode on a tiny
engine, the CLI, and the captured-engine lookup.

Tolerances: the sampler over an explicit grid at atol 1e-3 (fp32 Euler
steps, as in test_torch_sampler.py) with the prompt frames exact; every
other comparison is exact (the same integer, string or float operations on
both sides, or the same port arithmetic down two paths).
"""

import collections
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.infer import cli as jcli
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops import nn as jnn
from f5e_tts_tpu.utils import aot as jaot
from f5e_tts_tpu.utils import text as jtext
from f5e_tts_tpu_torch import api as tapi
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, InferConfig, MelConfig
from f5e_tts_tpu_torch.infer import audio as taudio
from f5e_tts_tpu_torch.infer import cli as tcli
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.utils import aot as taot
from f5e_tts_tpu_torch.utils import text as ttext
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

# ---------------------------------------------------------------------------
# explicit ODE grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep,base,sway", [
    ((0, 1, 2, 3, 4, 6, 10, 18, 32), 32, -1.0),  # the quality proxy's EPSS keep set
    (tuple(range(33)), 32, -1.0),
    ((0, 3, 7), 7, None),
    ((0, 1, 4), 4, 0.5),
])
def test_pruned_sway_timesteps_matches_jax(keep, base, sway):
    got = tcfm.pruned_sway_timesteps(keep, base_steps=base, sway_coef=sway)
    assert isinstance(got, tuple)
    assert got == jcfm.pruned_sway_timesteps(keep, base_steps=base, sway_coef=sway)


@pytest.mark.parametrize("keep", [(1, 2, 32), (0, 5, 31), (0, 5, 5, 32), (0, 9, 4, 32)])
def test_pruned_sway_timesteps_bad_keep_raises_as_jax(keep):
    with pytest.raises(ValueError, match="strictly increasing"):
        jcfm.pruned_sway_timesteps(keep)
    with pytest.raises(ValueError, match="strictly increasing"):
        tcfm.pruned_sway_timesteps(keep)


TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0)


@pytest.fixture(scope="module")
def tiny():
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**TINY), 8)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)
    cond = rng.standard_normal((1, 40, 20)).astype(np.float32)
    ids = np.asarray([[1, 2, 3, 3, 4, 0, 5, -1]], np.int32)
    return params, cond, ids


@pytest.mark.parametrize("cfg", [2.0, 0.0])
def test_sample_with_timesteps_matches_jax(tiny, cfg):
    params, cond, ids = tiny
    n = 64
    grid = tcfm.pruned_sway_timesteps((0, 1, 2, 4, 8), base_steps=8)
    key = jax.random.PRNGKey(1)
    j_in = jcfm.prepare_inputs(jnp.asarray(cond), jnp.asarray([40]), jnp.asarray([57]), n,
                               text_ids=jnp.asarray(ids))
    want, _ = jcfm.sample(params, {}, JDiTConfig(**TINY), JCFMConfig(), j_in, key, steps=32,
                          cfg_strength=cfg, sway_coef=-1.0, timesteps=grid,
                          compute_dtype=jnp.float32)
    y0 = np.array(jcfm.noise_like(key, 1, n, 20, j_in.duration))

    t_in = tcfm.prepare_inputs(torch.from_numpy(cond), torch.tensor([40]), torch.tensor([57]), n,
                               text_ids=torch.from_numpy(ids))
    got, traj = tcfm.sample(dit_from_jax(params, DiTConfig(**TINY)), DiTConfig(**TINY),
                            CFMConfig(), t_in, steps=32, cfg_strength=cfg, sway_coef=-1.0,
                            y0=torch.from_numpy(y0), timesteps=grid,
                            compute_dtype=torch.float32, device="cpu")
    assert traj.shape == (len(grid), 1, n, 20)  # the grid overrides steps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])


# ---------------------------------------------------------------------------
# get_pos_embed_indices and the text helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,length,max_pos,scale", [
    (np.array([0, 5, 9], np.int32), 7, 12, 1.0),
    (np.array([0, 3], np.int32), 10, 8, np.array([0.5, 1.7], np.float32)),
    (np.array([2, 4], np.int32), 6, 100, 2.5),
    (np.array([0.0, 1.5], np.float32), 5, 4, 1.3),
])
def test_get_pos_embed_indices_matches_jax(start, length, max_pos, scale):
    want = np.asarray(jnn.get_pos_embed_indices(jnp.asarray(start), length, max_pos,
                                                jnp.asarray(scale)))
    got = tnn.get_pos_embed_indices(torch.from_numpy(start), length, max_pos,
                                    torch.as_tensor(scale)).numpy()
    assert got.dtype == want.dtype == start.dtype
    np.testing.assert_array_equal(got, want)


Token = collections.namedtuple("Token", "phones lang")


@pytest.mark.parametrize("name,args", [
    ("split_rime", ("iang3",)), ("split_rime", ("er2",)), ("split_rime", ("a1",)),
    ("split_rime", ("ong4",)), ("split_rime", ("uai5",)),
    ("g2p_mix_process_token", (Token(["zh", "ong1"], "ZH"),)),
    ("g2p_mix_process_token", (Token(["1984"], "NUM"),)),
    ("g2p_mix_process_token", (Token(["HH", "AH0", "L", "OW1"], "EN"),)),
    ("g2p_mix_process_token", (Token([","], "SYM"),)),
    ("intersperse", ([["a", "b", "c"], [], ["x"]],)),
    ("intersperse", ([list("hi")], "#")),
    ("split_pinyin", ("zhuang",)), ("split_pinyin", ("xiong",)), ("split_pinyin", ("ang",)),
    ("split_pinyin", ("shi",)), ("split_pinyin", ("lüe",)), ("split_pinyin", ("er",)),
    ("repetition_found", ("ab" * 12,)), ("repetition_found", ("abcdefg hijk",)),
    ("repetition_found", ("aaaa", 1, 2)), ("repetition_found", ("", 2, 10)),
    ("g2p_mix_vocab", ()),
])
def test_text_helpers_match_jax(name, args):
    assert getattr(ttext, name)(*args) == getattr(jtext, name)(*args)


def test_split_rime_without_tone_raises_as_jax():
    for mod in (jtext, ttext):
        with pytest.raises(ValueError, match="tone digit"):
            mod.split_rime("ang")


@pytest.mark.parametrize("use_intersperse", [False, True])
def test_char_tokenizer_matches_jax(use_intersperse):
    vocab = {c: i for i, c in enumerate(" _abcdefghijklmnopqrstuvwxyz.,")}
    texts = ["hello, world.", "Zebra!", ""]
    jeng = jpipe.TTSEngine(params=None, state=None, arch=None, vocab=vocab, tokenizer="char",
                           use_intersperse=use_intersperse)
    teng = tpipe.TTSEngine(params={}, arch=None, vocab=vocab, tokenizer="char",
                           use_intersperse=use_intersperse, device="cpu")
    np.testing.assert_array_equal(teng.tokenize(texts), jeng.tokenize(texts))
    teng.tokenizer = "pinyin"
    with pytest.raises(NotImplementedError):
        teng.tokenize(texts)


# ---------------------------------------------------------------------------
# slice_gen, CachedTranscriber, preprocess_ref_audio_text
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("starts,gen_lens,L", [
    ([3, 40], [10, 5], 16),
    ([0, 64], [16, 3], 16),   # a start at N
    ([10, 90], [20, 8], 32),  # a start past N is clamped, as lax.dynamic_slice does
    ([5, 0], [0, 64], 64),
])
def test_slice_gen_matches_jax(starts, gen_lens, L):
    out = np.random.default_rng(4).standard_normal((2, 64, 12)).astype(np.float32)
    want = np.asarray(jpipe.slice_gen(jnp.asarray(out), jnp.asarray(starts, jnp.int32),
                                      jnp.asarray(gen_lens, jnp.int32), L))
    got = tpipe.slice_gen(torch.from_numpy(out), torch.tensor(starts, dtype=torch.int32),
                          torch.tensor(gen_lens, dtype=torch.int32), L)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cached_transcriber_calls_once_per_audio():
    calls = []

    def stub(wav, sr):
        calls.append(len(wav))
        return f"text of {len(wav)} samples at {sr}"

    t, j = tpipe.CachedTranscriber(stub), jpipe.CachedTranscriber(lambda w, s: stub(w, s))
    a = np.linspace(-1, 1, 100, dtype=np.float32)
    b = np.linspace(-1, 1, 101, dtype=np.float32)
    assert t(a, 8000) == t(a.astype(np.float64), 8000) == j(a, 8000)
    assert t(b, 8000) == "text of 101 samples at 8000"
    assert calls == [100, 100, 101]  # the port's two calls on `a` hit its cache


def test_preprocess_ref_audio_text_clip_short_matches_jax():
    rng = np.random.default_rng(1)
    sr = 8000
    x = np.concatenate([np.zeros(3000), 0.3 * rng.standard_normal(sr),
                        np.zeros(2000)]).astype(np.float32)
    long = np.concatenate([x] * 10)  # 16.25 s
    for clip_short in (False, True):
        tw, tt = tpipe.preprocess_ref_audio_text(long, sr, "words", clip_short=clip_short,
                                                 show_info=lambda *_: None)
        jw, jt = jpipe.preprocess_ref_audio_text(long, sr, "words", clip_short=clip_short,
                                                 show_info=lambda *_: None)
        np.testing.assert_array_equal(tw, jw)
        assert tt == jt
        assert (len(tw) == len(long)) == (not clip_short)
    text = tpipe.preprocess_ref_audio_text(x, sr, "", transcribe=lambda w, s: "heard this",
                                           show_info=lambda *_: None)[1]
    assert text == "heard this. "


# ---------------------------------------------------------------------------
# a tiny engine: reference-mel cache, streaming, grids, device-resident decode
# ---------------------------------------------------------------------------

MEL = MelConfig(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12,
                target_sample_rate=8000)
ARCH = DiTConfig(dim=32, depth=1, heads=1, dim_head=32, ff_mult=2, mel_dim=12, text_dim=16,
                 conv_layers=0, dropout=0.0)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.")}
REF = (0.2 * np.sin(2 * np.pi * 220 * np.arange(4000) / 8000)).astype(np.float32)


def host_vocoder(mel: torch.Tensor) -> np.ndarray:
    """Length-preserving and mel-dependent, so outputs tell grids apart."""
    return mel.float().mean(-1).repeat_interleave(MEL.hop_length, -1).numpy()


def device_vocoder():
    def decode(mel):
        return torch.from_numpy(host_vocoder(mel))

    decode.device = lambda mel: mel.float().mean(-1).repeat_interleave(MEL.hop_length, -1)
    return decode


@pytest.fixture(scope="module")
def tiny_params():
    params = tdit.init_dit(ARCH, len(VOCAB), torch.Generator().manual_seed(0))
    params["proj_out"]["w"] = 0.05 * torch.randn(params["proj_out"]["w"].shape,
                                                 generator=torch.Generator().manual_seed(9))
    return params


def make_engine(params, vocoder=host_vocoder, **kw):
    return tpipe.TTSEngine(params=params, arch=ARCH, vocab=VOCAB, mel=MEL,
                           infer_cfg=InferConfig(nfe_steps=4, max_duration=512), tokenizer="char",
                           vocoder_decode=vocoder, compute_dtype=torch.float32,
                           buckets=(128, 256, 512), device="cpu", **kw)


def test_engine_ref_mel_cache(tiny_params, monkeypatch):
    calls = []
    mel_fn = tpipe.mel_spectrogram
    monkeypatch.setattr(tpipe, "mel_spectrogram", lambda *a: calls.append(1) or mel_fn(*a))
    engine = make_engine(tiny_params)
    first = engine.infer(REF, 8000, "hello there.", "a test.", seed=1)
    again = engine.infer(REF.copy(), 8000, "hello there.", "a test.", seed=1)
    assert len(calls) == 1 and len(engine._ref_mel_cache) == 1  # same samples: a hit
    np.testing.assert_array_equal(first[0], again[0])
    engine.infer(REF, 16000, "hello there.", "a test.", seed=1)  # another rate: a miss
    assert len(calls) == 2
    oldest = next(iter(engine._ref_mel_cache))
    for i in range(7):
        engine.infer(REF * (0.5 + 0.05 * i), 8000, "hello there.", "a test.", seed=1)
    assert len(engine._ref_mel_cache) == 8 and len(calls) == 9
    assert oldest not in engine._ref_mel_cache  # first in, first out


def test_engine_streaming_chunks_concatenate_to_the_wav(tiny_params):
    engine = make_engine(tiny_params)
    wav, sr, _ = engine.infer(REF, 8000, "hello.", "a test.", seed=2)
    chunks = list(engine.infer(REF, 8000, "hello.", "a test.", seed=2, streaming=True,
                               chunk_size=100))
    assert len(chunks) == -(-len(wav) // 100) and all(s == sr for _, s in chunks)
    assert all(len(c) == 100 for c, _ in chunks[:-1]) and 0 < len(chunks[-1][0]) <= 100
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks]), wav)


def test_engine_pruned_timesteps(tiny_params):
    """Mirrors test_infer_pipeline.py::test_engine_infer_pruned_timesteps."""
    engine = make_engine(tiny_params)
    call = (REF, 8000, "hello there.", "this is a test.")
    w_def, _, m_def = engine.infer(*call, seed=1)
    full = tcfm.pruned_sway_timesteps(range(5), base_steps=4, sway_coef=-1.0)
    w_full, _, m_full = engine.infer(*call, seed=1, timesteps=full)
    np.testing.assert_array_equal(w_full, w_def)
    np.testing.assert_array_equal(m_full, m_def)
    pruned = tcfm.pruned_sway_timesteps((0, 1, 4), base_steps=4, sway_coef=-1.0)
    w_p, sr, _ = engine.infer(*call, seed=1, timesteps=pruned)
    assert sr == 8000 and np.isfinite(w_p).all()
    assert w_p.shape == w_def.shape  # the grid changes values, not the length
    assert not np.allclose(w_p, w_def)


@pytest.mark.parametrize("vocoder_pad_to", [128, 0])
def test_engine_device_resident_decode_equals_host_path(tiny_params, vocoder_pad_to):
    host = make_engine(tiny_params, vocoder_pad_to=vocoder_pad_to)
    dev = make_engine(tiny_params, device_vocoder(), vocoder_pad_to=vocoder_pad_to)
    decode, calls = dev.decode_mel, []

    def device_only(mel, device_out=False):
        # the device path hands the decode a tensor and asks for a tensor back:
        # the mel is not fetched to the host before decoding
        assert device_out and isinstance(mel, torch.Tensor)
        calls.append(mel.shape[1])
        return decode(mel, device_out=device_out)

    dev.decode_mel = device_only
    call = (REF, 8000, "hello there.", "this is a test. and one more sentence follows it.")
    kw = dict(seed=3, cross_fade_duration=0.01)
    for timesteps in (None, tcfm.pruned_sway_timesteps((0, 2, 4), base_steps=4)):
        w_h, _, m_h = host.infer(*call, timesteps=timesteps, **kw)
        calls.clear()
        w_d, _, m_d = dev.infer(*call, timesteps=timesteps, **kw)
        np.testing.assert_array_equal(w_d, w_h)
        np.testing.assert_array_equal(m_d, m_h)
        assert calls and sum(calls) == len(m_d)  # every chunk decoded on the device
    mel = np.random.default_rng(5).standard_normal((70, 12)).astype(np.float32)
    wav, trim = make_engine(tiny_params, device_vocoder()).decode_mel(mel, device_out=True)
    assert trim == 70 * MEL.hop_length and isinstance(wav, torch.Tensor)
    np.testing.assert_array_equal(wav[0, :trim].numpy(), host.decode_mel(mel))


def test_synthesize_chunk_device_out(tiny_params):
    engine = make_engine(tiny_params)
    ref_mel = np.random.default_rng(6).standard_normal((1, 40, 12)).astype(np.float32)
    out, rf, dur = engine.synthesize_chunk(ref_mel, "abc def", 100, seed=4, device_out=True)
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (1, 128, 12)
    assert (rf, dur) == (40, 100)
    host = engine.synthesize_chunk(ref_mel, "abc def", 100, seed=4)
    np.testing.assert_array_equal(out[0, 40:100].numpy(), host)


# ---------------------------------------------------------------------------
# F5TTS and the CLI on the CPU
# ---------------------------------------------------------------------------

TINY_F5 = dict(dim=32, depth=1, heads=1, dim_head=32, ff_mult=2, text_dim=16, conv_layers=1)


def ref_file(tmp_path, seconds=1.0, sr=24000):
    path = str(tmp_path / "ref.wav")
    t = np.arange(int(seconds * sr)) / sr
    taudio.write_wav(path, (0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr)
    return path


def tiny_f5tts(**kw):
    return tapi.F5TTS(model_cfg=TINY_F5, compute_dtype=torch.float32, device="cpu", **kw)


def test_f5tts_transcribes_an_empty_ref_text_once(tmp_path):
    path = ref_file(tmp_path)
    calls = []
    tts = tiny_f5tts(transcribe=lambda wav, sr: calls.append(sr) or "some words")
    grid = tcfm.pruned_sway_timesteps((0, 1, 2), base_steps=2)
    spec_path = str(tmp_path / "spec.npy")
    for _ in range(2):
        wav, sr, spec = tts.infer(path, "", "well hello.", nfe_step=2, seed=7, timesteps=grid,
                                  file_spec=spec_path)
    assert calls == [24000]  # the second request hit the transcriber's cache
    assert np.isfinite(wav).all() and sr == 24000
    np.testing.assert_array_equal(np.load(spec_path), spec)
    with pytest.raises(RuntimeError, match="no transcriber"):
        tiny_f5tts().infer(path, "", "well hello.", nfe_step=2, seed=7)


@pytest.mark.parametrize("text", [
    "Hello there. [town] How are you? [main] Fine.", "no tags at all", "[a][b] x [c]", "",
])
def test_split_voices_matches_jax(text):
    assert tcli.split_voices(text) == jcli.split_voices(text)


def test_cli_config_merge_matches_jax(tmp_path):
    toml = tmp_path / "c.toml"
    toml.write_text('model = "X"\nnfe_step = 16\nref_audio = "a.wav"\noutput_file = "o.wav"\n'
                    '[voices.town]\nref_audio = "t.wav"\n')
    argv = ["-c", str(toml), "--nfe_step", "8", "--speed", "0.9", "--remove_silence"]
    got = tcli.load_config(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    want = jcli.load_config(jcli.build_parser().parse_args(argv))
    assert got.pop("device") == "cpu"
    assert got == want and got["nfe_step"] == 8  # the flags override the TOML
    assert tcli.load_config(tcli.build_parser().parse_args([]))["device"] == "cuda"


def test_cli_writes_a_wav_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "F5TTS", functools.partial(tapi.F5TTS, model_cfg=TINY_F5,
                                                         compute_dtype=torch.float32))
    path = ref_file(tmp_path)
    toml = tmp_path / "c.toml"
    toml.write_text(f'[voices.town]\nref_audio = "{path}"\nref_text = "other words"\n')
    out_dir = str(tmp_path / "out")
    out = tcli.main(["-c", str(toml), "-r", path, "-s", "hello there", "-t",
                     "Hi. [town] Hello town.", "-o", out_dir, "-w", "o.wav", "--nfe_step", "2",
                     "--save_chunk", "--device", "cpu", "--seed", "3"])
    assert out == os.path.join(out_dir, "o.wav")
    wav, sr = taudio.read_wav(out)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert sorted(os.listdir(os.path.join(out_dir, "chunks"))) == ["0_main.wav", "1_town.wav"]
    # --asr_model reaches the Whisper pipeline, which finds no weights there
    with pytest.raises(SystemExit, match="ASR weights not found at whisper"):
        tcli.main(["-r", path, "-t", "x", "--device", "cpu", "--asr_model", "whisper"])
    # --model_cfg reaches F5TTS(config_file=), which reads the YAML
    with pytest.raises(FileNotFoundError):
        tcli.main(["-r", path, "-t", "x", "--device", "cpu", "--model_cfg",
                   str(tmp_path / "missing.yaml")])


# ---------------------------------------------------------------------------
# captured engines: names, lookup, routing; capture needs a card
# ---------------------------------------------------------------------------

EPSS = tcfm.pruned_sway_timesteps((0, 1, 2, 3, 4, 6, 10, 18, 32))
ENGINES = [  # (nfe, timesteps, cfg_strength, bucket)
    (32, None, None, 1536), (32, None, None, 1024), (16, None, None, 1536),
    (32, None, 0.0, 1536), (8, EPSS, None, 1536), (8, EPSS, 0.0, 1536), (32, None, None, 4096),
]


@pytest.mark.parametrize("timesteps,cfg_strength", [(None, None), (EPSS, None), (None, 0.0),
                                                    (EPSS, 2.5), ((0.0, 0.5, 1.0), None)])
def test_variant_tag_matches_jax(timesteps, cfg_strength):
    assert taot.variant_tag(timesteps, cfg_strength) == jaot._variant_tag(timesteps, cfg_strength)


@pytest.mark.parametrize("query", [
    (32, 1536, None, None), (32, 1024, None, None), (32, 768, None, None),
    (16, 1536, None, None), (8, 1536, None, None), (32, 1536, None, 0.0),
    (32, 1536, EPSS, None), (5, 1536, EPSS, 0.0), (32, 1024, EPSS, None),
    (32, 1536, None, 1.0), (32, 4096, None, None), (32, 1536, (0.0, 0.5, 1.0), None),
])
def test_engine_lookup_matches_jax(tmp_path, query):
    """The same choice as the JAX engine-file match on (nfe or grid,
    guidance, bucket), None when nothing fits. The JAX files also carry a
    prompt and a text length; the query here covers both, as any request of
    a bucket fits its engine in the port."""
    nfe, bucket, timesteps, cfg_strength = query
    engines = {}
    for e_nfe, e_ts, e_cfg, e_bucket in ENGINES:
        tag = taot.variant_tag(e_ts, e_cfg)
        (tmp_path / f"sampler_nfe{e_nfe}{tag}_ref100_b{e_bucket}_t256.jaxexport").touch()
        engines[taot.engine_name(e_nfe, e_bucket, e_ts, e_cfg)] = object()
    want = jaot.find_sampler_engine(str(tmp_path), nfe, 100, bucket, 256,
                                    timesteps=timesteps, cfg_strength=cfg_strength)
    got = taot.find_sampler_engine(engines, nfe, bucket, timesteps=timesteps,
                                   cfg_strength=cfg_strength)
    assert (got is None) == (want is None)
    if got is not None:
        assert got + "_t256.jaxexport" == os.path.basename(want[0]).replace("_ref100", "")


class EagerStub:
    """Stands in for a captured engine on the CPU: records its calls and
    runs the eager sampler from the y0 it is given."""

    def __init__(self, engine, timesteps=None, cfg_strength=2.0):
        self.engine, self.timesteps, self.cfg = engine, timesteps, cfg_strength
        self.calls = 0

    def sample(self, inputs, y0):
        self.calls += 1
        e = self.engine
        return tcfm.sample(e.params, e.arch, e.cfm, inputs, steps=e.infer_cfg.nfe_steps,
                           cfg_strength=self.cfg, sway_coef=e.infer_cfg.sway_sampling_coef,
                           y0=y0, timesteps=self.timesteps, compute_dtype=e.compute_dtype,
                           device="cpu")[0]


def test_synthesize_chunk_routes_to_a_matching_engine(tiny_params):
    engine = make_engine(tiny_params)
    ref_mel = np.random.default_rng(7).standard_normal((1, 40, 12)).astype(np.float32)
    long_text = "abcdefghij" * 4
    eager = engine.synthesize_chunk(ref_mel, "abc def", 100, seed=5)
    eager_long = engine.synthesize_chunk(ref_mel, long_text, 100, seed=5)
    grid = tcfm.pruned_sway_timesteps((0, 2, 4), base_steps=4)
    eager_grid = engine.synthesize_chunk(ref_mel, "abc def", 100, seed=5, timesteps=grid)
    default, epss = EagerStub(engine), EagerStub(engine, timesteps=grid)
    engine.engines = {"sampler_nfe4_b128": default,
                      f"sampler_nfe2{taot.variant_tag(grid)}_b128": epss}
    # a match replays with the noise of the request's seed: the eager bits
    np.testing.assert_array_equal(engine.synthesize_chunk(ref_mel, "abc def", 100, seed=5), eager)
    np.testing.assert_array_equal(
        engine.synthesize_chunk(ref_mel, "abc def", 100, seed=5, timesteps=grid), eager_grid)
    assert (default.calls, epss.calls) == (1, 1)
    # no match runs eagerly: another bucket, another nfe, sway or guidance
    engine.synthesize_chunk(ref_mel, "abc def", 200, seed=5)
    engine.synthesize_chunk(ref_mel, "abc def", 100, seed=5, nfe_steps=8)
    engine.synthesize_chunk(ref_mel, "abc def", 100, seed=5, sway=0.0)
    engine.synthesize_chunk(ref_mel, "abc def", 100, seed=5, cfg_strength=1.0)
    assert (default.calls, epss.calls) == (1, 1)
    # the text is data, not shape: a longer text in the bucket replays too
    np.testing.assert_array_equal(engine.synthesize_chunk(ref_mel, long_text, 100, seed=5),
                                  eager_long)
    engine.synthesize_chunk(ref_mel, long_text, 100, seed=5, timesteps=grid)
    assert (default.calls, epss.calls) == (2, 2)


def test_capture_on_the_cpu_raises(tiny_params):
    with pytest.raises(RuntimeError, match="CUDA device"):
        taot.capture_sampler_buckets(make_engine(tiny_params), buckets=(128,), nfe=2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tiny_f5tts(capture_buckets=(256,))
