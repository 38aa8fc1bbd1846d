"""Captured sampler engines (f5e_tts_tpu_torch/utils/aot.py) against the
eager sampler on the card: a replay from a request's seed gives the eager
run's bits, for any prompt and text length of the bucket (a PPG model's
too, with no PPG; a batch of two, the serving batcher's); engines sharing
one memory pool keep their own bits in either order of replay, and from
several threads at once; a replay on another stream raises.

These need a CUDA device and nvcc and skip without one. On a machine with
the card (which has no JAX, so the suite's conftest is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py

Tolerance: none. A replay launches the kernels the eager loop launched, on
the same values, so every comparison is bitwise.
"""

import threading

import numpy as np
import pytest
import torch

from f5e_tts_tpu_torch.api import _cast
from f5e_tts_tpu_torch.config import DiTConfig, InferConfig
from f5e_tts_tpu_torch.infer.pipeline import TTSEngine
from f5e_tts_tpu_torch.kernels import gated_adaln as ga
from f5e_tts_tpu_torch.kernels import rope_attention as ra
from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps
from f5e_tts_tpu_torch.models.dit import fuse_qkv, init_dit
from f5e_tts_tpu_torch.utils.aot import capture_sampler_buckets

pytestmark = pytest.mark.gpu

DEPTH, NFE = 2, 8
ARCH = DiTConfig(dim=256, depth=DEPTH, heads=4, dim_head=64, ff_mult=2, mel_dim=100,
                 text_dim=128, conv_layers=1, dropout=0.0)
EPSS = pruned_sway_timesteps((0, 1, 2, 4, 8), base_steps=NFE)


@pytest.fixture
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_dit(ARCH, 256, gen, "cuda")
    for blk in params["blocks"]:  # AdaLN-zero would make every block an identity
        blk["attn_norm"]["w"].normal_(0.0, 0.02, generator=gen)
    params["proj_out"]["w"].normal_(0.0, 0.02, generator=gen)
    return TTSEngine(params=fuse_qkv(_cast(params, torch.bfloat16)), arch=ARCH, vocab=None,
                     infer_cfg=InferConfig(nfe_steps=NFE, max_duration=1024),
                     compute_dtype=torch.bfloat16, buckets=(256, 512), device="cuda")


def _ref_mel(frames=80, seed=1):
    return np.random.default_rng(seed).standard_normal((1, frames, 100)).astype(np.float32)


def _chunk(engine, text="hello there, this is a test.", duration=200, seed=7, **kw):
    out, _, _ = engine.synthesize_chunk(_ref_mel(), text, duration, seed=seed, device_out=True,
                                        **kw)
    torch.cuda.synchronize()
    return out.clone()


def _eager(engine, **kw):
    engines, engine.engines = engine.engines, {}
    try:
        return _chunk(engine, **kw)
    finally:
        engine.engines = engines


def _counts():
    counts = (ra.launches, ga.launches)
    ra.launches = ga.launches = 0
    return counts


def test_replay_gives_the_eager_bits(engine):
    want = _eager(engine)
    _counts()
    names = capture_sampler_buckets(engine, buckets=(256,), nfe=NFE)
    assert names == [f"sampler_nfe{NFE}_b256"]
    # counted once a launch while the loop was captured, plus one eager warm-up step
    assert _counts() == (DEPTH * (NFE + 1), DEPTH * (NFE + 1))
    for seed in (7, 7, 8):
        got = _chunk(engine, seed=seed)
        assert _counts() == (0, 0)  # a replay counts nothing
        if seed == 7:
            assert torch.equal(got, want)
    assert not torch.equal(got, want)  # another seed, another noise
    # another prompt length in the same bucket: the same graph, the eager bits
    frames = 30
    got = engine.synthesize_chunk(_ref_mel(frames), "short.", 250, seed=3, device_out=True)[0]
    assert _counts() == (0, 0)
    engines, engine.engines = engine.engines, {}
    want = engine.synthesize_chunk(_ref_mel(frames), "short.", 250, seed=3, device_out=True)[0]
    engine.engines = engines
    assert torch.equal(got, want)


def test_two_engines_in_one_pool_keep_their_bits(engine):
    want_default, want_epss = _eager(engine), _eager(engine, timesteps=EPSS)
    want_512 = _eager(engine, duration=400)
    _counts()
    capture_sampler_buckets(engine, buckets=(256, 512), nfe=NFE)
    capture_sampler_buckets(engine, buckets=(256,), timesteps=EPSS)
    assert len(engine.engines) == 3 and engine.graph_pool is not None
    for order in ((0, 1, 2), (2, 1, 0), (1, 0, 1, 2, 2, 0)):
        for which in order:
            if which == 0:
                assert torch.equal(_chunk(engine), want_default)
            elif which == 1:
                assert torch.equal(_chunk(engine, timesteps=EPSS), want_epss)
            else:
                assert torch.equal(_chunk(engine, duration=400), want_512)
    assert _counts() == (DEPTH * (2 * (NFE + 1) + len(EPSS)),) * 2  # captures only


def test_a_long_text_replays_with_the_eager_bits(engine):
    """The text is no shape of the graph: a text that fills most of the
    bucket, in 3-byte characters too, replays and gives the eager bits."""
    texts = ("a much longer sentence, with well over two hundred bytes of it. " * 3,
             "\u4f60\u597d\u4e16\u754c\u3002" * 13)
    want = [_eager(engine, text=t, duration=250) for t in texts]
    capture_sampler_buckets(engine, buckets=(256,), nfe=NFE)
    _counts()
    for text, w in zip(texts, want):
        assert len(text.encode()) > 180
        assert torch.equal(_chunk(engine, text=text, duration=250), w)
    assert _counts() == (0, 0)  # both replayed



def test_a_batch_of_two_replays_with_the_eager_bits(engine):
    """A (2, bucket) engine (the serving batcher's) replays the folded loop
    of two requests, 4 folded rows, with the eager sampler's bits from the
    seeds' noise; the batch-1 engine of the bucket refuses the pair."""
    from f5e_tts_tpu_torch.models import cfm as fcfm
    from f5e_tts_tpu_torch.utils.aot import find_sampler_engine

    n = 256
    cond = torch.zeros((2, n, 100), device="cuda")
    cond[0, :80], cond[1, :50] = (torch.from_numpy(_ref_mel(f, s)[0]).cuda()
                                  for f, s in ((80, 1), (50, 2)))
    text = torch.full((2, 32), -1, dtype=torch.int32, device="cuda")
    text[0, :20], text[1, :9] = 5, 7
    inputs = fcfm.prepare_inputs(cond, torch.tensor([80, 50], device="cuda"),
                                 torch.tensor([200, 230], device="cuda"), n, text_ids=text)
    y0 = fcfm.noise_like(None, 2, n, 100, inputs.duration, seeds=[7, 8])
    want, _ = fcfm.sample(engine.params, engine.arch, engine.cfm, inputs, steps=NFE,
                          cfg_strength=2.0, sway_coef=-1.0, y0=y0,
                          compute_dtype=torch.bfloat16, device="cuda")
    _counts()
    names = capture_sampler_buckets(engine, buckets=(n,), nfe=NFE, batches=(1, 2))
    assert names == [f"sampler_nfe{NFE}_b{n}", f"sampler_nfe{NFE}_b{n}_x2"]
    assert _counts() == (2 * DEPTH * (NFE + 1),) * 2
    pair = engine.engines[find_sampler_engine(engine.engines, NFE, n, batch=2)]
    for _ in range(2):
        assert torch.equal(pair.sample(inputs, y0), want)
    assert _counts() == (0, 0)
    with pytest.raises(ValueError, match="batch 1"):
        engine.engines[names[0]].sample(inputs, y0)

def test_threads_share_an_engine_and_another_stream_raises(engine):
    """Requests from several threads on the default stream replay one at a
    time and each gets its own eager bits; a replay or a capture on another
    stream than the engines' raises."""
    seeds = (3, 4, 5, 6)
    want = {s: _eager(engine, seed=s) for s in seeds}
    capture_sampler_buckets(engine, buckets=(256,), nfe=NFE)
    got, errors = {}, []

    def worker(seed):
        try:
            for _ in range(3):
                out = _chunk(engine, seed=seed)
                if not torch.equal(out, want[seed]):
                    got[seed] = out
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and not got
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="one stream"):
            _chunk(engine)
        with pytest.raises(RuntimeError, match="one stream"):
            capture_sampler_buckets(engine, buckets=(512,), nfe=NFE)


def test_unett_engine_replay_gives_the_eager_bits():
    """A UNetT engine (the E2-TTS backbone: time token at row 0, attention
    on N+1 rows through the partial-RoPE kernel, RoPE tables N+1 long) replays
    with the eager bits, for any prompt and text of its bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from f5e_tts_tpu_torch.config import UNetTConfig
    from f5e_tts_tpu_torch.models import backbone as fbb

    arch = UNetTConfig(dim=256, depth=4, heads=4, dim_head=64, ff_mult=2, mel_dim=100,
                       dropout=0.0)
    params = fbb.init_backbone(arch, 256, torch.Generator(device="cuda").manual_seed(0), "cuda")
    engine = TTSEngine(params=fbb.fuse_qkv(_cast(params, torch.bfloat16), arch), arch=arch,
                       vocab=None, infer_cfg=InferConfig(nfe_steps=NFE, max_duration=1024),
                       compute_dtype=torch.bfloat16, buckets=(256, 512), device="cuda")
    want = _eager(engine)
    ra.partial_launches = ga.launches = 0
    assert capture_sampler_buckets(engine, buckets=(256,), nfe=NFE) == [f"sampler_nfe{NFE}_b256"]
    assert ra.partial_launches == arch.depth * (NFE + 1) and ga.launches == 0
    ra.partial_launches = 0
    assert torch.equal(_chunk(engine), want)
    assert ra.partial_launches == 0  # a replay counts nothing
    got = engine.synthesize_chunk(_ref_mel(30), "short.", 250, seed=3, device_out=True)[0]
    engines, engine.engines = engine.engines, {}
    eager = engine.synthesize_chunk(_ref_mel(30), "short.", 250, seed=3, device_out=True)[0]
    engine.engines = engines
    assert torch.equal(got, eager) and torch.isfinite(got).all()


def test_ppg_model_engine_replay_gives_the_eager_bits():
    """A PPG + codebook DiT (the F5E model's kind: 12 heads, RoPE on the first
    head, BatchNorm state) replays plain CFG with no PPG with the eager bits,
    its zero PPG embedding run through the BatchNorms' running statistics;
    a request with a PPG runs eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from f5e_tts_tpu_torch.config import CodebookConfig, PPGConfig

    arch = DiTConfig(dim=768, depth=DEPTH, heads=12, dim_head=64, ff_mult=2, mel_dim=100,
                     text_dim=128, conv_layers=1, dropout=0.0, pe_attn_head=1,
                     text_mask_padding=False, ppg=PPGConfig(use_ppg=True, ppg_dim=64),
                     codebook=CodebookConfig(use_codebook=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, state = init_dit(arch, 256, gen, "cuda")
    for blk in params["blocks"]:
        blk["attn_norm"]["w"].normal_(0.0, 0.02, generator=gen)
    params["proj_out"]["w"].normal_(0.0, 0.02, generator=gen)
    for bn in state["ppg_bn"]:  # running statistics away from the identity
        bn["mean"].normal_(0.0, 0.1, generator=gen)
        bn["var"].uniform_(0.5, 1.5, generator=gen)
    engine = TTSEngine(params=fuse_qkv(_cast(params, torch.bfloat16)), state=state, arch=arch,
                       vocab=None, infer_cfg=InferConfig(nfe_steps=NFE, max_duration=1024),
                       compute_dtype=torch.bfloat16, buckets=(256, 512), device="cuda")
    want = _eager(engine)
    ra.partial_launches = ga.launches = 0
    assert capture_sampler_buckets(engine, buckets=(256,), nfe=NFE) == [f"sampler_nfe{NFE}_b256"]
    assert (ra.partial_launches, ga.launches) == (DEPTH * (NFE + 1),) * 2
    ra.partial_launches = ga.launches = 0
    assert torch.equal(_chunk(engine), want)
    assert (ra.partial_launches, ga.launches) == (0, 0)  # a replay counts nothing
    ppg = np.random.default_rng(2).standard_normal((1, 90, 64)).astype(np.float32)
    with_ppg = _chunk(engine, ppg=ppg)  # eager: a PPG is no engine's input
    assert (ra.partial_launches, ga.launches) == (DEPTH * NFE,) * 2
    assert torch.equal(with_ppg, _eager(engine, ppg=ppg)) and not torch.equal(with_ppg, want)


def test_f5tts_capture_buckets_replays_in_infer(tmp_path):
    """F5TTS(capture_buckets=) captures the default engine of each bucket;
    infer replays it with the eager run's wav. The params are seeded after
    the capture, in place: the graph reads them by address."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from f5e_tts_tpu_torch.api import F5TTS
    from f5e_tts_tpu_torch.infer.audio import write_wav

    tts = F5TTS(model_cfg=dict(dim=256, depth=DEPTH, heads=4, dim_head=64, text_dim=128),
                device="cuda", capture_buckets=(512,))
    assert list(tts.engine.engines) == ["sampler_nfe32_b512"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for blk in tts.engine.params["blocks"]:
            blk["attn_norm"]["w"].normal_(0.0, 0.02, generator=gen)
        tts.engine.params["proj_out"]["w"].normal_(0.0, 0.02, generator=gen)
    path = str(tmp_path / "ref.wav")
    t = np.arange(24000) / 24000
    write_wav(path, (0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 24000)
    call = (path, "hello there.", "a test of the engine.")
    kw = dict(fix_duration=4.0, seed=3)  # 375 frames: bucket 512
    _counts()
    replayed, sr, _ = tts.infer(*call, **kw)
    assert _counts() == (0, 0)
    engines, tts.engine.engines = tts.engine.engines, {}
    eager, _, _ = tts.infer(*call, **kw)
    tts.engine.engines = engines
    assert _counts() == (DEPTH * 32, DEPTH * 32)
    assert sr == 24000 and np.isfinite(replayed).all()
    np.testing.assert_array_equal(replayed, eager)


def test_ppg_engine_replay_gives_the_eager_bits():
    """capture_ppg_buckets over a small fp32 Conformer: a replay of a clip
    padded into its bucket equals eager mel_to_ppg bit for bit, in either
    order of the engines (one pool), and find_ppg_engine picks the bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from f5e_tts_tpu_torch.models.conformer import ConformerConfig, PPGExtractor, init_conformer
    from f5e_tts_tpu_torch.utils.aot import capture_ppg_buckets, find_ppg_engine

    cfg = ConformerConfig(output_size=64, attention_heads=2, linear_units=128, num_blocks=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ext = PPGExtractor(params=init_conformer(cfg, gen, "cuda"), cfg=cfg, device="cuda")
    engines = capture_ppg_buckets(ext, frame_buckets=(100, 200))
    assert sorted(engines) == ["ppg_b1_t100", "ppg_b1_t200"]
    for frames in (160, 70):
        name, bucket = find_ppg_engine(engines, 1, frames)
        feats = torch.zeros((1, bucket, 80), device="cuda")
        feats[0, :frames] = torch.randn((frames, 80), generator=gen, device="cuda") + 8.0
        lens = torch.tensor([frames], dtype=torch.int32, device="cuda")
        ppg, true_len = engines[name].run(feats, lens)
        want, want_len = ext.mel_to_ppg(feats, lens)
        assert torch.equal(ppg, want) and torch.equal(true_len, want_len)
    assert find_ppg_engine(engines, 1, 201) is None
