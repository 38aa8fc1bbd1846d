"""The port's evaluation harness against the JAX package on the CPU: meta
lists, prompt batches, the batch-inference runner in its three modes, the VC
prompts, the batch CLI and the scoring CLI's glue.

- `get_seedtts_metainfo`, `get_librispeech_metainfo` and `shard_for_host`
  exactly; `get_inference_prompts` (frame-budget grouping, the bucket
  index, the seeded shuffle): utterances, lengths, text ids and rms
  exactly, the reference mels within rtol 1e-4 + atol 1e-4 (the mel front
  ends' own parity bound).
- `run_batch_inference` in the cfg and tts modes on a tiny DiT and in the
  vc mode on a tiny PPG DiT (dim 64, depth 2, 2 x 32 heads, mel 12),
  fp32, 3 Euler steps, over six prompts in two batches of three (texts
  padded within each batch, one text length across them, so JAX compiles
  once a mode), the JAX noise injected through `draw_noise` (the JAX
  runner draws `noise_like(PRNGKey(seed))` for each batch): each written
  wav within atol 1e-4 of JAX's through the same stand-in vocoder (a
  frame's mean repeated over its hop).
- `get_vc_inference_prompts` with one stand-in extractor in both: the
  same groups, lengths and PPG, exactly up to the mel bound above.
- `eval_infer_batch.main --device cpu` over a written seed-tts list on a
  tiny preset writes one finite wav an utterance inside the 3-40 s window
  and reports RTF; without
  a card it raises unless asked for the CPU.
- `score_cli`: the meta pairs as JAX's, and the gated loaders raise
  without their weights (tests/test_score_cli.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import InferConfig as JInferConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.config import PPGConfig as JPPGConfig
from f5e_tts_tpu.eval import harness as jh
from f5e_tts_tpu.eval import score_cli as jscore
from f5e_tts_tpu.eval import vc as jvc
from f5e_tts_tpu.infer import pipeline as jpipe
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, InferConfig, MelConfig, PPGConfig
from f5e_tts_tpu_torch.eval import harness as th
from f5e_tts_tpu_torch.eval import score_cli as tscore
from f5e_tts_tpu_torch.eval import vc as tvc
from f5e_tts_tpu_torch.infer import audio as taudio
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.utils.convert import dit_from_jax
from f5e_tts_tpu_torch.utils.text import list_str_to_idx

MEL_KW = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12, target_sample_rate=8000)
TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=12, text_dim=32,
            conv_layers=1, dropout=0.0)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.")}


def _tokenize(texts):
    return list_str_to_idx([list(x.lower()) for x in texts], VOCAB)


def _testset(root, n=5, period=None):
    """A seed-tts list of n prompts (8 kHz, from 1.2 s by 0.3 s) with
    ground-truth wavs; the i-th text to say is 3 * i characters longer than
    the first, or 3 * (i % period) with a period."""
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    lines = []
    for i in range(n):
        sec = 1.2 + 0.3 * i
        wav = (0.05 * np.sin(2 * np.pi * (150 + 40 * i) * np.arange(int(sec * 8000)) / 8000)
               ).astype(np.float32)
        taudio.write_wav(os.path.join(root, f"p{i}.wav"), wav, 8000)
        taudio.write_wav(os.path.join(root, "wavs", f"u{i}.wav"), wav[: 8000 + 2000 * i], 8000)
        lines.append(f"u{i}|a prompt text.|p{i}.wav|the text to say " + "x" * (3 * (i if period is None else i % period)))
    path = os.path.join(root, "meta.lst")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nbroken line\n")
    return path


def _same_batch(g, w):
    assert g.utts == w.utts
    for k in ("ref_mel_lens", "total_mel_lens", "text_ids", "ref_rms"):
        np.testing.assert_array_equal(getattr(g, k), np.asarray(getattr(w, k)))
    np.testing.assert_allclose(g.ref_mels, np.asarray(w.ref_mels), rtol=1e-4, atol=1e-4)


def test_metainfo_prompts_and_shards_match_jax(tmp_path):
    meta = _testset(str(tmp_path))
    info = th.get_seedtts_metainfo(meta)
    assert info == jh.get_seedtts_metainfo(meta) and len(info) == 5
    assert info[1][2] == str(tmp_path / "p1.wav") and info[1][4] == str(tmp_path / "wavs/u1.wav")
    ls = tmp_path / "ls.lst"
    ls.write_text("1-2-3\t3.1\tref words\t4-5-6\t5.0\tgen words\n")
    assert th.get_librispeech_metainfo(str(ls), "/data") == \
        jh.get_librispeech_metainfo(str(ls), "/data")
    items = list(range(11))
    assert [th.shard_for_host(items, i, 3) for i in range(3)] == \
        [jh.shard_for_host(items, i, 3) for i in range(3)]
    assert th.shard_for_host(items) == items
    for bs in (1, 700):
        kw = dict(infer_batch_size=bs, min_secs=1.0, max_secs=12.0, num_buckets=4)
        got = th.get_inference_prompts(info, _tokenize, MelConfig(**MEL_KW), **kw)
        want = jh.get_inference_prompts(info, _tokenize, JMelConfig(**MEL_KW), **kw)
        assert len(got) == len(want) and sum(len(b.utts) for b in got) == 5
        for g, w in zip(got, want):
            _same_batch(g, w)
    assert max(len(b.utts) for b in got) > 1  # the 700-frame budget groups utterances


def _hop_vocoder(m):
    """A stand-in vocoder: each frame's mean over its hop, scaled."""
    return np.repeat(0.01 * np.asarray(m, np.float32).mean(-1), MEL_KW["hop_length"], axis=1)


def _engines(ppg: bool):
    extra_j = dict(ppg=JPPGConfig(use_ppg=True, ppg_dim=16), text_mask_padding=False) if ppg \
        else {}
    extra_t = dict(ppg=PPGConfig(use_ppg=True, ppg_dim=16), text_mask_padding=False) if ppg \
        else {}
    arch_j, arch_t = JDiTConfig(**TINY, **extra_j), DiTConfig(**TINY, **extra_t)
    params, state = jdit.init_dit(jax.random.PRNGKey(0), arch_j, len(VOCAB))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) if np.asarray(a).any()
                          else (0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
                          params)
    state = jax.tree.map(np.asarray, state)
    # one bucket: the JAX sampler compiles once a mode
    kw = dict(vocab=VOCAB, tokenizer="char", vocoder_decode=_hop_vocoder, buckets=(768,))
    jeng = jpipe.TTSEngine(params=jax.tree.map(jnp.asarray, params),
                           state=jax.tree.map(jnp.asarray, state), arch=arch_j,
                           mel=JMelConfig(**MEL_KW), cfm=JCFMConfig(),
                           infer_cfg=JInferConfig(nfe_steps=3), compute_dtype=jnp.float32, **kw)
    made = dit_from_jax(params, arch_t, state_np=state) if ppg else (
        dit_from_jax(params, arch_t), {})
    teng = tpipe.TTSEngine(params=made[0], state=made[1], arch=arch_t, mel=MelConfig(**MEL_KW), cfm=CFMConfig(),
                           infer_cfg=InferConfig(nfe_steps=3), compute_dtype=torch.float32,
                           device="cpu", **kw)
    return jeng, teng


def _written(monkeypatch, module):
    """Capture the wavs `module.faudio.write_wav` writes, by file name."""
    wavs = {}
    monkeypatch.setattr(module.faudio, "write_wav",
                        lambda path, wav, sr: wavs.__setitem__(os.path.basename(path),
                                                               np.asarray(wav)))
    return wavs


@pytest.mark.parametrize("mode", ["cfg", "tts", "vc"])
def test_run_batch_inference_matches_jax(tmp_path, monkeypatch, mode):
    jeng, teng = _engines(ppg=mode == "vc")
    # six prompts in two batches of three, each of its own prompt and total
    # lengths and with padded texts, both padded to one text length: the
    # JAX sampler compiles once a mode
    info = th.get_seedtts_metainfo(_testset(str(tmp_path), n=6, period=2))
    kw = dict(infer_batch_size=1200, min_secs=1.0, max_secs=12.0, num_buckets=4)
    batches = th.get_inference_prompts(info, teng.tokenize, teng.mel, **kw)
    jbatches = jh.get_inference_prompts(info, jeng.tokenize, jeng.mel, **kw)

    def jax_noise(seed, b, n, c, durations):  # what the JAX runner draws for a batch
        return torch.from_numpy(np.array(jcfm.noise_like(
            jax.random.PRNGKey(seed), b, n, c, jnp.asarray(durations.numpy()))))

    monkeypatch.setattr(th, "draw_noise", jax_noise)
    run = dict(nfe_steps=3, seed=4, mode=mode, cfg_strength=2.0, alpha_spk=1.5, alpha_txt=2.0,
               alpha_ppg=2.0)
    got_w = _written(monkeypatch, th)
    stats = th.run_batch_inference(teng, batches, str(tmp_path / "t"), **run)
    monkeypatch.undo()
    want_w = _written(monkeypatch, jh)
    jh.run_batch_inference(jeng, jbatches, str(tmp_path / "j"), **run)
    assert [len(b.utts) for b in batches] == [3, 3]
    assert all(b.text_ids.shape == batches[0].text_ids.shape and (b.text_ids == -1).any()
               for b in batches)
    assert sorted(got_w) == sorted(want_w) == [f"u{i}.wav" for i in range(6)]
    for name, wav in got_w.items():
        assert wav.shape == want_w[name].shape and np.isfinite(wav).all()
        np.testing.assert_allclose(wav, want_w[name], atol=1e-4, err_msg=name)
    assert stats["n_batches"] == len(batches) and stats["rtf"] > 0
    assert stats["audio_s"] == pytest.approx(sum(len(w) for w in got_w.values()) / 8000)


class _StandInExtractor:
    """audio_to_ppg(wav (1, T)) -> a deterministic (1, T // 320, 16) PPG."""

    def __init__(self, to):
        self.to = to

    def audio_to_ppg(self, wav):
        w = np.asarray(wav)[0]
        n = len(w) // 320
        ppg = np.stack([np.abs(w[: n * 320]).reshape(n, 320)[:, :16 * 20:20]] * 1)[0]
        return self.to(ppg[None].astype(np.float32)), self.to(np.asarray([n], np.int32))


def test_vc_prompts_match_jax(tmp_path):
    info = th.get_seedtts_metainfo(_testset(str(tmp_path)))
    kw = dict(infer_batch_size=2, min_secs=1.0, max_secs=12.0, num_buckets=4)
    got = tvc.get_vc_inference_prompts(info, _StandInExtractor(torch.from_numpy),
                                       MelConfig(**MEL_KW), **kw)
    want = jvc.get_vc_inference_prompts(info, _StandInExtractor(jnp.asarray),
                                        JMelConfig(**MEL_KW), **kw)
    assert len(got) == len(want) == 3
    for (gb, gp, gl), (wb, wp, wl) in zip(got, want):
        _same_batch(gb, wb)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gp, wp, atol=1e-6)
        assert (gb.text_ids == -1).all()


def test_eval_infer_batch_cli_on_the_cpu(tmp_path, monkeypatch):
    import f5e_tts_tpu_torch.api as tapi
    from f5e_tts_tpu_torch import config as tconfig
    from f5e_tts_tpu_torch.eval import eval_infer_batch
    from f5e_tts_tpu_torch.models.vocos import VocosConfig

    meta = _testset(str(tmp_path))
    # the preset and the vocoder cut to tiny widths (mel 100, 24 kHz)
    monkeypatch.setattr(tapi, "preset", lambda name: tconfig.ModelConfig(
        name=name, backbone="DiT", arch=DiTConfig(**{**TINY, "mel_dim": 100})))
    monkeypatch.setattr(tapi, "VocosConfig",
                        lambda: VocosConfig(dim=32, intermediate_dim=48, num_layers=1))
    args = ["--metalst", meta, "--output_dir", str(tmp_path / "out"), "-nfe", "2",
            "--seed", "3"]
    stats = eval_infer_batch.main(args + ["--device", "cpu"])
    out = tmp_path / "out" / "F5TTS_v1_Base_1250000_seedtts_2nfe_euler_ss-1_cfg2.0_seed3"
    wavs = sorted(os.listdir(out))
    # u0 (1.2 s of prompt, ~2.5 s in all) is under the CLI's 3 s floor
    assert wavs == [f"u{i}.wav" for i in range(1, 5)] and stats["n_batches"] == 4
    for name in wavs:
        wav, sr = taudio.read_wav(str(out / name))
        assert sr == 24_000 and len(wav) > 0 and np.isfinite(wav).all()
    assert stats["rtf"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_infer_batch.main(args)


def test_score_cli_pairs_and_gated_loaders(tmp_path):
    from f5e_tts_tpu_torch.eval import scorers as ts

    gen = tmp_path / "gen"
    gen.mkdir()
    for utt in ("u1", "u2"):
        taudio.write_wav(str(gen / f"{utt}.wav"), np.zeros(100, np.float32), 8000)
    meta = tmp_path / "meta.lst"
    meta.write_text("u1|ptext|p1.wav|gtext one\nu2|ptext|p2.wav|gtext two\n"
                    "u3|ptext|p3.wav|missing gen\n")
    for field in ("wer", "sim"):
        assert tscore._pairs_from_meta(str(meta), str(gen), field) == \
            jscore._pairs_from_meta(str(meta), str(gen), field)
    assert tscore._pairs_from_meta(str(meta), str(gen), "wer")[0] == \
        ("u1", "gtext one", str(gen / "u1.wav"))
    with pytest.raises(FileNotFoundError):
        ts.load_whisper_asr(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        ts.load_utmos(str(tmp_path / "nope.pt"))
    with pytest.raises(FileNotFoundError):
        ts.load_wavlm_xvector(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        tscore._load_speaker_embedder(str(tmp_path / "nope.pt"))
    with pytest.raises(FileNotFoundError):
        tscore.main(["utmos", "--gen_dir", str(gen), "--utmos", str(tmp_path / "nope.pt"),
                     "--device", "cpu"])
    assert ts.wer("a b c".split(), "a x c".split()) == pytest.approx(1 / 3)


def test_asr_loaders_run_on_the_device_asked_for(tmp_path, monkeypatch):
    """`score_cli wer --device` reaches the Whisper pipeline; with no card a
    CUDA request raises rather than running on the CPU."""
    import transformers

    from f5e_tts_tpu_torch.eval import scorers as ts

    gen = tmp_path / "gen"
    gen.mkdir()
    for utt in ("u1", "u2"):
        taudio.write_wav(str(gen / f"{utt}.wav"), np.zeros(100, np.float32), 8000)
    meta = tmp_path / "meta.lst"
    meta.write_text("u1|ptext|p1.wav|gtext one\nu2|ptext|p2.wav|gtext two\n")
    asr_dir = tmp_path / "whisper"
    asr_dir.mkdir()
    seen = []

    def fake_pipeline(task, model, device):
        seen.append((task, model, torch.device(device)))
        return lambda path, generate_kwargs: {"text": "gtext one"}

    monkeypatch.setattr(transformers, "pipeline", fake_pipeline)
    args = ["wer", "--gen_dir", str(gen), "--metalst", str(meta), "--backend", "hf_whisper",
            "--asr_model", str(asr_dir)]
    out = tscore.main(args + ["--device", "cpu"])
    assert seen == [("automatic-speech-recognition", str(asr_dir), torch.device("cpu"))]
    assert out == {"wer": 0.25, "n": 2}
    with pytest.raises(ValueError, match="unknown ASR backend"):
        ts.load_asr_backend("en", backend="bogus")
    if not torch.cuda.is_available():
        for call in (lambda: tscore.main(args),
                     lambda: ts.load_asr_backend("en", backend="hf_whisper",
                                                 ckpt_dir=str(asr_dir)),
                     lambda: ts.load_whisper_asr(str(asr_dir))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        assert len(seen) == 1
