"""The quality proxy of the port (`eval/proxy_quality.py`,
`eval/quality_proxy_cli.py`) against the JAX package's on the CPU.

- The toyspeech language, its tokenizer, the decoder, TER, the DCT and the
  mel metrics: bit for bit against f5e_tts_tpu.eval.proxy_quality on the
  same inputs (numpy on both sides; the decoder and metrics are fed one
  mel). `_mel` (the port's log-mel) against the JAX one in linear
  magnitude, exp(mel), within 1e-6 of the utterance's largest (fp32 FFT
  rounding against the frame's peak: the toyspeech's pure tones leave bins
  40 dB and more below it, whose logs differ by up to 0.05); the token
  templates, means of those logs over a token's frames, within 1e-2.
- `score_levers` against the same levers computed as scripts/quality_proxy.py
  computes them (the JAX `cfm.sample` with seeds, then the JAX proxy's
  decoder and metrics): seeded JAX weights of the proxy's DiT at dim 64 (4
  heads of 16: the unfused route) converted by `dit_from_jax`, four eval
  utterances, few steps; both sides draw their noise from the same seeds
  (the port's `noise_like(seeds=)` is JAX's threefry draw). TER equal; each metric within two units of
  its rounding (the rows are rounded as the JAX runner rounds them) plus
  1e-4 relative (fp32 sampling on both sides).
- The ground-truth decoder's TER on the CLI's default evaluation set (64
  utterances, 3 prompt tokens) equals the JAX package's.
- `quality_proxy_cli all` at a tiny size on the CPU: train, distill and
  eval run through the port's Trainer; the report has the eight lever rows
  and `_gt_decoder_ter_pct`.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.eval import proxy_quality as jpq
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops.quant import quantize_backbone_params as jquantize
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig
from f5e_tts_tpu_torch.eval import proxy_quality as pq
from f5e_tts_tpu_torch.eval import quality_proxy_cli as cli
from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps
from f5e_tts_tpu_torch.ops.quant import quantize_backbone_params
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

ARCH = dict(dim=64, depth=1, heads=4, dim_head=16, ff_mult=2, mel_dim=24, text_dim=64,
            conv_layers=2, dropout=0.0)  # the proxy's DiT (_configs) at dim 64, depth 1
PROMPT, EVAL_UTTS = 3, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The proxy's many tiny ops on one intra-op thread: beside other test
    workers, a thread per core spins against them (the CLI test took ~600 s
    so, ~20 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_language_tokenizer_decoder_and_metrics_match_jax():
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        (tj, sj, wj), (tt, st, wt) = jpq.make_utterance(rng_j), pq.make_utterance(rng_t)
        assert (tj, sj.f0, sj.tilt) == (tt, st.f0, st.tilt) and np.array_equal(wj, wt)
    spk = pq.Speaker(f0=120.0, tilt=0.9)
    assert np.array_equal(pq.synth_token("c", spk), jpq.synth_token("c", jpq.Speaker(120.0, 0.9)))
    rows_j, rows_t = jpq.make_dataset(4, seed=5), pq.make_dataset(4, seed=5)
    assert [(r["text"], r["duration"]) for r in rows_j] == [(r["text"], r["duration"])
                                                             for r in rows_t]
    assert all(np.array_equal(a["audio"]["array"], b["audio"]["array"])
               for a, b in zip(rows_j, rows_t))
    texts = [r["text"] for r in rows_t] + ["ab"]
    assert np.array_equal(pq.tokenize(texts), jpq.tokenize(texts))
    assert np.array_equal(pq._dct_matrix(24), jpq._dct_matrix(24))

    wav = rows_t[0]["audio"]["array"]
    mel_t, mel_j = pq._mel(wav), jpq._mel(wav)
    assert mel_t.shape == mel_j.shape
    np.testing.assert_allclose(np.exp(mel_t), np.exp(mel_j), rtol=0,
                               atol=1e-6 * np.exp(mel_j).max())
    np.testing.assert_allclose(pq.token_templates(), jpq.token_templates(), rtol=0, atol=1e-2)
    n = len(rows_t[0]["text"])
    noisy = mel_j + 0.3 * np.random.default_rng(0).standard_normal(mel_j.shape).astype(np.float32)
    for m in (mel_j, noisy):  # one mel into both decoders
        assert pq.decode_mel(m, n, start_token=PROMPT) == jpq.decode_mel(m, n, start_token=PROMPT)
    for hyp, ref in (("abd", "abc"), ("", "abc"), ("abxc", "abc"), ("ab", "")):
        assert pq.token_error_rate(hyp, ref) == jpq.token_error_rate(hyp, ref)
    assert pq.mel_metrics(noisy, mel_j) == jpq.mel_metrics(noisy, mel_j)


def _jax_inputs(utts):
    """cmd_eval's inputs (scripts/quality_proxy.py:175-205) with the JAX package."""
    frames, bucket = jpq.FRAMES_PER_TOKEN, 16 * jpq.FRAMES_PER_TOKEN
    gt_mels = [jpq._mel(w)[: len(t) * frames] for t, _, w in utts]
    texts, n_toks = [t for t, _, _ in utts], [len(t) for t, _, _ in utts]
    b = len(utts)
    cond = np.zeros((b, bucket, jpq.MEL.n_mel_channels), np.float32)
    for i, m in enumerate(gt_mels):
        cond[i, : PROMPT * frames] = m[: PROMPT * frames]
    text_ids = jpq.tokenize(texts)
    text_pad = np.full((b, 16), -1, np.int32)
    text_pad[:, : text_ids.shape[1]] = text_ids
    duration = np.asarray([n * frames for n in n_toks], np.int32)
    inputs = jcfm.prepare_inputs(jnp.asarray(cond), jnp.full((b,), PROMPT * frames, jnp.int32),
                                 jnp.asarray(duration), bucket, text_ids=jnp.asarray(text_pad))
    return inputs, texts, n_toks, gt_mels


def _jax_rows(levers, arch, inputs, texts, n_toks, gt_mels, seeds):
    """The lever rows as scripts/quality_proxy.py:226-253 computes them."""
    frames, results, teacher = jpq.FRAMES_PER_TOKEN, {}, None
    for name, lv in levers.items():
        out, _ = jcfm.sample(lv["p"], {}, arch, JCFMConfig(), inputs, jax.random.PRNGKey(99),
                             steps=lv["steps"], cfg_strength=lv["cfg"], sway_coef=-1.0,
                             use_mask=True, seeds=seeds, timesteps=lv["ts"],
                             compute_dtype=jnp.float32)
        out = np.asarray(out)
        teacher = out if teacher is None else teacher
        ters, metrics, drift = [], [], []
        for i, n in enumerate(n_toks):
            gen = slice(PROMPT * frames, n * frames)
            hyp = jpq.decode_mel(out[i, : n * frames], n, start_token=PROMPT)
            ters.append(jpq.token_error_rate(hyp, texts[i][PROMPT:]))
            metrics.append(jpq.mel_metrics(out[i, gen], gt_mels[i][gen]))
            drift.append(jpq.mel_metrics(out[i, gen], teacher[i, gen])["mcd_db"])
        results[name] = {
            "ter_pct": round(100 * float(np.mean(ters)), 2),
            "mel_mse": round(float(np.mean([m["mel_mse"] for m in metrics])), 4),
            "mcd_db": round(float(np.mean([m["mcd_db"] for m in metrics])), 3),
            "lsd": round(float(np.mean([m["lsd"] for m in metrics])), 4),
            "mcd_vs_teacher_db": round(float(np.mean(drift)), 3)}
    return results


def _randomized(tree, rng):
    def leaf(a):
        a = np.asarray(a, np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return jax.tree.map(leaf, tree)


def test_score_levers_rows_match_jax_levers():
    arch_j, arch_t = JDiTConfig(**ARCH), DiTConfig(**ARCH)
    teacher, student = (_randomized(jdit.init_dit(jax.random.PRNGKey(s), arch_j,
                                                  len(jpq.VOCAB))[0],
                                    np.random.default_rng(s)) for s in (0, 1))
    grid = (0, 1, 3, 4)  # an EPSS-style grid: 3 of 4 sway steps
    levers_j = {"teacher": dict(p=teacher, steps=3, cfg=2.0, ts=None),
                "epss": dict(p=teacher, steps=32, cfg=2.0,
                             ts=jcfm.pruned_sway_timesteps(grid, base_steps=4)),
                "int8_one_step": dict(p=jquantize(teacher, "DiT"), steps=1, cfg=2.0, ts=None),
                "cfg0_student": dict(p=student, steps=2, cfg=0.0, ts=None)}
    tp, sp = dit_from_jax(teacher, arch_t), dit_from_jax(student, arch_t)
    levers_t = {"teacher": dict(p=tp, steps=3, cfg=2.0, ts=None),
                "epss": dict(p=tp, steps=32, cfg=2.0, ts=pruned_sway_timesteps(grid, base_steps=4)),
                "int8_one_step": dict(p=quantize_backbone_params(tp, "DiT"), steps=1, cfg=2.0,
                                      ts=None),
                "cfg0_student": dict(p=sp, steps=2, cfg=0.0, ts=None)}

    rng = np.random.default_rng(12345)
    utts = [jpq.make_utterance(rng) for _ in range(EVAL_UTTS)]
    inputs_j, texts, n_toks, gt_j = _jax_inputs(utts)
    seeds = jnp.arange(7000, 7000 + EVAL_UTTS, dtype=jnp.uint32)
    want = _jax_rows(levers_j, arch_j, inputs_j, texts, n_toks, gt_j, seeds)

    inputs_t, texts_t, n_toks_t, gt_t = cli.eval_inputs(EVAL_UTTS, PROMPT, "cpu")
    assert (texts_t, n_toks_t) == (texts, n_toks)
    got = cli.score_levers(levers_t, arch_t, CFMConfig(), inputs_t, texts_t, n_toks_t, gt_t,
                           PROMPT, seeds=seeds.tolist(), device="cpu", log=lambda m: None)
    assert list(got) == list(want)
    units = {"ter_pct": 0.0, "mel_mse": 2e-4, "mcd_db": 2e-3, "lsd": 2e-4,
             "mcd_vs_teacher_db": 2e-3}
    for name, row in want.items():
        assert got[name]["ter_pct"] == row["ter_pct"], name
        for key, unit in units.items():
            assert abs(got[name][key] - row[key]) <= unit + 1e-4 * abs(row[key]), (name, key)


def test_ground_truth_decoder_ter_equals_jax_on_the_cli_eval_set():
    rng = np.random.default_rng(12345)
    utts = [jpq.make_utterance(rng) for _ in range(64)]
    frames = jpq.FRAMES_PER_TOKEN
    want = round(100 * float(np.mean([
        jpq.token_error_rate(jpq.decode_mel(jpq._mel(w)[: len(t) * frames], len(t),
                                            start_token=PROMPT), t[PROMPT:])
        for t, _, w in utts])), 3)
    _, texts, n_toks, gt = cli.eval_inputs(64, PROMPT, "cpu")
    assert cli.gt_decoder_ter_pct(texts, n_toks, gt, PROMPT) == want


def test_cli_all_on_the_cpu(tmp_path):
    report = cli.main(["all", "--dir", str(tmp_path), "--device", "cpu", "--steps", "2",
                       "--distill-steps", "1", "--train-utts", "32", "--eval-utts", "2",
                       "--dim", "64", "--depth", "1", "--batch-utts", "8"])
    assert report["train"]["updates"] == 2 and report["distill"]["updates"] == 1
    levers = report["eval"]["levers"]
    assert list(levers) == ["teacher_nfe32_cfg2", "nfe16", "epss16of32", "epss8of32",
                            "cfg0_base", "int8_w8a8", "cfg0_distill", "cfg0_distill_nfe16",
                            "_gt_decoder_ter_pct"]
    assert all(np.isfinite(v) for name, row in levers.items() if not name.startswith("_")
               for v in row.values())
    saved = json.loads((tmp_path / "quality_proxy.json").read_text())
    assert saved["levers"] == levers and saved["eval_utts"] == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval", "--dir", str(tmp_path)])  # the card by default
