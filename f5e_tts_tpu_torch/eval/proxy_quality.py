"""Quality-proxy harness: a decodable synthetic language for lever scoring
(counterpart of `f5e_tts_tpu/eval/proxy_quality.py`, its numpy parts copied,
the log-mel on the port's `ops/mel.py`).

- a "toyspeech" language: 10 token symbols, each synthesized as a fixed
  96 ms formant-pair segment (f1/f2 unique per token, speaker-independent);
  speakers vary f0 and spectral tilt. The token->spectrum mapping is
  deterministic and invertible, so the intelligibility of generated mel is
  measurable as a token error rate (TER), a WER proxy with no external ASR.
- a tiny DiT+CFM trained on it with the port's Trainer and data path
  (`eval/quality_proxy_cli.py`),
- mel-domain metrics (masked MSE, MCD, log-spectral distance) against the
  ground truth and against the teacher's output,
- the lever table: each serving lever scored with the same per-utterance
  noise, so differences isolate the lever.

reference analogue: the paper's WER/SIM ablations and the eval harness
(src/f5_tts/eval/utils_eval.py:400-753); here the "ASR" is the language's
own decoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from f5e_tts_tpu_torch.config import MelConfig

# ---------------------------------------------------------------------------
# the toyspeech language
# ---------------------------------------------------------------------------

SR = 8000
HOP = 64
FRAMES_PER_TOKEN = 12                      # 96 ms per token
SAMPLES_PER_TOKEN = FRAMES_PER_TOKEN * HOP
TOKENS = "abcdefghij"
VOCAB = {" ": 0, **{c: i + 1 for i, c in enumerate(TOKENS)}}

MEL = MelConfig(n_fft=256, hop_length=HOP, win_length=256, n_mel_channels=24,
                target_sample_rate=SR)

# formant table: unique, well-separated, all << Nyquist (4 kHz)
_F1 = 350.0 + 55.0 * np.arange(len(TOKENS))     # 350 .. 845 Hz
_F2 = 1300.0 + 180.0 * np.arange(len(TOKENS))   # 1300 .. 2920 Hz


@dataclass(frozen=True)
class Speaker:
    f0: float    # 100..200 Hz
    tilt: float  # gain on the f2 partial, 0.8..1.2

    @classmethod
    def sample(cls, rng: np.random.Generator) -> "Speaker":
        return cls(f0=float(rng.uniform(100.0, 200.0)),
                   tilt=float(rng.uniform(0.8, 1.2)))


def synth_token(tok: str, speaker: Speaker, rng: Optional[np.random.Generator] = None
                ) -> np.ndarray:
    """One token -> (SAMPLES_PER_TOKEN,) float32 waveform segment."""
    i = TOKENS.index(tok)
    t = np.arange(SAMPLES_PER_TOKEN) / SR
    p1, p2 = (rng.uniform(0, 2 * np.pi, 2) if rng is not None else (0.0, 0.0))
    seg = (0.45 * np.sin(2 * np.pi * _F1[i] * t + p1)
           + 0.35 * speaker.tilt * np.sin(2 * np.pi * _F2[i] * t + p2)
           + 0.20 * np.sin(2 * np.pi * speaker.f0 * t))
    # hann fade over the outer 25% keeps segment boundaries clean
    fade = int(0.25 * SAMPLES_PER_TOKEN)
    env = np.ones(SAMPLES_PER_TOKEN)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / fade)
    env[:fade] = ramp
    env[-fade:] = ramp[::-1]
    return (seg * env).astype(np.float32)


def synth_utterance(text: str, speaker: Speaker,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Token string -> waveform; duration is exactly 12 frames per token."""
    return np.concatenate([synth_token(c, speaker, rng) for c in text])


def make_utterance(rng: np.random.Generator, min_tokens: int = 8,
                   max_tokens: int = 14) -> Tuple[str, Speaker, np.ndarray]:
    n = int(rng.integers(min_tokens, max_tokens + 1))
    text = "".join(TOKENS[i] for i in rng.integers(0, len(TOKENS), n))
    spk = Speaker.sample(rng)
    return text, spk, synth_utterance(text, spk, rng)


def make_dataset(n_utts: int, seed: int = 0) -> List[dict]:
    """Rows in the ArrowSpeechDataset layout {audio: {array, sampling_rate}, text}."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_utts):
        text, spk, wav = make_utterance(rng)
        rows.append({"audio": {"array": wav, "sampling_rate": SR}, "text": text,
                     "duration": len(wav) / SR})
    return rows


def tokenize(texts: Sequence[str]) -> np.ndarray:
    from f5e_tts_tpu_torch.utils.text import list_str_to_idx

    return list_str_to_idx([list(t) for t in texts], VOCAB)


# ---------------------------------------------------------------------------
# the decoder (the language's own "ASR")
# ---------------------------------------------------------------------------

_TEMPLATES: Optional[np.ndarray] = None


def _mel(wav: np.ndarray) -> np.ndarray:
    """(samples,) waveform -> (frames, n_mels) log-mel of `MEL`, on the CPU."""
    import torch

    from f5e_tts_tpu_torch.ops.mel import mel_spectrogram

    return mel_spectrogram(torch.from_numpy(np.asarray(wav, np.float32))[None], MEL)[0].numpy()


def token_templates() -> np.ndarray:
    """(n_tokens, n_mels) mean log-mel signature per token, neutral speaker."""
    global _TEMPLATES
    if _TEMPLATES is None:
        spk = Speaker(f0=150.0, tilt=1.0)
        temps = []
        for c in TOKENS:
            m = _mel(synth_token(c, spk))  # (~12, 24)
            temps.append(m[2:FRAMES_PER_TOKEN - 2].mean(axis=0))
        _TEMPLATES = np.stack(temps)
    return _TEMPLATES


def decode_mel(mel: np.ndarray, n_tokens: int, start_token: int = 0) -> str:
    """(frames, n_mels) log-mel -> token string by per-segment nearest template.

    Cosine similarity on mean-subtracted log-mel signatures is invariant to
    speaker tilt/gain to first order.
    """
    temps = token_templates()
    tz = temps - temps.mean(axis=1, keepdims=True)
    tz = tz / np.linalg.norm(tz, axis=1, keepdims=True)
    out = []
    for k in range(start_token, n_tokens):
        seg = mel[k * FRAMES_PER_TOKEN + 2:(k + 1) * FRAMES_PER_TOKEN - 2]
        v = seg.mean(axis=0)
        v = v - v.mean()
        v = v / max(np.linalg.norm(v), 1e-8)
        out.append(TOKENS[int(np.argmax(tz @ v))])
    return "".join(out)


def token_error_rate(hyp: str, ref: str) -> float:
    """Levenshtein distance / len(ref) (jiwer-style WER over characters)."""
    m, n = len(hyp), len(ref)
    if n == 0:
        return float(m > 0)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (hyp[i - 1] != ref[j - 1]))
        prev = cur
    return prev[n] / n


# ---------------------------------------------------------------------------
# mel-domain metrics
# ---------------------------------------------------------------------------

def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II over the mel axis."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return m


def mel_metrics(gen: np.ndarray, ref: np.ndarray, n_cep: int = 13) -> Dict[str, float]:
    """gen/ref: (frames, n_mels) log-mel over the SAME region.

    - mse: mean squared error in log-mel
    - mcd: mel-cepstral distortion dB (c1..c_n_cep, the standard
      (10/ln10)*sqrt(2*sum dc^2) per frame, frame-averaged)
    - lsd: log-spectral distance, sqrt(mean_bins (a-b)^2) per frame, averaged
    """
    assert gen.shape == ref.shape, (gen.shape, ref.shape)
    diff = gen - ref
    mse = float(np.mean(diff ** 2))
    lsd = float(np.mean(np.sqrt(np.mean(diff ** 2, axis=1))))
    dct = _dct_matrix(gen.shape[1])
    cg = gen @ dct.T
    cr = ref @ dct.T
    dc = (cg - cr)[:, 1:1 + n_cep]
    mcd = float(np.mean((10.0 / np.log(10.0)) * np.sqrt(2.0 * np.sum(dc ** 2, axis=1))))
    return {"mel_mse": mse, "mcd_db": mcd, "lsd": lsd}
