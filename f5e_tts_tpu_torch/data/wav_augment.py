"""Waveform augmentation for ASR (PPG) training: the port's own copy of
`f5e_tts_tpu/data/wav_augment.py` (numpy only).

reference: src/f5_tts/ppg/wenet/dataset/wav_distortion.py:16-290 (db-domain
sample-level distortions) and wav_augment.py:15-130 (MUSAN additive noise +
RIR reverberation). The reference applies distortions in a per-sample Python
loop; here the identical math is numpy-vectorized with a Bernoulli
sample-selection mask, and the noise/RIR sources are injected as callables so
the pipeline stays testable without the MUSAN/RIR corpora.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_MAX_AMP = 0.997
_POLY_CAP = 0.9997


def db2amp(db):
    return np.power(10.0, db / 20.0)


def amp2db(amp):
    return 20.0 * np.log10(np.maximum(amp, 1e-30))


# ---------------------------------------------------------------------------
# distortion functions: each takes and returns a float ndarray of amplitudes
# (vectorized equivalents of the reference's scalar closures)
# ---------------------------------------------------------------------------


def make_poly_distortion(conf: Dict) -> Callable:
    """f(db_norm) = a * x^m * (1-x)^n + x in normalized db space
    (wav_distortion.py:16-52)."""
    a, m, n = conf["a"], conf["m"], conf["n"]

    def poly(x: np.ndarray) -> np.ndarray:
        ax = np.abs(x)
        tiny = ax < 1e-6
        db_norm = np.clip(amp2db(ax) / 100.0 + 1.0, 0.0, None)
        db_norm = a * np.power(db_norm, m) * np.power(1.0 - db_norm, n) + db_norm
        db_norm = np.minimum(db_norm, 1.0)
        amp = np.minimum(db2amp((db_norm - 1.0) * 100.0), _POLY_CAP)
        out = np.sign(x) * amp
        return np.where(tiny, x, out).astype(x.dtype)

    return poly


def make_quad_distortion() -> Callable:
    return make_poly_distortion({"a": 1, "m": 1, "n": 1})


def make_max_distortion(conf: Dict) -> Callable:
    """Every nonzero sample snaps to +-max_amp (wav_distortion.py:58-82)."""
    max_amp = db2amp(conf["max_db"]) if conf.get("max_db") else _MAX_AMP

    def mx(x: np.ndarray) -> np.ndarray:
        return (np.sign(x) * max_amp).astype(x.dtype)

    return mx


def make_amp_mask(db_mask: Optional[List[Tuple[float, float]]] = None):
    if db_mask is None:
        db_mask = [(-110, -95), (-90, -80), (-65, -60), (-50, -30), (-15, 0)]
    return [(float(db2amp(lo)), float(db2amp(hi))) for lo, hi in db_mask]


_DEFAULT_MASK = make_amp_mask()


def generate_amp_mask(mask_num: int, rng: Optional[np.random.Generator] = None):
    """Random [-100db, 0db] mask slots (wav_distortion.py:104-126)."""
    rng = rng or np.random.default_rng()
    a = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.0, 2 * mask_num - 1))])
    max_val = a[-1]
    db = [(((a[2 * i] - max_val) / max_val) * 100.0,
           ((a[2 * i + 1] - max_val) / max_val) * 100.0) for i in range(mask_num)]
    return make_amp_mask(db)


def _in_mask(ax: np.ndarray, mask: Sequence[Tuple[float, float]]) -> np.ndarray:
    hit = np.zeros(ax.shape, bool)
    for lo, hi in mask:
        hit |= (ax >= lo) & (ax <= hi)
    return hit


def _masked_distortion(conf: Dict, keep_value: bool,
                       rng: Optional[np.random.Generator] = None) -> Callable:
    mask_number = conf["mask_number"]
    if mask_number <= 0:
        pos_mask, neg_mask = _DEFAULT_MASK, make_amp_mask([(-50, 0)])
    else:
        pos_mask = generate_amp_mask(mask_number, rng)
        neg_mask = generate_amp_mask(mask_number, rng)
    max_amp = db2amp(conf["max_db"]) if not keep_value else None

    def fn(x: np.ndarray) -> np.ndarray:
        ax = np.abs(x)
        hit = np.where(x > 0, _in_mask(ax, pos_mask), _in_mask(ax, neg_mask))
        inside = x if keep_value else np.full_like(x, max_amp)
        out = np.where(hit, inside, 0.0)
        return np.where(x == 0, x, out).astype(x.dtype)

    return fn


def make_fence_distortion(conf: Dict, rng=None) -> Callable:
    """Samples inside mask slots -> max amp, outside -> 0
    (wav_distortion.py:128-173)."""
    return _masked_distortion(conf, keep_value=False, rng=rng)


def make_jag_distortion(conf: Dict, rng=None) -> Callable:
    """Samples inside mask slots kept, outside -> 0 (wav_distortion.py:176-220)."""
    return _masked_distortion(conf, keep_value=True, rng=rng)


def make_gain_db(conf: Dict) -> Callable:
    """Amplitude gain by db, capped at 0.997 (wav_distortion.py:222-239)."""
    g = float(np.power(10.0, conf["db"] / 20.0))

    def gain(x: np.ndarray) -> np.ndarray:
        return np.minimum(_MAX_AMP, x * g).astype(x.dtype)

    return gain


def distort(x: np.ndarray, func: Callable, rate: float = 0.8,
            rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Apply `func` to a Bernoulli(rate) subset of samples
    (wav_distortion.py:241-256, vectorized)."""
    rng = rng or np.random.default_rng()
    sel = rng.uniform(size=x.shape) < rate
    return np.where(sel, func(x), x).astype(x.dtype)


def distort_chain(x: np.ndarray, funcs: Sequence[Callable], rate: float = 0.8,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    sel = rng.uniform(size=x.shape) < rate
    y = x
    for f in funcs:
        y = f(y)
    return np.where(sel, y, x).astype(x.dtype)


def distort_wav_conf(x: np.ndarray, distort_type: str, conf: Optional[Dict],
                     rate: float = 0.1, rng=None) -> np.ndarray:
    """Dispatch by name (wav_distortion.py:267-290). gain_db uses the
    reference's fixed 0.8 rate."""
    if distort_type == "gain_db":
        return distort(x, make_gain_db(conf), rng=rng)
    if distort_type == "max_distortion":
        return distort(x, make_max_distortion(conf), rate=rate, rng=rng)
    if distort_type == "fence_distortion":
        return distort(x, make_fence_distortion(conf, rng), rate=rate, rng=rng)
    if distort_type == "jag_distortion":
        return distort(x, make_jag_distortion(conf, rng), rate=rate, rng=rng)
    if distort_type == "poly_distortion":
        return distort(x, make_poly_distortion(conf), rate=rate, rng=rng)
    if distort_type == "quad_distortion":
        return distort(x, make_quad_distortion(), rate=rate, rng=rng)
    if distort_type == "none_distortion":
        return x
    raise ValueError(f"unsupported distortion type {distort_type!r}")


# ---------------------------------------------------------------------------
# additive noise + reverberation (wav_augment.py:15-130)
# ---------------------------------------------------------------------------


class AugmentWav:
    """MUSAN-style additive noise + RIR reverberation.

    noise_source(category) -> list of candidate 1-D float arrays;
    rir_source() -> one 1-D impulse response. Injecting callables replaces the
    reference's wav/h5 corpus readers (offline-testable; wire a loader over
    the real MUSAN/RIR trees in production).
    """

    NOISE_SNR = {"noise": (0, 10), "speech": (10, 15), "music": (5, 10)}
    NUM_NOISE = {"noise": (1, 1), "speech": (3, 7), "music": (1, 1)}

    def __init__(self, noise_source: Callable[[str, int], List[np.ndarray]],
                 rir_source: Callable[[], np.ndarray],
                 rng: Optional[np.random.Generator] = None):
        self.noise_source = noise_source
        self.rir_source = rir_source
        self.rng = rng or np.random.default_rng()

    def additive_noise(self, category: str, audio: np.ndarray) -> np.ndarray:
        """Mix N noises at per-noise random SNR against the clean level
        (wav_augment.py:57-103)."""
        clean_db = 10.0 * np.log10(np.mean(audio**2) + 1e-4)
        lo, hi = self.NUM_NOISE[category]
        n = int(self.rng.integers(lo, hi + 1))
        out = audio.astype(np.float32).copy()
        for noise in self.noise_source(category, n):
            noise = np.asarray(noise, np.float32)
            t = audio.shape[-1]
            if noise.shape[-1] <= t:
                noise = np.pad(noise, (0, t - noise.shape[-1] + 1), "wrap")[:t]
            else:
                start = int(self.rng.random() * (noise.shape[-1] - t))
                noise = noise[start : start + t]
            snr = self.rng.uniform(*self.NOISE_SNR[category])
            noise_db = 10.0 * np.log10(np.mean(noise**2) + 1e-4)
            out = out + np.sqrt(10.0 ** ((clean_db - noise_db - snr) / 10.0)) * noise
        return out

    def reverberate(self, audio: np.ndarray) -> np.ndarray:
        """Full convolution with an energy-normalized RIR, trimmed to the
        input length (wav_augment.py:106-130)."""
        rir = np.asarray(self.rir_source(), np.float32)
        t = audio.shape[-1]
        if rir.shape[-1] > t:
            start = int(self.rng.random() * (rir.shape[-1] - t))
            rir = rir[start : start + t]
        rir = rir / np.sqrt(np.sum(rir**2) + 1e-30)
        if np.isnan(rir).any():
            return audio
        n = t + rir.shape[-1] - 1
        nfft = 1 << (n - 1).bit_length()
        out = np.fft.irfft(np.fft.rfft(audio, nfft) * np.fft.rfft(rir, nfft), nfft)
        return out[:t].astype(np.float32)
