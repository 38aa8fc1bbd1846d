"""Host-side audio utilities (the port's copy of `f5e_tts_tpu/infer/audio.py`):
wav IO with the stdlib `wave`, scipy resampling, RMS normalisation, silence."""

from __future__ import annotations

import wave
from math import gcd
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """PCM wav -> (float32 mono array in [-1, 1], sample rate)."""
    with wave.open(path, "rb") as f:
        sr, n, ch, width = f.getframerate(), f.getnframes(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """float32 [-1, 1] mono -> 16-bit PCM wav."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    if sr_in == sr_out:
        return x
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)))) if x.size else 0.0


def normalize_rms(x: np.ndarray, target_rms: float) -> Tuple[np.ndarray, float]:
    """Scale quiet audio UP to target_rms; return (audio, original rms)
    (reference: utils_infer.py:441-447)."""
    r = rms(x)
    if 0 < r < target_rms:
        x = x * (target_rms / r)
    return x, r


def remove_silence_edges(x: np.ndarray, sr: int, silence_threshold_db: float = -42.0,
                         frame_ms: float = 10.0) -> np.ndarray:
    """Trim leading/trailing frames quieter than the dBFS threshold."""
    frame = max(int(sr * frame_ms / 1000), 1)
    n_frames = len(x) // frame
    if n_frames == 0:
        return x
    frames = x[: n_frames * frame].reshape(n_frames, frame)
    db = 20 * np.log10(np.sqrt(np.mean(frames**2, axis=1)) + 1e-10)
    loud = np.where(db > silence_threshold_db)[0]
    if len(loud) == 0:
        return x
    return x[loud[0] * frame: min((loud[-1] + 1) * frame, len(x))]


def detect_leading_silence(x: np.ndarray, sr: int, silence_threshold_db: float = -42.0,
                           chunk_ms: float = 10.0) -> int:
    """Sample index of the first chunk louder than the threshold (len(x) if none)."""
    chunk = max(int(sr * chunk_ms / 1000), 1)
    pos = 0
    while pos + chunk <= len(x):
        seg = x[pos: pos + chunk]
        if 20 * np.log10(np.sqrt(np.mean(seg**2)) + 1e-10) > silence_threshold_db:
            return pos
        pos += chunk
    return len(x)
