"""PCM16 wire conversions of the socket server and clients: numpy copies of
the Python fallbacks of `f5e_tts_tpu/native.py: pcm16_bytes_to_f32,
f32_to_pcm16_bytes` (:143-161). The JAX package's C++ host library is not
ported."""

from __future__ import annotations

import numpy as np


def pcm16_bytes_to_f32(data: bytes) -> np.ndarray:
    """Little-endian int16 PCM bytes -> float32 samples in [-1, 1)."""
    return np.frombuffer(data, np.int16).astype(np.float32) / 32768.0


def f32_to_pcm16_bytes(x: np.ndarray) -> bytes:
    """float32 samples, clipped to [-1, 1] and scaled by 32767 (truncated
    toward zero) -> little-endian int16 PCM bytes."""
    return (np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes()
