"""Kaldi-compatible log-mel filterbank, 16 kHz, 25 ms frames every 10 ms
(counterpart of `f5e_tts_tpu/ops/kaldi.py`; reference:
src/f5_tts/ppg/wenet/dataset/feats.py:49-83, torchaudio.compliance.kaldi.fbank
with num_mel_bins 80, dither 0, energy_floor 0).

Kaldi's defaults: snip_edges framing, per-frame DC removal, pre-emphasis 0.97,
the povey window, the FFT padded to 512, the power spectrum, mel banks linear
in Kaldi's mel scale (1127 ln(1 + f / 700), 20 Hz to Nyquist, the Nyquist
bin dropped) and the log with a float32-eps floor. `kaldi_fbank` runs on the
waveform's device (torch.fft.rfft); `kaldi_fbank_numpy` is a straight-line
host twin, frame by frame in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1.1920928955078125e-07  # float32 machine eps (Kaldi's log floor)


def povey_window(n: int) -> np.ndarray:
    """Kaldi's povey window: the symmetric hann (N - 1 denominator) ** 0.85."""
    i = np.arange(n, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85).astype(np.float32)


def kaldi_mel_banks(num_bins: int, padded_window_size: int, sample_freq: float,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi's triangular mel banks (num_bins, padded_window_size // 2), the
    triangles linear in mel; the Nyquist bin is left out."""
    if high_freq <= 0.0:
        high_freq = sample_freq / 2.0 + high_freq
    fft_bin_width = sample_freq / padded_window_size

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    mel_low, mel_high = mel(low_freq), mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    left = mel_low + np.arange(num_bins, dtype=np.float64)[:, None] * mel_delta
    center, right = left + mel_delta, left + 2 * mel_delta
    m = mel(fft_bin_width * np.arange(padded_window_size // 2, dtype=np.float64)[None, :])
    up, down = (m - left) / (center - left), (right - m) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _tables(win_size: int, n_fft: int, num_mel_bins: int, sample_rate: int):
    # built outside inference mode: the cache outlives the call, and a later
    # call under autograd cannot save an inference tensor for its backward
    with torch.inference_mode(False):
        return (torch.from_numpy(povey_window(win_size)),
                torch.from_numpy(kaldi_mel_banks(num_mel_bins, n_fft, float(sample_rate))))


def _fbank_impl(wav: torch.Tensor, sample_rate: int, frame_length: int, frame_shift: int,
                num_mel_bins: int, n_fft: int) -> torch.Tensor:
    win_size = int(sample_rate * frame_length / 1000)  # 400
    hop = int(sample_rate * frame_shift / 1000)  # 160
    n_frames = 1 + (wav.shape[-1] - win_size) // hop  # snip_edges
    frames = wav.float().unfold(-1, win_size, hop)[..., :n_frames, :]  # (B, M, win)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    # pre-emphasis 0.97, the first sample its own predecessor
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    window, banks = (t.to(wav.device) for t in _tables(win_size, n_fft, num_mel_bins,
                                                       sample_rate))
    frames = (frames - 0.97 * prev) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = (spec.real.square() + spec.imag.square())[..., : n_fft // 2]
    return torch.log(torch.clamp(power @ banks.T, min=_EPS))


def kaldi_fbank(wav: torch.Tensor, sample_rate: int = 16_000, frame_length: int = 25,
                frame_shift: int = 10, num_mel_bins: int = 80) -> torch.Tensor:
    """(B, T) or (T,) waveform in [-1, 1] -> (B, M, num_mel_bins) log-mel on
    its device, after the int16 scale (1 << 15) of the reference front end
    (feats.py:63)."""
    if wav.dim() == 1:
        wav = wav[None]
    win_size = int(sample_rate * frame_length / 1000)
    n_fft = 1 << (win_size - 1).bit_length()  # the next power of two (512)
    return _fbank_impl(wav.float() * 32768.0, sample_rate, frame_length, frame_shift,
                       num_mel_bins, n_fft)


def kaldi_fbank_numpy(wav: np.ndarray, sample_rate: int = 16_000, frame_length: int = 25,
                      frame_shift: int = 10, num_mel_bins: int = 80) -> np.ndarray:
    """The host twin of `kaldi_fbank` for one (T,) waveform, frame by frame
    in float64 -> (M, num_mel_bins) float32."""
    wav = np.asarray(wav, np.float64) * 32768.0
    win_size = int(sample_rate * frame_length / 1000)
    hop = int(sample_rate * frame_shift / 1000)
    n_fft = 1 << (win_size - 1).bit_length()
    n_frames = 1 + (len(wav) - win_size) // hop
    win = povey_window(win_size).astype(np.float64)
    banks = kaldi_mel_banks(num_mel_bins, n_fft, float(sample_rate)).astype(np.float64)
    out = np.zeros((n_frames, num_mel_bins))
    for m in range(n_frames):
        fr = wav[m * hop: m * hop + win_size].copy()
        fr -= fr.mean()
        fr = np.concatenate([[fr[0] - 0.97 * fr[0]], fr[1:] - 0.97 * fr[:-1]])
        spec = np.fft.rfft(fr * win, n=n_fft)
        out[m] = np.log(np.maximum(banks @ (spec.real ** 2 + spec.imag ** 2)[: n_fft // 2], _EPS))
    return out.astype(np.float32)
