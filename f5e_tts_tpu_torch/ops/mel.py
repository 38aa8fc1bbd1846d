"""Log-mel frontend and (I)STFT (counterpart of `f5e_tts_tpu/ops/mel.py`).

"vocos" flavour: torchaudio MelSpectrogram semantics (power-1 magnitude,
center=True reflect padding, periodic Hann, HTK mel, no filterbank norm),
then clamp(min=1e-5).log(). "bigvgan" flavour: reflect pad by
(n_fft - hop) // 2, center=False, sqrt(|S|^2 + 1e-9), Slaney mel.
Filterbanks are built host-side in float64 and returned as float32.
(reference: src/f5_tts/model/modules.py:30-101)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.config import MelConfig


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


_F_SP, _MIN_LOG_HZ, _LOGSTEP = 200.0 / 3.0, 1000.0, np.log(6.4) / 27.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, scale: str = "htk",
                   norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank (n_freqs, n_mels): htk/None as torchaudio's
    melscale_fbanks, slaney/slaney as librosa.filters.mel."""
    if fmax is None:
        fmax = sr / 2.0
    all_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1, dtype=np.float64)
    hz_to_mel = _hz_to_mel_htk if scale == "htk" else _hz_to_mel_slaney
    mel_to_hz = _mel_to_hz_htk if scale == "htk" else _mel_to_hz_slaney
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _window(n_fft: int, win_length: int) -> np.ndarray:
    """Hann window zero-padded to n_fft, centred, as torch.stft pads it."""
    win = hann_window(win_length)
    if win_length < n_fft:
        pad_l = (n_fft - win_length) // 2
        win = np.pad(win, (pad_l, n_fft - win_length - pad_l))
    return win


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                   center: bool = True, pad_mode: str = "reflect",
                   magnitude_eps: float = 0.0) -> torch.Tensor:
    """|STFT| of (B, T) -> (B, n_frames, n_fft // 2 + 1); center pads n_fft // 2
    on both sides (n_frames = 1 + T // hop)."""
    win = torch.from_numpy(_window(n_fft, win_length)).to(wav.device)
    if center:
        wav = F.pad(wav[:, None, :], (n_fft // 2, n_fft // 2), mode=pad_mode)[:, 0]
    frames = wav.unfold(-1, n_fft, hop_length)
    spec = torch.fft.rfft(frames.float() * win, n=n_fft, dim=-1)
    mag2 = spec.real.square() + spec.imag.square()
    if magnitude_eps:
        return torch.sqrt(mag2 + magnitude_eps)
    return torch.sqrt(mag2.clamp_min(1e-30))


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, n_frames, frame_len) -> (B, (n_frames - 1) * hop + frame_len), as
    the sum of ceil(frame_len / hop) shifted contiguous streams."""
    b, n_frames, frame_len = frames.shape
    m = -(-frame_len // hop)
    if m * hop != frame_len:
        frames = F.pad(frames, (0, m * hop - frame_len))
    chunks = frames.reshape(b, n_frames, m, hop)
    out = frames.new_zeros((b, (n_frames - 1) * hop + m * hop))
    for j in range(m):
        out[:, j * hop: j * hop + n_frames * hop] += chunks[:, :, j, :].reshape(b, n_frames * hop)
    return out[:, : (n_frames - 1) * hop + frame_len]


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int, center: bool = True) -> torch.Tensor:
    """Inverse STFT with a Hann window, torch.istft semantics: (B, n_frames,
    n_fft // 2 + 1) real/imag -> (B, n_frames * hop - n_fft) when centred,
    normalised by the summed squared window."""
    win_np = _window(n_fft, win_length)
    frames = torch.fft.irfft(torch.complex(spec_real.float(), spec_imag.float()), n=n_fft, dim=-1)
    y = overlap_add(frames * torch.from_numpy(win_np).to(frames.device), hop_length)
    n_frames = spec_real.shape[1]
    env = np.zeros((n_frames - 1) * hop_length + n_fft, np.float64)
    for i in range(n_frames):
        env[i * hop_length: i * hop_length + n_fft] += win_np.astype(np.float64) ** 2
    env = np.where(env > 1e-11, env, 1.0).astype(np.float32)
    y = y / torch.from_numpy(env).to(y.device)
    if center:
        y = y[:, n_fft // 2: -(n_fft // 2)]
    return y


def mel_spectrogram(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, T) or (T,) waveform -> (B, n_frames, n_mels) log-mel, frames first.

    The filterbank product is taken in float64, so it is full precision on
    the card whatever the TF32 settings (the JAX package asks XLA for HIGHEST
    precision at this point).
    """
    if wav.dim() == 1:
        wav = wav[None, :]
    wav = wav.float()
    if cfg.mel_spec_type == "vocos":
        fb = mel_filterbank(cfg.target_sample_rate, cfg.n_fft, cfg.n_mel_channels,
                            scale="htk", norm=None)
        mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.win_length, center=True)
    else:
        fb = mel_filterbank(cfg.target_sample_rate, cfg.n_fft, cfg.n_mel_channels,
                            scale="slaney", norm="slaney")
        pad = (cfg.n_fft - cfg.hop_length) // 2
        wav = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
        mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, cfg.win_length, center=False,
                             magnitude_eps=1e-9)
    mel = (mag.double() @ torch.from_numpy(fb).to(mag.device).double()).float()
    return torch.log(mel.clamp_min(1e-5))


def num_frames(num_samples: int, cfg: MelConfig) -> int:
    """Number of mel frames the frontend produces for a waveform length."""
    if cfg.mel_spec_type == "vocos":
        return 1 + num_samples // cfg.hop_length
    pad = (cfg.n_fft - cfg.hop_length) // 2
    return 1 + (num_samples + 2 * pad - cfg.n_fft) // cfg.hop_length
