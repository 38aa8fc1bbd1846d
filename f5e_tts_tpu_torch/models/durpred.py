"""Auxiliary duration predictor (StableTTS-derived) and its alignment helpers
(counterpart of `f5e_tts_tpu/models/durpred.py`).

reference: src/f5_tts/durpred/durpred.py (MelStyleEncoder, DurationPredictor)
and src/f5_tts/durpred/utils.py (generate_path, duration_loss, Conv1dGLU).
No path of the port uses it; it is kept for capability parity with the JAX
package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.utils.masks import lens_to_mask


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations (B, Tx) -> monotonic alignment path (B, Tx, Ty): row i is
    True on [cum[i-1], cum[i]), times `mask` (B, Tx, Ty)
    (durpred/utils.py:26-37)."""
    b, t_x, t_y = mask.shape
    cum = torch.cumsum(duration, dim=1)
    path = lens_to_mask(cum.reshape(b * t_x), t_y).float().reshape(b, t_x, t_y)
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


def duration_loss(logw: torch.Tensor, logw_hat: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Summed squared log-duration error over the total length
    (durpred/utils.py:64-66)."""
    return torch.sum(torch.square(logw - logw_hat)) / torch.sum(lengths)


@dataclass(frozen=True)
class StyleEncoderConfig:
    n_mel_channels: int = 100
    style_hidden: int = 128
    style_vector_dim: int = 256
    style_kernel_size: int = 5
    style_head: int = 2


def init_style_encoder(cfg: StyleEncoderConfig, generator: torch.Generator,
                       device="cpu") -> dict:
    """fp32 MelStyleEncoder parameters from `generator` (torch's default rules)."""
    h, g, dev = cfg.style_hidden, generator, device
    return {
        "spectral1": fnn.linear_init(cfg.n_mel_channels, h, g, dev),
        "spectral2": fnn.linear_init(h, h, g, dev),
        # Conv1dGLU x2 (utils.py:69-87): conv k5 -> split -> a * sigmoid(b) + res
        "glu1": fnn.conv1d_init(h, 2 * h, cfg.style_kernel_size, 1, g, dev),
        "glu2": fnn.conv1d_init(h, 2 * h, cfg.style_kernel_size, 1, g, dev),
        "attn": {"in_proj": fnn.linear_init(h, 3 * h, g, dev),
                 "out_proj": fnn.linear_init(h, h, g, dev)},
        "fc": fnn.linear_init(h, cfg.style_vector_dim, g, dev),
    }


def _conv1d_glu(p, x, k: int, compute_dtype):
    h = fnn.conv1d(p, x, padding=k // 2, compute_dtype=compute_dtype)
    a, b = h.chunk(2, dim=-1)
    return x + a * torch.sigmoid(b.float()).to(a.dtype)


def style_encoder(params, cfg: StyleEncoderConfig, mel: torch.Tensor,
                  mel_lens: Optional[torch.Tensor] = None,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """(B, N, mel) -> (B, style_dim) utterance style vector: spectral MLP
    (Mish), two temporal Conv1dGLU, multi-head self-attention
    (torch.nn.MultiheadAttention semantics, padded keys masked), fc, and a
    mean over the valid frames (durpred.py:55-71)."""
    b, n, _ = mel.shape
    mask = lens_to_mask(mel_lens.to(mel.device), n) if mel_lens is not None else None
    h = fnn.mish(fnn.linear(params["spectral1"], mel.to(compute_dtype), compute_dtype))
    h = fnn.mish(fnn.linear(params["spectral2"], h, compute_dtype))
    k = cfg.style_kernel_size
    h = _conv1d_glu(params["glu2"], _conv1d_glu(params["glu1"], h, k, compute_dtype), k,
                    compute_dtype)

    q, kk, v = (t.unflatten(-1, (cfg.style_head, -1))
                for t in fnn.linear(params["attn"]["in_proj"], h, compute_dtype).chunk(3, dim=-1))
    scores = torch.einsum("bthd,bshd->bhts", q, kk) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, n, -1)
    h = fnn.linear(params["attn"]["out_proj"], o, compute_dtype)
    h = fnn.linear(params["fc"], h, compute_dtype)
    if mask is not None:
        h = h.masked_fill(~mask[:, :, None], 0.0)
        return h.sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1)[:, None]
    return h.mean(dim=1)


@dataclass(frozen=True)
class DurPredConfig:
    in_channels: int = 512
    filter_channels: int = 256
    kernel_size: int = 3
    style_vector_dim: int = 256


def init_duration_predictor(cfg: DurPredConfig, generator: torch.Generator,
                            device="cpu") -> dict:
    """fp32 DurationPredictor parameters from `generator`."""
    g, dev, f = generator, device, cfg.filter_channels

    def ln():
        return {"g": torch.ones(f, device=dev), "b": torch.zeros(f, device=dev)}

    return {
        "cond": fnn.linear_init(cfg.style_vector_dim, cfg.in_channels, g, dev),
        "conv1": fnn.conv1d_init(cfg.in_channels, f, cfg.kernel_size, 1, g, dev),
        "norm1": ln(),
        "conv2": fnn.conv1d_init(f, f, cfg.kernel_size, 1, g, dev),
        "norm2": ln(),
        "proj": fnn.linear_init(f, 1, g, dev),
    }


def duration_predictor(params, cfg: DurPredConfig, x: torch.Tensor, x_mask: torch.Tensor,
                       style: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """(B, Tx, C) text encodings and a (B, style) vector -> (B, Tx)
    log-durations: conv, ReLU, LayerNorm twice, then a projection, masked
    throughout; the inputs are detached, as upstream (durpred.py:88-102)."""
    x, style = x.detach(), style.detach()
    m = x_mask[:, :, None].to(x.dtype)
    pad = cfg.kernel_size // 2
    h = x + fnn.linear(params["cond"], style, compute_dtype)[:, None, :]
    h = fnn.layernorm(params["norm1"], torch.relu(
        fnn.conv1d(params["conv1"], h * m, padding=pad, compute_dtype=compute_dtype)))
    h = fnn.layernorm(params["norm2"], torch.relu(
        fnn.conv1d(params["conv2"], h * m, padding=pad, compute_dtype=compute_dtype)))
    out = fnn.linear(params["proj"], h * m, compute_dtype)[:, :, 0]
    return out * x_mask.to(out.dtype)
