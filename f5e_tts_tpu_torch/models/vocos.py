"""Vocos vocoder, mel -> waveform (counterpart of `f5e_tts_tpu/models/vocos.py`).

Architecture of `charactr/vocos-mel-24khz`: Conv1d embed (k7) -> LayerNorm ->
8x ConvNeXt-V1 (dim 512, intermediate 1536, layer scale) -> LayerNorm ->
Linear head to n_fft + 2 -> exp magnitude (clipped at 1e2) and cos/sin
phase -> centred ISTFT. (reference: src/f5_tts/infer/utils_infer.py:101-124)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from f5e_tts_tpu_torch.ops import convnext as fcnx
from f5e_tts_tpu_torch.ops import mel as fmel
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops import prng


@dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    sample_rate: int = 24_000


def init_vocos(cfg: VocosConfig, key: torch.Tensor, device="cpu") -> dict:
    """fp32 parameters from the threefry `key` under torch's default init
    rules and the JAX init's key chain (models/vocos.py:39-54: `key` split
    in num_layers + 2 for the embedding conv, the blocks and the head)."""
    ks = prng.split(key, cfg.num_layers + 2)
    d = cfg.dim

    def ln():
        return {"g": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}

    return {
        "embed": fnn.conv1d_init(cfg.input_channels, d, 7, 1, ks[0], device),
        "norm": ln(),
        "blocks": [fcnx.convnext_v1_init(d, cfg.intermediate_dim, ks[i + 1], device,
                                         layer_scale_init=1.0 / cfg.num_layers)
                   for i in range(cfg.num_layers)],
        "final_norm": ln(),
        "head": fnn.linear_init(d, cfg.n_fft + 2, ks[-1], device),
    }


def istft_head(head_params, h: torch.Tensor, n_fft: int, hop_length: int,
               compute_dtype=torch.float32) -> torch.Tensor:
    """(B, N, dim) features -> (B, wav): Linear to n_fft + 2, split into log
    magnitude and phase, exp magnitude clipped at 1e2, centred ISTFT."""
    h = fnn.linear(head_params, h, compute_dtype)
    half = n_fft // 2 + 1
    mag = torch.exp(h[..., :half].float().clamp(max=1e2))
    phase = h[..., half:].float()
    return fmel.istft(mag * torch.cos(phase), mag * torch.sin(phase), n_fft, hop_length, n_fft,
                      center=True)


def vocos_decode(params, cfg: VocosConfig, mel: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """(B, N, n_mels) log-mel -> (B, (N - 1) * hop) waveform (centred ISTFT)."""
    h = fnn.conv1d(params["embed"], mel.to(compute_dtype), padding=3, compute_dtype=compute_dtype)
    h = fnn.layernorm(params["norm"], h, eps=1e-6)
    for blk in params["blocks"]:
        h = fcnx.convnext_v1(blk, h, compute_dtype=compute_dtype)
    h = fnn.layernorm(params["final_norm"], h, eps=1e-6)
    return istft_head(params["head"], h, cfg.n_fft, cfg.hop_length, compute_dtype)


def vocos_from_torch(sd: Dict[str, object], cfg: VocosConfig) -> dict:
    """Map the vocos pip package's state dict (backbone.embed, backbone.norm,
    backbone.convnext.{i}.*, backbone.final_layer_norm, head.out) to the
    port's fp32 parameter dict. Conv weights (out, in, k) -> (k, in, out)."""
    def t(key):
        return torch.as_tensor(np.asarray(sd[key], dtype=np.float32))

    def lin(k):
        return {"w": t(f"{k}.weight").T.contiguous(), "b": t(f"{k}.bias")}

    def conv(k):
        return {"w": t(f"{k}.weight").permute(2, 1, 0).contiguous(), "b": t(f"{k}.bias")}

    def ln(k):
        return {"g": t(f"{k}.weight"), "b": t(f"{k}.bias")}

    return {
        "embed": conv("backbone.embed"),
        "norm": ln("backbone.norm"),
        "blocks": [
            {"dwconv": conv(f"backbone.convnext.{i}.dwconv"),
             "norm": ln(f"backbone.convnext.{i}.norm"),
             "pwconv1": lin(f"backbone.convnext.{i}.pwconv1"),
             "pwconv2": lin(f"backbone.convnext.{i}.pwconv2"),
             "gamma": t(f"backbone.convnext.{i}.gamma")}
            for i in range(cfg.num_layers)
        ],
        "final_norm": ln("backbone.final_layer_norm"),
        "head": lin("head.out"),
    }
