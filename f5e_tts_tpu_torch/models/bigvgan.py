"""BigVGAN v2 generator, mel -> waveform (counterpart of
`f5e_tts_tpu/models/bigvgan.py`).

The published `nvidia/bigvgan_v2_24khz_100band_256x` architecture (the
reference loads it as a submodule, src/f5_tts/infer/utils_infer.py:125-139):

- conv_pre k7, then six transposed-conv upsample stages (rates 4, 4, 2, 2,
  2, 2, kernel 2 x rate, channels halving from 1536), each followed by
  three AMP blocks (kernels 3, 7, 11 at dilations 1, 3, 5) whose outputs
  are averaged;
- snake-beta activations (per-channel log-scale alpha and beta) inside
  anti-aliased 2x up / activation / 2x down resampling (a 12-tap
  kaiser-windowed sinc);
- a last anti-aliased activation, conv_post k7 without bias, clamped to
  [-1, 1] (v2 has no tanh).

As in the JAX package, which is the reference here, the resampler pads with
zeros; the published `alias_free_activation` pads with `replicate`, so
against a released checkpoint the two would differ at the edges.

The parameter tree is the JAX package's (convs (k, in, out), transposed
convs pre-flipped (k, in, out)); the decode runs channels-first inside, on
torch's convolutions (cuDNN on the card). BigVGAN is a module with a loader,
not wired into `F5TTS`, which decodes with Vocos.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.ops import nn as fnn


@dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 100
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    sample_rate: int = 24_000


# ---------------------------------------------------------------------------
# snake-beta + anti-aliased resampling
# ---------------------------------------------------------------------------


def snake_beta(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """x + 1/(beta + 1e-9) * sin^2(alpha x) over the last (channel) axis,
    alpha and beta per channel in log scale; fp32 inside, x's dtype out."""
    xf = x.float()
    alpha, beta = log_alpha.float().exp(), log_beta.float().exp()
    return (xf + (1.0 / (beta + 1e-9)) * torch.sin(alpha * xf).square()).to(x.dtype)


def kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass (BigVGAN alias_free_activation's filter),
    float32 taps summing to 1 (a copy of the JAX package's numpy function)."""
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    t = np.arange(-half, half) + 0.5 if even else np.arange(kernel_size) - half
    window = np.i0(beta * np.sqrt(np.maximum(1 - (t / half) ** 2, 0.0))) / np.i0(beta)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * t)
    return (f / np.sum(f)).astype(np.float32)


def _filter_taps(device) -> torch.Tensor:
    """The 12-tap up/down filter (cutoff 0.25, half width 0.3), fp32."""
    return torch.from_numpy(kaiser_sinc_filter(0.5 / 2, 0.6 / 2, 12)).to(device)


def _fir_cf(x: torch.Tensor, taps: torch.Tensor, stride: int = 1, up: int = 1) -> torch.Tensor:
    """One FIR filter over every channel of (B, C, L): zero-stuff by `up`,
    pad (k - 2) // 2 zeros before and one more after, correlate, keep every
    `stride`-th sample; fp32 accumulation, x's dtype out (JAX
    `_depthwise_filter` with the pads of `aa_activation`)."""
    b, c, n = x.shape
    if up > 1:
        z = x.new_zeros((b, c, n * up))
        z[:, :, ::up] = x
        x = z
    k = taps.shape[0]
    pad = (k - 2) // 2
    xf = F.pad(x.float(), (pad, pad + 1)).reshape(b * c, 1, -1)
    y = F.conv1d(xf, taps.view(1, 1, k), stride=stride)
    return y.reshape(b, c, -1).to(x.dtype)


def _aa_act_cf(x: torch.Tensor, act: dict, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """2x upsample (the `up` filter x 2) -> snake-beta -> lowpass (`down`), 2x
    down, on (B, C, L)."""
    h = _fir_cf(x, up * 2.0, up=2)
    h = snake_beta(h, act["log_alpha"][:, None], act["log_beta"][:, None])
    return _fir_cf(h, down, stride=2)


def aa_activation(x: torch.Tensor, log_alpha, log_beta, up_filter: np.ndarray,
                  down_filter: np.ndarray) -> torch.Tensor:
    """Anti-aliased activation over (B, N, C): 2x upsample -> snake-beta ->
    2x downsample (BigVGAN's Activation1d with up_ratio = down_ratio = 2)."""
    up, down = (torch.from_numpy(np.asarray(f, np.float32)).to(x.device)
                for f in (up_filter, down_filter))
    act = {"log_alpha": log_alpha, "log_beta": log_beta}
    return _aa_act_cf(x.transpose(1, 2), act, up, down).transpose(1, 2)


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


def init_bigvgan(cfg: BigVGANConfig, generator: torch.Generator, device="cpu") -> dict:
    """fp32 parameters from `generator` under torch's default init rules;
    the snake parameters at log 0 (alpha = beta = 1), as the JAX init."""
    def conv(d_in, d_out, k, bias=True):
        return fnn.conv1d_init(d_in, d_out, k, 1, generator, device, bias=bias)

    def act(ch):
        return {"log_alpha": torch.zeros(ch, device=device),
                "log_beta": torch.zeros(ch, device=device)}

    ch = cfg.upsample_initial_channel
    params = {"conv_pre": conv(cfg.num_mels, ch, 7), "ups": [], "resblocks": []}
    for k in cfg.upsample_kernel_sizes:
        params["ups"].append(fnn.conv_transpose1d_init(ch, ch // 2, k, generator, device))
        ch //= 2
        stage = []
        for kr, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            stage.append({"convs1": [conv(ch, ch, kr) for _ in dils],
                          "convs2": [conv(ch, ch, kr) for _ in dils],
                          "acts1": [act(ch) for _ in dils], "acts2": [act(ch) for _ in dils]})
        params["resblocks"].append(stage)
    params["act_post"] = act(ch)
    params["conv_post"] = conv(ch, 1, 7, bias=False)
    return params


def _conv_cf(p: dict, x: torch.Tensor, padding: int, dilation: int = 1) -> torch.Tensor:
    """`ops.nn.conv1d` on (B, C, L): the transposes are views, so the
    channels-first activations reach torch's conv as they are."""
    return fnn.conv1d(p, x.transpose(1, 2), padding=padding, dilation=dilation).transpose(1, 2)


def _amp_block(block: dict, x: torch.Tensor, kernel: int, dilations, taps) -> torch.Tensor:
    """AMPBlock1: for each dilation, aa-act -> dilated conv -> aa-act -> conv,
    added to the residual."""
    for j, d in enumerate(dilations):
        h = _aa_act_cf(x, block["acts1"][j], taps, taps)
        h = _conv_cf(block["convs1"][j], h, (kernel - 1) // 2 * d, d)
        h = _aa_act_cf(h, block["acts2"][j], taps, taps)
        x = x + _conv_cf(block["convs2"][j], h, (kernel - 1) // 2)
    return x


def bigvgan_decode(params: dict, cfg: BigVGANConfig, mel: torch.Tensor,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """(B, N, num_mels) log-mel -> (B, N * prod(rates)) fp32 waveform in [-1,
    1], convolutions in `compute_dtype` (f5e_tts_tpu bigvgan.py:162-183)."""
    taps = _filter_taps(mel.device)
    h = _conv_cf(params["conv_pre"], mel.to(compute_dtype).transpose(1, 2), 3)
    for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        h = fnn.conv_transpose1d(params["ups"][i], h.transpose(1, 2), r,
                                 (k - r) // 2).transpose(1, 2)
        acc = None
        for bi, (kr, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                            cfg.resblock_dilation_sizes)):
            out = _amp_block(params["resblocks"][i][bi], h, kr, dils, taps)
            acc = out if acc is None else acc + out
        h = acc / len(cfg.resblock_kernel_sizes)
    h = _aa_act_cf(h, params["act_post"], taps, taps)
    h = _conv_cf(params["conv_post"], h, 3)
    return torch.clamp(h[:, 0].float(), -1.0, 1.0)


def bigvgan_from_torch(sd: Dict[str, object], cfg: BigVGANConfig) -> dict:
    """The published generator's state dict (numpy arrays or tensors) -> the
    fp32 parameter tree on the CPU (f5e_tts_tpu bigvgan.py:186-248).

    Keys: conv_pre, ups.{i}.0 (ConvTranspose1d, flipped to (k, in, out)),
    resblocks.{stage * n_blocks + b}.convs1/convs2.{j}, their
    activations.{2j, 2j+1}.act.alpha/beta (log scale), activation_post,
    conv_post. A weight-normed conv (weight_g, weight_v) folds to g v /
    ||v||, the norm over all but the first axis."""
    sd = {k: torch.as_tensor(np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                                        np.float32)) for k, v in sd.items()}

    def get_w(key):
        if f"{key}.weight" in sd:
            return sd[f"{key}.weight"]
        g, v = sd[f"{key}.weight_g"], sd[f"{key}.weight_v"]
        norm = v.square().sum(dim=(1, 2), keepdim=True).sqrt()
        return g * v / torch.clamp(norm, min=1e-12)

    def with_bias(key, w):
        p = {"w": w.contiguous()}
        if f"{key}.bias" in sd:
            p["b"] = sd[f"{key}.bias"]
        return p

    def conv(key):  # torch Conv1d (out, in, k) -> (k, in, out)
        return with_bias(key, get_w(key).permute(2, 1, 0))

    def conv_t(key):  # torch ConvTranspose1d (in, out, k) -> flipped (k, in, out)
        return with_bias(key, get_w(key).flip(2).permute(2, 0, 1))

    def act(key):
        return {"log_alpha": sd[f"{key}.act.alpha"], "log_beta": sd[f"{key}.act.beta"]}

    n_blocks = len(cfg.resblock_kernel_sizes)
    params = {"conv_pre": conv("conv_pre"),
              "ups": [conv_t(f"ups.{i}.0") for i in range(len(cfg.upsample_rates))],
              "resblocks": [], "act_post": act("activation_post"),
              "conv_post": conv("conv_post")}
    for i in range(len(cfg.upsample_rates)):
        stage = []
        for b, dils in enumerate(cfg.resblock_dilation_sizes):
            rb = f"resblocks.{i * n_blocks + b}"
            stage.append({
                "convs1": [conv(f"{rb}.convs1.{j}") for j in range(len(dils))],
                "convs2": [conv(f"{rb}.convs2.{j}") for j in range(len(dils))],
                # activations interleave: 2j before convs1[j], 2j + 1 before convs2[j]
                "acts1": [act(f"{rb}.activations.{2 * j}") for j in range(len(dils))],
                "acts2": [act(f"{rb}.activations.{2 * j + 1}") for j in range(len(dils))]})
        params["resblocks"].append(stage)
    return params
