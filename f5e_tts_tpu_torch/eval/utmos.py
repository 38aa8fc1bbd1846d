"""UTMOS (the UTokyo-SaruLab MOS predictor, utmos22 strong learner) for
inference (counterpart of `f5e_tts_tpu/eval/utmos.py`).

reference: src/f5_tts/eval/eval_utmos.py:18-20 loads `tarepan/SpeechMOS:
v1.2.0 utmos22_strong` through torch.hub. The graph:

  wav at 16 kHz
  -> wav2vec2-base encoder (7 strided convs with a per-channel group norm
     on the first, feature projection, weight-normed positional conv k128
     g16, 12 post-LN transformer layers)
  -> concat(features, the domain embedding, the judge embedding)
  -> one bidirectional LSTM layer
  -> Linear -> ReLU -> Linear frame scores, their time mean x 2 + 3.

Parameter trees are the JAX package's; fp32 throughout. The attention is a
plain softmax(q k^T / sqrt(dh)) v in torch, the BLSTM `torch.lstm` with
torch's gate order (i, f, g, o), which is the JAX scan's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch

from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.utils.convert import to_tensors
from f5e_tts_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class W2V2Config:
    """wav2vec2-base (transformers Wav2Vec2Config defaults)."""

    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 3, 2)
    conv_bias: bool = False
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ff: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    eps: float = 1e-5


@dataclass(frozen=True)
class UTMOSConfig:
    ssl: W2V2Config = field(default_factory=W2V2Config)
    domain_dim: int = 128
    judge_dim: int = 128
    blstm_hidden: int = 512
    proj_hidden: int = 2048
    # inference-time ids (SpeechMOS strong: the main domain, the mean listener)
    domain_id: int = 0
    judge_id: int = 288
    score_scale: float = 2.0
    score_shift: float = 3.0


# ---------------------------------------------------------------------------
# wav2vec2 encoder
# ---------------------------------------------------------------------------


def _group_norm_per_channel(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """GroupNorm with one group a channel: each channel normalised over time
    (population variance). x: (B, N, C)."""
    mu = x.mean(dim=1, keepdim=True)
    var = (x - mu).square().mean(dim=1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def w2v2_feature_extractor(params: dict, cfg: W2V2Config, wav: torch.Tensor) -> torch.Tensor:
    """(B, S) raw 16 kHz samples -> (B, T, conv_dim[-1]) latent frames."""
    x = wav.float()[:, :, None]
    for i, s in enumerate(cfg.conv_stride):
        x = fnn.conv1d(params["conv"][i], x, padding=0, stride=s)
        if i == 0:
            x = _group_norm_per_channel(params["gn"], x, cfg.eps)
        x = fnn.gelu(x)
    return x


def _mha(p: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Unmasked multi-head self-attention of (B, N, D) (utmos.py:91-101)."""
    b, n, d = x.shape
    dh = d // heads
    q, k, v = (fnn.linear(p[name], x).reshape(b, n, heads, dh).transpose(1, 2)
               for name in ("q", "k", "v"))
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    return fnn.linear(p["out"], (attn @ v).transpose(1, 2).reshape(b, n, d))


def w2v2_encode(params: dict, cfg: W2V2Config, wav: torch.Tensor) -> torch.Tensor:
    """The wav2vec2 forward (B, S) -> (B, T, hidden): transformers'
    Wav2Vec2Model(config).eval() of the post-norm base variant, no masking."""
    x = w2v2_feature_extractor(params["fe"], cfg, wav)
    x = fnn.layernorm(params["fp_norm"], x, eps=cfg.eps)
    x = fnn.linear(params["fp"], x)
    # grouped positional conv, k // 2 padding each side; an even kernel
    # gives one frame too many, dropped at the end
    pos = fnn.conv1d(params["pos_conv"], x, groups=cfg.pos_conv_groups,
                     padding=cfg.pos_conv_kernel // 2)
    if cfg.pos_conv_kernel % 2 == 0:
        pos = pos[:, :-1]
    x = fnn.layernorm(params["enc_norm"], x + fnn.gelu(pos), eps=cfg.eps)
    for lp in params["layers"]:
        x = fnn.layernorm(lp["norm1"], x + _mha(lp["attn"], x, cfg.heads), eps=cfg.eps)
        h = fnn.gelu(fnn.linear(lp["ff1"], x))
        x = fnn.layernorm(lp["norm2"], x + fnn.linear(lp["ff2"], h), eps=cfg.eps)
    return x


# ---------------------------------------------------------------------------
# BiLSTM (torch.nn.LSTM semantics, batch_first, bidirectional)
# ---------------------------------------------------------------------------


def blstm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, N, In) -> (B, N, 2H), the forward direction's states then the
    backward one's; gate order i, f, g, o; zero initial states."""
    h = p["w_hh"].shape[1]
    weights = [p[k].float().contiguous() for k in ("w_ih", "w_hh", "b_ih", "b_hh", "w_ih_r",
                                                   "w_hh_r", "b_ih_r", "b_hh_r")]
    h0 = x.new_zeros((2, x.shape[0], h), dtype=torch.float32)
    out, _, _ = torch.lstm(x.float(), (h0, h0), weights, True, 1, 0.0, False, True, True)
    return out


# ---------------------------------------------------------------------------
# UTMOS head and scorer
# ---------------------------------------------------------------------------


def utmos_features(params: dict, cfg: UTMOSConfig, wav: torch.Tensor):
    """(B, S) 16 kHz wav -> (the wav2vec2 encoder's last hidden state (B, T,
    hidden), the BLSTM's output (B, T, 2 x blstm_hidden)), the two stages
    the head reads."""
    feat = w2v2_encode(params["ssl"], cfg.ssl, wav)
    b, n, _ = feat.shape
    dom = params["domain_emb"][cfg.domain_id].float()
    jud = params["judge_emb"][cfg.judge_id].float()
    x = torch.cat([feat, dom.expand(b, n, -1), jud.expand(b, n, -1)], dim=-1)
    return feat, blstm(params["blstm"], x)


def utmos_forward(params: dict, cfg: UTMOSConfig, wav: torch.Tensor) -> torch.Tensor:
    """(B, S) 16 kHz wav -> (B,) MOS scores."""
    _, x = utmos_features(params, cfg, wav)
    frame = fnn.linear(params["proj2"], torch.relu(fnn.linear(params["proj1"], x)))[..., 0]
    return frame.mean(dim=1) * cfg.score_scale + cfg.score_shift


def init_w2v2(cfg: W2V2Config, generator: torch.Generator, device="cpu") -> dict:
    """fp32 wav2vec2 parameters from `generator` under torch's default rules."""
    def ln(d):
        return {"g": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}

    def lin(d_in, d_out):
        return fnn.linear_init(d_in, d_out, generator, device)

    conv, d_in = [], 1
    for d_out, k in zip(cfg.conv_dim, cfg.conv_kernel):
        conv.append(fnn.conv1d_init(d_in, d_out, k, 1, generator, device, bias=cfg.conv_bias))
        d_in = d_out
    layers = [{"attn": {n: lin(cfg.hidden, cfg.hidden) for n in ("q", "k", "v", "out")},
               "norm1": ln(cfg.hidden), "ff1": lin(cfg.hidden, cfg.ff),
               "ff2": lin(cfg.ff, cfg.hidden), "norm2": ln(cfg.hidden)}
              for _ in range(cfg.layers)]
    return {
        "fe": {"conv": conv, "gn": {"scale": torch.ones(cfg.conv_dim[0], device=device),
                                    "bias": torch.zeros(cfg.conv_dim[0], device=device)}},
        "fp_norm": ln(cfg.conv_dim[-1]),
        "fp": lin(cfg.conv_dim[-1], cfg.hidden),
        "pos_conv": fnn.conv1d_init(cfg.hidden, cfg.hidden, cfg.pos_conv_kernel,
                                    cfg.pos_conv_groups, generator, device),
        "enc_norm": ln(cfg.hidden),
        "layers": layers,
    }


def init_utmos(cfg: UTMOSConfig, generator: torch.Generator, num_domains: int = 3,
               num_judges: int = 3000, device="cpu") -> dict:
    """fp32 UTMOS parameters from `generator`: the embeddings N(0, 0.02^2),
    the LSTM U(+-1/sqrt(H)) as torch.nn.LSTM, the projections torch's
    Linear rule."""
    in_dim = cfg.ssl.hidden + cfg.domain_dim + cfg.judge_dim
    h = cfg.blstm_hidden

    def u(shape):
        return (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) / math.sqrt(h)

    lstm = {}
    for sfx in ("", "_r"):
        lstm.update({f"w_ih{sfx}": u((4 * h, in_dim)), f"w_hh{sfx}": u((4 * h, h)),
                     f"b_ih{sfx}": u((4 * h,)), f"b_hh{sfx}": u((4 * h,))})
    return {
        "ssl": init_w2v2(cfg.ssl, generator, device),
        "domain_emb": 0.02 * torch.randn((num_domains, cfg.domain_dim), generator=generator,
                                         device=device),
        "judge_emb": 0.02 * torch.randn((num_judges, cfg.judge_dim), generator=generator,
                                        device=device),
        "blstm": lstm,
        "proj1": fnn.linear_init(2 * h, cfg.proj_hidden, generator, device),
        "proj2": fnn.linear_init(cfg.proj_hidden, 1, generator, device),
    }


def _np(a) -> np.ndarray:
    return np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach") else a, np.float32)


def w2v2_from_hf(sd: Dict[str, object], cfg: W2V2Config) -> dict:
    """A transformers Wav2Vec2Model state dict (the base, post-norm variant)
    -> the fp32 parameter tree on the CPU. The positional conv's weight norm
    is folded from either layout (weight_g/weight_v or
    parametrizations.weight.original0/1), its norm over all but the kernel
    axis; torch's groups slice the output channels as `ops.nn.conv1d`'s do,
    so a plain transpose lines them up."""
    sd = {k: _np(v) for k, v in sd.items()}

    def lin(prefix):
        p = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
        if f"{prefix}.bias" in sd:
            p["b"] = sd[f"{prefix}.bias"]
        return p

    def ln(prefix):
        return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}

    conv = []
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}.conv"
        p = {"w": np.ascontiguousarray(sd[f"{pre}.weight"].transpose(2, 1, 0))}
        if f"{pre}.bias" in sd:
            p["b"] = sd[f"{pre}.bias"]
        conv.append(p)
    gn = {"scale": sd["feature_extractor.conv_layers.0.layer_norm.weight"],
          "bias": sd["feature_extractor.conv_layers.0.layer_norm.bias"]}
    pre = "encoder.pos_conv_embed.conv"
    if f"{pre}.weight_g" in sd:
        g, v = sd[f"{pre}.weight_g"], sd[f"{pre}.weight_v"]
    else:
        g = sd[f"{pre}.parametrizations.weight.original0"]
        v = sd[f"{pre}.parametrizations.weight.original1"]
    w = g * v / np.maximum(np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True)), 1e-12)
    layers = []
    for i in range(cfg.layers):
        pre_l = f"encoder.layers.{i}"
        layers.append({
            "attn": {n: lin(f"{pre_l}.attention.{n}_proj") for n in ("q", "k", "v", "out")},
            "norm1": ln(f"{pre_l}.layer_norm"),
            "ff1": lin(f"{pre_l}.feed_forward.intermediate_dense"),
            "ff2": lin(f"{pre_l}.feed_forward.output_dense"),
            "norm2": ln(f"{pre_l}.final_layer_norm"),
        })
    return to_tensors({
        "fe": {"conv": conv, "gn": gn},
        "fp_norm": ln("feature_projection.layer_norm"),
        "fp": lin("feature_projection.projection"),
        "pos_conv": {"w": np.ascontiguousarray(w.transpose(2, 1, 0)), "b": sd[f"{pre}.bias"]},
        "enc_norm": ln("encoder.layer_norm"),
        "layers": layers,
    })


def utmos_from_torch(sd: Dict[str, object], cfg: UTMOSConfig, ssl_prefix: str = "wav2vec2.",
                     strict: bool = True) -> dict:
    """A SpeechMOS-style utmos22 strong checkpoint -> the parameter tree: the
    SSL subtree under `ssl_prefix` in transformers' naming, the domain and
    judge embeddings, the BLSTM (weight_ih_l0[_reverse], ...) and the two
    projection linears. A naming mismatch raises KeyError when `strict`."""
    sd = {k: _np(v) for k, v in sd.items()}
    ssl_sd = {k[len(ssl_prefix):]: v for k, v in sd.items() if k.startswith(ssl_prefix)}

    def find(*cands):
        for c in cands:
            if c in sd:
                return sd[c]
        if strict:
            raise KeyError(f"none of {cands} in checkpoint")
        return None

    lstm = {}
    for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                         ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        lstm[ours] = find(f"blstm.{theirs}", f"lstm.{theirs}")
        lstm[f"{ours}_r"] = find(f"blstm.{theirs}_reverse", f"lstm.{theirs}_reverse")
    tree = {
        "domain_emb": find("domain_emb.weight", "domain_embedding.weight"),
        "judge_emb": find("judge_emb.weight", "judge_embedding.weight"),
        "blstm": lstm,
        "proj1": {"w": find("projection.0.weight", "proj1.weight").T,
                  "b": find("projection.0.bias", "proj1.bias")},
        "proj2": {"w": find("projection.2.weight", "projection.3.weight", "proj2.weight").T,
                  "b": find("projection.2.bias", "projection.3.bias", "proj2.bias")},
    }
    return {"ssl": w2v2_from_hf(ssl_sd, cfg.ssl), **to_tensors(tree)}


def make_native_utmos_scorer(params: dict, cfg: UTMOSConfig, device="cuda"):
    """score(path) -> float: the eval_utmos.py per-file loop on `device` (the
    card unless "cpu"): read, resample to 16 kHz, one forward at the file's
    exact length (the frame mean depends on it, so nothing is padded). The
    params are moved to the device once."""
    dev = resolve_device(device)
    params = to_tensors(params, dev, torch.float32)

    @torch.no_grad()
    def score(path: str) -> float:
        from f5e_tts_tpu_torch.infer.audio import read_wav, resample

        wav, sr = read_wav(path)
        wav = resample(np.asarray(wav, np.float32), sr, 16_000)
        return float(utmos_forward(params, cfg, torch.from_numpy(
            np.asarray(wav, np.float32)[None]).to(dev))[0])

    return score
