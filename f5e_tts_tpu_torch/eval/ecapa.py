"""ECAPA-TDNN speaker-embedding head of the SIM metric (counterpart of
`f5e_tts_tpu/eval/ecapa.py`).

reference: src/f5_tts/eval/ecapa_tdnn.py:17-331, the UniSpeech speaker-
verification head: Conv1dReluBn -> 3 SE-Res2Blocks (k3, dilations 2/3/4,
scale 8) -> concat -> 1x1 conv -> attentive statistics pooling -> BN ->
linear. It reads WavLM-large hidden states combined by softmax(
feature_weight) and instance-normalised over time; `load_wavlm_ecapa` keeps
transformers' WavLMModel as that front end, on the port's device.

Layout channels-last (B, T, C), as the JAX package (the torch original is
(B, C, T)); BatchNorm in eval mode (running statistics); fp32 throughout.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.utils.convert import to_tensors
from f5e_tts_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ECAPAConfig:
    feat_dim: int = 1024  # wavlm_large hidden size
    channels: int = 512
    emb_dim: int = 256
    scale: int = 8
    se_bottleneck: int = 128
    attention_channels: int = 128
    num_feat_layers: int = 25  # wavlm_large hidden_states count (24 + input)


def _bn_eval(bn: dict, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm1d with the running statistics, channels-last."""
    return (x.float() - bn["mean"]) * torch.rsqrt(bn["var"] + 1e-5) * bn["g"] + bn["b"]


def _conv(p: dict, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    k = p["w"].shape[0]
    return fnn.conv1d(p, x, padding=dilation * (k - 1) // 2, dilation=dilation,
                      compute_dtype=torch.float32)


def _conv_relu_bn(p: dict, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """conv -> relu -> BN (ecapa_tdnn.py:60-67 Conv1dReluBn: BN last)."""
    return _bn_eval(p["bn"], torch.relu(_conv(p["conv"], x, dilation)))


def _res2_conv(p: dict, x: torch.Tensor, cfg: ECAPAConfig, dilation: int) -> torch.Tensor:
    """Res2 hierarchical convs (ecapa_tdnn.py:17-53): `scale` channel groups;
    group i < scale - 1 convolves the sum of its input and the previous
    group's output (conv -> relu -> bn); the last group passes through."""
    parts = torch.split(x, x.shape[-1] // cfg.scale, dim=-1)
    outs, sp = [], None
    for i in range(cfg.scale - 1):
        sp = parts[i] if i == 0 else sp + parts[i]
        sp = _bn_eval(p["bns"][i], torch.relu(_conv(p["convs"][i], sp, dilation)))
        outs.append(sp)
    outs.append(parts[-1])
    return torch.cat(outs, dim=-1)


def _se_connect(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excite over the time mean (ecapa_tdnn.py:73-86)."""
    s = torch.relu(fnn.linear(p["linear1"], x.float().mean(dim=1), torch.float32))
    s = torch.sigmoid(fnn.linear(p["linear2"], s, torch.float32))
    return x * s[:, None, :]


def _se_res2_block(p: dict, x: torch.Tensor, cfg: ECAPAConfig, dilation: int) -> torch.Tensor:
    """ecapa_tdnn.py:99-127: 1x1 -> res2 -> 1x1 -> SE, plus the residual."""
    residual = x
    if "shortcut" in p:
        residual = fnn.conv1d(p["shortcut"], x, padding=0, compute_dtype=torch.float32)
    h = _conv_relu_bn(p["in_conv"], x)
    h = _res2_conv(p["res2"], h, cfg, dilation)
    h = _se_connect(p["se"], _conv_relu_bn(p["out_conv"], h))
    return h + residual


def _attentive_stats_pool(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Attention weights softmax_t(V tanh(W x)); the weighted mean and std,
    concatenated (ecapa_tdnn.py:134-161, global_context_att=False)."""
    xf = x.float()
    alpha = torch.tanh(fnn.linear(p["linear1"], xf, torch.float32))
    alpha = torch.softmax(fnn.linear(p["linear2"], alpha, torch.float32), dim=1)
    mean = (alpha * xf).sum(dim=1)
    var = (alpha * xf * xf).sum(dim=1) - mean * mean
    return torch.cat([mean, torch.sqrt(torch.clamp(var, min=1e-9))], dim=-1)


def combine_hidden_states(feature_weight: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """softmax(feature_weight)-weighted sum over the front end's layers + 1e-6,
    then instance norm over time per channel (ecapa_tdnn.py:283-300;
    InstanceNorm1d's defaults: no affine, eps 1e-5). hidden: (L, B, T, C)."""
    w = torch.softmax(feature_weight.float(), dim=0)
    x = torch.einsum("l,lbtc->btc", w, hidden.float()) + 1e-6
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def ecapa_embed(params: dict, cfg: ECAPAConfig, feats: torch.Tensor) -> torch.Tensor:
    """(B, T, feat_dim) normalised features -> (B, emb_dim) speaker embedding
    (ecapa_tdnn.py:295-310, after get_feat)."""
    out1 = _conv_relu_bn(params["layer1"], feats)
    out2 = _se_res2_block(params["layer2"], out1, cfg, dilation=2)
    out3 = _se_res2_block(params["layer3"], out2, cfg, dilation=3)
    out4 = _se_res2_block(params["layer4"], out3, cfg, dilation=4)
    h = torch.cat([out2, out3, out4], dim=-1)
    h = torch.relu(fnn.conv1d(params["conv"], h, padding=0, compute_dtype=torch.float32))
    h = _bn_eval(params["bn"], _attentive_stats_pool(params["pooling"], h))
    return fnn.linear(params["linear"], h, torch.float32)


def init_ecapa(cfg: ECAPAConfig, generator: torch.Generator, device="cpu") -> dict:
    """fp32 head parameters from `generator` under torch's default rules
    (Conv1d and Linear U(+-1/sqrt(fan_in)), BatchNorm gain 1, bias 0,
    running mean 0, variance 1, feature weights 0), in `ecapa_from_torch`'s
    tree; the JAX package has no init, since its head only ingests."""
    def lin(d_in, d_out):
        return fnn.linear_init(d_in, d_out, generator, device)

    def conv(d_in, d_out, k):
        return fnn.conv1d_init(d_in, d_out, k, 1, generator, device)

    def bn(d):
        return {"g": torch.ones(d, device=device), "b": torch.zeros(d, device=device),
                "mean": torch.zeros(d, device=device), "var": torch.ones(d, device=device)}

    ch, cat, width = cfg.channels, 3 * cfg.channels, cfg.channels // cfg.scale

    def block():
        return {"in_conv": {"conv": conv(ch, ch, 1), "bn": bn(ch)},
                "res2": {"convs": [conv(width, width, 3) for _ in range(cfg.scale - 1)],
                         "bns": [bn(width) for _ in range(cfg.scale - 1)]},
                "out_conv": {"conv": conv(ch, ch, 1), "bn": bn(ch)},
                "se": {"linear1": lin(ch, cfg.se_bottleneck),
                       "linear2": lin(cfg.se_bottleneck, ch)}}

    return {"feature_weight": torch.zeros(cfg.num_feat_layers, device=device),
            "layer1": {"conv": conv(cfg.feat_dim, ch, 5), "bn": bn(ch)},
            "layer2": block(), "layer3": block(), "layer4": block(),
            "conv": conv(cat, cat, 1),
            "pooling": {"linear1": lin(cat, cfg.attention_channels),
                        "linear2": lin(cfg.attention_channels, cat)},
            "bn": bn(2 * cat), "linear": lin(2 * cat, cfg.emb_dim)}


def ecapa_from_torch(sd: Dict[str, object], cfg: ECAPAConfig = ECAPAConfig()) -> dict:
    """The reference head's state dict (numpy arrays or tensors) -> the fp32
    parameter tree on the CPU. Front-end keys (`feature_extract.*`) are
    ignored; torch Conv1d (out, in, k) -> (k, in, out), Linear (out, in) ->
    (in, out), the pooling's 1x1 convs -> linear layout."""
    sd = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
          for k, v in sd.items()}

    def with_bias(k, w):
        p = {"w": np.ascontiguousarray(w)}
        if f"{k}.bias" in sd:
            p["b"] = sd[f"{k}.bias"]
        return p

    def conv(k):
        return with_bias(k, sd[f"{k}.weight"].transpose(2, 1, 0))

    def lin(k):
        return with_bias(k, sd[f"{k}.weight"].T)

    def pool_lin(k):  # a 1x1 conv (out, in, 1) as a linear (in, out)
        return with_bias(k, sd[f"{k}.weight"][:, :, 0].T)

    def bn(k):
        return {"g": sd[f"{k}.weight"], "b": sd[f"{k}.bias"],
                "mean": sd[f"{k}.running_mean"], "var": sd[f"{k}.running_var"]}

    def crb(k):
        return {"conv": conv(f"{k}.conv"), "bn": bn(f"{k}.bn")}

    def block(k):
        p = {"in_conv": crb(f"{k}.Conv1dReluBn1"),
             "res2": {"convs": [conv(f"{k}.Res2Conv1dReluBn.convs.{i}")
                                for i in range(cfg.scale - 1)],
                      "bns": [bn(f"{k}.Res2Conv1dReluBn.bns.{i}") for i in range(cfg.scale - 1)]},
             "out_conv": crb(f"{k}.Conv1dReluBn2"),
             "se": {"linear1": lin(f"{k}.SE_Connect.linear1"),
                    "linear2": lin(f"{k}.SE_Connect.linear2")}}
        if f"{k}.shortcut.weight" in sd:
            p["shortcut"] = conv(f"{k}.shortcut")
        return p

    return to_tensors({
        "feature_weight": sd["feature_weight"],
        "layer1": crb("layer1"), "layer2": block("layer2"), "layer3": block("layer3"),
        "layer4": block("layer4"), "conv": conv("conv"),
        "pooling": {"linear1": pool_lin("pooling.linear1"), "linear2": pool_lin("pooling.linear2")},
        "bn": bn("bn"), "linear": lin("linear")})


def load_wavlm_ecapa(ckpt_path: str, wavlm_path: Optional[str] = None,
                     cfg: ECAPAConfig = ECAPAConfig(), device="cuda"):
    """Speaker embedder path -> (emb_dim,) numpy: transformers' WavLMModel
    front end (a local directory, `wavlm_path`) and this head over the
    ECAPA checkpoint's weights (wavlm_large_finetune.pth), both on `device`
    (the card unless "cpu"; reference: utils_eval.py:714-719)."""
    dev = resolve_device(device)
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"ECAPA checkpoint not found at {ckpt_path} (supply "
                                "wavlm_large_finetune.pth locally; nothing is downloaded)")
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    raw = raw.get("model", raw)
    params = to_tensors(ecapa_from_torch(
        {k: v for k, v in raw.items() if isinstance(v, torch.Tensor)
         and not k.startswith("feature_extract.")}, cfg), dev)

    from transformers import WavLMModel

    frontend = WavLMModel.from_pretrained(wavlm_path or "microsoft/wavlm-large").to(dev).eval()

    @torch.no_grad()
    def embed(path: str) -> np.ndarray:
        from f5e_tts_tpu_torch.infer.audio import read_wav, resample

        wav, sr = read_wav(path)
        wav = resample(wav, sr, 16_000)
        out = frontend(torch.from_numpy(np.asarray(wav, np.float32)[None]).to(dev),
                       output_hidden_states=True)
        hidden = torch.stack(list(out.hidden_states), dim=0)
        feats = combine_hidden_states(params["feature_weight"], hidden)
        return ecapa_embed(params, cfg, feats)[0].cpu().numpy()

    return embed
