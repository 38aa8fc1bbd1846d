"""WeNet-style Conformer encoder and the PPG extractor over it (counterpart
of `f5e_tts_tpu/models/conformer.py`): the full-utterance encoder with
optional chunk masks, the streaming chunk-by-chunk decode, and the loaders.

reference: src/f5_tts/ppg/ — asr_model.py:222-244 (extract),
wenet/transformer/encoder.py:141-208 (ConformerEncoder), encoder_layer.py:130-268,
attention.py:134-222 (RelPositionMultiHeadedAttention, no rel_shift),
convolution.py (GLU + depthwise conv + BatchNorm + swish),
subsampling.py:68-120 (Conv2dSubsampling2), embedding.py:86-111
(RelPositionalEncoding), cmvn.py (GlobalCMVN), ppg_model.py:58-169
(PPGModelWapper).

Eval mode only: no dropout, the BatchNorm's running statistics. The
extraction is kaldi fbank -> CMVN -> conv subsampling -> the conformer layers
-> the content linear -> optionally the phone-centre map. The relative-position
attention is plain PyTorch (the JAX package leaves it to XLA; no Pallas
kernel). Parameters are nested dicts of tensors with the JAX tree's names and
layouts (linear (in, out), depthwise conv (k, 1, out), subsampling conv HWIO
(k, k, in, out)).
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops.kaldi import kaldi_fbank
from f5e_tts_tpu_torch.utils.convert import to_tensors
from f5e_tts_tpu_torch.utils.device import resolve_device
from f5e_tts_tpu_torch.utils.masks import lens_to_mask


@dataclass(frozen=True)
class ConformerConfig:
    input_dim: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 12
    cnn_module_kernel: int = 15
    # wenet input_layer in this fork's naming: "linear" (1/1), "conv2d" (1/2,
    # Conv2dSubsampling2; "conv2d2" is an alias), "conv2d4", "conv2d6", "conv2d8"
    subsampling: str = "conv2d"
    max_pos: int = 5000


# (kernel, stride) of each conv stage, the attribute of the output linear
# (Conv2dSubsampling{2,4} .out, {6,8} .linear), the rate and right context
# (subsampling.py:16-254, encoder.py:328-332)
_SUBSAMPLING = {
    "linear": dict(convs=[], out_attr="out", rate=1, right_context=0),
    "conv2d": dict(convs=[(3, 2)], out_attr="out", rate=2, right_context=2),
    "conv2d2": dict(convs=[(3, 2)], out_attr="out", rate=2, right_context=2),
    "conv2d4": dict(convs=[(3, 2), (3, 2)], out_attr="out", rate=4, right_context=6),
    "conv2d6": dict(convs=[(3, 2), (5, 3)], out_attr="linear", rate=6, right_context=10),
    "conv2d8": dict(convs=[(3, 2), (3, 2), (3, 2)], out_attr="linear", rate=8,
                    right_context=14),
}


def subsampling_spec(name: str) -> dict:
    if name not in _SUBSAMPLING:
        raise ValueError(f"unsupported subsampling/input_layer {name!r}; supported: "
                         f"{sorted(_SUBSAMPLING)} (reference subsampling.py:23-280)")
    return _SUBSAMPLING[name]


def subsampled_feat_dim(name: str, idim: int) -> int:
    """The frequency axis after the conv stack (the flatten linear's fan-in
    is output_size times this)."""
    f = idim
    for k, s in subsampling_spec(name)["convs"]:
        f = (f - (k - 1) - 1) // s + 1
    return f


def subsampled_time(name: str, t: int) -> int:
    """The time axis after the conv stack (the mask slice x_mask[:, :, :-(k-1):s]
    of each stage)."""
    for k, s in subsampling_spec(name)["convs"]:
        t = (t - (k - 1) + s - 1) // s
    return t


def _sinus_table(d_model: int, max_len: int) -> np.ndarray:
    """The interleaved absolute table (embedding.py:36-44): pe[:, 0::2] =
    sin, pe[:, 1::2] = cos; float64 math, float32 out."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pos_table(d_model: int, max_len: int, device: torch.device) -> torch.Tensor:
    """`_sinus_table` on `device`, built once per (d, max_len, device): a
    CUDA-graph capture of the encoder (utils/aot.py: capture_ppg_buckets)
    cannot contain a copy from the host, so the encoder slices this cached
    device tensor instead of copying the table in on every call. Built
    outside inference mode: the cache outlives the call, and a later
    training step cannot save an inference tensor for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_sinus_table(d_model, max_len)).to(device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """wenet forward_attention: the masked keys filled with the fp32 minimum,
    softmax, then zeroed. mask: (B, S) key padding, or a (B, T, S) chunk
    mask (mask.py:116-186, add_optional_chunk_mask)."""
    if mask is None:
        return torch.softmax(scores.float(), dim=-1)
    m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
    scores = scores.masked_fill(~m, torch.finfo(torch.float32).min)
    return torch.softmax(scores.float(), dim=-1).masked_fill(~m, 0.0)


def _rel_attention(p, x, pos_emb, mask, heads: int, compute_dtype, x_q=None):
    """Transformer-XL attention without rel_shift (attention.py:180-222):
    scores ((q + u) k^T + (q + v) pos^T) / sqrt(dk), in fp32. `x_q` gives
    the queries alone (the streaming chunk queries only its new frames while
    keys and values cover the cache too, encoder_layer.py:220-231)."""
    b, t, d = x.shape
    dk = d // heads

    def proj(pp, y):
        return fnn.linear(pp, y, compute_dtype).reshape(y.shape[0], -1, heads, dk)

    q = proj(p["linear_q"], x if x_q is None else x_q)
    k, v = proj(p["linear_k"], x), proj(p["linear_v"], x)
    pos = proj(p["linear_pos"], pos_emb[None])
    qf = q.float()
    ac = torch.einsum("bthd,bshd->bhts", qf + p["pos_bias_u"].float(), k.float())
    bd = torch.einsum("bthd,zshd->bhts", qf + p["pos_bias_v"].float(), pos.float())
    attn = _masked_softmax((ac + bd) / math.sqrt(dk), mask)
    out = torch.einsum("bhts,bshd->bthd", attn, v.float()).reshape(b, -1, d).to(compute_dtype)
    return fnn.linear(p["linear_out"], out, compute_dtype)


def _conv_module(p, x, mask, compute_dtype):
    """Pointwise conv + GLU -> depthwise conv -> BatchNorm (running
    statistics) -> swish -> pointwise conv, padding zeroed before and after
    (convolution.py)."""
    if mask is not None:
        x = x.masked_fill(~mask[:, :, None], 0.0)
    a, g = fnn.linear(p["pw1"], x, compute_dtype).chunk(2, dim=-1)
    h = a * torch.sigmoid(g.float()).to(a.dtype)
    k = p["dw"]["w"].shape[0]
    h = fnn.conv1d(p["dw"], h, groups=h.shape[-1], padding=(k - 1) // 2,
                   compute_dtype=compute_dtype)
    bn = p["bn"]
    hf = (h.float() - bn["mean"]) * torch.rsqrt(bn["var"] + 1e-5) * bn["g"] + bn["b"]
    h = fnn.linear(p["pw2"], (hf * torch.sigmoid(hf)).to(compute_dtype), compute_dtype)
    if mask is not None:
        h = h.masked_fill(~mask[:, :, None], 0.0)
    return h


def _ffn(p, x, compute_dtype):
    h = fnn.linear(p["w1"], x, compute_dtype).float()
    return fnn.linear(p["w2"], (h * torch.sigmoid(h)).to(compute_dtype), compute_dtype)


def _conformer_layer(p, x, pos_emb, mask, heads, compute_dtype, mask_pad=None):
    """Macaron FF (x 0.5) -> attention -> conv module -> FF (x 0.5) -> final
    LayerNorm, each behind a pre-LayerNorm and a residual (encoder_layer.py:179-268).
    `mask` is the (B, S) padding or a (B, T, S) chunk mask; the conv module
    reads the plain padding mask `mask_pad` (by default `mask` when 2-D)."""
    if mask_pad is None and (mask is None or mask.dim() == 2):
        mask_pad = mask

    def ln(name, y):
        return fnn.layernorm(p[name], y, eps=1e-5)

    x = x + 0.5 * _ffn(p["ff_macaron"], ln("norm_ff_macaron", x), compute_dtype)
    x = x + _rel_attention(p["attn"], ln("norm_mha", x), pos_emb, mask, heads, compute_dtype)
    x = x + _conv_module(p["conv"], ln("norm_conv", x), mask_pad, compute_dtype)
    x = x + 0.5 * _ffn(p["ff"], ln("norm_ff", x), compute_dtype)
    return ln("norm_final", x)


def _subsample(params: dict, cfg: ConformerConfig, x: torch.Tensor,
               mask: Optional[torch.Tensor], compute_dtype):
    """CMVN'd features -> the embedding, scaled by sqrt(output_size) (the
    RelPositionalEncoding xscale); returns (x, mask) at the subsampled rate
    (subsampling.py:23-280)."""
    b = x.shape[0]
    spec = subsampling_spec(cfg.subsampling)
    if spec["convs"]:
        # VALID conv2d + ReLU stages, then the channel-major flatten linear
        h = x[:, None]  # (B, 1, T, F)
        for i, (k, s) in enumerate(spec["convs"]):
            conv = params["embed_convs"][i]
            w = conv["w"].permute(3, 2, 0, 1).to(compute_dtype)  # HWIO -> OIHW
            h = F.conv2d(h.to(compute_dtype), w, stride=s).float()
            h = torch.relu(h + conv["b"].float()[None, :, None, None])
            if mask is not None:
                mask = mask[:, : -(k - 1): s]
        _, c, tt, ff = h.shape
        h = h.permute(0, 2, 1, 3).reshape(b, tt, c * ff)  # (c outer, f inner)
        x = fnn.linear(params["embed_out"], h.to(compute_dtype), compute_dtype)
    else:
        x = fnn.linear(params["embed_out"], x.to(compute_dtype), compute_dtype)
        x = fnn.layernorm(params["embed_ln"], x, eps=1e-5).to(compute_dtype)
    return x.float() * math.sqrt(cfg.output_size), mask


def subsequent_chunk_mask_np(size: int, chunk_size: int, num_left_chunks: int = -1) -> np.ndarray:
    """(size, size) bool chunk visibility (mask.py:78-113): row i sees the
    columns [chunk start - num_left_chunks chunks, (i // chunk + 1) * chunk)."""
    i = np.arange(size)[:, None]
    j = np.arange(size)[None, :]
    ending = np.minimum((i // chunk_size + 1) * chunk_size, size)
    if num_left_chunks < 0:
        start = np.zeros_like(i)
    else:
        start = np.maximum((i // chunk_size - num_left_chunks) * chunk_size, 0)
    return (j >= start) & (j < ending)


def make_chunk_mask(pad_mask: torch.Tensor, chunk_size: int,
                    num_left_chunks: int = -1) -> torch.Tensor:
    """(B, T, T) = the padding mask AND the chunk mask (add_optional_chunk_mask,
    mask.py:116-186); chunk_size <= 0 means the full context."""
    t = pad_mask.shape[1]
    cm = torch.from_numpy(subsequent_chunk_mask_np(t, chunk_size if chunk_size > 0 else t,
                                                   num_left_chunks)).to(pad_mask.device)
    return pad_mask[:, None, :] & cm[None]


def dynamic_chunk_size(max_len: int, rng: np.random.Generator) -> int:
    """A training chunk size drawn as this fork does: the full context half
    the time, else 5-11 frames (mask.py:157-170, `chunk_size % 7 + 1 + 4`)."""
    c = int(rng.integers(1, max_len))
    if c > max_len // 2:
        return max_len
    return c % 7 + 1 + 4


def sample_train_chunk_mask(cfg: ConformerConfig, t_frames: int,
                            rng: np.random.Generator) -> np.ndarray:
    """The (T', T') bool dynamic-chunk mask of one training batch
    (use_dynamic_chunk), drawn on the host; all True for the full context,
    so every step has the same inputs."""
    tt = subsampled_time(cfg.subsampling, t_frames)
    c = dynamic_chunk_size(tt, rng)
    if c >= tt:
        return np.ones((tt, tt), bool)
    return subsequent_chunk_mask_np(tt, c)


def conformer_encode(params: dict, cfg: ConformerConfig, feats: torch.Tensor,
                     feat_lens: torch.Tensor, compute_dtype=torch.float32,
                     chunk_size: int = 0, num_left_chunks: int = -1,
                     chunk_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-utterance encoder forward (encoder.py:141-208): (B, T, 80)
    fbank and (B,) lengths -> ((B, T', output_size), (B,) lengths at the
    subsampled rate), padding masked out of attention and the conv module.

    chunk_size > 0 masks attention to chunks over the whole utterance (the
    static / decoding chunk of add_optional_chunk_mask, with
    num_left_chunks); `chunk_mask` (T', T') gives a precomputed visibility
    instead (`sample_train_chunk_mask`). The conv module always reads the
    plain padding mask."""
    t = feats.shape[1]
    mask = lens_to_mask(feat_lens.to(feats.device), t)
    x = (feats.float() - params["cmvn_mean"]) * params["cmvn_istd"]
    x, mask = _subsample(params, cfg, x, mask, compute_dtype)
    pos_emb = _pos_table(cfg.output_size, cfg.max_pos, x.device)[: x.shape[1]]
    if chunk_mask is not None:
        attn_mask = mask[:, None, :] & torch.as_tensor(chunk_mask, device=x.device)[None]
    elif chunk_size > 0:
        attn_mask = make_chunk_mask(mask, chunk_size, num_left_chunks)
    else:
        attn_mask = mask
    x = x.to(compute_dtype)
    for layer_p in params["layers"]:
        x = _conformer_layer(layer_p, x, pos_emb, attn_mask, cfg.attention_heads, compute_dtype,
                             mask_pad=mask)
    x = fnn.layernorm(params["after_norm"], x, eps=1e-5)
    return x, mask.sum(dim=1, dtype=torch.int32)


def conformer_forward_chunk(params: dict, cfg: ConformerConfig, feats: torch.Tensor,
                            offset: int, required_cache_size: int, caches: Optional[dict] = None,
                            compute_dtype=torch.float32) -> Tuple[torch.Tensor, dict]:
    """One streaming chunk (encoder.py:210-291): (1, w, 80) raw fbank of the
    decoding window -> (the encoder output of the new frames, the caches).

    caches: {"sub": (1, c, d) embedding cache, "layers": [(1, c, d)] per
    layer}. The subsampling's left context comes from overlapping input
    frames, not a cache (encoder.py:308-320), and the conv module runs on
    the chunk alone, zero-padded at its edges, as the reference does for
    this fork's non-causal convs: so the streamed output equals the
    chunk-masked full encode only for kernel-1 convs.
    `required_cache_size` < 0 keeps the whole history, 0 none, n > 0 the
    last n frames."""
    if feats.shape[0] != 1:
        raise ValueError("the streaming decode is single-utterance")
    x = (feats.float() - params["cmvn_mean"]) * params["cmvn_istd"]
    x, _ = _subsample(params, cfg, x, None, compute_dtype)
    sub_cache = caches["sub"] if caches else None
    cache_size = 0 if sub_cache is None else sub_cache.shape[1]
    if sub_cache is not None:
        x = torch.cat([sub_cache, x], dim=1)
    t_full = x.shape[1]
    # the table read from the cached span's absolute start
    # (encoder.py:257: position_encoding(offset - cache_size, xs.size(1)))
    start = offset - cache_size
    pos_emb = _pos_table(cfg.output_size, cfg.max_pos, x.device)[start: start + t_full]
    if required_cache_size < 0:
        next_cache_start = 0
    elif required_cache_size == 0:
        next_cache_start = t_full
    else:
        next_cache_start = max(t_full - required_cache_size, 0)

    new_caches = {"sub": x[:, next_cache_start:], "layers": []}
    x = x.to(compute_dtype)
    layer_caches = caches["layers"] if caches else [None] * len(params["layers"])
    for layer_p, att_cache in zip(params["layers"], layer_caches):
        x = _conformer_layer_chunk(layer_p, x, pos_emb, cfg.attention_heads, compute_dtype,
                                   att_cache)
        new_caches["layers"].append(x[:, next_cache_start:])
    y = fnn.layernorm(params["after_norm"], x, eps=1e-5)
    return y[:, cache_size:], new_caches


def _conformer_layer_chunk(p, x, pos_emb, heads, compute_dtype, output_cache):
    """The streaming `_conformer_layer` (encoder_layer.py:179-268): only the
    new frames are queried; the cached span of the output is the previous
    call's cache, reused as it is."""
    def ln(name, y):
        return fnn.layernorm(p[name], y, eps=1e-5)

    x1 = x + 0.5 * _ffn(p["ff_macaron"], ln("norm_ff_macaron", x), compute_dtype)
    h = ln("norm_mha", x1)
    if output_cache is None:
        x_q, res = None, x1
    else:
        chunk = x.shape[1] - output_cache.shape[1]
        x_q, res = h[:, -chunk:], x1[:, -chunk:]
    x2 = res + _rel_attention(p["attn"], h, pos_emb, None, heads, compute_dtype, x_q=x_q)
    x2 = x2 + _conv_module(p["conv"], ln("norm_conv", x2), None, compute_dtype)
    x2 = x2 + 0.5 * _ffn(p["ff"], ln("norm_ff", x2), compute_dtype)
    x2 = ln("norm_final", x2)
    if output_cache is not None:
        x2 = torch.cat([output_cache, x2], dim=1)
    return x2


def conformer_encode_chunk_by_chunk(params: dict, cfg: ConformerConfig, feats: torch.Tensor,
                                    decoding_chunk_size: int, num_decoding_left_chunks: int = -1,
                                    compute_dtype=torch.float32) -> torch.Tensor:
    """The streaming decode of a whole utterance (encoder.py:293-355): (1, T,
    80) fbank fed in overlapping windows, chunk by chunk, carrying the
    caches -> (1, T', output_size)."""
    if decoding_chunk_size <= 0:
        raise ValueError("decoding_chunk_size must be positive")
    spec = subsampling_spec(cfg.subsampling)
    context = spec["right_context"] + 1
    stride = spec["rate"] * decoding_chunk_size
    window = (decoding_chunk_size - 1) * spec["rate"] + context
    required = decoding_chunk_size * num_decoding_left_chunks
    caches, offset, outs = None, 0, []
    for cur in range(0, feats.shape[1] - context + 1, stride):
        end = min(cur + window, feats.shape[1])
        y, caches = conformer_forward_chunk(params, cfg, feats[:, cur:end], offset, required,
                                            caches, compute_dtype)
        outs.append(y)
        offset += y.shape[1]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# PPG extraction
# ---------------------------------------------------------------------------


@dataclass
class PPGExtractor:
    """Frozen PPG extractor: 16 kHz audio or kaldi fbank -> the 256-d PPG at
    20 ms frames, on `device` (the card unless the caller asks for the CPU;
    the params move there). `output_type` "map" projects onto the phone
    centres (`ce_w`, `ce_b`, `phn_center`)."""

    params: dict
    cfg: ConformerConfig
    output_type: str = "ppg"  # "ppg" | "map"
    map_mix_ratio: float = 1.0
    phn_center: Optional[np.ndarray] = None  # (phones, 256)
    ce_w: Optional[np.ndarray] = None  # (phones, 256)
    ce_b: Optional[np.ndarray] = None  # (phones,)
    frame_length: int = 20
    mel_frame_shift: int = 10
    compute_dtype: torch.dtype = torch.float32
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = to_tensors(self.params, self.device)
        self._map = None
        if self.output_type == "map":
            self._map = tuple(torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                              for a in (self.ce_w, self.ce_b, self.phn_center))

    @torch.no_grad()
    def mel_to_ppg(self, feats, feat_lens):
        """(B, T, 80) fbank at 10 ms -> ((B, T', 256) fp32 PPG, (B,) lengths):
        true_len = feat_len // (frame_length / mel_frame_shift), clamped to
        the encoder's length; frames past it are zero (ppg_model.py:132-141)."""
        feats = torch.as_tensor(feats, device=self.device)
        feat_lens = torch.as_tensor(feat_lens, device=self.device)
        enc, _ = conformer_encode(self.params, self.cfg, feats, feat_lens, self.compute_dtype)
        ppg = fnn.linear(self.params["content_linear"], enc, self.compute_dtype).float()
        ratio = self.frame_length // self.mel_frame_shift
        true_len = torch.clamp(torch.div(feat_lens, ratio, rounding_mode="floor"),
                               max=ppg.shape[1]).to(torch.int32)
        return self._to_target(ppg, true_len), true_len

    def _to_target(self, ppg, true_len):
        """The phone-centre map of output_type "map" (ppg_model.py:112-131),
        then the frames past each length zeroed."""
        if self._map is not None:
            ce_w, ce_b, centres = self._map
            mapped = torch.softmax(ppg @ ce_w.T + ce_b, dim=-1) @ centres
            ppg = mapped if self.map_mix_ratio == 1.0 else (
                ppg * (1 - self.map_mix_ratio) + mapped * self.map_mix_ratio)
        return ppg.masked_fill(~lens_to_mask(true_len, ppg.shape[1])[:, :, None], 0.0)

    @torch.no_grad()
    def audio_to_ppg(self, wav, wav_lens=None):
        """(B, T) 16 kHz waveform (and its (B,) lengths) -> `mel_to_ppg` of its
        kaldi fbank (ppg_model.py:162-169)."""
        wav = torch.as_tensor(wav, device=self.device)
        feats = kaldi_fbank(wav)
        if wav_lens is None:
            feat_lens = torch.full((feats.shape[0],), feats.shape[1], dtype=torch.int32,
                                   device=self.device)
        else:
            wav_lens = torch.as_tensor(wav_lens, device=self.device).long()
            feat_lens = torch.clamp(torch.div(wav_lens - 400, 160, rounding_mode="floor") + 1,
                                    min=0).to(torch.int32)
        return self.mel_to_ppg(feats, feat_lens)


# ---------------------------------------------------------------------------
# weights: seeded init, the JAX tree, the wenet checkpoint layout
# ---------------------------------------------------------------------------


def load_cmvn_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A wenet/kaldi global_cmvn stats file -> (mean, istd) float32. JSON
    {"mean_stat", "var_stat", "frame_num"}, or a kaldi text matrix of two
    rows [mean_stat... count] [var_stat... 0]."""
    import json

    with open(path, "r", encoding="utf-8") as f:
        txt = f.read()
    try:
        d = json.loads(txt)
        mean_stat = np.asarray(d["mean_stat"], np.float64)
        var_stat = np.asarray(d["var_stat"], np.float64)
        n = float(d["frame_num"])
    except json.JSONDecodeError:
        rows = [r for r in txt.replace("[", " ").replace("]", " ").split("\n") if r.strip()]
        r1 = np.asarray([float(x) for x in rows[-2].split()], np.float64)
        r2 = np.asarray([float(x) for x in rows[-1].split()], np.float64)
        mean_stat, n, var_stat = r1[:-1], r1[-1], r2[:-1]
    mean = mean_stat / n
    var = np.maximum(var_stat / n - mean ** 2, 1e-20)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)


def conformer_from_jax(params_np) -> dict:
    """The JAX `init_conformer` / `conformer_from_torch` tree (nested dicts of
    numpy arrays) -> port params: the same names and layouts, as tensors."""
    return to_tensors(params_np)


def conformer_from_torch(sd: Dict, cfg: ConformerConfig,
                         cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> dict:
    """A wenet ASR checkpoint's encoder and content linear (numpy arrays or
    tensors under `encoder.*` and `linear.*`) -> port params. CMVN from
    `cmvn` (mean, istd), else the checkpoint's global_cmvn, else identity."""
    sd = {k: v.detach().float().cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)
          for k, v in sd.items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def lin(k, bias=True):
        p = {"w": t(sd[f"{k}.weight"].T)}
        if bias and f"{k}.bias" in sd:
            p["b"] = t(sd[f"{k}.bias"])
        return p

    def ln(k):
        return {"g": t(sd[f"{k}.weight"]), "b": t(sd[f"{k}.bias"])}

    params: dict = {}
    if cmvn is not None:
        params["cmvn_mean"], params["cmvn_istd"] = t(cmvn[0]), t(cmvn[1])
    elif "encoder.global_cmvn.mean" in sd:
        params["cmvn_mean"] = t(sd["encoder.global_cmvn.mean"])
        params["cmvn_istd"] = t(sd["encoder.global_cmvn.istd"])
    else:
        params["cmvn_mean"] = torch.zeros(cfg.input_dim)
        params["cmvn_istd"] = torch.ones(cfg.input_dim)

    spec = subsampling_spec(cfg.subsampling)
    if spec["convs"]:
        # Sequential(conv, relu, conv, relu, ...): convs at 0, 2, 4;
        # (odim, in, k, k) -> HWIO (k, k, in, odim)
        convs = []
        for i, (k, _s) in enumerate(spec["convs"]):
            wk = f"encoder.embed.conv.{2 * i}.weight"
            if wk not in sd:
                raise KeyError(f"checkpoint has no {wk}: its conv stack does not match "
                               f"input_layer={cfg.subsampling!r}")
            if sd[wk].shape[-1] != k:
                raise ValueError(f"conv stage {i} kernel {sd[wk].shape[-1]} != {k} expected "
                                 f"for input_layer={cfg.subsampling!r}")
            convs.append({"w": t(sd[wk].transpose(2, 3, 1, 0)),
                          "b": t(sd[f"encoder.embed.conv.{2 * i}.bias"])})
        if f"encoder.embed.conv.{2 * len(spec['convs'])}.weight" in sd:
            raise KeyError(f"checkpoint has more conv stages than input_layer="
                           f"{cfg.subsampling!r} expects ({len(spec['convs'])})")
        params["embed_convs"] = convs
        params["embed_out"] = lin("encoder.embed.out.0" if spec["out_attr"] == "out"
                                  else "encoder.embed.linear")
        want = cfg.output_size * subsampled_feat_dim(cfg.subsampling, cfg.input_dim)
        if params["embed_out"]["w"].shape[0] != want:
            raise ValueError(f"subsampling flatten linear fan-in "
                             f"{params['embed_out']['w'].shape[0]} != {want} expected")
    else:
        params["embed_out"] = lin("encoder.embed.out.0")
        params["embed_ln"] = ln("encoder.embed.out.1")

    layers = []
    for i in range(cfg.num_blocks):
        k = f"encoder.encoders.{i}"
        cm = f"{k}.conv_module"
        layers.append({
            "norm_ff_macaron": ln(f"{k}.norm_ff_macaron"),
            "ff_macaron": {"w1": lin(f"{k}.feed_forward_macaron.w_1"),
                           "w2": lin(f"{k}.feed_forward_macaron.w_2")},
            "norm_mha": ln(f"{k}.norm_mha"),
            "attn": {
                **{name: lin(f"{k}.self_attn.{name}")
                   for name in ("linear_q", "linear_k", "linear_v", "linear_out")},
                "linear_pos": lin(f"{k}.self_attn.linear_pos", bias=False),
                "pos_bias_u": t(sd[f"{k}.self_attn.pos_bias_u"]),
                "pos_bias_v": t(sd[f"{k}.self_attn.pos_bias_v"]),
            },
            "norm_conv": ln(f"{k}.norm_conv"),
            "conv": {
                # the pointwise convs are k = 1: (out, in, 1) -> linear (in, out)
                "pw1": {"w": t(sd[f"{cm}.pointwise_conv1.weight"][:, :, 0].T),
                        "b": t(sd[f"{cm}.pointwise_conv1.bias"])},
                "dw": {"w": t(sd[f"{cm}.depthwise_conv.weight"].transpose(2, 1, 0)),
                       "b": t(sd[f"{cm}.depthwise_conv.bias"])},
                "bn": {"g": t(sd[f"{cm}.norm.weight"]), "b": t(sd[f"{cm}.norm.bias"]),
                       "mean": t(sd[f"{cm}.norm.running_mean"]),
                       "var": t(sd[f"{cm}.norm.running_var"])},
                "pw2": {"w": t(sd[f"{cm}.pointwise_conv2.weight"][:, :, 0].T),
                        "b": t(sd[f"{cm}.pointwise_conv2.bias"])},
            },
            "norm_ff": ln(f"{k}.norm_ff"),
            "ff": {"w1": lin(f"{k}.feed_forward.w_1"), "w2": lin(f"{k}.feed_forward.w_2")},
            "norm_final": ln(f"{k}.norm_final"),
        })
    params["layers"] = layers
    params["after_norm"] = ln("encoder.after_norm")
    params["content_linear"] = lin("linear")  # asr_model.py:77-78
    return params


def load_ppg_extractor(ckpt_path: str, config_path: str, *, output_type: str = "ppg",
                       map_mix_ratio: float = 1.0, phn_center_path: Optional[str] = None,
                       ce_layer_path: Optional[str] = None, device="cuda") -> PPGExtractor:
    """A frozen extractor from the reference artifacts (ppg_model.py:11-28):
    the wenet checkpoint (33.pt), its train.yaml and global_cmvn (the
    YAML's `cmvn_file`, else `global_cmvn` beside the checkpoint), and for
    output_type "map" phn_center.npy and ce_layer.pkl. Runs on `device`,
    the card unless the caller asks for the CPU."""
    import pickle

    import yaml

    with open(config_path, "r", encoding="utf-8") as f:
        conf = yaml.safe_load(f)
    enc = conf.get("encoder_conf", {})
    cfg = ConformerConfig(
        input_dim=conf.get("input_dim", 80),
        output_size=enc.get("output_size", 256),
        attention_heads=enc.get("attention_heads", 4),
        linear_units=enc.get("linear_units", 2048),
        num_blocks=enc.get("num_blocks", 12),
        cnn_module_kernel=enc.get("cnn_module_kernel", 15),
        subsampling=enc.get("input_layer", "conv2d2"),
    )
    device = resolve_device(device)
    sd = {k: v for k, v in torch.load(ckpt_path, map_location="cpu", weights_only=True).items()
          if torch.is_tensor(v)}
    cmvn = None
    cmvn_file = conf.get("cmvn_file")
    if cmvn_file and not os.path.exists(cmvn_file):
        cmvn_file = os.path.join(os.path.dirname(ckpt_path), "global_cmvn")
    if cmvn_file and os.path.exists(cmvn_file):
        cmvn = load_cmvn_file(cmvn_file)
    params = conformer_from_torch(sd, cfg, cmvn)
    phn_center = ce_w = ce_b = None
    if output_type == "map":
        phn_center = np.load(phn_center_path).astype(np.float32)
        with open(ce_layer_path, "rb") as f:
            ce = pickle.load(f)
        ce_w, ce_b = np.asarray(ce["w"], np.float32), np.asarray(ce["b"], np.float32)
    return PPGExtractor(params=params, cfg=cfg, output_type=output_type,
                        map_mix_ratio=map_mix_ratio, phn_center=phn_center, ce_w=ce_w, ce_b=ce_b,
                        device=device)


def init_conformer(cfg: ConformerConfig, generator: torch.Generator, device="cpu") -> dict:
    """Seeded fp32 parameters (tests, smoke runs): torch-default linears and
    depthwise convs, subsampling convs N(0, 0.01), pos biases N(0, 0.02^2),
    unit LayerNorms and an identity BatchNorm and CMVN (the JAX init's
    rules)."""
    g, dev = generator, device
    d, lu, heads = cfg.output_size, cfg.linear_units, cfg.attention_heads

    def lin(i, o, bias=True):
        return fnn.linear_init(i, o, g, dev, bias=bias)

    def ln():
        return {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}

    params = {"cmvn_mean": torch.zeros(cfg.input_dim, device=dev),
              "cmvn_istd": torch.ones(cfg.input_dim, device=dev),
              "after_norm": ln(), "content_linear": lin(d, d)}
    spec = subsampling_spec(cfg.subsampling)
    if spec["convs"]:
        params["embed_convs"] = [
            {"w": 0.1 * torch.randn((k, k, 1 if i == 0 else d, d), generator=g, device=dev),
             "b": torch.zeros(d, device=dev)} for i, (k, _s) in enumerate(spec["convs"])]
        params["embed_out"] = lin(d * subsampled_feat_dim(cfg.subsampling, cfg.input_dim), d)
    else:
        params["embed_out"] = lin(cfg.input_dim, d)
        params["embed_ln"] = ln()
    params["layers"] = [{
        "norm_ff_macaron": ln(),
        "ff_macaron": {"w1": lin(d, lu), "w2": lin(lu, d)},
        "norm_mha": ln(),
        "attn": {"linear_q": lin(d, d), "linear_k": lin(d, d), "linear_v": lin(d, d),
                 "linear_out": lin(d, d), "linear_pos": lin(d, d, bias=False),
                 "pos_bias_u": 0.02 * torch.randn((heads, d // heads), generator=g, device=dev),
                 "pos_bias_v": 0.02 * torch.randn((heads, d // heads), generator=g, device=dev)},
        "norm_conv": ln(),
        "conv": {"pw1": lin(d, 2 * d),
                 "dw": fnn.conv1d_init(d, d, cfg.cnn_module_kernel, d, g, dev),
                 "bn": {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev),
                        "mean": torch.zeros(d, device=dev), "var": torch.ones(d, device=dev)},
                 "pw2": lin(d, d)},
        "norm_ff": ln(),
        "ff": {"w1": lin(d, lu), "w2": lin(lu, d)},
        "norm_final": ln(),
    } for _ in range(cfg.num_blocks)]
    return params
